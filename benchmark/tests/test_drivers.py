"""Each traffic mix's loop against a tiny configuration on the CPU through
the same entries the cells time, the comparison that decides ``correct``
with the cells' own limits, the control, and the faults the check has to
catch."""

import pytest
import torch

from benchmark import faults, harness, rollout, train
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 2024  # past 32 signed bits, as the driver's seeds


def driver_of(cell):
    return rollout if tiny.traffic(cell)["driver"] == "rollout" else train


def run(cell, seed=SEED, traced=False, control=False):
    readers = harness.metric_readers(harness.load_spec(), cell) if traced else {}
    return driver_of(cell).run(tiny.config(cell), tiny.traffic(cell), tiny.limits(cell), seed,
                               1.0, traced, CPU, readers, control=control)


@pytest.mark.parametrize("cell", [tiny.SAMPLE, tiny.ROLLOUT, tiny.TRAIN])
def test_loop_runs_and_is_correct(cell):
    result, checks = run(cell)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(checks) == set(tiny.limits(cell))


@pytest.mark.parametrize("cell", [tiny.SAMPLE, tiny.ROLLOUT, tiny.TRAIN])
def test_traced_run_reports_the_window(cell):
    """Without a card the profiler sees no device operation: the device's
    metrics find nothing to read and are left out, the rest are there."""
    result, _ = run(cell, traced=True)
    assert result["correct"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    mfu = next(n for n in result["metrics"] if n.startswith("mfu."))
    assert 0 < result["metrics"][mfu]["value"] < 100
    assert not any(n.startswith("kernel_roofline") for n in result["metrics"])


@pytest.mark.parametrize("cell", [tiny.SAMPLE, tiny.ROLLOUT, tiny.TRAIN])
def test_control_fails_the_limits(cell):
    """The reference one precision lower in the system's place, judged by
    the harness against the cell's limits, as a run judges the system."""
    result, checks = run(cell, control=True)
    assert not result["correct"], checks


def test_survey_judges_the_system_and_the_control():
    row = rollout.survey(tiny.config(tiny.ROLLOUT), tiny.traffic(tiny.ROLLOUT),
                         tiny.limits(tiny.ROLLOUT), SEED, True, CPU)
    assert row["system_correct"] and not row["control_correct"], row


def test_run_refuses_without_a_card(capsys):
    from benchmark import run as bench_run

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench_run.main(["--workload", tiny.SAMPLE, "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


# ------------------------------------------------------------- faults

@pytest.mark.parametrize("fault", faults.SAMPLING)
@pytest.mark.parametrize("cell", [tiny.SAMPLE, tiny.ROLLOUT])
def test_sampling_faults_are_not_correct(cell, fault):
    with faults.planted(fault):
        result, checks = run(cell)
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", faults.TRAINING)
def test_training_faults_are_not_correct(fault):
    with faults.planted(fault):
        result, checks = run(tiny.TRAIN)
    assert not result["correct"], checks


def test_faults_are_removed_after_the_block():
    from vista_tpu_torch.engine.engine import VistaEngine

    before = VistaEngine.__dict__["denoise_fn"]
    with faults.planted("unchanged_step"):
        assert VistaEngine.__dict__["denoise_fn"] is not before
    assert VistaEngine.__dict__["denoise_fn"] is before
