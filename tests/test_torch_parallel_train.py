"""The sharded trainer on 2 gloo ranks: the tiny phase-2 engine (LoRA +
action control, seeded random weights with non-zero adapters, ucg
dropout, dynamics loss), fp32, on a global batch of 2 videos; the draws are
the global batch's, each rank keeping its rows.

- ``(data 2, fsdp 1)``, each rank on its video, against one rank on the
  global batch, two micro-steps at ``accum_steps`` 2: the loss and its
  metrics within 1e-6; the masters, EMA and module within 1e-6 of their
  largest magnitude where Adam's first step is well posed (see
  ``_posed``); the moments (the gradient: sums over every token that
  cancel, added per rank instead of in one product) within
  ``MOMENTS_TOL`` of theirs. ``tests/test_torch_train.py`` holds a
  ``(data 2, fsdp 1)`` step to the JAX package's ``make_train_step`` on a
  global batch, where that step is compiled already;
- ``(data 1, fsdp 2)`` against one rank: masters, moments, EMA, the
  accumulation buffer and the module bit for bit (both ranks compute the
  whole gradient; the norm's fp64 sums round to the same fp32); its
  ``state_dict`` the whole state on rank 0, the sliced tensors on the host,
  and nothing on rank 1;
- a checkpoint written at fsdp 2 resumes on one rank, and the reverse,
  bit for bit after one more micro-step;
- the ``Runner`` at fsdp 2 (``configs/tiny_smoke.yaml``): rank 0 alone
  writes the config, the CSV, the images and the checkpoints, and its
  checkpoint resumes on one rank bit for bit; the signal flags agree over
  the ranks; a global batch the data ranks do not divide raises; the LR
  rule ``accum x n_data x batch x lr``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_conditioner import fp32_cfgs
from tests.test_torch_train import LOSS, _batch, _rel, well_posed
from tests.torch_parallel_ranks import digest, training
from tests.torch_ranks import start_ranks
from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu_torch.diffusion.loss import LossConfig
from vista_tpu_torch.engine.training import TrainConfig

OPT = dict(learning_rate=1e-3, warmup_steps=0, policy="lora_only", accum_steps=2,
           ema_decay=0.9999)
TINY = str(Path(__file__).resolve().parents[1] / "configs" / "tiny_smoke.yaml")
GROUPS = ("master", "mu", "nu", "ema", "acc")
# the gradient's moments, data-parallel against one rank: 5.4e-6 of the
# largest first moment and 7.7e-6 of the largest second moment measured
MOMENTS_TOL = 5e-5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    _, pcfg = fp32_cfgs(0.15, lora=True)
    t = pcfg.num_frames
    tcfg = TrainConfig(**OPT, loss=LossConfig(num_frames=t, **LOSS))
    batch = {k: torch.from_numpy(v) for k, v in _batch(t, b=2).items()}
    batch["frames"] = batch["frames"].permute(0, 1, 4, 2, 3).contiguous()
    return start_ranks(training, 2, (pcfg, tcfg, batch, TINY,
                                     str(tmp_path_factory.mktemp("train")))).results()


def _posed(mu):
    """``well_posed`` of the gradient whose first Adam moment is ``mu``
    (``mu = (1 - beta1) g`` after the first step); the step differs by 0.13
    lr at most where it is not, data-parallel against one rank."""
    return well_posed(mu / (1.0 - TrainConfig().beta1))


def _within(got, ref):
    """Each group within its bound of the group's largest magnitude: the
    tensors Adam moved where the step is well posed (else within 2 lr) to
    1e-6, the moments to ``MOMENTS_TOL``."""
    for g in GROUPS + ("module",):
        scale = max([float(np.abs(r).max()) for r in ref[g].values()] + [1e-30])
        for n, r in ref[g].items():
            err = np.abs(got[g][n] - r)
            if g in ("master", "ema", "module"):
                posed = _posed(ref["mu"][n])
                assert float(err[~posed].max(initial=0.0)) <= 2 * OPT["learning_rate"], (g, n)
                err = err[posed]
            rel = 1e-6 if g in ("master", "ema", "module") else MOMENTS_TOL
            assert float(err.max(initial=0.0)) <= rel * scale, (g, n)


def _equal(got, ref):
    assert got["counts"] == ref["counts"]
    for g in GROUPS + ("module",):
        assert got[g].keys() == ref[g].keys()
        differ = [n for n in ref[g] if not np.array_equal(got[g][n], ref[g][n])]
        assert not differ, (g, differ[:5])


def test_data_parallel_matches_one_rank(run):
    for out in run:
        got, ref = out["data2"], out["one"]
        assert got["counts"] == ref["counts"] == (2, 1)
        for m, r in zip(out["data2_metrics"], out["one_metrics"]):
            for k in ("loss", "loss_main", "loss_hf", "sigma_mean"):
                assert _rel(m[k], r[k]) <= 1e-6, k
            assert _rel(m["grad_norm"], r["grad_norm"]) <= MOMENTS_TOL
        _within(got, ref)
        moved = [n for n in ref["master"] if not np.array_equal(got["master"][n], got["module"][n])]
        assert not moved  # the module holds the masters
    # the reported loss is the global batch's mean on every rank
    assert run[0]["data2_metrics"] == run[1]["data2_metrics"]


def test_fsdp_state_is_bit_identical_to_one_rank(run):
    for out in run:
        _equal(out["fsdp2"], out["one"])
        assert out["fsdp2_metrics"] == out["one_metrics"]
        dims = out["fsdp2_dims"]
        assert any(d is not None for d in dims.values()) and None in dims.values()
        for n, shape in out["fsdp2_local"].items():  # a rank holds half of a sliced tensor
            whole = out["one"]["master"][n].shape
            assert shape == whole if dims[n] is None else (
                shape[dims[n]] * 2 == whole[dims[n]]), n
    # state_dict: the whole state on rank 0's host, nothing on the other rank
    r0, r1 = (out["fsdp2_state_dict"] for out in run)
    assert r0[0] == digest({f"{g}.{k}": torch.from_numpy(v) for g in GROUPS
                            for k, v in run[0]["fsdp2"][g].items()})
    assert r0[1] == ["cpu"] and r0[2] == {g: len(run[0]["fsdp2"][g]) for g in GROUPS}
    assert r1[1] == [] and r1[2] == {g: 0 for g in GROUPS}


def test_checkpoints_resume_across_meshes(run):
    for out in run:
        fsdp2, one_from_fsdp2, fsdp2_from_one, one = out["resumed"]
        assert fsdp2["counts"] == (3, 1)
        _equal(one_from_fsdp2, fsdp2)
        _equal(fsdp2_from_one, one)
        _equal(fsdp2, one)


def test_runner_at_fsdp2(run):
    r0, r1 = run
    assert set(r0["files"]) >= {"config.yaml", "metrics.csv", "checkpoints/last"}
    assert any(f.startswith("images/") for f in r0["files"])
    assert r1["files"] == []
    assert r0["runner_digest"] == r1["runner_digest"]  # the same state over the slices
    assert r0["alone_differs"] == []
    assert r0["flags"] == r1["flags"] == (True, False)


def test_batch_and_lr_rules(run):
    for out in run:
        assert out["batch_error"] == "global batch 1 not divisible by data-parallel degree 2"
        assert out["scaled_lr"] == pytest.approx(2 * 2 * 2 * 1e-4, rel=1e-12)  # accum n_data bs
