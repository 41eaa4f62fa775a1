"""The system's spans in a traced record: device time launched inside them
and the device's idle time while the host was inside them, by exact
interval arithmetic on hand-built records, and the readers of the metrics
that read them."""

import importlib.util

import pytest

from benchmark import harness, program

READERS = ("forward_idle_s.train", "backward_idle_s.train", "apply_idle_s.train",
           "apply_busy_s.train", "host_syncs.train", "condition_ms.sample")


def record():
    # one micro-step of 0.0-10.0 in a window of -1.0-12.0: forward 0-4 (encode
    # 0.5-1.5 and condition 1.5-2.5 inside), backward 4-7, apply 7-9.5 (two
    # host_syncs), the root's own 9.5-10 (one host_sync); a span before the
    # window. The device runs 0.2-3.0 (two streams), 3.5-6.0, 6.5-8.0, 9.0-9.6
    # and 11.0-11.5 (the benchmark's loop, after the root).
    spans = [("train.step", 0.0, 10.0, 0, None), ("train.forward", 0.0, 4.0, 1, 0),
             ("encode", 0.5, 1.5, 2, 1), ("condition", 1.5, 2.5, 3, 1),
             ("train.backward", 4.0, 7.0, 4, 0), ("train.apply", 7.0, 9.5, 5, 0),
             ("host_sync", 7.1, 7.2, 6, 5), ("host_sync", 9.0, 9.1, 7, 5),
             ("host_sync", 9.6, 9.7, 8, 0), ("train.step", -5.0, -3.0, 9, None),
             ("host_sync", -4.0, -3.5, 10, 9)]
    device = [("a", 0.2, 2.0, 0.6), ("b", 1.0, 3.0, 1.6), ("c", 3.5, 6.0, 3.2),
              ("d", 6.5, 8.0, 7.05), ("e", 9.0, 9.6, 9.05), ("f", 11.0, 11.5, 10.5),
              ("g", 2.5, 2.6, None)]
    return {"window": (-1.0, 12.0), "device": device, "program": spans, "units": 1}


def test_nested_spans_count_an_instant_once():
    rec = record()
    # train.step holds every other span: its idle is 0-0.2, 3.0-3.5, 6.0-6.5,
    # 8.0-9.0, 9.6-10.0
    assert program.idle_in(rec, ("train.step",)) == pytest.approx(0.2 + 0.5 + 0.5 + 1.0 + 0.4)
    assert program.idle_in(rec, ("train.step", "train.forward", "encode")) == pytest.approx(2.6)
    # a, b overlap (two streams): 0.2-3.0 once
    assert program.busy_in(rec, ("train.forward",)) == pytest.approx(2.8 + 2.5)


def test_a_gap_that_straddles_a_span_edge_is_split():
    rec = record()
    # the gap 3.0-3.5 lies in the forward; 6.0-6.5 in the backward; 8.0-9.0 in apply
    assert program.idle_in(rec, ("train.forward",)) == pytest.approx(0.2 + 0.5)
    assert program.idle_in(rec, ("train.backward",)) == pytest.approx(0.5)
    assert program.idle_in(rec, ("train.apply",)) == pytest.approx(1.0)
    # condition 1.5-2.5 is busy throughout; encode too
    assert program.idle_in(rec, ("encode", "condition")) == pytest.approx(0.0)
    # encode launched a (0.2-2.0), condition b (1.0-3.0): 0.2-3.0
    assert program.busy_in(rec, ("encode", "condition")) == pytest.approx(2.8)
    # apply launched d (6.5-8.0) and e (9.0-9.6)
    assert program.busy_in(rec, ("train.apply",)) == pytest.approx(1.5 + 0.6)


def test_spans_outside_the_window_are_dropped():
    rec = record()
    assert program.count(rec, "host_sync") == 3
    rec["window"] = (-6.0, -2.0)
    assert program.count(rec, "host_sync") == 1
    assert program.idle_in(rec, ("train.apply",)) is None
    rec["window"] = (20.0, 30.0)
    assert program.count(rec, "host_sync") is None
    assert program.idle_in(rec, ("train.step",)) is None
    assert program.busy_in(rec, ("train.step",)) is None


def test_phase_idles_and_the_idle_outside_the_roots_make_the_window_idle():
    rec = record()
    phases = sum(program.idle_in(rec, (p,)) for p in ("train.forward", "train.backward",
                                                       "train.apply"))
    inside_root_only = 0.4  # 9.6-10.0: the root's own host_sync after apply
    window_idle = 13.0 - (2.8 + 2.5 + 1.5 + 0.6 + 0.5)
    assert program.length(program.idle(rec)) == pytest.approx(window_idle)
    assert phases + inside_root_only + program.idle_outside(rec, ("train.step",)) == \
        pytest.approx(window_idle)
    assert program.idle_outside(rec, ("train.step",)) == pytest.approx(1.0 + 1.0 + 0.5)


def _reader(name):
    path = harness.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_readers_read_the_record():
    rec = record()
    assert _reader("forward_idle_s.train")(rec) == pytest.approx(0.7)
    assert _reader("backward_idle_s.train")(rec) == pytest.approx(0.5)
    assert _reader("apply_idle_s.train")(rec) == pytest.approx(1.0)
    assert _reader("apply_busy_s.train")(rec) == pytest.approx(2.1)
    assert _reader("host_syncs.train")(rec) == 3
    assert _reader("condition_ms.sample")(rec) == pytest.approx(2800.0)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_returns_none_with_an_empty_store(name):
    from vista_tpu_torch.utils import profiling

    profiling.clear()
    rec = record()
    del rec["program"]
    assert _reader(name)(rec) is None
    assert rec["program"] == []


def test_the_store_is_read_in_seconds_on_the_window_clock():
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vista_tpu_torch.utils import profiling

    profiling.clear()
    t0 = time.time_ns() * 1e-9
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("train.step"):
            profiling.host_sync(torch.ones(()))
    t1 = time.time_ns() * 1e-9
    rec = {"window": (t0, t1), "device": [], "units": 1}
    assert [s[0] for s in program.spans(rec)] == ["train.step", "host_sync"]
    assert all(t0 <= s[1] <= s[2] <= t1 for s in rec["program"])
    assert program.count(rec, "host_sync") == 1
    assert program.idle_in(rec, ("train.step",)) == pytest.approx(rec["program"][0][2]
                                                                  - rec["program"][0][1])
    profiling.clear()
