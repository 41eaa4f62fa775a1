"""The traced run's arithmetic: device operations placed in spans by the
host time of their launch, busy time as a union, idle gaps named by the
span open on the host."""

import pytest

from benchmark import trace


def record():
    # the host launches A and B inside "sample" (0.0-1.0), C inside
    # "decode_first_stage" (1.0-1.2); the device runs B and C late, after
    # their spans closed, and a second stream's D overlaps A
    return {"window": (0.0, 4.0),
            "spans": [("sample", 0.0, 1.0), ("decode_first_stage", 1.0, 1.2)],
            "device": [("vk::attention_wgmma_kernel<64>", 0.1, 1.1, 0.05),
                       ("elementwise_kernel", 1.5, 2.0, 0.5),
                       ("cudnn fprop", 2.0, 3.0, 1.1),
                       ("vk::attn_bwd_dq_wgmma", 0.5, 1.4, None)]}


def test_operations_belong_to_the_span_that_launched_them():
    rec = record()
    assert [op[0] for op in trace.within(rec, "sample")] == [
        "vk::attention_wgmma_kernel<64>", "elementwise_kernel"]
    assert [op[0] for op in trace.within(rec, "decode_first_stage")] == ["cudnn fprop"]


def test_busy_time_counts_overlapping_streams_once():
    rec = record()
    assert trace.busy_s(rec) == pytest.approx(1.3 + 1.5)  # 0.1-1.4, 1.5-3.0
    assert trace.device_time(rec["device"]) == pytest.approx(1.0 + 0.5 + 1.0 + 0.9)


def test_idle_gaps_are_named_by_the_open_host_span():
    rec = record()
    gaps = trace.idle_gaps(rec)
    assert gaps[0] == ("host", pytest.approx(1.0))  # 3.0-4.0, every span closed
    assert ("host", pytest.approx(0.1)) in gaps[1:]  # 1.4-1.5
    assert ("sample", pytest.approx(0.1)) in gaps[1:]  # 0.0-0.1, the host in "sample"


def test_groups_follow_the_kernel_table():
    groups = trace.groups(record()["device"])
    assert groups["K: attention (wgmma)"] == pytest.approx(1.0)
    assert groups["convs (cuDNN)"] == pytest.approx(1.0)
    assert groups["elementwise"] == pytest.approx(0.5)
