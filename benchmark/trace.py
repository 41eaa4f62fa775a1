"""The traced run's record: device operations from ``torch.profiler`` and
the benchmark's own spans, read in memory, and what the per-layer metrics
derive from them.

Spans are ``torch.profiler.record_function`` ranges the benchmark puts
around the entry's methods on the instance (:meth:`Spans.wrap`,
:meth:`Spans.span`); nothing in the system changes, and no span waits for
the device. A device operation belongs to the spans that were open on the
host when it was launched: the profiler gives the kernel and the runtime
call that launched it one correlation id, and the call's host time places
it.

Busy time is the union of the intervals in which any operation ran on the
device (kernels, copies, fills): two streams at once count once.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import sys
from typing import Dict, Iterable, List, Tuple

import torch

# kernel symbols of the system's hand-written kernels by group (the first
# group whose pattern a demangled name contains takes it)
SYMBOLS = {
    "attention (wgmma)": ("vk::attention_wgmma_kernel<",),
    "attention (short, Sk <= 64)": ("vk::attention_short_kernel<",),
    "ln_linear": ("vk::ln_linear_kernel", "vk::ln_stats_kernel"),
    "linear_residual": ("vk::linear_residual_tma_kernel",),
    "gn_silu_conv3": ("vk::gn_silu_kernel", "vk::conv3_tma_kernel<1>", "vk::conv3_tma_kernel<2>"),
    "conv3": ("vk::conv3_tma_kernel<0>",),
    "layer_norm": ("vk::layer_norm_kernel",),
    "attention_bwd dK/dV (wgmma)": ("vk::attn_bwd_dkv_wgmma",),
    "attention_bwd dQ (wgmma)": ("vk::attn_bwd_dq_wgmma",),
    "attention_bwd prep (lse, D)": ("vk::attn_bwd_prep",),
    "attention_bwd (short, Sk <= 64)": ("vk::attn_bwd_short_kernel<",),
    "ff_bwd_dh": ("vk::ff_bwd_dh_tma_kernel",),
    "seg_gemm": ("vk::seg_gemm_tma_kernel",),
    "vk_wgrad": ("vk::wgrad_tma_kernel",),
    "ln_bwd": ("vk::ln_bwd_kernel",),
}
# PyTorch's own kernels by what their names contain
LIBRARY = [("cuDNN layout", ("nchwtonhwc", "nhwctonchw", "converttensor")),
           ("convs (cuDNN)", ("fprop", "dgrad", "wgrad", "conv")),
           ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass")),
           ("group norm", ("group_norm", "groupnorm", "rowwisemoments")),
           ("copies", ("copy", "catarray", "memcpy", "memset")),
           ("softmax", ("softmax",)),
           ("fft", ("fft",)),
           ("upsample", ("upsample",)),
           ("reductions", ("reduce",)),
           ("elementwise", ("elementwise",))]
GLUE = ("copies", "elementwise", "reductions")  # PyTorch's glue between the kernels


def group(name: str) -> str:
    """The group of a device operation: ``K: <kernel>`` for the system's
    hand-written kernels, else PyTorch's kind."""
    for g, symbols in SYMBOLS.items():
        if any(s in name for s in symbols):
            return f"K: {g}"
    low = name.lower()
    for g, keys in LIBRARY:
        if any(k in low for k in keys):
            return g
    return "other"


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Spans:
    """The benchmark's spans around methods of the entry's objects. Off, a
    wrapper only calls through; on (the traced run), it opens a
    ``record_function`` range."""

    def __init__(self):
        self.on = False

    def wrap(self, obj, method: str) -> None:
        inner = getattr(obj, method)
        label = f"bench:{method}"

        @functools.wraps(inner)
        def call(*args, **kwargs):
            if not self.on:
                return inner(*args, **kwargs)
            with torch.profiler.record_function(label):
                return inner(*args, **kwargs)

        setattr(obj, method, call)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(f"bench:{name}"):
            yield


@contextlib.contextmanager
def profiled(spans: Spans, out: dict):
    """Profile the block: ``out`` receives ``device`` ``[(name, start_s,
    end_s, launched_s)]`` (``launched_s`` the host time of the runtime call
    that launched it, None where the trace has none), ``spans`` ``[(name,
    start_s, end_s)]`` on the same clock and the block's ``window``
    ``(start_s, end_s)``, which ends once the device has finished the
    block's work."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    spans.on = True
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                           else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        with torch.profiler.record_function("bench:window"):
            yield
            sync()
    finally:
        prof.stop()
        spans.on = False
    cuda = torch.autograd.DeviceType.CUDA
    ops, host, launched = [], [], {}
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
        name = e.name()
        if e.device_type() == cuda:
            if not name.startswith("bench:"):  # not a span's copy on the device's row
                ops.append((name, start, end, e.correlation_id()))
        elif name.startswith("bench:"):
            host.append((name[6:], start, end))
        elif name.startswith("cu"):  # a runtime call: cudaLaunchKernel, cudaMemcpyAsync, ...
            launched[e.correlation_id()] = start
    window = [(s, e) for n, s, e in host if n == "window"]
    unplaced = sum(1 for *_, c in ops if c not in launched)
    print(f"trace: {len(ops)} device operations, {unplaced} without their launch on the host",
          file=sys.stderr, flush=True)
    out.update(device=[(n, s, e, launched.get(c)) for n, s, e, c in ops],
               spans=[h for h in host if h[0] != "window"],
               window=window[0] if window else (0.0, 0.0))


# ------------------------------------------------------------ derivations

def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def busy_s(rec: dict) -> float:
    return sum(e - s for s, e in union((s, e) for _, s, e, _ in rec["device"]))


def window_s(rec: dict) -> float:
    s, e = rec["window"]
    return e - s


def within(rec: dict, name: str) -> list:
    """The device operations launched while a span called ``name`` was open
    on the host."""
    spans = sorted((s, e) for n, s, e in rec["spans"] if n == name)
    starts = [s for s, _ in spans]
    out = []
    for op in rec["device"]:
        t = op[3]
        k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if k >= 0 and t <= spans[k][1]:
            out.append(op)
    return out


def device_time(ops) -> float:
    """Summed durations (a share of device time: two streams count twice)."""
    return sum(op[2] - op[1] for op in ops)


def groups(ops) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, s, e, _ in ops:
        g = group(name)
        out[g] = out.get(g, 0.0) + (e - s)
    return out


def idle_gaps(rec: dict, top: int = 10) -> List[Tuple[str, float]]:
    """The longest idle intervals of the device inside the window, each
    named by the innermost span open at its middle (``host`` outside
    every span)."""
    w0, w1 = rec["window"]
    busy = union((max(s, w0), min(e, w1)) for _, s, e, _ in rec["device"] if e > w0 and s < w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        open_ = [(ss, n) for n, ss, ee in rec["spans"] if ss <= mid <= ee]
        out.append((max(open_)[1] if open_ else "host", e - s))
    return out


def breakdown(rec: dict) -> dict:
    g = sorted(groups(rec["device"]).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in g], "idle_gaps": [list(x) for x in idle_gaps(rec)]}
