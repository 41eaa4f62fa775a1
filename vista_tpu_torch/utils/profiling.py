"""Tracing and step timing (counterpart of ``vista_tpu/utils/profiling.py``):

- ``trace(logdir)``: ``torch.profiler`` over the CPU and, where there is
  one, the card, writing a Chrome trace (``trace.json``) into ``logdir``;
- ``annotate(name)``: a named region in that trace
  (``torch.profiler.record_function``);
- ``StepTimer``: host-clock step durations, fenced with
  ``torch.cuda.synchronize()`` when a step hands over its result and a card
  is present;
  ``report()`` gives the JAX version's keys (steps, p50_s, p90_s, mean_s,
  steps_per_sec).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch

annotate = torch.profiler.record_function


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Collects fenced step durations; ``report()`` gives p50 / p90 / mean."""

    def __init__(self):
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        assert self._t0 is not None, "call start() first"
        self.durations.append(time.perf_counter() - self._t0)
        self._t0 = None

    @contextlib.contextmanager
    def step(self):
        """``with timer.step() as out: out["result"] = ...``: the step ends
        when its result is ready."""
        self.start()
        out = {}
        try:
            yield out
        finally:
            self.stop(out.get("result"))

    def report(self) -> dict:
        if not self.durations:
            return {}
        d = sorted(self.durations)
        n = len(d)
        return {"steps": n, "p50_s": d[n // 2], "p90_s": d[min(int(n * 0.9), n - 1)],
                "mean_s": sum(d) / n, "steps_per_sec": n / sum(d)}
