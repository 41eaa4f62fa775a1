"""Spans, the one way to the host, and step timing (counterpart of
``vista_tpu/utils/profiling.py``):

- ``span(name)``: a named phase of the program, on exactly while a torch
  profiler is recording (in any thread: the profiler's flag is the
  process's). Off, it costs that one check: it opens nothing,
  stores nothing and never touches the device. On, it stores a
  :class:`Span` (``name``, ``start_ns`` / ``end_ns`` from
  ``time.time_ns()``, the clock of the profiler's host events; ``parent``,
  the ``index`` of the span open on the same thread when it opened;
  ``request``, the id of the root it descends from: a span opened with
  nothing open takes the next id) in a bounded store, and opens a
  ``RecordFunction`` of the same name, so an export shows the program's
  spans beside the kernels (those of the threads the profiler follows). The
  twin is a host-side op (``torch._C._profiler._RecordFunctionFast``, the
  function scope): a ``torch.profiler.record_function`` is a user
  annotation, which the trace also copies onto the device's row, where it
  would read as device work. No span synchronises the device.
- ``spans()`` / ``clear()``: the stored spans, oldest first; empty the store.
- ``host_sync(tensor)``: ``float(tensor)`` inside a ``host_sync`` span, the
  program's one way to bring a device scalar to the host (it waits for the
  device), so a traced run counts every such wait.
- ``StepTimer``: host-clock step durations, fenced with
  ``torch.cuda.synchronize()`` when a step hands over its result and a card
  is present;
  ``report()`` gives the JAX version's keys (steps, p50_s, p90_s, mean_s,
  steps_per_sec).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Deque, List, Optional

import torch
import torch.autograd.profiler as _profiler

STORE_SIZE = 2 ** 20  # spans kept: a profiler left recording drops the oldest

_store: Deque["Span"] = collections.deque(maxlen=STORE_SIZE)
_indices = itertools.count()  # every stored span's index
_requests = itertools.count()  # every root's request id
_local = threading.local()  # each thread's stack of open spans
_OFF = contextlib.nullcontext()


@dataclasses.dataclass(slots=True)
class Span:
    """One stored span; ``end_ns`` is None while it is open."""

    name: str
    index: int
    parent: Optional[int]
    request: int
    start_ns: int = 0
    end_ns: Optional[int] = None


class _Open:
    """An open span: stamped inside its ``RecordFunction`` twin."""

    __slots__ = ("span", "stack", "twin")

    def __init__(self, name: str):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.stack = stack
        self.span = Span(name, next(_indices), None if up is None else up.index,
                         next(_requests) if up is None else up.request)
        self.twin = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self):
        self.twin.__enter__()
        self.stack.append(self.span)
        _store.append(self.span)
        self.span.start_ns = time.time_ns()
        return self.span

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        self.stack.pop()
        return self.twin.__exit__(*exc)


def span(name: str):
    """``with span(name): ...``: a span while a profiler records, else nothing."""
    return _Open(name) if _profiler._is_profiler_enabled else _OFF


def spans() -> List[Span]:
    return list(_store)


def clear() -> None:
    _store.clear()


def host_sync(tensor: torch.Tensor) -> float:
    """``float(tensor)`` of a one-element tensor, inside a ``host_sync`` span."""
    with span("host_sync"):
        return float(tensor)


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
