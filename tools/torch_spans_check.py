"""The port's spans against the profiler's trace, in the benchmark's cells,
on the card:

    python3 tools/torch_spans_check.py [--seed N] [--cells train sample rollout] [--out FILE]

- ``cost``: microseconds a span costs on this host with no profiler
  recording and with one (CPU and CUDA activities), beside a bare
  ``record_function`` with none;
- ``syncs``: one optimizer step of the training cell (after one to warm up)
  and one request of each sampling cell under
  ``torch.cuda.set_sync_debug_mode("warn")``: the warnings by call site,
  beside the ``host_sync`` spans of the same work under the profiler;
- ``traced``: each cell's traced run as ``python -m benchmark.run --trace 1``
  makes it (``benchmark/train.py`` / ``rollout.py`` ``measure``, no check
  against the reference), and from its record: the window's idle split by
  the program's spans (the phases, the root's own time, outside every
  root; the parts must add up to the window's idle), each phase's device
  time by group, and each span against its ``record_function`` twin in the
  profiler's host events.

``--tiny --device cpu`` runs it on the benchmark's tiny configurations on
the CPU (no device operation: every instant is idle), to rehearse. Prints a
JSON line a cell; ``--out`` also writes the whole report there.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark import harness, program, rollout, trace, train  # noqa: E402
from vista_tpu_torch.utils import profiling  # noqa: E402

CELLS = {"train": "train-phase1-576x1024", "sample": "sample-576x1024-1x25",
         "rollout": "rollout-576x1024-2x10"}
PHASES = {"train": ("train.forward", "train.backward", "train.apply"),
          "sample": ("encode", "condition", "sample", "decode")}
ROOTS = {"train": "train.step", "sample": "rollout"}
SUBPHASES = ("apply.norm", "apply.accumulate", "apply.update", "apply.ema", "host_sync",
             "condition.clip", "condition.encode", "sampler.step", "decode.window")


def files(cell: str, tiny: bool):
    spec = harness.load_spec()
    if tiny:
        from benchmark.tests import tiny as t

        return t.config(cell), t.traffic(cell), t.limits(cell)
    _, cfg, traffic, limits = harness.cell_files(spec, cell)
    return cfg, traffic, limits


def span_cost(device) -> dict:
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])

    def per_call(fn, n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e6 * (time.perf_counter() - t0) / n

    def bare():
        pass

    def one_span():
        with profiling.span("cost"):
            pass

    def one_rf():
        with torch.profiler.record_function("cost"):
            pass

    out = {"loop_us": per_call(bare, 200000), "span_off_us": per_call(one_span, 200000),
           "record_function_off_us": per_call(one_rf, 50000)}
    with profile(activities=acts):
        out["span_on_us"] = per_call(one_span, 20000)
    profiling.clear()
    return out


def sync_sites(fn) -> collections.Counter:
    """The synchronising calls ``fn`` makes, by call site: the innermost
    frame of this repository and the one it called."""
    if not torch.cuda.is_available():
        return collections.Counter()
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        mine = [i for i, f in enumerate(stack) if f.filename.startswith(str(ROOT))
                and not f.filename.endswith("torch_spans_check.py")]
        if not mine:
            sites[f"{filename}:{lineno}"] += 1
            return
        f = stack[mine[-1]]
        callee = stack[mine[-1] + 1] if mine[-1] + 1 < len(stack) else None
        where = f"{Path(f.filename).relative_to(ROOT)}:{f.lineno}"
        sites[where + (f" -> {Path(callee.filename).name}:{callee.lineno}" if callee else "")] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def host_syncs(fn, device) -> int:
    profiling.clear()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts):
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    n = sum(1 for s in profiling.spans() if s.name == "host_sync")
    profiling.clear()
    return n


def train_syncs(cfg, seed, device) -> dict:
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.engine.training import Trainer

    from benchmark import weights

    engine = VistaEngine(harness.engine_config(cfg), device)
    weights.fill_(harness.components(engine), harness.sub_seed(seed, 0))
    trainer = Trainer(engine, train.train_config(cfg))
    micro = iter(range(10 ** 6))

    def step():
        for _ in range(trainer.cfg.accum_steps):
            batch, d = train.micro_batch(device, cfg, harness.sub_seed(seed, 1, next(micro)))
            trainer(batch, train.system_draws(d))

    step()  # warm-up
    sites = sync_sites(step)
    out = {"warnings": sum(sites.values()), "sites": dict(sites),
           "host_sync_spans": host_syncs(step, device)}
    del engine, trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def sample_syncs(cfg, traffic, seed, device) -> dict:
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.engine.rollout import autoregressive_rollout

    from benchmark import weights

    engine = VistaEngine(harness.engine_config(cfg), device)
    weights.fill_(harness.components(engine), harness.sub_seed(seed, 0))

    def request(steps=traffic["steps"]):
        images, batch, draws = rollout.inputs(device, cfg, traffic, harness.sub_seed(seed, 1, 0))
        sampler, roll = rollout.configs(cfg, traffic, steps)
        autoregressive_rollout(engine, images, batch, sampler, roll, draws)

    request(1)  # warm-up
    sites = sync_sites(request)
    out = {"warnings": sum(sites.values()), "sites": dict(sites),
           "host_sync_spans": host_syncs(request, device), "steps": traffic["steps"]}
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


class Kept:
    """Keeps the record the cell's loop hands to the readers, and the profiler."""

    def __init__(self):
        self.record, self.prof = None, None

    def __enter__(self):
        self.per_layer, self.profile = harness.per_layer, torch.profiler.profile
        kept = self

        class Profile(self.profile):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                kept.prof = self

        def per_layer(readers, record):
            kept.record = record
            return self.per_layer(readers, record)

        harness.per_layer, torch.profiler.profile = per_layer, Profile
        return self

    def __exit__(self, *exc):
        harness.per_layer, torch.profiler.profile = self.per_layer, self.profile


def twins(prof, spans) -> dict:
    """The largest gaps (ms) between each span's start and end and its
    ``record_function`` twin's, matched by name in order."""
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            events[e.name()].append((e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9))
    mine = collections.defaultdict(list)
    for name, s, e, *_ in spans:
        mine[name].append((s, e))
    worst_start = worst_end = 0.0
    unmatched = 0
    for name, ours in mine.items():
        theirs = sorted(events[name])
        unmatched += abs(len(theirs) - len(ours))
        for (s, e), (ts, te) in zip(sorted(ours), theirs):
            worst_start, worst_end = max(worst_start, abs(s - ts)), max(worst_end, abs(e - te))
    return {"spans": sum(len(v) for v in mine.values()), "unmatched": unmatched,
            "start_ms": 1e3 * worst_start, "end_ms": 1e3 * worst_end}


def split(rec: dict, kind: str) -> dict:
    """The window's idle by the program's spans, and device time by group
    inside each phase."""
    units = rec["units"]
    window = trace.window_s(rec)
    idle = program.length(program.idle(rec))
    root = ROOTS[kind]
    out = {"units": units, "window_s": window, "idle_s": idle,
           "idle_share_x_window_s": window - trace.busy_s(rec),
           "outside_roots_s": program.idle_outside(rec, (root,)),
           "phases": {}, "subphases": {}}
    phases = 0.0
    for p in PHASES[kind]:
        got = {"idle_s": program.idle_in(rec, (p,)), "busy_s": program.busy_in(rec, (p,))}
        phases += got["idle_s"] or 0.0
        ops = program.launched_in(rec, (p,)) or []
        got["groups_s"] = dict(sorted(trace.groups(ops).items(), key=lambda kv: -kv[1])[:8])
        out["phases"][p] = got
    for p in SUBPHASES:
        i, b = program.idle_in(rec, (p,)), program.busy_in(rec, (p,))
        if i is not None:
            out["subphases"][p] = {"idle_s": i, "busy_s": b,
                                   "count": program.count(rec, p)}
    inside_root = program.idle_in(rec, (root,)) or 0.0
    out["root_own_s"] = inside_root - phases
    out["sum_s"] = phases + out["root_own_s"] + (out["outside_roots_s"] or 0.0)
    out["gap_of_window"] = abs(phases + (out["outside_roots_s"] or 0.0) - idle) / window
    return out


def traced(cell, kind, seed, device) -> dict:
    cfg, traffic, limits = files(cell, ARGS.tiny)
    readers = harness.metric_readers(harness.load_spec(), cell)
    loop = train if kind == "train" else rollout
    profiling.clear()
    with Kept() as kept:
        out, *_ = loop.measure(cfg, traffic, seed, 0.0, True, device, readers)
    rec = kept.record
    result = {"per_layer": out["per_layer"], "breakdown": out["breakdown"],
              "split": split(rec, "train" if kind == "train" else "sample"),
              "twins": twins(kept.prof, program.spans(rec))}
    profiling.clear()
    return result


def main(argv=None) -> int:
    global ARGS
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=3300000241)
    p.add_argument("--cells", nargs="+", default=["train", "sample", "rollout"])
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", type=Path)
    ARGS = p.parse_args(argv)
    device = torch.device(ARGS.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    report = {"device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
              "torch": torch.__version__, "cost": span_cost(device)}
    print(json.dumps(report["cost"]), flush=True)
    for name in ARGS.cells:
        cell = CELLS[name]
        cfg, traffic, _ = files(cell, ARGS.tiny)
        t0 = time.perf_counter()
        syncs = (train_syncs(cfg, ARGS.seed, device) if name == "train"
                 else sample_syncs(cfg, traffic, ARGS.seed, device))
        got = traced(cell, name, ARGS.seed, device)
        report[name] = {"syncs": syncs, **got, "seconds": time.perf_counter() - t0}
        print(name, json.dumps(report[name]), flush=True)
    if ARGS.out:
        ARGS.out.parent.mkdir(parents=True, exist_ok=True)
        ARGS.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
