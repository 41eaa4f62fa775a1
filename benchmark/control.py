"""Readings that set a cell's limits: the system's comparison with the
reference over many seeds, and the control's over a few, in one process.

    python -m benchmark.control --workload <cell> --seeds S1 S2 ... \
        [--control-seeds C1 C2 ...] [--fault NAME] [--out chiprun_out/control_<cell>.json]

Each seed runs the cell's timed path once at the cell's own size (one
request, or the set-up's checked optimizer steps) and the check that a run
makes. On a control seed the reference computed from fp8 operands (the step
below the bf16 the configurations state) also stands in the system's place
and is read and judged the same way (``harness.judge`` against the
cell's limits: the control has to come out not correct). The lower reading of a number is the largest the
system gives, the upper the smallest the control gives. With ``--fault``
the system runs with that fault of ``benchmark/faults.py`` planted, and its
readings are the fault's. Not a test: it runs on the card only.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import faults, harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default=None, choices=faults.SAMPLING + faults.TRAINING)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    _, cfg, traffic, limits = harness.cell_files(spec, args.workload)
    driver = importlib.import_module(f"benchmark.{traffic['driver']}")
    device = torch.device("cuda", 0)
    rows = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            got = driver.survey(cfg, traffic, limits, seed, seed in args.control_seeds, device)
        got["seed"], got["seconds"] = seed, time.perf_counter() - t0
        print(json.dumps(got), flush=True)
        rows.append(got)
    names = [n for n in limits]
    summary = {"card": torch.cuda.get_device_name(device), "workload": args.workload,
               "fault": args.fault,
               "system_correct": [r["system_correct"] for r in rows],
               "control_correct": [r["control_correct"] for r in rows if "control" in r],
               "lower": {n: max(r["system"][n] for r in rows) for n in names},
               "upper": {n: min((r["control"][n] for r in rows if "control" in r), default=None)
                         for n in names},
               "rows": rows}
    print(json.dumps({k: summary[k] for k in ("card", "workload", "fault", "system_correct",
                                                  "control_correct", "lower", "upper")}),
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
