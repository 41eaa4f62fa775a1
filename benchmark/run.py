"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and limits are found by the names in
``BENCHMARK.json``; the traffic's ``driver`` (a module of this package)
builds the system under test (``vista_tpu_torch``) on the card, makes its
weights and inputs from the seed, warms up the cell's shapes, runs the
window (``--trace 1``: the traffic's ``trace_units`` under the profiler,
for the per-layer metrics), then checks what the timed path produced
against the plain reference. The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error. Without a card the run fails: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import importlib
import sys

from benchmark import harness


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(spec: dict, cell: str, seed: int, seconds: float, traced: bool, device):
    """``(result, checks)`` of one run of ``cell`` on ``device``."""
    _, cfg, traffic, limits = harness.cell_files(spec, cell)
    readers = harness.metric_readers(spec, cell) if traced else {}
    driver = importlib.import_module(f"benchmark.{traffic['driver']}")
    return driver.run(cfg, traffic, limits, seed, seconds, traced, device, readers)


def main(argv=None) -> int:
    args = parse(argv)
    spec = harness.load_spec()
    work, _, _, _ = harness.cell_files(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"the cell needs {work['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, checks = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
