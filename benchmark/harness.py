"""What every cell shares: the files found by the names in
``BENCHMARK.json``, the engine built from a configuration file, seeds,
timing, the per-layer metric readers and the result line.

Layout under ``benchmark/``: ``configs/<config>.json`` (a configuration:
its source, sizes, ``reduced`` and ``assumed``), ``traffic/<mix>.json``
(a traffic mix: the parameters its ``driver`` reads), ``limits/<cell>.json``
(the limits of the cell's comparisons with the reference) and
``metrics/<metric>.py`` or, shared by a family of metrics, ``<stem>.py``
(a per-layer metric's reader: ``read(record)`` returns its value, or None
where it finds nothing to read). A later cell, mix or metric
is new files and entries, with no edit to a file here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vista_tpu")  # top-level module names, compared whole


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(spec: dict, cell: str, here: Path = HERE):
    """``(workload entry, configuration, traffic, limits)`` of a cell."""
    work = {w["name"]: w for w in spec["workloads"]}
    if cell not in work:
        raise SystemExit(f"unknown workload {cell!r}; one of {sorted(work)}")
    w = work[cell]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = json.loads((here.parent / conf["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{cell}.json").read_text())
    return w, cfg, traffic, limits


def metric_readers(spec: dict, cell: str, here: Path = HERE) -> Dict[str, tuple]:
    """``{name: (read, unit)}`` of the per-layer metrics whose ``workloads``
    list this cell. A metric's reader is ``metrics/<name>.py``, or where
    there is none the reader its family shares, ``metrics/<stem>.py`` of
    the name's part before the first dot (``glue_share.py`` for
    ``glue_share.sample`` and ``glue_share.train``)."""
    out = {}
    for m in spec["per_layer"]:
        if cell not in m.get("workloads", ()):
            continue
        path = here / "metrics" / f"{m['name']}.py"
        if not path.exists():
            path = here / "metrics" / f"{m['name'].split('.')[0]}.py"
        mod_spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + path.stem.replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        out[m["name"]] = (module.read, m["unit"])
    return out


def e2e_metrics(spec: dict, cell: str):
    return [m for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's seed (weights, a request's
    inputs, the check's draws), any whole ``seed`` accepted."""
    return int(np.random.SeedSequence([seed, *tags]).generate_state(2, np.uint64)[0] >> 1)


def replace(obj, values: dict):
    """A frozen dataclass with ``values`` put in, nested dataclasses too
    (lists become tuples, as the configs hold them)."""
    changes = {}
    for k, v in values.items():
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            changes[k] = replace(cur, v)
        elif isinstance(v, list):
            changes[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        else:
            changes[k] = v
    return dataclasses.replace(obj, **changes)


def engine_config(cfg: dict):
    from vista_tpu_torch.engine.engine import EngineConfig

    return replace(EngineConfig(), cfg["engine"])


def engine_layout(engine) -> dict:
    from benchmark import weights

    return weights.layout(components(engine))


def components(engine) -> dict:
    return {"unet": engine.unet, "decoder": engine.decoder, "encoder": engine.encoder,
            "conditioner": engine.conditioner}


def process_age() -> float:
    """Seconds since this process started (Linux; the import of this module
    otherwise)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        import os

        boot_age = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, boot_age - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def window(seconds: float, unit: Callable[[int], int], clock=time.perf_counter):
    """Run ``unit(i)`` back to back from ``i = 0``; a new one starts only
    while the time left is at least the last one's length. Returns
    ``(wall, units, counted)``: the wall from the first start to the last
    end and the sum of what each unit returned."""
    t0 = clock()
    i, total, last = 0, 0, 0.0
    while True:
        s = clock()
        total += unit(i)
        e = clock()
        i, last = i + 1, e - s
        if seconds - (e - t0) < last:
            return e - t0, i, total


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def per_layer(readers: Dict[str, tuple], record: dict) -> dict:
    """The per-layer metrics that found something to read, as the result
    line carries them."""
    out = {}
    for name, (read, unit) in readers.items():
        value = read(record)
        if value is not None:
            out[name] = {"value": float(value), "unit": unit}
    return out


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among loaded modules (``names``:
    these instead of ``sys.modules``)."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def emit(result: dict, checks: Dict[str, tuple]) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result line on standard output, ``checks`` last."""
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr, flush=True)
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """``(correct, checks)``: every reading at most its limit (a reading that
    is not a number fails)."""
    checks = {n: (float(readings[n]), float(limits[n])) for n in limits}
    ok = all(np.isfinite(v) and v <= lim for v, lim in checks.values())
    return bool(ok), checks


def rel(a, b) -> float:
    """``|a - b|_2 / |b|_2`` in fp64 (0 where both are 0, inf where only b is)."""
    import torch

    a, b = a.double(), b.double().to(a.device)
    num, den = float(torch.linalg.vector_norm(a - b)), float(torch.linalg.vector_norm(b))
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def result(out: dict, device, rate: dict) -> dict:
    """The result line of a run from what ``measure`` returned: the traced
    run's per-layer metrics and device times, or ``rate`` (the cell's own
    end-to-end metric) with the peak memory and the set-up."""
    line = {"attempted": out["attempted"], "failed": 0, "device": device_info(device, out["peak"])}
    if "per_layer" in out:
        line["metrics"] = out["per_layer"]
        line["device"].update(busy_s=out["busy_s"], window_s=out["window_s"])
        line["breakdown"] = out["breakdown"]
    else:
        line["metrics"] = {**rate,
                           "peak_mem_gib": {"value": out["peak"] / 2 ** 30, "unit": "GiB"},
                           "setup_s": {"value": out["setup_s"], "unit": "s"}}
    return line


def device_info(device, peak: Optional[int]) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak)}
