"""Tiny configurations for the CPU tests: the system's own tiny engine in
fp32, at the full configurations' switches, on 32x32 frames."""

import dataclasses
import json

from benchmark import harness

SAMPLE, TRAIN, ROLLOUT = (w["name"] for w in harness.load_spec()["workloads"])


def config(cell: str) -> dict:
    from vista_tpu_torch.engine.engine import EngineConfig

    spec = harness.load_spec()
    _, full, _, _ = harness.cell_files(spec, cell)
    e = EngineConfig().tiny()
    d = json.loads(json.dumps(dataclasses.asdict(e)))
    fe = full["engine"]
    d["unet"].update(action_control=fe["unet"]["action_control"], remat=fe["unet"]["remat"],
                     dtype="float32")
    d["vae"]["dtype"] = "float32"
    c = d["conditioner"]
    c.update(action_control=fe["conditioner"]["action_control"],
             ucg_rate=fe["conditioner"]["ucg_rate"])
    c["clip"]["dtype"] = c["vae"]["dtype"] = "float32"
    out = {"height": 32, "width": 32, "engine": d}
    if "train" in full:
        tr = dict(full["train"])
        tr["loss"] = dict(tr["loss"], num_frames=e.num_frames)
        out["train"] = tr
    return out


def traffic(cell: str) -> dict:
    _, _, t, _ = harness.cell_files(harness.load_spec(), cell)
    if t["driver"] == "rollout":  # 4 frames: 2 re-pinned leave 2 free, one of them guided
        t = dict(t, steps=3, n_context=min(t["n_context"], 2))
    return t


def limits(cell: str) -> dict:
    return harness.cell_files(harness.load_spec(), cell)[3]
