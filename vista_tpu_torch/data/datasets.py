"""What the CLIs read from a dataset (counterpart of the parts of
``vista_tpu/data/datasets.py`` and ``vista_tpu/cli/sample.py`` they use):
frames center-cropped and resized as the reference's datasets do, and an
annotation's action for the chosen mode. numpy only; PIL is imported by the
functions that open images.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np

ACTION_MODES = ("free", "traj", "cmd", "steer", "goal")


def center_crop_resize(img, target_h: int, target_w: int) -> np.ndarray:
    """Center-crop to the target aspect, then LANCZOS-resize; ``(h, w, 3)``
    float32 in [-1, 1]."""
    from PIL import Image

    if not isinstance(img, Image.Image):
        img = Image.fromarray(np.asarray(img))
    w, h = img.size
    target_aspect = target_w / target_h
    aspect = w / h
    if aspect > target_aspect:  # too wide: crop width
        new_w = int(round(h * target_aspect))
        x0 = (w - new_w) // 2
        img = img.crop((x0, 0, x0 + new_w, h))
    elif aspect < target_aspect:  # too tall: crop height
        new_h = int(round(w / target_aspect))
        y0 = (h - new_h) // 2
        img = img.crop((0, y0, w, y0 + new_h))
    img = img.resize((target_w, target_h), Image.LANCZOS)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    return arr[..., :3] * 2.0 - 1.0


def load_image(path: str, height: int, width: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return center_crop_resize(img.convert("RGB"), height, width)


def load_anno_frames(anno: Mapping, data_root: str, n_frames: int, height: int,
                     width: int) -> np.ndarray:
    """The first ``n_frames`` of an annotation's ``frames`` -> ``(n, h, w, 3)``."""
    return np.stack([load_image(os.path.join(data_root, rel), height, width)
                     for rel in anno["frames"][:n_frames]])


def anno_actions(anno: Mapping, action: str) -> Dict[str, np.ndarray]:
    """The conditioning of one action mode from an annotation, each ``(1, d)``
    float32: ``traj`` -> trajectory ``traj[2:10]``; ``cmd`` -> command;
    ``steer`` -> speed ``speed[1:5]`` and angle ``angle[1:5] / 780``; ``goal``
    -> goal ``goal / (1600, 900)``. Empty for ``free`` or when the
    annotation lacks the field. The ``goal`` mode tests for a ``"z"`` key, as
    the JAX package's sampler does."""
    if action not in ACTION_MODES:
        raise ValueError(f"unknown action mode {action!r}")
    row = lambda v: np.asarray(v, np.float32)[None]
    if action == "traj" and "traj" in anno:
        return {"trajectory": row(anno["traj"][2:10])}
    if action == "cmd" and "cmd" in anno:
        return {"command": row([float(anno["cmd"])])}
    if action == "steer" and "speed" in anno:
        return {"speed": row(anno["speed"][1:5]), "angle": row(anno["angle"][1:5]) / 780.0}
    if action == "goal" and "z" in anno:
        return {"goal": row([anno["goal"][0] / 1600.0, anno["goal"][1] / 900.0])}
    return {}
