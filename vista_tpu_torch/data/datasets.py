"""Host-side datasets: frame loading, crop and resize, action annotations
(counterpart of ``vista_tpu/data/datasets.py``, and of the parts of
``vista_tpu/cli/sample.py`` that read a dataset).

- ``BaseVideoDataset``: a JSON annotation list; each frame center-cropped
  to the target aspect, LANCZOS-resized and scaled to [-1, 1]; the
  conditioning scalars (motion_bucket_id 127, fps_id 9, cond_aug) beside
  the frames. JPEG clips go through the native library where it loads
  (``data/native.py``), everything else through PIL;
- ``YouTubeFramesDataset``: zero-padded numbered frame files per folder;
- ``NuScenesDataset``: action-annotated clips, one of four action
  modalities per sample by a cycling ``action_mod``, command balancing and
  oversampling of complete samples;
- ``SyntheticVideoDataset``: deterministic random clips;
- ``load_image``, ``load_anno_frames`` and ``anno_actions``: what the
  sample and reward CLIs read.

Outputs are numpy, NHWC; the runner moves batches to the card. PIL is
imported by the functions that open images.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Sequence

import numpy as np

ACTION_MODES = ("free", "traj", "cmd", "steer", "goal")


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    anno_file: str = ""
    data_root: str = ""
    height: int = 320
    width: int = 576
    num_frames: int = 25
    fps_id: float = 9.0
    motion_bucket_id: float = 127.0
    cond_aug: float = 0.0



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


class BaseVideoDataset:
    """JSON-annotated frame-sequence dataset."""

    def __init__(self, cfg: DatasetConfig):
        self.cfg = cfg
        self.annos: List[Dict] = []
        if cfg.anno_file and os.path.exists(cfg.anno_file):
            with open(cfg.anno_file) as f:
                self.annos = json.load(f)

    def __len__(self) -> int:
        return len(self.annos)

    def frame_paths(self, anno: Dict) -> List[str]:
        raise NotImplementedError

    def action_dict(self, anno: Dict, index: int) -> Dict[str, np.ndarray]:
        return {}

    def _load_frames(self, paths: List[str]) -> np.ndarray:
        cfg = self.cfg
        if all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
            from vista_tpu_torch.data import native

            if native.available():
                return native.load_frame_batch(paths, cfg.height, cfg.width)
        return np.stack([load_image(p, cfg.height, cfg.width) for p in paths])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        anno = self.annos[index % max(len(self.annos), 1)]
        out = {
            "frames": self._load_frames(self.frame_paths(anno)[: cfg.num_frames]),
            "fps_id": np.float32(cfg.fps_id),
            "motion_bucket_id": np.float32(cfg.motion_bucket_id),
            "cond_aug": np.float32(cfg.cond_aug),
        }
        out.update(self.action_dict(anno, index))
        return out


class YouTubeFramesDataset(BaseVideoDataset):
    """OpenDV-style: frames as zero-padded numbered images in per-video
    folders; an annotation names the folder and its first frame."""

    def __init__(self, cfg: DatasetConfig, pad_width: int = 9, ext: str = ".jpg"):
        super().__init__(cfg)
        self.pad_width = pad_width
        self.ext = ext

    def frame_paths(self, anno: Dict) -> List[str]:
        folder = os.path.join(self.cfg.data_root, anno["folder"])
        first = int(anno["first_frame"])
        return [os.path.join(folder, str(first + i).zfill(self.pad_width) + self.ext)
                for i in range(self.cfg.num_frames)]


# nuScenes command ids that are not oversampled; every other one is rare
_COMMAND_EXCEPTIONS = (2, 3)


def _goal_valid(anno: Dict) -> bool:
    """A usable goal point: z > 0 and the pixel strictly inside the 1600x900
    camera frame."""
    goal = anno.get("goal") or (0, 0)
    return anno.get("z", 0) > 0 and 0 < goal[0] < 1600 and 0 < goal[1] < 900


def balance_with_actions(annos: List[Dict], increase_factor: int = 5,
                         exceptions: Sequence[int] = _COMMAND_EXCEPTIONS) -> List[Dict]:
    """Every sample whose command is not in ``exceptions`` ``increase_factor``
    times: the originals first, then the extra copies."""
    extra = [a for a in annos if a.get("cmd") not in exceptions
             for _ in range(increase_factor - 1)]
    return annos + extra


def resample_complete_samples(annos: List[Dict], increase_factor: int = 2) -> List[Dict]:
    """Samples with a non-empty speed and angle and a valid goal point
    ``increase_factor`` times."""
    extra = [a for a in annos
             if a.get("speed") and a.get("angle") and _goal_valid(a)
             for _ in range(increase_factor - 1)]
    return annos + extra


class NuScenesDataset(BaseVideoDataset):
    """Action-annotated nuScenes clips. Each ``__getitem__`` emits one of four
    action sets; the modality counter first advances by the sample index,
    ``action_mod = (action_mod + index) % 4``, then picks:

    0: trajectory ``traj[2:10]``; 1: command; 2: speed ``speed[1:5]`` and
    angle ``angle[1:5] / 780``, each when non-empty; 3: goal ``goal / (1600,
    900)`` only when the point is valid (else nothing: the conditioner
    zero-fills).
    """

    def __init__(self, cfg: DatasetConfig, balance: bool = True,
                 oversample_complete: bool = True):
        super().__init__(cfg)
        if balance and self.annos:
            self.annos = balance_with_actions(self.annos, increase_factor=5)
        if oversample_complete and self.annos:
            self.annos = resample_complete_samples(self.annos, increase_factor=2)
        self._action_mod = 0

    def frame_paths(self, anno: Dict) -> List[str]:
        return [os.path.join(self.cfg.data_root, p) for p in anno["frames"]]

    def action_dict(self, anno: Dict, index: int) -> Dict[str, np.ndarray]:
        self._action_mod = (self._action_mod + index) % 4
        mod = self._action_mod
        out: Dict[str, np.ndarray] = {}
        if mod == 0 and "traj" in anno:
            out["trajectory"] = np.asarray(anno["traj"][2:10], np.float32)
        elif mod == 1 and "cmd" in anno:
            out["command"] = np.asarray([anno["cmd"]], np.float32)
        elif mod == 2:
            if anno.get("speed"):
                out["speed"] = np.asarray(anno["speed"][1:5], np.float32)
            if anno.get("angle"):
                out["angle"] = np.asarray(anno["angle"][1:5], np.float32) / 780.0
        elif mod == 3 and _goal_valid(anno):
            out["goal"] = np.asarray(
                [anno["goal"][0] / 1600.0, anno["goal"][1] / 900.0], np.float32)
        return out


class SyntheticVideoDataset(BaseVideoDataset):
    """Deterministic random clips: sample ``index`` draws from
    ``np.random.RandomState(index)``."""

    def __init__(self, cfg: DatasetConfig, length: int = 64, with_actions: bool = False):
        self.cfg = cfg
        self.length = length
        self.with_actions = with_actions
        self.annos = [{} for _ in range(length)]

    def __len__(self):
        return self.length

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.RandomState(index)
        out = {
            "frames": rng.randn(cfg.num_frames, cfg.height, cfg.width, 3).astype(np.float32) * 0.3,
            "fps_id": np.float32(cfg.fps_id),
            "motion_bucket_id": np.float32(cfg.motion_bucket_id),
            "cond_aug": np.float32(cfg.cond_aug),
        }
        if self.with_actions:
            out["trajectory"] = rng.randn(8).astype(np.float32)
        return out
