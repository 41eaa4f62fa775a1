"""Classifier-free guidance (counterpart of ``vista_tpu/diffusion/guidance.py``).

Every non-identity guider doubles the batch as ``[uncond; cond]`` and merges
``x_u + s_f * (x_c - x_u)`` with a per-frame scale vector ``s``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GuiderConfig:
    """kind: "identity" | "vanilla" | "linear" | "triangle"."""

    kind: str = "vanilla"
    scale: float = 2.5
    min_scale: float = 1.0
    num_frames: int = 25
    period: Union[float, Sequence[float]] = 1.0
    period_fusing: str = "max"


def _triangle_wave(values: np.ndarray, period: float) -> np.ndarray:
    return 2.0 * np.abs(values / period - np.floor(values / period + 0.5))


def guider_frame_scales(cfg: GuiderConfig) -> Optional[np.ndarray]:
    """Per-frame guidance scales, shape ``(num_frames,)``; None for identity."""
    t = cfg.num_frames
    if cfg.kind == "identity":
        return None
    if cfg.kind == "vanilla":
        return np.full((t,), cfg.scale, dtype=np.float32)
    if cfg.kind == "linear":
        return np.linspace(cfg.min_scale, cfg.scale, t, dtype=np.float32)
    if cfg.kind == "triangle":
        values = np.linspace(0.0, 1.0, t)
        periods = cfg.period if isinstance(cfg.period, (list, tuple)) else [cfg.period]
        waves = np.stack([_triangle_wave(values, p) for p in periods])
        if cfg.period_fusing == "mean":
            wave = waves.mean(0)
        elif cfg.period_fusing == "multiply":
            wave = waves.prod(0)
        elif cfg.period_fusing == "max":
            wave = waves.max(0)
        else:
            raise ValueError(f"unknown period_fusing {cfg.period_fusing!r}")
        return (wave * (cfg.scale - cfg.min_scale) + cfg.min_scale).astype(np.float32)
    raise ValueError(f"unknown guider kind {cfg.kind!r}")


def cfg_merge(denoised_pair: torch.Tensor,
              frame_scales: Optional[Union[np.ndarray, torch.Tensor]],
              num_frames: int) -> torch.Tensor:
    """Merge ``(2*b*t, ...)`` with the uncond half first (``frame_scales``
    on the host or, with no copy, on the pair's device)."""
    if frame_scales is None:
        return denoised_pair
    x_u, x_c = denoised_pair.chunk(2, dim=0)
    scale = torch.as_tensor(frame_scales, dtype=x_u.dtype, device=x_u.device)
    scale = scale.repeat(x_u.shape[0] // num_frames)
    scale = scale.reshape(-1, *([1] * (x_u.ndim - 1)))
    return x_u + scale * (x_c - x_u)
