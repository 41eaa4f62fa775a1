"""Training-time sigma sampling (counterpart of
``vista_tpu/diffusion/sigma_sampling.py``): one lognormal sigma per video,
repeated over its frames. The standard-normal draw is an argument, so
tests can hand both packages the same numbers."""

from __future__ import annotations

import torch


def edm_sigmas(normal: torch.Tensor, num_frames: int, p_mean: float = 1.0,
               p_std: float = 1.6) -> torch.Tensor:
    """``exp(p_mean + p_std * normal)`` per video ``(n,)`` -> ``(n * num_frames,)``."""
    return torch.exp(p_mean + p_std * normal.float()).repeat_interleave(num_frames)
