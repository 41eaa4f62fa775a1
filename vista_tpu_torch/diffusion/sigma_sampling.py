"""Training-time sigma sampling (counterpart of
``vista_tpu/diffusion/sigma_sampling.py``): one sigma per video, lognormal
or from a discrete table, repeated over its frames. The draws (the standard
normals, the table's indices) are arguments, so tests can hand both
packages the same numbers."""

from __future__ import annotations

import torch


def edm_sigmas(normal: torch.Tensor, num_frames: int, p_mean: float = 1.0,
               p_std: float = 1.6) -> torch.Tensor:
    """``exp(p_mean + p_std * normal)`` per video ``(n,)`` -> ``(n * num_frames,)``."""
    return torch.exp(p_mean + p_std * normal.float()).repeat_interleave(num_frames)


def discrete_sigmas(index: torch.Tensor, sigma_table: torch.Tensor,
                    num_frames: int) -> torch.Tensor:
    """``sigma_table[index]`` per video ``(n,)`` -> ``(n * num_frames,)``; the
    indices are drawn uniformly over the table by the caller."""
    return sigma_table[index].repeat_interleave(num_frames)
