"""Noise-level schedules (counterpart of ``vista_tpu/diffusion/discretization.py``).

The Karras rho schedule and the legacy scaled-linear DDPM one, computed
with numpy, returned as descending float32 CPU tensors with a
trailing 0.
"""

from __future__ import annotations

import numpy as np
import torch


def edm_sigmas(n: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
               rho: float = 7.0, append_zero: bool = True) -> torch.Tensor:
    """Karras et al. rho-spaced sigmas, descending from sigma_max to sigma_min."""
    ramp = np.linspace(0.0, 1.0, n)
    min_inv_rho = sigma_min ** (1.0 / rho)
    max_inv_rho = sigma_max ** (1.0 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    if append_zero:
        sigmas = np.concatenate([sigmas, [0.0]])
    return torch.from_numpy(sigmas.astype(np.float32))


def _scaled_linear_alphas_cumprod(num_timesteps: int, linear_start: float,
                                  linear_end: float) -> np.ndarray:
    betas = np.linspace(linear_start**0.5, linear_end**0.5, num_timesteps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas, axis=0)


def legacy_ddpm_sigmas(n: int, linear_start: float = 0.00085, linear_end: float = 0.0120,
                       num_timesteps: int = 1000, append_zero: bool = True) -> torch.Tensor:
    """Sigmas of the scaled-linear beta schedule, descending; for ``n <
    num_timesteps`` at roughly equally spaced integer timesteps."""
    alphas_cumprod = _scaled_linear_alphas_cumprod(num_timesteps, linear_start, linear_end)
    if n < num_timesteps:
        timesteps = np.linspace(num_timesteps - 1, 0, n, endpoint=False, dtype=int)[::-1]
        alphas_cumprod = alphas_cumprod[timesteps]
    elif n != num_timesteps:
        raise ValueError(f"n={n} exceeds num_timesteps={num_timesteps}")
    sigmas = (((1.0 - alphas_cumprod) / alphas_cumprod) ** 0.5)[::-1]
    if append_zero:
        sigmas = np.concatenate([sigmas, [0.0]])
    return torch.from_numpy(sigmas.astype(np.float32))
