"""Noise-level schedules (counterpart of ``vista_tpu/diffusion/discretization.py``).

Computed with numpy, returned as descending float32 CPU tensors with a
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
