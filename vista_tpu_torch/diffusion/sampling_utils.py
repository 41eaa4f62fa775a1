"""Small sampling helpers (counterpart of ``vista_tpu/diffusion/sampling_utils.py``):
the ODE derivative, CFG with std-rescale, the ancestral step split, the
linear-multistep coefficient and the log-sigma maps."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _bcast(sigma: torch.Tensor, ndim: int) -> torch.Tensor:
    return sigma.reshape(*sigma.shape, *([1] * (ndim - sigma.ndim)))


def to_d(x: torch.Tensor, sigma: torch.Tensor, denoised: torch.Tensor) -> torch.Tensor:
    """The probability-flow ODE's derivative ``(x - denoised) / sigma``."""
    return (x - denoised) / _bcast(sigma, x.ndim)


def apply_cfg_with_rescale(pos: torch.Tensor, neg: torch.Tensor, scale: float,
                           rescale: float = 0.7) -> torch.Tensor:
    """CFG whose output std (per sample, population) is pulled toward the
    conditional branch's by ``rescale``."""
    cfg = neg + scale * (pos - neg)
    dims = tuple(range(1, pos.ndim))
    std_pos = pos.std(dim=dims, keepdim=True, correction=0)
    std_cfg = cfg.std(dim=dims, keepdim=True, correction=0)
    return cfg * (rescale * (std_pos / std_cfg) + (1.0 - rescale))


def get_ancestral_step(sigma_from: torch.Tensor, sigma_to: torch.Tensor,
                       eta: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sigma_down, sigma_up)`` of an ancestral (SDE) step."""
    if not eta:
        return sigma_to, torch.zeros_like(sigma_to)
    sigma_up = torch.minimum(
        sigma_to,
        eta * torch.sqrt(sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2))
    return torch.sqrt(sigma_to**2 - sigma_up**2), sigma_up


def linear_multistep_coeff(order: int, t: Sequence[float], i: int, j: int,
                           n_quad: int = 257) -> float:
    """The LMS coefficient: the Lagrange basis product integrated over
    ``[t[i], t[i+1]]`` by Simpson's rule on ``n_quad`` (odd) samples."""
    t = [float(v) for v in t]

    def fn(tau):
        prod = 1.0
        for k in range(order):
            if j == k:
                continue
            prod *= (tau - t[i - k]) / (t[i - j] - t[i - k])
        return prod

    a, b = t[i], t[i + 1]
    if a == b:
        return 0.0
    n = n_quad if n_quad % 2 == 1 else n_quad + 1
    ys = [fn(a + (b - a) * k / (n - 1)) for k in range(n)]
    h = (b - a) / (n - 1)
    return (ys[0] + ys[-1] + 4.0 * sum(ys[1:-1:2]) + 2.0 * sum(ys[2:-1:2])) * h / 3.0


def to_neg_log_sigma(sigma: torch.Tensor) -> torch.Tensor:
    return -torch.log(sigma)


def to_sigma(neg_log_sigma: torch.Tensor) -> torch.Tensor:
    return torch.exp(-neg_log_sigma)
