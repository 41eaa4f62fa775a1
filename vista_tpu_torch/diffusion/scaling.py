"""EDM-family denoiser preconditioning scalings (counterpart of
``vista_tpu/diffusion/scaling.py``).

Each maps ``sigma`` to ``(c_skip, c_out, c_in, c_noise)`` such that the
denoiser output is ``net(x * c_in, c_noise) * c_out + x * c_skip``. The
shipped Vista config uses ``v_scaling_edm_cnoise``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

Coeffs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
ScalingFn = Callable[[torch.Tensor], Coeffs]


def edm_scaling(sigma: torch.Tensor, sigma_data: float = 0.5) -> Coeffs:
    c_skip = sigma_data**2 / (sigma**2 + sigma_data**2)
    c_out = sigma * sigma_data / torch.sqrt(sigma**2 + sigma_data**2)
    c_in = 1.0 / torch.sqrt(sigma**2 + sigma_data**2)
    c_noise = 0.25 * torch.log(sigma)
    return c_skip, c_out, c_in, c_noise


def eps_scaling(sigma: torch.Tensor) -> Coeffs:
    c_skip = torch.ones_like(sigma)
    c_out = -sigma
    c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
    c_noise = sigma
    return c_skip, c_out, c_in, c_noise


def v_scaling(sigma: torch.Tensor) -> Coeffs:
    c_skip = 1.0 / (sigma**2 + 1.0)
    c_out = -sigma / torch.sqrt(sigma**2 + 1.0)
    c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
    c_noise = sigma
    return c_skip, c_out, c_in, c_noise


def v_scaling_edm_cnoise(sigma: torch.Tensor) -> Coeffs:
    """v-prediction coefficients with the EDM noise conditioning (shipped Vista)."""
    c_skip, c_out, c_in, _ = v_scaling(sigma)
    return c_skip, c_out, c_in, 0.25 * torch.log(sigma)


_SCALINGS = {
    "edm": edm_scaling,
    "eps": eps_scaling,
    "v": v_scaling,
    "v_edm_cnoise": v_scaling_edm_cnoise,
}


def get_scaling(name: str) -> ScalingFn:
    try:
        return _SCALINGS[name]
    except KeyError:
        raise ValueError(f"unknown scaling {name!r}; one of {sorted(_SCALINGS)}") from None
