"""Per-sigma loss weightings (counterpart of ``vista_tpu/diffusion/weighting.py``)."""

from __future__ import annotations

import torch


def unit_weighting(sigma: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(sigma)


def edm_weighting(sigma: torch.Tensor, sigma_data: float = 0.5) -> torch.Tensor:
    return (sigma ** 2 + sigma_data ** 2) / (sigma * sigma_data) ** 2


def v_weighting(sigma: torch.Tensor) -> torch.Tensor:
    return edm_weighting(sigma, sigma_data=1.0)


def eps_weighting(sigma: torch.Tensor) -> torch.Tensor:
    return sigma ** -2.0


_WEIGHTINGS = {"unit": unit_weighting, "edm": edm_weighting, "v": v_weighting,
               "eps": eps_weighting}


def get_weighting(name: str):
    try:
        return _WEIGHTINGS[name]
    except KeyError:
        raise ValueError(f"unknown weighting {name!r}; one of {sorted(_WEIGHTINGS)}") from None
