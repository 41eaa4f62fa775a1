"""EDM denoiser preconditioning (counterpart of ``vista_tpu/diffusion/denoiser.py``,
``precondition_denoise``): scale the input by ``c_in``, condition on
``c_noise``, and return ``net(...) * c_out + x * c_skip`` in fp32;
``precondition_denoise_discrete`` with ``sigma_to_idx``, its discrete-table
counterpart.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from vista_tpu_torch.diffusion.scaling import ScalingFn, v_scaling_edm_cnoise

# network_fn(scaled_input, c_noise, cond, cond_mask) -> prediction
NetworkFn = Callable[[torch.Tensor, torch.Tensor, dict, Optional[torch.Tensor]],
                     torch.Tensor]


def precondition_denoise(network_fn: NetworkFn, noised_input: torch.Tensor,
                         sigma: torch.Tensor, cond: dict,
                         cond_mask: Optional[torch.Tensor] = None,
                         scaling: ScalingFn = v_scaling_edm_cnoise) -> torch.Tensor:
    """noised_input ``(b*t, c, h, w)``; sigma ``(b*t,)`` per-frame noise levels."""
    sigma_b = sigma.float().reshape(-1, *([1] * (noised_input.ndim - 1)))
    c_skip, c_out, c_in, c_noise = scaling(sigma_b)
    out = network_fn(noised_input * c_in, c_noise.reshape(sigma.shape), cond,
                     cond_mask)
    return out.float() * c_out + noised_input * c_skip


def sigma_to_idx(sigma: torch.Tensor, sigma_table: torch.Tensor) -> torch.Tensor:
    """Index of the nearest table entry (the first on a tie)."""
    table = sigma_table.to(device=sigma.device, dtype=torch.float32)
    return torch.argmin((sigma[..., None] - table).abs(), dim=-1)


def precondition_denoise_discrete(network_fn: NetworkFn, noised_input: torch.Tensor,
                                  sigma: torch.Tensor, cond: dict,
                                  sigma_table: torch.Tensor,
                                  cond_mask: Optional[torch.Tensor] = None,
                                  scaling: ScalingFn = v_scaling_edm_cnoise,
                                  quantize_c_noise: bool = True) -> torch.Tensor:
    """The discrete denoiser: sigma snapped to the nearest entry of a
    descending table (e.g. ``legacy_ddpm_sigmas(1000, append_zero=False)``);
    with ``quantize_c_noise`` the network is conditioned on ``c_noise``
    re-quantised through the table (its index, for identity-like
    ``c_noise``)."""
    sigma = sigma.float()
    table = sigma_table.to(device=sigma.device, dtype=torch.float32)
    idx = sigma_to_idx(sigma, table)
    sigma_b = table[idx].reshape(-1, *([1] * (noised_input.ndim - 1)))
    c_skip, c_out, c_in, c_noise = scaling(sigma_b)
    c_noise = c_noise.reshape(sigma.shape)
    if quantize_c_noise:
        c_noise = sigma_to_idx(c_noise, table)
    out = network_fn(noised_input * c_in, c_noise.float(), cond, cond_mask)
    return out.float() * c_out + noised_input * c_skip
