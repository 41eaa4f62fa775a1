"""EDM denoiser preconditioning (counterpart of ``vista_tpu/diffusion/denoiser.py``,
``precondition_denoise``): scale the input by ``c_in``, condition on
``c_noise``, and return ``net(...) * c_out + x * c_skip`` in fp32.
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
