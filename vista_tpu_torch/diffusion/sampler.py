"""Euler-EDM sampling as a Python loop (counterpart of
``vista_tpu/diffusion/sampler.py``, ``sample_euler_edm``), with Vista's
semantics:

- the initial noise is rescaled by ``sqrt(1 + sigma_0^2)``;
- the context frames are pinned into the state (``x*(1-m) + cond_frame*m``)
  before every step and once after the loop;
- classifier-free guidance runs the batched pair ``[uc; c]`` and merges with
  per-frame scales.

Not ported yet: stochastic churn (``s_churn > 0``) and ``cfg_mode =
"sequential"``; both raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from vista_tpu_torch.diffusion.discretization import edm_sigmas
from vista_tpu_torch.diffusion.guidance import GuiderConfig, cfg_merge, guider_frame_scales

# denoise_fn(x, sigma, cond, cond_mask) -> denoised estimate
DenoiseFn = Callable[[torch.Tensor, torch.Tensor, dict, Optional[torch.Tensor]],
                     torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_steps: int = 50
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = 999.0
    s_noise: float = 1.0
    guider: GuiderConfig = dataclasses.field(default_factory=GuiderConfig)
    cfg_mode: str = "batched"


def _double_cond(cond: dict, uc: dict) -> dict:
    return {k: torch.cat([uc[k], cond[k]], dim=0) for k in cond}


@torch.no_grad()
def sample_euler_edm(denoise_fn: DenoiseFn, noise: torch.Tensor, cond: dict,
                     uc: Optional[dict] = None,
                     cond_frame: Optional[torch.Tensor] = None,
                     cond_mask: Optional[torch.Tensor] = None,
                     config: SamplerConfig = SamplerConfig(),
                     num_frames: int = 25) -> torch.Tensor:
    """noise ``(b*t, c, h, w)`` standard normal; returns the final latents."""
    if config.s_churn > 0.0:
        raise NotImplementedError("stochastic churn is not ported yet")
    sigmas = [float(s) for s in edm_sigmas(config.num_steps, config.sigma_min,
                                           config.sigma_max, config.rho)]
    frame_scales = guider_frame_scales(config.guider)
    guided = frame_scales is not None and uc is not None
    if guided and config.cfg_mode != "batched":
        raise NotImplementedError(f"cfg_mode {config.cfg_mode!r} is not ported yet")
    cond_all = _double_cond(cond, uc) if guided else cond

    pinned = cond_frame is not None and cond_mask is not None
    if pinned:
        mask_b = cond_mask.to(noise.dtype).reshape(-1, *([1] * (noise.ndim - 1)))

    def pin(x):
        return x * (1.0 - mask_b) + cond_frame * mask_b if pinned else x

    x = noise * math.sqrt(1.0 + sigmas[0] ** 2)
    for sigma, next_sigma in zip(sigmas[:-1], sigmas[1:]):
        x = pin(x)
        s1 = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
        if guided:
            m = torch.cat([cond_mask, cond_mask]) if cond_mask is not None else None
            denoised = cfg_merge(denoise_fn(torch.cat([x, x]), torch.cat([s1, s1]),
                                            cond_all, m), frame_scales, num_frames)
        else:
            denoised = denoise_fn(x, s1, cond_all, cond_mask)
        x = x + (next_sigma - sigma) * ((x - denoised) / sigma)
    return pin(x)
