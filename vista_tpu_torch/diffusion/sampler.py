"""Euler-EDM sampling as a Python loop (counterpart of
``vista_tpu/diffusion/sampler.py``, ``sample_euler_edm``), with Vista's
semantics:

- the initial noise is rescaled by ``sqrt(1 + sigma_0^2)``;
- the context frames are pinned into the state (``x*(1-m) + cond_frame*m``)
  before every step and once after the loop;
- classifier-free guidance merges ``[uc; c]`` with per-frame scales:
  ``cfg_mode="batched"`` runs the pair as one doubled batch,
  ``"sequential"`` as two calls on the undoubled batch (uc, then c), the
  same FLOPs at half the activation memory;
- stochastic churn (``s_churn > 0``): where ``s_tmin <= sigma <= s_tmax``
  the step starts from ``sigma_hat = sigma (1 + gamma)``, ``gamma =
  min(s_churn / (n_sigmas - 1), sqrt(2) - 1)``, after adding
  ``eps * s_noise * sqrt(sigma_hat^2 - sigma^2)`` to the state. The
  per-step ``eps`` comes from the caller (the JAX package draws it from
  ``fold_in(key, i)``): a callable ``i -> eps``, or a ``torch.Generator``
  on the state's device.

The step's sigma arithmetic is float32, as the JAX scan's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from vista_tpu_torch.diffusion.discretization import edm_sigmas
from vista_tpu_torch.diffusion.guidance import GuiderConfig, cfg_merge, guider_frame_scales

# denoise_fn(x, sigma, cond, cond_mask) -> denoised estimate
DenoiseFn = Callable[[torch.Tensor, torch.Tensor, dict, Optional[torch.Tensor]],
                     torch.Tensor]
# the churn's per-step standard-normal draws: step index -> eps of the state's shape
ChurnNoise = Union[Callable[[int], torch.Tensor], torch.Generator]

CFG_MODES = ("batched", "sequential")


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


def _eps(churn_noise: ChurnNoise, i: int, x: torch.Tensor) -> torch.Tensor:
    if isinstance(churn_noise, torch.Generator):
        return torch.randn(x.shape, generator=churn_noise, device=x.device, dtype=x.dtype)
    eps = churn_noise(i)
    if eps.shape != x.shape:
        raise ValueError(f"churn noise of step {i} has shape {tuple(eps.shape)}, "
                         f"the state {tuple(x.shape)}")
    return eps.to(device=x.device, dtype=x.dtype)


@torch.no_grad()
def sample_euler_edm(denoise_fn: DenoiseFn, noise: torch.Tensor, cond: dict,
                     uc: Optional[dict] = None,
                     cond_frame: Optional[torch.Tensor] = None,
                     cond_mask: Optional[torch.Tensor] = None,
                     config: SamplerConfig = SamplerConfig(),
                     num_frames: int = 25,
                     churn_noise: Optional[ChurnNoise] = None,
                     frames: Optional[slice] = None) -> torch.Tensor:
    """noise ``(b*t, c, h, w)`` standard normal; returns the final latents.
    ``churn_noise`` is required when ``config.s_churn > 0``. ``frames``
    (frame parallelism): the call holds these frames of each video, the
    guider's scales are read at them and ``num_frames`` is their count."""
    if config.cfg_mode not in CFG_MODES:
        raise ValueError(f"unknown cfg_mode {config.cfg_mode!r}; one of {CFG_MODES}")
    use_churn = config.s_churn > 0.0
    if use_churn and churn_noise is None:
        raise ValueError("s_churn > 0 requires churn_noise (a callable or a torch.Generator)")
    sigmas = edm_sigmas(config.num_steps, config.sigma_min, config.sigma_max,
                        config.rho).numpy()
    gamma_max = min(config.s_churn / (len(sigmas) - 1), math.sqrt(2.0) - 1.0)
    frame_scales = guider_frame_scales(config.guider)
    if frames is not None and frame_scales is not None:
        frame_scales = frame_scales[frames]
    guided = frame_scales is not None and uc is not None
    doubled = guided and config.cfg_mode == "batched"
    cond_all = _double_cond(cond, uc) if doubled else cond

    pinned = cond_frame is not None and cond_mask is not None
    if pinned:
        mask_b = cond_mask.to(noise.dtype).reshape(-1, *([1] * (noise.ndim - 1)))

    def pin(x):
        return x * (1.0 - mask_b) + cond_frame * mask_b if pinned else x

    def denoise(x, sigma):
        s1 = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
        if doubled:
            m = torch.cat([cond_mask, cond_mask]) if cond_mask is not None else None
            return cfg_merge(denoise_fn(torch.cat([x, x]), torch.cat([s1, s1]), cond_all, m),
                             frame_scales, num_frames)
        if guided:  # sequential: uc, then c, each on the undoubled batch
            out_u = denoise_fn(x, s1, uc, cond_mask)
            out_c = denoise_fn(x, s1, cond, cond_mask)
            return cfg_merge(torch.cat([out_u, out_c]), frame_scales, num_frames)
        return denoise_fn(x, s1, cond_all, cond_mask)

    x = noise * math.sqrt(1.0 + float(sigmas[0]) ** 2)
    for i, (sigma, next_sigma) in enumerate(zip(sigmas[:-1], sigmas[1:])):
        x = pin(x)
        sigma_hat = sigma
        if use_churn:
            gamma = np.float32(gamma_max if config.s_tmin <= sigma <= config.s_tmax else 0.0)
            sigma_hat = sigma * (gamma + np.float32(1.0))
            extra = np.sqrt(np.maximum(sigma_hat * sigma_hat - sigma * sigma, np.float32(0.0)))
            x = x + _eps(churn_noise, i, x) * (config.s_noise * float(extra))
        denoised = denoise(x, float(sigma_hat))
        x = x + float(next_sigma - sigma_hat) * ((x - denoised) / float(sigma_hat))
    return pin(x)
