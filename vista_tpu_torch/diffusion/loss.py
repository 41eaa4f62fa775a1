"""Diffusion training loss with Vista's dynamics terms (counterpart of
``vista_tpu/diffusion/loss.py``, ``diffusion_loss``).

- one lognormal sigma per video, repeated over its frames;
- a per-video condition-frame pattern drawn from ``cond_frames_choices``
  with weights ``2^n``: the pinned frames get sigma 0 and their prediction
  is replaced by the clean latent;
- optional offset noise;
- ``use_additional_loss``: the per-pixel loss weighted by ``1 +
  normalize(inter-frame difference error)``, plus a high-pass term through
  a 2-D FFT of every frame (``torch.fft``).

Every random draw (:class:`LossDraws`) is an argument: :func:`draw_loss`
makes one from a ``torch.Generator``, and the tests hand in the JAX
package's draws. Latents are NCHW ``(b*t, c, h, w)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from vista_tpu_torch.diffusion.sigma_sampling import edm_sigmas
from vista_tpu_torch.diffusion.weighting import get_weighting


@dataclasses.dataclass(frozen=True)
class LossConfig:
    loss_type: str = "l2"
    weighting: str = "v"
    sigma_p_mean: float = 1.0
    sigma_p_std: float = 1.6
    num_frames: int = 25
    use_additional_loss: bool = False
    additional_loss_weight: float = 0.1
    offset_noise_level: float = 0.0
    replace_cond_frames: bool = False
    cond_frames_choices: Tuple[Tuple[int, ...], ...] = ((), (0,), (0, 1), (0, 1, 2))


@dataclasses.dataclass
class LossDraws:
    """sigma_normal ``(n_videos,)`` standard normals; choice ``(n_videos,)``
    indices into ``cond_frames_choices``; noise like the latents; offset
    ``(b*t, c)`` standard normals (read only with offset noise)."""

    sigma_normal: torch.Tensor
    choice: torch.Tensor
    noise: torch.Tensor
    offset: Optional[torch.Tensor] = None


def draw_loss(cfg: LossConfig, shape, gen: torch.Generator, device) -> LossDraws:
    """The draws for latents of ``shape`` ``(b*t, c, h, w)``, from ``gen``."""
    n = shape[0] // cfg.num_frames
    weights = torch.tensor([2.0 ** i for i in range(len(cfg.cond_frames_choices))],
                           device=device)
    return LossDraws(
        sigma_normal=torch.randn(n, generator=gen, device=device),
        choice=torch.multinomial(weights, n, replacement=True, generator=gen),
        noise=torch.randn(tuple(shape), generator=gen, device=device),
        offset=torch.randn(tuple(shape[:2]), generator=gen, device=device))


def cond_mask_table(choices, num_frames: int) -> np.ndarray:
    table = np.zeros((len(choices), num_frames), dtype=np.float32)
    for i, idxs in enumerate(choices):
        table[i, list(idxs)] = 1.0
    return table


def fourier_highpass_mask(h: int, w: int, d_s: float = 0.25) -> np.ndarray:
    """0 where ``(2i/H - 1)^2 + (2j/W - 1)^2 <= 2 d_s`` (low frequencies of
    the shifted spectrum), else 1."""
    ii = (2.0 * np.arange(h) / h - 1.0) ** 2
    jj = (2.0 * np.arange(w) / w - 1.0) ** 2
    return ((ii[:, None] + jj[None, :]) > 2.0 * d_s).astype(np.float32)


# The tables below are copied to a device once: a copy from pageable host
# memory waits for the device's queue to drain.
@functools.lru_cache(maxsize=None)
def _cond_mask_table_on(device: torch.device, choices, num_frames: int) -> torch.Tensor:
    return torch.from_numpy(cond_mask_table(choices, num_frames)).to(device)


@functools.lru_cache(maxsize=None)
def _highpass_mask_on(device: torch.device, h: int, w: int) -> torch.Tensor:
    return torch.from_numpy(fourier_highpass_mask(h, w)).to(device)


def fourier_filter_highpass(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """High-pass each frame of ``(n, c, h, w)`` through a 2-D FFT."""
    f = torch.fft.fftshift(torch.fft.fftn(x.to(torch.complex64), dim=(-2, -1)), dim=(-2, -1))
    f = torch.fft.ifftshift(f * mask, dim=(-2, -1))
    return torch.fft.ifftn(f, dim=(-2, -1)).real.to(x.dtype)


def fourier_highpass_mask_3d(t: int, h: int, w: int, d_s: float = 0.25,
                             d_t: float = 0.25) -> np.ndarray:
    """The spatiotemporal :func:`fourier_highpass_mask`: 0 where
    ``(d_s/d_t (2k/T - 1))^2 + (2i/H - 1)^2 + (2j/W - 1)^2 <= 2 d_s``, else 1."""
    tt = ((d_s / d_t) * (2.0 * np.arange(t) / t - 1.0)) ** 2
    ii = (2.0 * np.arange(h) / h - 1.0) ** 2
    jj = (2.0 * np.arange(w) / w - 1.0) ** 2
    d_square = tt[:, None, None] + ii[None, :, None] + jj[None, None, :]
    return (d_square > 2.0 * d_s).astype(np.float32)


def fourier_filter_highpass_3d(x: torch.Tensor, mask: torch.Tensor,
                               num_frames: int) -> torch.Tensor:
    """High-pass each video of frame-major ``(b*t, c, h, w)`` through a 3-D
    FFT over (t, h, w); ``mask`` ``(t, h, w)``. No shipped config uses it."""
    bt, c, h, w = x.shape
    dims = (1, 3, 4)
    x5 = x.reshape(bt // num_frames, num_frames, c, h, w).to(torch.complex64)
    f = torch.fft.fftshift(torch.fft.fftn(x5, dim=dims), dim=dims)
    f = torch.fft.ifftshift(f * mask[:, None], dim=dims)
    return torch.fft.ifftn(f, dim=dims).real.reshape(bt, c, h, w).to(x.dtype)


def _dynamics_weight(predict, target, num_frames: int, ord_: int) -> torch.Tensor:
    """``1 + normalize(inter-frame difference error)``, no gradient: the
    error L_p-normalised over (frames - 1, h, w) per (video, channel), 0 for
    each video's first frame."""
    bt, c, h, w = target.shape
    b = bt // num_frames
    p = predict.detach().reshape(b, num_frames, c, h, w)
    t = target.reshape(b, num_frames, c, h, w)
    diff = (t[:, 1:] - t[:, :-1]) - (p[:, 1:] - p[:, :-1])
    aux = diff ** 2 if ord_ == 2 else diff.abs()
    norm = aux.norm(p=ord_, dim=(1, 3, 4), keepdim=True)
    aux = aux / norm.clamp_min(1e-12)
    aux = torch.cat([torch.zeros_like(aux[:, :1]), aux], dim=1)
    return 1.0 + aux.reshape(bt, c, h, w)


def diffusion_loss(denoise_fn: Callable, latents: torch.Tensor, cond: dict,
                   cfg: LossConfig, draws: LossDraws):
    """The scalar training loss on clean latents and its metrics."""
    bt = latents.shape[0]
    dev = latents.device
    expand = lambda v: v.reshape(-1, *(1,) * (latents.ndim - 1))
    sigmas = edm_sigmas(draws.sigma_normal, cfg.num_frames, cfg.sigma_p_mean, cfg.sigma_p_std)
    if cfg.replace_cond_frames:
        choices = tuple(tuple(c) for c in cfg.cond_frames_choices)
        table = _cond_mask_table_on(dev, choices, cfg.num_frames)
        cond_mask = table[draws.choice.long()].reshape(-1)
    else:
        cond_mask = torch.zeros(bt, device=dev)
    noise = draws.noise
    if cfg.offset_noise_level > 0.0:
        noise = noise + cfg.offset_noise_level * draws.offset[:, :, None, None]
    noised = latents + noise * expand((1.0 - cond_mask) * sigmas)

    model_output = denoise_fn(noised, sigmas, cond, cond_mask)
    w = expand(get_weighting(cfg.weighting)(sigmas))
    mask = expand(cond_mask)
    predict = model_output * (1.0 - mask) + latents * mask
    err = predict - latents
    per_pix = w * (err ** 2 if cfg.loss_type == "l2" else err.abs())
    if cfg.use_additional_loss:
        aux_w = _dynamics_weight(predict, latents, cfg.num_frames,
                                 2 if cfg.loss_type == "l2" else 1)
        hp = _highpass_mask_on(dev, *latents.shape[-2:])
        hf_err = fourier_filter_highpass(predict, hp) - fourier_filter_highpass(latents, hp)
        hf = w * (hf_err ** 2 if cfg.loss_type == "l2" else hf_err.abs())
        hf_loss = hf.reshape(bt, -1).mean(1).mean()
        main = (per_pix * aux_w).reshape(bt, -1).mean(1).mean()
        loss = main + cfg.additional_loss_weight * hf_loss
        return loss, {"loss_main": main, "loss_hf": hf_loss, "sigma_mean": sigmas.mean()}
    loss = per_pix.reshape(bt, -1).mean(1).mean()
    return loss, {"loss_main": loss, "sigma_mean": sigmas.mean()}
