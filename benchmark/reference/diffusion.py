"""Vista's diffusion arithmetic in plain fp32 PyTorch and NumPy, from the
published equations (EDM, Karras et al. 2022; SVD; Vista, Gao et al. 2024):
the v-prediction preconditioning with EDM noise conditioning, the EDM
noise schedule and Euler step with pinned context frames,
classifier-free guidance with per-frame scales (vanilla, linear,
triangle), and the training loss with Vista's dynamics and
high-frequency terms.

Latents are ``(b*t, c, h, w)``, frame-major.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.nn import state


def scalings(sigma: torch.Tensor):
    """``(c_skip, c_out, c_in, c_noise)`` of v-prediction with ``0.25 log sigma``."""
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
    c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
    return c_skip, c_out, c_in, 0.25 * torch.log(sigma)


def frame_scales(kind: str, scale: float, min_scale: float, t: int) -> np.ndarray:
    """The guidance scale of each of ``t`` frames."""
    if kind == "vanilla":
        return np.full(t, scale, np.float32)
    if kind == "linear":
        return np.linspace(min_scale, scale, t, dtype=np.float32)
    if kind == "triangle":  # one period, as the system's default
        v = np.linspace(0.0, 1.0, t)
        wave = 2.0 * np.abs(v - np.floor(v + 0.5))
        return (wave * (scale - min_scale) + min_scale).astype(np.float32)
    raise ValueError(f"unknown guider {kind!r}")


def edm_sigmas(n: int, sigma_min: float, sigma_max: float, rho: float) -> np.ndarray:
    """Karras et al.'s schedule of ``n`` sigmas from ``sigma_max`` down to
    ``sigma_min``, rho-spaced, then 0 (fp64; bf16 under the control)."""
    ramp = np.linspace(0.0, 1.0, n)
    lo, hi = sigma_min ** (1.0 / rho), sigma_max ** (1.0 / rho)
    sigmas = np.append((hi + ramp * (lo - hi)) ** rho, 0.0)
    return state(torch.from_numpy(sigmas)).numpy()


def pin(x: torch.Tensor, frames: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``x`` with the frames under ``mask`` ``(t,)`` replaced by ``frames``."""
    m = mask.to(x.dtype).reshape(-1, 1, 1, 1)
    return x * (1.0 - m) + frames.to(x.dtype) * m


def initial_state(noise, sigma_0: float, frames, mask) -> torch.Tensor:
    """The state entering a round's first step: the noise scaled to
    ``sqrt(1 + sigma_0^2)`` (SVD's EDM sampler), context frames pinned."""
    return state(pin(state(noise.double() * float(np.sqrt(1.0 + sigma_0 ** 2))), frames, mask))


def euler(x, denoised, sigma: float, next_sigma: float, mask) -> torch.Tensor:
    """One Euler step of the probability-flow ODE from ``sigma`` to
    ``next_sigma``, the context frames under ``mask`` kept as ``x`` holds
    them."""
    x = x.double()
    step = state(x + (next_sigma - sigma) * ((x - denoised.double()) / sigma))
    return pin(step, x, mask)


def denoise(unet, x, sigma, cond, cond_mask, num_frames):
    """The preconditioned denoiser on ``x`` at per-frame ``sigma``: the
    network sees ``x c_in`` with the ``concat`` condition on its channels."""
    sb = sigma.float().reshape(-1, 1, 1, 1)
    c_skip, c_out, c_in, c_noise = scalings(sb)
    concat = cond["concat"].float()
    if concat.shape[0] != x.shape[0]:
        concat = concat.repeat_interleave(num_frames, dim=0)
    net_in = torch.cat([x * c_in, concat], dim=1)
    out = unet(net_in, c_noise.reshape(-1), cond["crossattn"].float(), cond["vector"].float(),
               cond_mask, num_frames)
    return out * c_out + x * c_skip


def guided(unet, x, sigma, c, uc, cond_mask, scales, num_frames):
    """``x_u + s_f (x_c - x_u)`` for one video ``x`` ``(t, c, h, w)``: the
    unconditional and conditional denoisers run one after the other."""
    s = torch.full((x.shape[0],), float(sigma), device=x.device)
    d_u = denoise(unet, x, s, uc, cond_mask, num_frames)
    d_c = denoise(unet, x, s, c, cond_mask, num_frames)
    w = torch.as_tensor(scales, device=x.device).reshape(-1, 1, 1, 1)
    return d_u + w * (d_c - d_u)


# -------------------------------------------------------------- training

def highpass_mask(h: int, w: int, d_s: float = 0.25) -> torch.Tensor:
    ii = (2.0 * np.arange(h) / h - 1.0) ** 2
    jj = (2.0 * np.arange(w) / w - 1.0) ** 2
    return torch.from_numpy(((ii[:, None] + jj[None, :]) > 2.0 * d_s).astype(np.float32))


def highpass(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    f = torch.fft.fftshift(torch.fft.fftn(x.to(torch.complex64), dim=(-2, -1)), dim=(-2, -1))
    return torch.fft.ifftn(torch.fft.ifftshift(f * mask, dim=(-2, -1)), dim=(-2, -1)).real


def diffusion_loss(unet, latents, cond, loss_cfg: dict, draws: dict):
    """Vista's training loss on clean ``latents``: one lognormal sigma per
    video, condition frames (sigma 0, prediction replaced by the clean
    latent) from the drawn pattern, v weighting, the per-pixel error weighted
    by ``1 + normalize(inter-frame difference error)``, plus the high-pass
    term."""
    t = loss_cfg["num_frames"]
    bt = latents.shape[0]
    dev = latents.device
    sigmas = torch.exp(loss_cfg["sigma_p_mean"] + loss_cfg["sigma_p_std"]
                       * draws["sigma_normal"].float()).repeat_interleave(t)
    choices = loss_cfg["cond_frames_choices"]
    table = torch.zeros(len(choices), t, device=dev)
    for i, idx in enumerate(choices):
        table[i, list(idx)] = 1.0
    mask = (table[draws["choice"].long()].reshape(-1) if loss_cfg["replace_cond_frames"]
            else torch.zeros(bt, device=dev))
    ex = lambda v: v.reshape(-1, 1, 1, 1)
    noised = latents + draws["noise"] * ex((1.0 - mask) * sigmas)
    out = denoise(unet, noised, sigmas, cond, mask, t)
    w = ex((sigmas ** 2 + 1.0) / sigmas ** 2)
    predict = out * (1.0 - ex(mask)) + latents * ex(mask)
    err = predict - latents
    per_pix = w * err ** 2
    if not loss_cfg["use_additional_loss"]:
        return per_pix.reshape(bt, -1).mean(1).mean()
    c, h, wd = latents.shape[1:]
    p = predict.detach().reshape(-1, t, c, h, wd)
    lt = latents.reshape(-1, t, c, h, wd)
    diff = (lt[:, 1:] - lt[:, :-1]) - (p[:, 1:] - p[:, :-1])
    aux = diff ** 2
    aux = aux / aux.norm(p=2, dim=(1, 3, 4), keepdim=True).clamp_min(1e-12)
    aux_w = 1.0 + torch.cat([torch.zeros_like(aux[:, :1]), aux], dim=1).reshape(bt, c, h, wd)
    hp = highpass_mask(h, wd).to(dev)
    hf = w * (highpass(predict, hp) - highpass(latents, hp)) ** 2
    main = (per_pix * aux_w).reshape(bt, -1).mean(1).mean()
    return main + loss_cfg["additional_loss_weight"] * hf.reshape(bt, -1).mean(1).mean()
