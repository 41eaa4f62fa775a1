"""First-stage (VAE) training: reconstruction + KL + a PatchGAN hinge loss
(counterpart of ``vista_tpu/engine/vae_training.py``).

Two Adam optimizers (``optax.adam``'s moments and bias correction, ``b1 =
0.5``, ``b2 = 0.9``) alternate by step parity: an even step trains the
autoencoder (the encoder and the image decoder) on ``rec + kl_weight * kl``
plus, from ``disc_start`` on, ``disc_weight`` times the generator's
adversarial term; an odd step from ``disc_start`` on trains the
discriminator on the hinge loss of real frames against the (detached)
reconstruction. With ``disc_weight = 0`` every step trains the autoencoder.

The parameters are fp32; the VAE computes in its config's dtype (bf16 on
the card, by autocast), the discriminator in fp32, as in the JAX package.
Every random draw is an argument: ``step(x, posterior_noise)`` takes the
standard normal of the posterior sample.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vista_tpu_torch.models.vae import (VAEConfig, VAEDecoder, VAEEncoder, gaussian_kl,
                                        gaussian_sample)


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    learning_rate: float = 4.5e-6
    recon_loss: str = "l1"  # "l1" | "l2"
    kl_weight: float = 1e-6
    disc_weight: float = 0.5
    disc_start: int = 50001  # the generator sees the adversarial loss from this step
    disc_channels: int = 64
    disc_layers: int = 3


class _SameConv(nn.Conv2d):
    """A bias-optional 4x4 conv with flax's ``"SAME"`` padding (the low side
    gets the smaller half of the total)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in zip(x.shape[:-3:-1], self.kernel_size[::-1], self.stride[::-1]):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class PatchDiscriminator(nn.Module):
    """PatchGAN: a stride-2 4x4 conv, then ``num_layers - 1`` stride-2 4x4
    convs without bias, each under GroupNorm (eps 1e-6) and leaky ReLU 0.2,
    then a one-channel 4x4 head: per-patch real/fake logits ``(n, 1, h', w')``."""

    def __init__(self, base_channels: int = 64, num_layers: int = 3, in_channels: int = 3):
        super().__init__()
        ch = base_channels
        self.conv_in = _SameConv(in_channels, ch, 4, stride=2)
        for i in range(1, num_layers):
            out = min(ch * 2, 512)
            setattr(self, f"conv_{i}", _SameConv(ch, out, 4, stride=2, bias=False))
            setattr(self, f"norm_{i}", nn.GroupNorm(min(32, out), out, eps=1e-6))
            ch = out
        self.conv_out = _SameConv(ch, 1, 4)
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv_in(x.float()), 0.2)
        for i in range(1, self.num_layers):
            x = getattr(self, f"conv_{i}")(x)
            x = F.leaky_relu(getattr(self, f"norm_{i}")(x), 0.2)
        return self.conv_out(x)


def discriminator_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX discriminator's params (``conv_*`` HWIO kernels, ``norm_*``
    scale / bias) as a :class:`PatchDiscriminator` state dict (OIHW)."""
    out = {}
    for name, leaves in params.items():
        for leaf, value in leaves.items():
            t = torch.from_numpy(np.array(value, dtype=np.float32))
            if leaf == "kernel":
                out[f"{name}.weight"] = t.permute(3, 2, 0, 1).contiguous()
            else:
                out[f"{name}.{'weight' if leaf == 'scale' else leaf}"] = t
    return out


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


class _Adam:
    """``optax.adam`` over a module's parameters: ``mu``, ``nu`` in fp32,
    ``p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``."""

    def __init__(self, module: nn.Module, lr: float, b1: float = 0.5, b2: float = 0.9,
                 eps: float = 1e-8):
        self.params = [p for p in module.parameters() if p.requires_grad]
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * ((mu / c1) / (torch.sqrt(nu / c2) + self.eps)))
            p.grad = None


class VAETrainer:
    """``trainer.step(x, posterior_noise) -> metrics``: one alternating step.

    x: pixels ``(n, 3, H, W)`` in [-1, 1]; posterior_noise: standard normal
    ``(n, z, H/8, W/8)``. The modules are built on ``device`` with fp32
    parameters, or taken as given."""

    def __init__(self, cfg: VAETrainConfig, vae_cfg: VAEConfig, device="cuda",
                 encoder: VAEEncoder = None, decoder: VAEDecoder = None,
                 disc: PatchDiscriminator = None):
        self.cfg, self.vae_cfg = cfg, vae_cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VAETrainer runs on the card and found none; "
                               "pass device='cpu' to train on the CPU")
        with self.device:
            self.encoder = encoder or VAEEncoder(vae_cfg)
            self.decoder = decoder or VAEDecoder(vae_cfg)
            self.disc = disc or PatchDiscriminator(cfg.disc_channels, cfg.disc_layers,
                                                   vae_cfg.in_channels)
        for m in (self.encoder, self.decoder, self.disc):
            m.float().train()
        self.ae_opt = _Adam(nn.ModuleList([self.encoder, self.decoder]), cfg.learning_rate)
        self.disc_opt = _Adam(self.disc, cfg.learning_rate)
        self.steps = 0

    def _autocast(self):
        dtype = self.vae_cfg.compute_dtype
        if dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=dtype)

    def reconstruct(self, x: torch.Tensor, noise: torch.Tensor):
        """The posterior sample's decode and the encoder's moments (fp32)."""
        with self._autocast():
            moments = self.encoder(x)
            x_rec = self.decoder(gaussian_sample(moments, noise))
        return x_rec.float(), moments.float()

    def _rec(self, x: torch.Tensor, x_rec: torch.Tensor) -> torch.Tensor:
        err = x_rec - x
        return err.abs().mean() if self.cfg.recon_loss == "l1" else (err**2).mean()

    def trains_disc(self) -> bool:
        """Whether the next step trains the discriminator."""
        cfg = self.cfg
        return cfg.disc_weight > 0.0 and self.steps % 2 == 1 and self.steps >= cfg.disc_start

    def step(self, x: torch.Tensor, posterior_noise: torch.Tensor) -> Dict[str, float]:
        cfg = self.cfg
        if self.trains_disc():
            with torch.no_grad():
                x_rec, _ = self.reconstruct(x, posterior_noise)
            loss = hinge_d_loss(self.disc(x), self.disc(x_rec))
            loss.backward()
            self.disc_opt.step()
            self.steps += 1
            return {"loss": float(loss.detach()), "rec": 0.0, "kl": 0.0, "which": 1.0}
        x_rec, moments = self.reconstruct(x, posterior_noise)
        rec = self._rec(x, x_rec)
        kl = gaussian_kl(moments).mean()
        loss = rec + cfg.kl_weight * kl
        if cfg.disc_weight > 0.0:
            self.disc.requires_grad_(False)
            g_adv = -self.disc(x_rec).mean()
            self.disc.requires_grad_(True)
            adv_on = 1.0 if self.steps >= cfg.disc_start else 0.0
            loss = loss + cfg.disc_weight * adv_on * g_adv
        loss.backward()
        self.ae_opt.step()
        self.steps += 1
        return {"loss": float(loss.detach()), "rec": float(rec.detach()), "kl": float(kl.detach()),
                "which": 0.0}
