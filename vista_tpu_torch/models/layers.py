"""Shared network primitives (counterpart of ``vista_tpu/models/layers.py``).

Dtype policy: parameters and activations are in the model's dtype (bf16 on
the card); normalisation statistics are computed in fp32 and the time
embeddings are built in fp32, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding in fp32, ``cos`` half first then ``sin``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def num_groups(channels: int, groups: int = 32) -> int:
    """32 groups, or the largest divisor of 32 that divides narrow test widths."""
    return groups if channels % groups == 0 else math.gcd(channels, groups)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm computed in fp32 whatever the activation dtype. Works on
    ``(n, c, ...)`` of any rank, so a 5-D ``(b, c, t, h, w)`` video is
    normalised over its frames too."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(num_groups(channels), channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def timestep_mlp(in_dim: int, out_dim: int) -> nn.Sequential:
    """Linear -> SiLU -> Linear (upstream ``time_embed`` keys ``.0`` / ``.2``)."""
    return nn.Sequential(nn.Linear(in_dim, out_dim), nn.SiLU(), nn.Linear(out_dim, out_dim))


class AlphaBlender(nn.Module):
    """Learned (sigmoid) or fixed scalar blend ``a * x_spatial + (1 - a) * x_temporal``."""

    def __init__(self, alpha: float = 0.5, merge_strategy: str = "learned_with_images"):
        super().__init__()
        self.merge_strategy = merge_strategy
        if merge_strategy == "fixed":
            self.register_buffer("mix_factor", torch.tensor([alpha]), persistent=False)
        elif merge_strategy in ("learned", "learned_with_images"):
            self.mix_factor = nn.Parameter(torch.tensor([alpha]))
        else:
            raise ValueError(f"unknown merge strategy {merge_strategy!r}")

    def alpha(self) -> torch.Tensor:
        """The spatial weight ``a`` as a one-element fp32 tensor."""
        m = self.mix_factor.float()
        return m if self.merge_strategy == "fixed" else torch.sigmoid(m)

    def forward(self, x_spatial: torch.Tensor, x_temporal: torch.Tensor) -> torch.Tensor:
        a = self.alpha().to(x_spatial.dtype)
        return a * x_spatial + (1.0 - a) * x_temporal


def to_rows(x: torch.Tensor) -> torch.Tensor:
    """``(n, c, h, w)`` held channels-last -> ``(n, h*w, c)``; free when the
    tensor is channels-last contiguous."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, c)


def from_rows(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`to_rows`: a channels-last ``(n, c, h, w)`` view."""
    n, _, c = x.shape
    return x.reshape(n, h, w, c).permute(0, 3, 1, 2)
