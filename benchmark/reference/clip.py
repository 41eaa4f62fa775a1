"""The CLIP ViT-H/14 image tower and its preprocessing (the antialiased
bicubic resize ``jax.image.resize`` makes, then CLIP's normalisation) in
plain fp32 PyTorch: a frozen copy of the system's model code with its dtype
casts taken out, every product through the reference's primitives.
``cfg`` is the configuration file's ``clip`` entry."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.nn import Conv2d, Linear, attention, linear

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``(in_size, out_size)`` antialiased bicubic (Keys, a = -0.5) resampling
    matrix, the one ``jax.image.resize`` builds (``compute_weight_mat``, zero
    translation)."""
    f32 = np.float32
    inv = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def clip_preprocess(frames: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """``[-1, 1]`` frames ``(b, 3, H, W)`` -> CLIP-normalised ``(b, 3, S, S)``."""
    _, _, h, w = frames.shape
    x = frames.float()
    if h != image_size:
        wh = torch.from_numpy(resize_weights(h, image_size)).to(x.device)
        x = torch.einsum("bchw,hy->bcyw", x, wh)
    if w != image_size:
        ww = torch.from_numpy(resize_weights(w, image_size)).to(x.device)
        x = torch.einsum("bchw,wx->bchx", x, ww)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
    return (x - mean) / std


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1)
        return self.out_proj(attention(q, k, v, self.heads))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x)))


class _Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1, self.ln_2 = nn.LayerNorm(width), nn.LayerNorm(width)
        self.attn = _Attention(width, heads)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.resblocks = nn.ModuleList(_Block(cfg["width"], cfg["heads"])
                                       for _ in range(cfg["layers"]))


class CLIPVisionTower(nn.Module):
    """CLIP-normalised ``(b, 3, S, S)`` -> ``(b, output_dim)``."""

    def __init__(self, cfg: dict):
        super().__init__()
        grid = cfg["image_size"] // cfg["patch_size"]
        self.conv1 = Conv2d(3, cfg["width"], cfg["patch_size"], stride=cfg["patch_size"],
                            bias=False)
        self.class_embedding = nn.Parameter(torch.randn(cfg["width"]))
        self.positional_embedding = nn.Parameter(torch.randn(grid * grid + 1, cfg["width"]))
        self.ln_pre = nn.LayerNorm(cfg["width"])
        self.transformer = _Transformer(cfg)
        self.ln_post = nn.LayerNorm(cfg["width"])
        self.proj = nn.Parameter(torch.randn(cfg["width"], cfg["output_dim"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        b, w = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.expand(b, 1, w), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding)
        for block in self.transformer.resblocks:
            x = block(x)
        x = self.ln_post(x[:, 0])
        return linear(x, self.proj.t())
