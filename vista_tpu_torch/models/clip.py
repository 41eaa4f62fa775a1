"""OpenCLIP ViT-H/14 image tower and the CLIP text tower (counterpart of
``vista_tpu/models/clip.py``: ``clip_preprocess``, ``CLIPVisionTower``,
``CLIPTextConfig`` and ``CLIPTextTower``).

Frozen: it maps the first frame of a clip to one 1024-d token. Plain
PyTorch throughout: the JAX package runs its attention through XLA
(``dot_product_attention``: fp32 scores, probabilities rounded to the
compute dtype), so no kernel is owed. Parameter names are open_clip's
(``conv1``, ``class_embedding``, ``transformer.resblocks.{i}.attn.in_proj_weight``
...), the names ``vista_tpu/utils/torch_import.py:clip_key_map`` maps.

The text tower (openai/clip-vit-large-patch14's, the reference's
``FrozenCLIPEmbedder``; no shipped Vista config uses it) carries HF
``CLIPTextModel``'s parameter names, so an HF state dict loads with no map
(:func:`load_hf_clip_text` drops a ``text_model.`` prefix). Its attention is
causal, plain PyTorch (fp32 scores, -inf above the diagonal), its MLP
quick-GELU.

``clip_preprocess`` reproduces ``jax.image.resize(..., "bicubic",
antialias=True)`` exactly: the Keys cubic kernel (a = -0.5), widened by
the downscale factor, weights normalised over the input samples, as two
dense resampling matrices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    output_dim: int = 1024
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def tiny(self) -> "CLIPVisionConfig":
        return dataclasses.replace(self, image_size=28, patch_size=14, width=32,
                                   layers=2, heads=2, output_dim=16)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - x)


def resize_weights(in_size: int, out_size: int, method: str = "cubic") -> np.ndarray:
    """``(in_size, out_size)`` antialiased resampling matrix of ``method``
    (``"cubic"``: Keys, a = -0.5; ``"linear"``: the triangle), the one
    ``jax.image.resize`` builds (``compute_weight_mat``, zero translation)."""
    f32 = np.float32
    inv = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = {"cubic": _keys_cubic, "linear": _triangle}[method](x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


# The constants below are copied to a device once: a copy from pageable host
# memory waits for the device's queue to drain.
@functools.lru_cache(maxsize=None)
def _resize_on(device: torch.device, in_size: int, out_size: int) -> torch.Tensor:
    return torch.from_numpy(resize_weights(in_size, out_size)).to(device)


@functools.lru_cache(maxsize=None)
def _mean_std_on(device: torch.device) -> torch.Tensor:
    return torch.tensor((CLIP_MEAN, CLIP_STD), device=device)[:, :, None, None]


def clip_preprocess(frames: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """``[-1, 1]`` frames ``(b, 3, H, W)`` -> CLIP-normalised ``(b, 3, S, S)``
    in fp32."""
    _, _, h, w = frames.shape
    x = frames.float()
    if h != image_size:
        x = torch.einsum("bchw,hy->bcyw", x, _resize_on(x.device, h, image_size))
    if w != image_size:
        x = torch.einsum("bchw,wx->bchx", x, _resize_on(x.device, w, image_size))
    x = (x + 1.0) / 2.0
    mean, std = _mean_std_on(x.device)
    return (x - mean) / std


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm, result in x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.normal_(self.in_proj_weight, std=width ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        dh = d // self.heads
        q, k, v = (t.reshape(b, s, self.heads, dh).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dh ** -0.5
        out = torch.matmul(torch.softmax(logits, -1).to(v.dtype), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x)))


class _Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1, self.ln_2 = nn.LayerNorm(width), nn.LayerNorm(width)
        self.attn = _Attention(width, heads)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(_ln(self.ln_1, x))
        return x + self.mlp(_ln(self.ln_2, x))


class _Transformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(_Block(cfg.width, cfg.heads) for _ in range(cfg.layers))


class CLIPVisionTower(nn.Module):
    """CLIP-normalised ``(b, 3, S, S)`` -> fp32 ``(b, output_dim)``."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        grid = cfg.image_size // cfg.patch_size
        scale = cfg.width ** -0.5
        self.conv1 = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(cfg.width) * scale)
        self.positional_embedding = nn.Parameter(torch.randn(grid * grid + 1, cfg.width) * scale)
        self.ln_pre = nn.LayerNorm(cfg.width)
        self.transformer = _Transformer(cfg)
        self.ln_post = nn.LayerNorm(cfg.width)
        self.proj = nn.Parameter(torch.randn(cfg.width, cfg.output_dim) * scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.to(self.conv1.weight.dtype))
        b, w = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.to(x.dtype).expand(b, 1, w), x], dim=1)
        x = _ln(self.ln_pre, x + self.positional_embedding.to(x.dtype))
        for block in self.transformer.resblocks:
            x = block(x)
        x = _ln(self.ln_post, x[:, 0])
        return (x @ self.proj.to(x.dtype)).float()


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """openai/clip-vit-large-patch14's text trunk."""

    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_length: int = 77
    act: str = "quick_gelu"
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def tiny(self) -> "CLIPTextConfig":
        return dataclasses.replace(self, vocab_size=128, width=32, layers=2, heads=2,
                                   max_length=16)


class _TextAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(width, width)
                                                                 for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        dh = d // self.heads
        q, k, v = (p(x).reshape(b, s, self.heads, dh).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dh ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, float("-inf"))
        out = torch.matmul(torch.softmax(logits, -1).to(v.dtype), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class _TextMLP(nn.Module):
    def __init__(self, width: int, act: str):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(width, 4 * width), nn.Linear(4 * width, width)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class _TextLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = _TextAttention(cfg.width, cfg.heads)
        self.layer_norm1, self.layer_norm2 = nn.LayerNorm(cfg.width), nn.LayerNorm(cfg.width)
        self.mlp = _TextMLP(cfg.width, cfg.act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(_ln(self.layer_norm1, x))
        return x + self.mlp(_ln(self.layer_norm2, x))


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.width)
        nn.init.normal_(self.position_embedding.weight, std=0.01)


class _TextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(_TextLayer(cfg) for _ in range(cfg.layers))


class CLIPTextTower(nn.Module):
    """Token ids ``(b, L)`` -> ``(last_hidden_state (b, L, width), pooled (b,
    width))`` in fp32; ``pooled`` is the state at ``argmax(tokens)``, the
    end-of-text token (the largest id of CLIP's vocabulary). Tokenising
    stays with the caller (HF ``CLIPTokenizer``'s ``input_ids``). Built in
    fp32; ``tower.encoder.to(cfg.compute_dtype)`` runs the layers in the
    compute dtype, the embeddings and the norms' statistics staying fp32."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = _TextEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.width)

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s = tokens.shape
        emb = self.embeddings
        x = emb.token_embedding.weight.float()[tokens] + emb.position_embedding.weight.float()[:s]
        x = x.to(self.encoder.layers[0].mlp.fc1.weight.dtype)
        for layer in self.encoder.layers:
            x = layer(x)
        x = _ln(self.final_layer_norm, x)
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]
        return x.float(), pooled.float()


def load_hf_clip_text(tower: CLIPTextTower, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load an HF ``CLIPTextModel`` state dict (``text_model.`` prefix or
    not; an ``embeddings.position_ids`` buffer is dropped) with
    ``strict=True``, each tensor cast to its parameter's dtype."""
    sd = {k.removeprefix("text_model."):
          v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
          for k, v in state_dict.items()}
    sd.pop("embeddings.position_ids", None)
    ref = tower.state_dict()
    tower.load_state_dict({k: v.to(ref[k].dtype) if k in ref else v for k, v in sd.items()},
                          strict=True)
