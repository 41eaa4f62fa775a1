"""Multi-head attention on the packed ``(B, S, heads * head_dim)`` layout.

Counterpart of ``vista_tpu/ops/attention.py``, ``ops/flash_attention.py``
and ``ops/tiny_attention.py``: one entry, :func:`attention_packed`, covers
the spatial self-attention at every length (the JAX package switches
between its flash kernel at s >= 2048 and its tiny kernel at s <= 1024) and
the temporal attention over t = 25 frames. On CUDA tensors it launches the
hand-written kernel K1 (``csrc/attention.cu``); on CPU tensors it runs
:func:`attention_plain`. The kernel takes t = 25 unpadded; ``valid_k``
masks keys at or past it for callers that do pad.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from vista_tpu_torch.ops import _build

HEAD_DIM = 64  # the only head width K1 is built for (the UNet's)
_LOG2E = 1.4426950408889634


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, valid_k: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head, in fp32; returns q's dtype."""
    b, s_q, hd = q.shape
    s_k = k.shape[1]
    d = hd // heads
    qh = q.float().reshape(b, s_q, heads, d).transpose(1, 2)
    kh = k.float().reshape(b, s_k, heads, d).transpose(1, 2)
    vh = v.float().reshape(b, s_k, heads, d).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * (d ** -0.5)
    if valid_k is not None and valid_k < s_k:
        logits[..., valid_k:] = -math.inf
    out = torch.matmul(torch.softmax(logits, dim=-1), vh)
    return out.transpose(1, 2).reshape(b, s_q, hd).to(q.dtype)


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, valid_k: Optional[int] = None,
                     site: str = "spatial") -> torch.Tensor:
    """Non-causal attention; ``site`` names the caller in the launch counts."""
    if _build.on_cpu(q, k, v):
        return attention_plain(q, k, v, heads, valid_k)
    b, s_q, hd = q.shape
    s_k = k.shape[1]
    if hd != heads * HEAD_DIM:
        raise ValueError(f"K1 needs head_dim {HEAD_DIM}: got {hd} / {heads} heads")
    _build.check(q, "q", torch.bfloat16)
    _build.check(k, "k", torch.bfloat16, (b, s_k, hd))
    _build.check(v, "v", torch.bfloat16, (b, s_k, hd))
    kv_len = s_k if valid_k is None else min(int(valid_k), s_k)
    if kv_len < 1:
        raise ValueError("attention needs at least one valid key")
    out = torch.empty_like(q)
    _build.launch("vk_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, s_q, s_k, heads, kv_len,
                  (HEAD_DIM ** -0.5) * _LOG2E)
    _build.count("attention", site)
    return out
