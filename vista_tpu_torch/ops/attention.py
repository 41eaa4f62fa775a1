"""Multi-head attention on the packed ``(B, S, heads * head_dim)`` layout.

Counterpart of ``vista_tpu/ops/attention.py``, ``ops/flash_attention.py``
and ``ops/tiny_attention.py``: one entry, :func:`attention_packed`, covers
the spatial self-attention at every length (the JAX package switches
between its flash kernel at s >= 2048 and its tiny kernel at s <= 1024) and
the temporal attention over t = 25 frames. On CUDA tensors it launches the
hand-written kernel K1 (``csrc/attention.cu``); on CPU tensors it runs
:func:`attention_plain`. The kernel takes t = 25 unpadded; ``valid_k``
masks keys at or past it for callers that do pad.

Backward (training): when an input requires grad, the forward also writes
the fp32 log-sum-exp of each query row, ``(B, heads, S_q)`` (the JAX
``want_lse`` path), and the backward runs ``csrc/attention_bwd.cu`` (FA2
style: a ``D = rowsum(dO * O)`` pre-pass, a dK/dV kernel looping over query
tiles and a dQ kernel looping over key tiles, both recomputing P from the
saved LSE). It replaces the flash backward (``_bwd_dq_kernel``,
``_bwd_dkv_kernel``) and the tiny backward (``_tiny_bwd_kernel``) alike; on
CPU tensors :func:`attention_bwd_plain` computes the same in fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from vista_tpu_torch.ops import _build

HEAD_DIM = 64  # the only head width K1 is built for (the UNet's)
_LOG2E = 1.4426950408889634


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, hd = t.shape
    return t.float().reshape(b, s, heads, hd // heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _logits(q, k, heads, valid_k):
    d = q.shape[-1] // heads
    logits = torch.matmul(_heads(q, heads), _heads(k, heads).transpose(-1, -2)) * (d ** -0.5)
    if valid_k is not None and valid_k < k.shape[1]:
        logits[..., valid_k:] = -math.inf
    return logits


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, valid_k: Optional[int] = None,
                    want_lse: bool = False):
    """softmax(q k^T / sqrt(d)) v per head, in fp32; returns q's dtype (and
    the fp32 log-sum-exp ``(B, heads, S_q)`` with ``want_lse``)."""
    logits = _logits(q, k, heads, valid_k)
    out = _merge(torch.matmul(torch.softmax(logits, dim=-1), _heads(v, heads))).to(q.dtype)
    if want_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def attention_bwd_plain(q, k, v, o, lse, do, heads: int,
                        valid_k: Optional[int] = None):
    """dq, dk, dv of :func:`attention_plain` from the saved output and LSE,
    explicit fp32 formulas: ``P = exp(S - lse)``, ``dV = P^T dO``,
    ``dP = dO V^T``, ``dS = P (dP - rowsum(dO O))``, ``dQ = dS K / sqrt(d)``,
    ``dK = dS^T Q / sqrt(d)``."""
    scale = (q.shape[-1] // heads) ** -0.5
    p = torch.exp(_logits(q, k, heads, valid_k) - lse.float()[..., None])
    doh, oh = _heads(do, heads), _heads(o, heads)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dp = torch.matmul(doh, _heads(v, heads).transpose(-1, -2))
    ds = p * (dp - (doh * oh).sum(-1, keepdim=True))
    dq = torch.matmul(ds, _heads(k, heads)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q, heads)) * scale
    return _merge(dq).to(q.dtype), _merge(dk).to(k.dtype), _merge(dv).to(v.dtype)


def _kv_len(s_k, valid_k):
    kv_len = s_k if valid_k is None else min(int(valid_k), s_k)
    if kv_len < 1:
        raise ValueError("attention needs at least one valid key")
    return kv_len


def _check_qkv(q, k, v, heads):
    b, s_q, hd = q.shape
    s_k = k.shape[1]
    if hd != heads * HEAD_DIM:
        raise ValueError(f"K1 needs head_dim {HEAD_DIM}: got {hd} / {heads} heads")
    _build.check(q, "q", torch.bfloat16)
    _build.check(k, "k", torch.bfloat16, (b, s_k, hd))
    _build.check(v, "v", torch.bfloat16, (b, s_k, hd))


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int, valid_k: Optional[int] = None,
                      site: str = "spatial", want_lse: bool = False):
    """K1 on CUDA tensors (with the LSE output when ``want_lse``), the plain
    version on CPU tensors. Not differentiable: see :func:`attention_packed`."""
    if _build.on_cpu(q, k, v):
        return attention_plain(q, k, v, heads, valid_k, want_lse)
    _check_qkv(q, k, v, heads)
    b, s_q, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, heads, s_q, dtype=torch.float32, device=q.device) if want_lse else None
    _build.launch("vk_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), _build.ptr(lse), b, s_q, k.shape[1], heads,
                  _kv_len(k.shape[1], valid_k), (HEAD_DIM ** -0.5) * _LOG2E)
    _build.count("attention", site)
    return (out, lse) if want_lse else out


def attention_bwd(q, k, v, o, lse, do, heads: int, valid_k: Optional[int] = None,
                  site: str = "spatial"):
    """dq, dk, dv: ``csrc/attention_bwd.cu`` on CUDA tensors, the plain
    version on CPU tensors."""
    if _build.on_cpu(q, k, v, do):
        return attention_bwd_plain(q, k, v, o, lse, do, heads, valid_k)
    _check_qkv(q, k, v, heads)
    b, s_q, hd = q.shape
    s_k = k.shape[1]
    _build.check(o, "o", torch.bfloat16, (b, s_q, hd))
    _build.check(do, "do", torch.bfloat16, (b, s_q, hd))
    _build.check(lse, "lse", torch.float32, (b, heads, s_q))
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.launch("vk_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s_q, s_k, heads,
                  _kv_len(s_k, valid_k), HEAD_DIM ** -0.5)
    _build.count("attention_bwd", site)
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, valid_k, site):
        out, lse = attention_forward(q, k, v, heads, valid_k, site, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (heads, valid_k, site)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, valid_k: Optional[int] = None,
                     site: str = "spatial") -> torch.Tensor:
    """Non-causal attention; ``site`` names the caller in the launch counts.
    Differentiable when an input requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, heads, valid_k, site)
    return attention_forward(q, k, v, heads, valid_k, site)
