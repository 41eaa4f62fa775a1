"""Primitives of the plain reference: fp32 layers whose products can be
computed in a lower precision for the control.

Every product of the reference (linear layers, convolutions, the
attention's two products) takes its operands through :func:`operand`. In
fp32, the default, that is the identity. Under ``precision("fp8")`` each
operand is rounded to float8 e4m3 with one scale per tensor (its largest
magnitude mapped to 448, the format's largest), the step below bf16 that a
later change might take; the products and everything else stay fp32.
Gradients pass the rounding straight through. The sampler's state, which
the configurations keep in fp32, is rounded to bf16 under the control
(:func:`state`), the step below fp32. The setting is global to
the process, not to a thread, since the autograd engine recomputes
checkpointed blocks in threads of its own.

Products run with TF32 off (:func:`no_tf32`), so fp32 means fp32 on the
card too.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

_STATE = {"precision": "fp32"}
PRECISIONS = ("fp32", "fp8")
FP8_MAX = 448.0  # the largest float8 e4m3 value


@contextlib.contextmanager
def precision(name: str):
    """Compute the reference's products from operands rounded to ``name``."""
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}; one of {PRECISIONS}")
    saved, _STATE["precision"] = _STATE["precision"], name
    try:
        yield
    finally:
        _STATE["precision"] = saved


@contextlib.contextmanager
def no_tf32():
    """fp32 products and convolutions in full fp32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def operand(x: torch.Tensor) -> torch.Tensor:
    """A product's operand in the current precision (fp32 values out)."""
    if _STATE["precision"] == "fp32":
        return x
    scale = FP8_MAX / x.detach().abs().amax().float().clamp_min(1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach()) if x.requires_grad else q


def state(x: torch.Tensor) -> torch.Tensor:
    """The sampler's fp32 state (and its sigmas) in the current precision:
    under the control rounded to bf16 (fp32 values out)."""
    if _STATE["precision"] == "fp32":
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def linear(x, w, b=None):
    return F.linear(operand(x), operand(w), b)


class Linear(nn.Linear):
    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(operand(x), operand(self.weight), self.bias)


class Conv3d(nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(operand(x), operand(self.weight), self.bias)


class GroupNorm32(nn.GroupNorm):
    """32 groups (or the largest divisor of 32 that divides the width), fp32."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(32 if channels % 32 == 0 else math.gcd(channels, 32), channels, eps=eps)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, ``cos`` half first then ``sin``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def mlp(in_dim: int, out_dim: int) -> nn.Sequential:
    """Linear -> SiLU -> Linear."""
    return nn.Sequential(Linear(in_dim, out_dim), nn.SiLU(), Linear(out_dim, out_dim))


SCORES = 2 ** 27  # scores a block of queries may hold: bounds the (block, keys) matrices


def _blocks(q, k):
    """Query ranges whose scores over every key and head fit in ``SCORES``."""
    n = q.shape[-2]
    step = max(1, min(n, SCORES // (q.shape[0] * q.shape[1] * k.shape[-2])))
    return [(i, min(i + step, n)) for i in range(0, n, step)]


class _Attention(torch.autograd.Function):
    """softmax(q kᵀ / sqrt(d)) v over ``(batch, heads, s, d)`` in blocks of
    queries; the backward recomputes each block's probabilities from the
    saved log-sum-exp, so no (s, s) matrix is ever held whole."""

    @staticmethod
    def forward(ctx, q, k, v):
        scale = q.shape[-1] ** -0.5
        o = torch.empty_like(q)
        lse = q.new_empty(q.shape[:-1])
        for a, b in _blocks(q, k):
            s = torch.matmul(q[..., a:b, :], k.transpose(-1, -2)) * scale
            lse[..., a:b] = torch.logsumexp(s, dim=-1)
            o[..., a:b, :] = torch.matmul(torch.exp(s - lse[..., a:b, None]), v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale = q.shape[-1] ** -0.5
        dq, dk, dv = torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
        for a, b in _blocks(q, k):
            p = torch.exp(torch.matmul(q[..., a:b, :], k.transpose(-1, -2)) * scale
                          - lse[..., a:b, None])
            dob = do[..., a:b, :]
            dv += torch.matmul(p.transpose(-1, -2), dob)
            dp = torch.matmul(dob, v.transpose(-1, -2))
            ds = p * (dp - (dob * o[..., a:b, :]).sum(-1, keepdim=True))
            dq[..., a:b, :] = torch.matmul(ds, k) * scale
            dk += torch.matmul(ds.transpose(-1, -2), q[..., a:b, :]) * scale
        return dq, dk, dv


def attention(q, k, v, heads: int):
    """Multi-head attention on ``(b, s, heads * d)`` rows."""
    b, s, c = q.shape
    split = lambda t: operand(t).reshape(b, t.shape[1], heads, c // heads).transpose(1, 2)
    o = _Attention.apply(split(q), split(k), split(v))
    return o.transpose(1, 2).reshape(b, s, c)
