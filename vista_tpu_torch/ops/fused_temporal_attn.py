"""Temporal self-attention ``x + to_out(attn(to_qkv(LN(x))))`` over frames.

Counterpart of ``vista_tpu/ops/fused_temporal_attn.py``
(``fused_temporal_self_attn``), which ran the chain as one TPU kernel per
row group on t padded from 25 to 32, forward (``_kernel``) and backward
(``_bwd_kernel``). Both kept the four (c, inner) weights in VMEM: about 13
MB at c = 1280, far beyond a Hopper block's 227 KB of shared memory. So here
the chain is three kernels, each with its own backward:

- K2 split (LN + q/k/v), backward ``ln_linear_split_bwd`` (``csrc/qkv_bwd.cu``
  with ``csrc/ff_bwd.cu``'s LN backward and split-K weight gradients);
- K1 (per-head softmax over the t frame tokens, unpadded, with the LSE),
  backward ``csrc/attention_bwd.cu``;
- K3 (out-projection + bias + residual), backward ``linear_residual_bwd``
  (dWo, dbo and the attention output's cotangent).

x is ``(rows, t, c)``, one row per spatial location of a video.
"""

from __future__ import annotations

import torch

from vista_tpu_torch.ops.attention import attention_bwd_plain, attention_packed, attention_plain
from vista_tpu_torch.ops.fused_qkv import fused_ln_qkv
from vista_tpu_torch.ops.linear import (linear_residual, linear_residual_bwd_plain,
                                        ln_linear_plain, ln_linear_split_bwd_plain)


def fused_temporal_self_attn(x: torch.Tensor, ln_w: torch.Tensor,
                             ln_b: torch.Tensor, wq: torch.Tensor,
                             wk: torch.Tensor, wv: torch.Tensor,
                             wo: torch.Tensor, bo: torch.Tensor, heads: int,
                             eps: float = 1e-5) -> torch.Tensor:
    """Differentiable; weights in Linear layout."""
    q, k, v = fused_ln_qkv(x, ln_w, ln_b, wq, wk, wv, eps, site="temporal-qkv",
                           bwd_site="temporal")
    o = attention_packed(q, k, v, heads, site="temporal")
    return linear_residual(o, wo, bo.float(), x, site="temporal-out")


def fused_temporal_self_attn_bwd_plain(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, gy,
                                       eps=1e-5):
    """The VJP of :func:`fused_temporal_self_attn` in explicit fp32 formulas,
    the math of ``_bwd_kernel``: recompute LN and q/k/v, the attention and
    its LSE; then do = gy Wo, dWo = gyᵀ o, dbo = Σ gy; the softmax backward;
    the q/k/v and LN backward with gy added to dx (the residual). Returns
    (dx, dγ, dβ, dWq, dWk, dWv, dWo, dbo)."""
    w = torch.cat([wq, wk, wv], dim=0)
    q, k, v = ln_linear_plain(x, ln_w, ln_b, w, None, "split", 3, eps)
    o, lse = attention_plain(q, k, v, heads, want_lse=True)
    do, dwo, dbo = linear_residual_bwd_plain(o, wo, gy)
    dq, dk, dv = attention_bwd_plain(q, k, v, o, lse, do, heads)
    dx, dln_w, dln_b, dw = ln_linear_split_bwd_plain(x, ln_w, ln_b, w,
                                                     torch.stack([dq, dk, dv]), eps)
    return (dx + gy, dln_w, dln_b, *dw.split(wq.shape[0]), dwo, dbo.to(bo.dtype))
