"""Pre-LN q/k/v projection of a self-attention, on kernel K2.

Counterpart of ``vista_tpu/ops/fused_qkv.py`` (``fused_ln_qkv``): one pass
reads x, normalises it (fp32 statistics, eps 1e-5) and writes q, k, v, each
a contiguous ``(tokens..., inner)`` view of one ``(3, tokens..., inner)``
tensor, in the packed-heads layout that
:func:`vista_tpu_torch.ops.attention.attention_packed` takes.

Differentiable: the backward is K2 split's (``ops/linear.py``
``ln_linear_split_bwd``, the port of ``_qkv_bwd_kernel``), which receives the
cotangent of q, k and v as the one ``(3, tokens..., inner)`` tensor.
"""

from __future__ import annotations

import torch

from vista_tpu_torch.ops.linear import ln_linear, ln_linear_split_bwd_plain


def fused_ln_qkv(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                 wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                 eps: float = 1e-5, site: str = "qkv", bwd_site: str = "spatial"):
    """``(q, k, v) = to_{q,k,v}(LN(x))``; weights in Linear layout (inner, c).
    ``site`` / ``bwd_site`` name the call site in the forward's / backward's
    launch counts."""
    w = torch.cat([wq, wk, wv], dim=0)
    qkv = ln_linear(x, ln_w.float(), ln_b.float(), w, None, "split", 3, eps, site,
                    bwd_site)
    return qkv.unbind(0)


def fused_ln_qkv_bwd_plain(x, ln_w, ln_b, wq, wk, wv, gq, gk, gv, eps=1e-5):
    """The VJP of :func:`fused_ln_qkv` in explicit fp32 formulas (the math of
    ``_qkv_bwd_kernel``): returns (dx, dγ, dβ, dWq, dWk, dWv)."""
    w = torch.cat([wq, wk, wv], dim=0)
    dx, dln_w, dln_b, dw = ln_linear_split_bwd_plain(x, ln_w, ln_b, w,
                                                     torch.stack([gq, gk, gv]), eps)
    return (dx, dln_w, dln_b, *dw.split(wq.shape[0]))
