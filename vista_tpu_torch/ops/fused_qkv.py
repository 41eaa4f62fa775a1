"""Pre-LN q/k/v projection of a self-attention, on kernel K2.

Counterpart of ``vista_tpu/ops/fused_qkv.py`` (``fused_ln_qkv``): one pass
reads x, normalises it (fp32 statistics, eps 1e-5) and writes q, k, v, each
a contiguous ``(tokens..., inner)`` tensor in the packed-heads layout that
:func:`vista_tpu_torch.ops.attention.attention_packed` takes.
"""

from __future__ import annotations

import torch

from vista_tpu_torch.ops.linear import ln_linear


def fused_ln_qkv(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                 wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                 eps: float = 1e-5, site: str = "qkv"):
    """``(q, k, v) = to_{q,k,v}(LN(x))``; weights in Linear layout (inner, c)."""
    w = torch.cat([wq, wk, wv], dim=0)
    q, k, v = ln_linear(x, ln_w.float(), ln_b.float(), w, None, "split", 3,
                        eps, site)
    return q, k, v
