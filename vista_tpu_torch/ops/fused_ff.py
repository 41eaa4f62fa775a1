"""Pre-LN GEGLU feed-forward ``x + proj_out(geglu(proj_in(LN(x))))``.

Counterpart of ``vista_tpu/ops/fused_ff.py`` (``fused_geglu_ff``). The TPU
kernel kept both weights resident and ran the whole chain per token tile;
here it is two kernels: K2 with the GEGLU epilogue (LN -> proj_in -> a *
gelu(g), the 2x-wide proj_in output never written) and K3 (proj_out + bias
+ fp32 residual). The ``(tokens, 4c)`` GEGLU output is the one intermediate
in device memory. GELU is the exact erf form; the TPU kernel used tanh.
"""

from __future__ import annotations

import torch

from vista_tpu_torch.ops.linear import linear_residual, ln_linear


def fused_geglu_ff(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                   w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, eps: float = 1e-5,
                   site: str = "ff") -> torch.Tensor:
    """w1 (8c, c), b1 (8c), w2 (c, 4c), b2 (c) in Linear layout."""
    hg = ln_linear(x, ln_w.float(), ln_b.float(), w1, b1.float(), "geglu",
                   eps=eps, site=site)
    return linear_residual(hg, w2, b2.float(), x, site=site)
