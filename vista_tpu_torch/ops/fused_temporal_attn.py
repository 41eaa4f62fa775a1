"""Temporal self-attention ``x + to_out(attn(to_qkv(LN(x))))`` over frames.

Counterpart of ``vista_tpu/ops/fused_temporal_attn.py``
(``fused_temporal_self_attn``), which ran the chain as one TPU kernel per
row group on t padded from 25 to 32. Here it is K2 (LN + q/k/v), K1 (per-head
softmax over the t frame tokens, unpadded) and K3 (out-projection + bias +
residual). x is ``(rows, t, c)``, one row per spatial location of a video.
"""

from __future__ import annotations

import torch

from vista_tpu_torch.ops.attention import attention_packed
from vista_tpu_torch.ops.fused_qkv import fused_ln_qkv
from vista_tpu_torch.ops.linear import linear_residual


def fused_temporal_self_attn(x: torch.Tensor, ln_w: torch.Tensor,
                             ln_b: torch.Tensor, wq: torch.Tensor,
                             wk: torch.Tensor, wv: torch.Tensor,
                             wo: torch.Tensor, bo: torch.Tensor, heads: int,
                             eps: float = 1e-5) -> torch.Tensor:
    q, k, v = fused_ln_qkv(x, ln_w, ln_b, wq, wk, wv, eps, site="temporal-qkv")
    o = attention_packed(q, k, v, heads, site="temporal")
    return linear_residual(o, wo, bo.float(), x, site="temporal-out")
