"""GroupNorm + SiLU + 3-tap frame convolution: kernel K4.

Counterpart of ``vista_tpu/ops/temporal_conv.py`` (``fused_gn_silu_conv3_emb``
and ``fused_gn_silu_conv3_res``) and of ``_gn_affine`` in
``vista_tpu/models/blocks.py``. The layout is the JAX package's frame-major
``(b*t, s, c)``: rows of one frame are contiguous, a video is ``t``
consecutive frames.

- :func:`gn_affine` folds the GroupNorm statistics of each video (over
  frames, tokens and the channels of a group, fp32, ``E[x^2] - E[x]^2``)
  into a per-(frame, channel) ``scale`` and ``shift``;
- :func:`gn_silu_conv3` computes ``conv3_t(SiLU(x * scale + shift)) + b``
  with the epilogue ``+ emb[frame]`` or ``residual + res_scale * y``. Taps
  that fall outside a video contribute nothing (the SAME zero padding).

The conv weight is in ``torch.nn.Conv3d`` layout ``(cout, cin, 3, 1, 1)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from vista_tpu_torch.ops import _build

_TILE_K = 32


def gn_affine(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              num_frames: int, eps: float = 1e-5):
    """x ``(b*t, s, c)`` -> fp32 ``scale``, ``shift`` of shape ``(b*t, c)``."""
    bt, s, c = x.shape
    b = bt // num_frames
    groups = 32 if c % 32 == 0 else math.gcd(c, 32)
    xf = x.float().reshape(b, num_frames * s, groups, c // groups)
    mean = xf.mean(dim=(1, 3))
    var = (xf * xf).mean(dim=(1, 3)) - mean * mean
    rstd = torch.rsqrt(var + eps)                              # (b, G)
    scale = rstd.repeat_interleave(c // groups, dim=-1) * gamma.float()
    shift = beta.float() - mean.repeat_interleave(c // groups, dim=-1) * scale
    expand = lambda a: a[:, None].expand(b, num_frames, c).reshape(bt, c)
    return expand(scale).contiguous(), expand(shift).contiguous()


def gn_silu_conv3_plain(x, scale, shift, w, bias, num_frames, emb=None,
                        residual=None, res_scale=None):
    bt, s, cin = x.shape
    cout = w.shape[0]
    b = bt // num_frames
    a = x.float() * scale.float()[:, None] + shift.float()[:, None]
    xn = F.silu(a).to(x.dtype).float().reshape(b, num_frames, s, cin)
    w3 = w.float().reshape(cout, cin, 3)
    y = torch.matmul(xn, w3[:, :, 1].t())
    y[:, 1:] += torch.matmul(xn[:, :-1], w3[:, :, 0].t())
    y[:, :-1] += torch.matmul(xn[:, 1:], w3[:, :, 2].t())
    y = y.reshape(bt, s, cout) + bias.float()
    if emb is not None:
        y = y + emb.float()[:, None]
    if residual is not None:
        y = residual.float() + res_scale.float() * y
    return y.to(x.dtype)


def gn_silu_conv3(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  w: torch.Tensor, bias: torch.Tensor, num_frames: int,
                  emb: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  res_scale: Optional[torch.Tensor] = None,
                  site: str = "emb") -> torch.Tensor:
    """x ``(b*t, s, cin)``, scale/shift ``(b*t, cin)``, w ``(cout, cin, 3, 1,
    1)``, bias ``(cout,)``, emb ``(b*t, cout)``, residual ``(b*t, s, cout)``
    with the 0-d or one-element ``res_scale``."""
    if (residual is None) != (res_scale is None):
        raise ValueError("residual and res_scale go together")
    if _build.on_cpu(x, w):
        return gn_silu_conv3_plain(x, scale, shift, w, bias, num_frames, emb,
                                   residual, res_scale)
    bt, s, cin = x.shape
    cout = w.shape[0]
    if bt % num_frames or cin % _TILE_K or cout % 8:
        raise ValueError(f"K4 shape not supported: {tuple(x.shape)} -> {cout}")
    _build.check(x, "x", torch.bfloat16)
    _build.check(scale, "scale", torch.float32, (bt, cin))
    _build.check(shift, "shift", torch.float32, (bt, cin))
    _build.check(bias, "bias", torch.float32, (cout,))
    wk = w.reshape(cout, cin, 3).permute(0, 2, 1).contiguous()
    _build.check(wk, "w", torch.bfloat16)
    if emb is not None:
        _build.check(emb, "emb", torch.float32, (bt, cout))
    if residual is not None:
        _build.check(residual, "residual", torch.bfloat16, (bt, s, cout))
        res_scale = res_scale.reshape(1)
        _build.check(res_scale, "res_scale", torch.float32, (1,))
    out = torch.empty(bt, s, cout, dtype=x.dtype, device=x.device)
    _build.launch("vk_gn_silu_conv3", x.data_ptr(), scale.data_ptr(),
                  shift.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                  _build.ptr(emb), _build.ptr(residual), _build.ptr(res_scale),
                  out.data_ptr(), bt * s, s, num_frames, cin, cout)
    _build.count("gn_silu_conv3", site)
    return out


def fused_gn_silu_conv3_emb(x, scale, shift, w, b, emb, num_frames):
    """``conv3(silu(x * scale + shift)) + b + emb[frame]``."""
    return gn_silu_conv3(x, scale, shift, w, b, num_frames, emb=emb, site="emb")


def fused_gn_silu_conv3_res(x, scale, shift, w, b, residual, res_scale,
                            num_frames):
    """``residual + res_scale * (conv3(silu(x * scale + shift)) + b)``: the
    temporal residual and the AlphaBlender ``a*x + (1-a)*(x+h)`` collapsed,
    with ``res_scale = 1 - a``."""
    return gn_silu_conv3(x, scale, shift, w, b, num_frames, residual=residual,
                         res_scale=res_scale, site="res")
