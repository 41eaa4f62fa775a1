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

Backward (training), the JAX package's VJPs (``_emb_vjp_bwd``,
``_res_vjp_bwd`` and ``temporal_conv3``'s ``_vjp_bwd``): the affine + SiLU
is recomputed in plain PyTorch (XLA in JAX); the gradient of the conv input
is :func:`conv3` of the cotangent with flipped, transposed taps, on the
hand-written kernel ``vk_conv3`` (``csrc/gn_silu_conv3.cu`` without its
prologue, replacing ``_conv3_kernel``); the ``res`` epilogue's
``res_scale`` gradient recomputes y through the same kernel. dW is three
shifted contractions over all tokens (``torch.matmul``, XLA matmuls in
JAX); db and demb are row sums.
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


def conv3_plain(x, w, bias, num_frames):
    """``y[f] = sum_tap x[f + tap - 1] . W[tap] (+ bias)``, zero outside a
    video; fp32 math, x's dtype out."""
    bt, s, cin = x.shape
    cout = w.shape[0]
    xv = x.float().reshape(bt // num_frames, num_frames, s, cin)
    w3 = w.float().reshape(cout, cin, 3)
    y = torch.matmul(xv, w3[:, :, 1].t())
    y[:, 1:] += torch.matmul(xv[:, :-1], w3[:, :, 0].t())
    y[:, :-1] += torch.matmul(xv[:, 1:], w3[:, :, 2].t())
    y = y.reshape(bt, s, cout)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def conv3(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
          num_frames: int, site: str = "dx") -> torch.Tensor:
    """The plain 3-tap frame conv: x ``(b*t, s, cin)``, w ``(cout, cin, 3, 1,
    1)``, bias ``(cout,)`` or None. ``vk_conv3`` on CUDA tensors."""
    if _build.on_cpu(x, w):
        return conv3_plain(x, w, bias, num_frames)
    bt, s, cin = x.shape
    cout = w.shape[0]
    if bt % num_frames or cin % _TILE_K or cout % 8:
        raise ValueError(f"conv3 shape not supported: {tuple(x.shape)} -> {cout}")
    _build.check(x, "x", torch.bfloat16)
    wk = w.reshape(cout, cin, 3).permute(0, 2, 1).contiguous()
    _build.check(wk, "w", torch.bfloat16)
    if bias is not None:
        bias = bias.float().contiguous()
        _build.check(bias, "bias", torch.float32, (cout,))
    out = torch.empty(bt, s, cout, dtype=x.dtype, device=x.device)
    _build.launch("vk_conv3", x.data_ptr(), wk.data_ptr(), _build.ptr(bias),
                  out.data_ptr(), bt * s, s, num_frames, cin, cout)
    _build.count("conv3", site)
    return out


def _flipped_taps(w: torch.Tensor) -> torch.Tensor:
    """``(cout, cin, 3, 1, 1)`` -> ``(cin, cout, 3, 1, 1)`` with the taps
    reversed: the conv whose output is the input gradient."""
    return w.transpose(0, 1).flip(2).contiguous()


def _conv3_weight_grad(xn, gy, num_frames, shape):
    """dW[:, :, tap] = sum over tokens of gy[f]^T xn[f + tap - 1]."""
    bt, s, cin = xn.shape
    cout = gy.shape[-1]
    xv = xn.reshape(bt // num_frames, num_frames, s, cin)
    gv = gy.reshape(bt // num_frames, num_frames, s, cout)
    dot = lambda g, a: torch.matmul(g.reshape(-1, cout).t(), a.reshape(-1, cin)).float()
    dw = torch.stack([dot(gv[:, 1:], xv[:, :-1]), dot(gv, xv), dot(gv[:, :-1], xv[:, 1:])], -1)
    return dw.reshape(shape)


def conv3_vjp(x, w, gy, num_frames, needs=(True, True, True), site="dx"):
    """(dx, dw, db) of ``conv3(x, w, b)`` for the cotangent ``gy`` (None
    where not needed): dx on :func:`conv3` with flipped, transposed taps."""
    dx = conv3(gy, _flipped_taps(w), None, num_frames, site=site) if needs[0] else None
    dw = _conv3_weight_grad(x, gy, num_frames, w.shape).to(w.dtype) if needs[1] else None
    db = gy.float().sum((0, 1)) if needs[2] else None
    return dx, dw, db


def _gn_silu_bwd(ctx, saved, gy, site):
    """Shared VJP of ``conv3(silu(x * scale + shift)) + b``: returns dx,
    dscale, dshift, dw, db (None where not needed) and xn. ``saved`` is
    ``ctx.saved_tensors``, unpacked once by the caller."""
    x, scale, shift, w = saved[:4]
    nf = ctx.num_frames
    need = ctx.needs_input_grad
    a = x.float() * scale.float()[:, None] + shift.float()[:, None]
    sig = torch.sigmoid(a)
    xn = (a * sig).to(x.dtype)
    dx = dscale = dshift = None
    dxn, dw, db = conv3_vjp(xn, w, gy, nf, (need[0] or need[1] or need[2], need[3], need[4]),
                            site=f"{site}-dx")
    if dxn is not None:
        da = dxn.float() * sig * (1.0 + a * (1.0 - sig))
        if need[0]:
            dx = (da * scale.float()[:, None]).to(x.dtype)
        if need[1]:
            dscale = (da * x.float()).sum(1).to(scale.dtype)
        if need[2]:
            dshift = da.sum(1).to(shift.dtype)
    if db is not None:
        db = db.to(ctx.bias_dtype)
    return dx, dscale, dshift, dw, db, xn


class _GnSiluConv3Emb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, w, b, emb, num_frames):
        ctx.save_for_backward(x, scale, shift, w)
        ctx.num_frames, ctx.bias_dtype, ctx.emb_dtype = num_frames, b.dtype, emb.dtype
        return gn_silu_conv3(x, scale, shift, w, b.float(), num_frames, emb=emb.float(),
                             site="emb")

    @staticmethod
    def backward(ctx, gy):
        gy = gy.contiguous()
        dx, dscale, dshift, dw, db, _ = _gn_silu_bwd(ctx, ctx.saved_tensors, gy, "emb")
        demb = gy.float().sum(1).to(ctx.emb_dtype) if ctx.needs_input_grad[5] else None
        return dx, dscale, dshift, dw, db, demb, None


class _GnSiluConv3Res(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, w, b, residual, res_scale, num_frames):
        ctx.save_for_backward(x, scale, shift, w, b, res_scale)
        ctx.num_frames, ctx.bias_dtype = num_frames, b.dtype
        return gn_silu_conv3(x, scale, shift, w, b.float(), num_frames, residual=residual,
                             res_scale=res_scale.float(), site="res")

    @staticmethod
    def backward(ctx, gy):
        gy = gy.contiguous()
        saved = ctx.saved_tensors
        w, b, res_scale = saved[3:]
        gs = (res_scale.float() * gy.float()).to(gy.dtype)
        dx, dscale, dshift, dw, db, xn = _gn_silu_bwd(ctx, saved, gs, "res")
        dres = gy if ctx.needs_input_grad[5] else None
        drs = None
        if ctx.needs_input_grad[6]:
            y = conv3(xn, w, b, ctx.num_frames, site="res-y")
            drs = (gy.float() * y.float()).sum().reshape(res_scale.shape).to(res_scale.dtype)
        return dx, dscale, dshift, dw, db, dres, drs, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_gn_silu_conv3_emb(x, scale, shift, w, b, emb, num_frames):
    """``conv3(silu(x * scale + shift)) + b + emb[frame]``; differentiable."""
    if _wants_grad(x, scale, shift, w, b, emb):
        return _GnSiluConv3Emb.apply(x, scale, shift, w, b, emb, num_frames)
    return gn_silu_conv3(x, scale, shift, w, b.float(), num_frames, emb=emb.float(),
                         site="emb")


def fused_gn_silu_conv3_res(x, scale, shift, w, b, residual, res_scale,
                            num_frames):
    """``residual + res_scale * (conv3(silu(x * scale + shift)) + b)``: the
    temporal residual and the AlphaBlender ``a*x + (1-a)*(x+h)`` collapsed,
    with ``res_scale = 1 - a``; differentiable."""
    res_scale = res_scale.reshape(1)
    if _wants_grad(x, scale, shift, w, b, residual, res_scale):
        return _GnSiluConv3Res.apply(x, scale, shift, w, b, residual, res_scale, num_frames)
    return gn_silu_conv3(x, scale, shift, w, b.float(), num_frames, residual=residual,
                         res_scale=res_scale.float(), site="res")
