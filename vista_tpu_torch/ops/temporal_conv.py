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

On CUDA tensors (``csrc/gn_silu_conv3.cu``) K4 is two kernels: the pre-pass
``vk_gn_silu`` writes ``xn = bf16(SiLU(x * scale + shift))`` once, then
``conv3_tma_kernel`` (the entry ``vk_conv3``), a TMA + ``wgmma`` implicit
GEMM on the skeleton of ``csrc/gemm_tma.cuh``, sums the three taps of xn
with the epilogue. It reads xn through a 3-d map over (clips, rows, cin),
so the zero fill past a clip's ends is the conv's padding; it launches as
:func:`conv3_plan` says and takes cin % 64 == 0 and cout % 8 == 0.

Backward (training), the JAX package's VJPs (``_emb_vjp_bwd``,
``_res_vjp_bwd`` and ``temporal_conv3``'s ``_vjp_bwd``): the affine + SiLU
is recomputed in plain PyTorch (XLA in JAX); the gradient of the conv input
is :func:`conv3` of the cotangent with flipped, transposed taps, on the
same GEMM without an epilogue (replacing ``_conv3_kernel``); the ``res``
epilogue's ``res_scale`` gradient recomputes y through it. dW is three
shifted contractions over all tokens, summed in fp32 as the reference asks
(``weight_grad``: ``vk_wgrad``'s fixed-order fp32 sums); db comes out of
the middle tap's launches, whose A operand is each clip's whole cotangent;
demb is a row sum.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from vista_tpu_torch.ops import _build
from vista_tpu_torch.ops.linear import (ALIGN_SLACK, BOX_BYTES, GEMM_TILE, STAGE_BYTES,
                                        TOKEN_BOX, sm_count, weight_grad)

CONV3_RING = 3  # ring stages of conv3_tma_kernel
CONV3_STG_BOXES = 3  # its residual/output boxes per consumer warpgroup


class Conv3Plan(NamedTuple):
    """How ``conv3_tma_kernel`` is launched for ``clips`` clips of ``rows``
    = t s rows (``s`` a frame) and cin -> cout: ``grid`` persistent blocks,
    block ``b`` taking work items ``b, b + grid, ...``; item ``i`` is the
    output tile of clip ``i // col_tiles // panels``, rows ``i // col_tiles
    % panels * tile[0]`` of that clip (those past the clip are dropped) and
    columns ``i % col_tiles * tile[1]``, summed over ``stages`` 64-deep
    stages (``cin // 64`` a tap) of a ring of ``ring`` stages of
    ``stage_bytes``; ``smem`` is the dynamic shared memory a block asks for."""
    clips: int
    rows: int
    s: int
    cin: int
    panels: int
    tile: tuple
    col_tiles: int
    items: int
    grid: int
    stages: int
    ring: int
    stage_bytes: int
    staging_bytes: int
    smem: int

    def tiles(self, block: int):
        """The (clip, first row in the clip, first column) of each tile that
        ``block`` takes, in order."""
        return [(i // self.col_tiles // self.panels,
                 i // self.col_tiles % self.panels * self.tile[0],
                 i % self.col_tiles * self.tile[1])
                for i in range(block, self.items, self.grid)]

    def tap_row(self, row0: int, stage: int) -> int:
        """The first row, in the clip, of the A box of ``stage`` for a tile
        whose first row is ``row0``: the tap's frame offset times s. Rows
        outside ``[0, rows)`` arrive as zeros."""
        tap = stage // (self.cin // TOKEN_BOX)
        return row0 + (tap - 1) * self.s


def conv3_plan(b: int, t: int, s: int, cin: int, cout: int, sms: int = 132) -> Conv3Plan:
    """The launch of the 3-tap frame conv over ``b`` clips of ``t`` frames
    of ``s`` rows, cin -> cout: 128 x 320 tiles inside one clip (the column
    tile fastest), 3 cin / 64 stages an item, a 3-stage ring and three 8 KB
    residual/output boxes per consumer warpgroup, as K3. Raises on a shape
    the kernel does not take: cin % 64 (a stage inside one tap) and cout % 8
    (TMA's 16-byte row strides)."""
    if min(b, t, s, cin, cout) <= 0 or cin % TOKEN_BOX or cout % 8:
        raise ValueError(f"conv3 needs positive sizes, cin % 64 == 0 and cout % 8 == 0: "
                         f"b={b}, t={t}, s={s}, cin={cin}, cout={cout}")
    rows = t * s
    panels = -(-rows // GEMM_TILE[0])
    col_tiles = -(-cout // GEMM_TILE[1])
    items = b * panels * col_tiles
    staging = 2 * CONV3_STG_BOXES * BOX_BYTES
    smem = (ALIGN_SLACK + CONV3_RING * STAGE_BYTES + staging + 16 * CONV3_RING
            + 8 * 2 * CONV3_STG_BOXES)
    return Conv3Plan(b, rows, s, cin, panels, GEMM_TILE, col_tiles, items, min(items, sms),
                     3 * cin // TOKEN_BOX, CONV3_RING, STAGE_BYTES, staging, smem)


def gn_affine(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              num_frames: int, eps: float = 1e-5, group=None):
    """x ``(b*t, s, c)`` -> fp32 ``scale``, ``shift`` of shape ``(b*t, c)``.

    With ``group`` (frame or height parallelism: each rank holds its own
    tokens of every frame) the statistics are fp32 sums over this rank's tokens,
    summed over the group, then divided by the whole count. Sampling only:
    no gradient flows through the sum."""
    bt, s, c = x.shape
    b = bt // num_frames
    groups = 32 if c % 32 == 0 else math.gcd(c, 32)
    xf = x.float().reshape(b, num_frames * s, groups, c // groups)
    if group is None:
        mean = xf.mean(dim=(1, 3))
        var = (xf * xf).mean(dim=(1, 3)) - mean * mean
    else:
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError("frame-parallel GroupNorm statistics have no backward")
        sums = torch.stack([xf.sum(dim=(1, 3)), (xf * xf).sum(dim=(1, 3))])
        tokens = xf.new_full((1,), float(s))  # a fill on the device: no host copy to wait on
        stats = torch.cat([sums.reshape(-1), tokens])
        dist.all_reduce(stats, group=group)
        count = num_frames * (c // groups) * stats[-1]
        mean, sq = stats[:-1].view(2, b, groups) / count
        var = sq - mean * mean
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
    y = _taps(xn, w.float().reshape(cout, cin, 3)).reshape(bt, s, cout) + bias.float()
    if emb is not None:
        y = y + emb.float()[:, None]
    if residual is not None:
        y = residual.float() + res_scale.float() * y
    return y.to(x.dtype)


def gn_silu_plain(x, scale, shift):
    """``bf16(SiLU(x * scale + shift))`` per (frame, channel), fp32 math."""
    a = x.float() * scale.float()[:, None] + shift.float()[:, None]
    return F.silu(a).to(x.dtype)


def gn_silu(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
            site: str = "emb") -> torch.Tensor:
    """K4's pre-pass: x ``(b*t, s, c)``, scale/shift ``(b*t, c)`` fp32 ->
    xn like x (``vk_gn_silu`` on CUDA tensors)."""
    if _build.on_cpu(x, scale, shift):
        return gn_silu_plain(x, scale, shift)
    bt, s, c = x.shape
    if c % 8 or c > 8192 or bt > 65535:
        raise ValueError(f"gn_silu shape not supported: {tuple(x.shape)}")
    _build.check(x, "x", torch.bfloat16)
    _build.check(scale, "scale", torch.float32, (bt, c))
    _build.check(shift, "shift", torch.float32, (bt, c))
    xn = torch.empty_like(x)
    _build.launch("vk_gn_silu", x.data_ptr(), scale.data_ptr(), shift.data_ptr(), xn.data_ptr(),
                  bt, s, c)
    _build.count("gn_silu", site)
    return xn


def _plan(x, w, num_frames) -> Conv3Plan:
    bt, s, cin = x.shape
    if bt % num_frames:
        raise ValueError(f"{bt} frames are not clips of {num_frames}")
    return conv3_plan(bt // num_frames, num_frames, s, cin, w.shape[0],
                      sm_count(x.device.index or 0))


def _conv3_launch(plan, x, w, bias, emb=None, residual=None, res_scale=None):
    """``vk_conv3`` as ``plan`` says: x ``(b*t, s, cin)`` bf16, w ``(cout,
    cin, 3, 1, 1)``; bias fp32 or None; the EMB (``emb``) or RES
    (``residual``, ``res_scale``) epilogue or neither."""
    bt, s, cin = x.shape
    cout = w.shape[0]
    _build.check(x, "x", torch.bfloat16)
    wk = w.reshape(cout, cin, 3).permute(0, 2, 1).contiguous()
    _build.check(wk, "w", torch.bfloat16)
    if bias is not None:
        _build.check(bias, "bias", torch.float32, (cout,))
    if emb is not None:
        _build.check(emb, "emb", torch.float32, (bt, cout))
    if residual is not None:
        _build.check(residual, "residual", torch.bfloat16, (bt, s, cout))
        _build.check(res_scale, "res_scale", torch.float32, (1,))
    out = torch.empty(bt, s, cout, dtype=x.dtype, device=x.device)
    _build.launch("vk_conv3", x.data_ptr(), wk.data_ptr(), _build.ptr(bias), _build.ptr(emb),
                  _build.ptr(residual), _build.ptr(res_scale), out.data_ptr(), plan.clips,
                  plan.rows // s, s, cin, cout, plan.grid, plan.smem)
    return out


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
    if emb is not None and residual is not None:
        raise ValueError("one epilogue: emb or residual")
    if _build.on_cpu(x, w):
        return gn_silu_conv3_plain(x, scale, shift, w, bias, num_frames, emb,
                                   residual, res_scale)
    if x.shape[1] == 0:  # no rows (an empty band of height-parallel sampling): nothing to launch
        return x.new_empty(*x.shape[:2], w.shape[0])
    plan = _plan(x, w, num_frames)  # refuses a shape before any launch
    if res_scale is not None:
        res_scale = res_scale.reshape(1)
    xn = gn_silu(x, scale, shift, site)
    out = _conv3_launch(plan, xn, w, bias, emb, residual, res_scale)
    _build.count("gn_silu_conv3", site)
    return out


def _taps(xv, w3):
    """``y[f] = xv[f] W1 + xv[f - 1] W0 + xv[f + 1] W2`` over ``(b, t, s, cin)``,
    zero outside a video, added in that order. Out of place: a selective
    checkpoint (``ops/remat.py``, ``"dots"``) keeps the products' outputs."""
    y = torch.matmul(xv, w3[:, :, 1].t())
    y = torch.cat([y[:, :1], y[:, 1:] + torch.matmul(xv[:, :-1], w3[:, :, 0].t())], dim=1)
    return torch.cat([y[:, :-1] + torch.matmul(xv[:, 1:], w3[:, :, 2].t()), y[:, -1:]], dim=1)


def conv3_plain(x, w, bias, num_frames):
    """``y[f] = sum_tap x[f + tap - 1] . W[tap] (+ bias)``, zero outside a
    video; fp32 math, x's dtype out."""
    bt, s, cin = x.shape
    cout = w.shape[0]
    xv = x.float().reshape(bt // num_frames, num_frames, s, cin)
    y = _taps(xv, w.float().reshape(cout, cin, 3)).reshape(bt, s, cout)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def conv3(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
          num_frames: int, site: str = "dx") -> torch.Tensor:
    """The plain 3-tap frame conv: x ``(b*t, s, cin)``, w ``(cout, cin, 3, 1,
    1)``, bias ``(cout,)`` or None. ``vk_conv3`` (no epilogue) on CUDA
    tensors."""
    if _build.on_cpu(x, w):
        return conv3_plain(x, w, bias, num_frames)
    plan = _plan(x, w, num_frames)
    if bias is not None:
        bias = bias.float().contiguous()
    out = _conv3_launch(plan, x, w, bias)
    _build.count("conv3", site)
    return out


def _flipped_taps(w: torch.Tensor) -> torch.Tensor:
    """``(cout, cin, 3, 1, 1)`` -> ``(cin, cout, 3, 1, 1)`` with the taps
    reversed: the conv whose output is the input gradient."""
    return w.transpose(0, 1).flip(2).contiguous()


def _conv3_weight_grad(xn, gy, num_frames, shape, want_db=False, want_dw=True):
    """dW[:, :, tap] = sum over tokens of gy[f]^T xn[f + tap - 1], in fp32
    (:func:`weight_grad`, per clip and tap on its contiguous rows, the
    clips' sums added in order). With ``want_db`` also db = gy's sum over
    tokens in fp32, from the middle tap's launches (their A operand is each
    clip's whole gy), the clips' sums added in order; returns (dW, db), dW
    None without ``want_dw`` (then only the middle tap runs, its dW
    dropped)."""
    bt, s, cin = xn.shape
    cout = gy.shape[-1]
    n = num_frames * s
    xv, gv = xn.reshape(-1, n, cin), gy.reshape(-1, n, cout)
    # (gy rows, xn rows) of each tap: tap 0 pairs gy's frames 1.. with xn's ..t-2
    spans = [((s, n), (0, n - s)), ((0, n), (0, n)), ((0, n - s), (s, n))]
    taps, db = [], None
    for tap, ((g0, g1), (x0, x1)) in enumerate(spans):
        middle = want_db and tap == 1
        if not (want_dw or middle):
            continue
        dw = torch.zeros(cout, cin, dtype=torch.float32, device=xn.device)
        if g1 > g0:
            for c in range(xv.shape[0]):
                if middle:
                    d, b = weight_grad(gv[c], xv[c], want_db=True)
                    db = b if db is None else db + b
                else:
                    d = weight_grad(gv[c, g0:g1], xv[c, x0:x1])
                if want_dw:
                    dw += d
        taps.append(dw)
    dw = torch.stack(taps, -1).reshape(shape) if want_dw else None
    return (dw, db) if want_db else dw


def conv3_vjp(x, w, gy, num_frames, needs=(True, True, True), site="dx"):
    """(dx, dw, db) of ``conv3(x, w, b)`` for the cotangent ``gy`` (None
    where not needed): dx on :func:`conv3` with flipped, transposed taps;
    dw and db from the same :func:`weight_grad` launches."""
    dx = conv3(gy, _flipped_taps(w), None, num_frames, site=site) if needs[0] else None
    dw = db = None
    if needs[2]:
        dw, db = _conv3_weight_grad(x, gy, num_frames, w.shape, want_db=True, want_dw=needs[1])
    elif needs[1]:
        dw = _conv3_weight_grad(x, gy, num_frames, w.shape)
    if dw is not None:
        dw = dw.to(w.dtype)
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
