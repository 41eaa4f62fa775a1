"""Row LayerNorm with fp32 statistics (counterpart of ``vista_tpu/ops/norms.py``)
and its backward.

On CUDA tensors :func:`layer_norm` launches the hand-written kernels of
``csrc/layer_norm.cu``: ``layer_norm_kernel`` forward (mean and ``E[x^2] -
E[x]^2`` in fp32, bf16 out) and ``ln_bwd_kernel`` backward; on CPU tensors
it runs :func:`layer_norm_plain` and :func:`ln_bwd_plain`, the explicit
formulas of the JAX package's backward (an XLA recompute there). Both
kernels walk rows in groups of lanes sized to the width on a persistent
grid, as :func:`ln_plan` says.

Under LoRA this is the ``norm1`` of every spatial and temporal
self-attention (``vista_tpu/models/attention.py`` ``LayerNorm``); the
backward kernels of the feed-forward and of the fused q/k/v launch the
forward to recompute their normalised input and :func:`ln_backward` for the
gradient through it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from vista_tpu_torch.ops import _build

MAX_C = 1280  # the row kernels hold a row in at most 32 lanes x 5 chunks of 8

# csrc/layer_norm.cu's launch constants (tests/test_torch_ln_plan.py reads them there)
LN_KMAX = 5  # chunks of 8 elements a lane holds at most
LN_CHUNK_BYTES = 32 * 16  # a 16-byte piece of every lane of a warp: one copy instruction
LN_BLOCKS_PER_SM = 2
LN_FWD_WARPS, LN_FWD_STAGES = 8, 4
LN_FWD_STAGE_BYTES = LN_KMAX * LN_CHUNK_BYTES  # x
LN_BWD_WARPS = 4
LN_BWD_STAGES = 2
LN_BWD_STAGE_BYTES = 4 * LN_KMAX * LN_CHUNK_BYTES  # x, dxn (up to fp32), dres
LN_FOLD = 16  # blocks whose partial dγ/dβ rows one block of the fold adds up
LN_COUNTERS = 64  # arrival counters of the fold, per stream


class LnPlan(NamedTuple):
    """How ``layer_norm_kernel`` (or ``ln_bwd_kernel``) walks m rows of c:
    ``lanes`` lanes a row, each holding ``chunks`` chunks of 8 elements
    (lane j of a row: chunks j, j + lanes, ...); a warp step is ``rows`` =
    32 / lanes consecutive rows, ``steps`` of them; ``grid`` persistent
    blocks of ``warps`` warps, warp w of the grid taking steps w, w + grid *
    warps, ...; each warp a ring of ``stages`` stages of ``stage_bytes`` in
    ``smem`` bytes of shared memory a block. The backward's fold adds the
    blocks' partial rows in ``groups`` groups of ``LN_FOLD``."""
    lanes: int
    chunks: int
    rows: int
    steps: int
    warps: int
    stages: int
    stage_bytes: int
    grid: int
    smem: int
    groups: int

    def walk(self, block: int, warp: int, m: int):
        """The (first row, rows) of each step that ``warp`` of ``block``
        takes, in order."""
        stride = self.grid * self.warps
        return [(t * self.rows, min(m, t * self.rows + self.rows) - t * self.rows)
                for t in range(block * self.warps + warp, self.steps, stride)]


@functools.lru_cache(maxsize=256)
def ln_plan(m: int, c: int, sms: int = 132, backward: bool = False) -> LnPlan:
    """The launch of the LayerNorm forward (or backward) for (m, c) rows:
    the fewest lanes a row (a power of 2) with at most ``LN_KMAX`` chunks a
    lane, C / 40 at the UNet's widths, and ``LN_BLOCKS_PER_SM`` blocks an SM
    or one block per ``warps`` steps, whichever is fewer. Raises on a shape
    the kernels do not take."""
    if m <= 0 or c <= 0 or c % 8 or c > MAX_C:
        raise ValueError(f"the LayerNorm kernels need m > 0, c % 8 == 0 and c <= {MAX_C}: "
                         f"{m}, {c}")
    chunks = c // 8
    lanes = 1
    while -(-chunks // lanes) > LN_KMAX:
        lanes *= 2
    rows = 32 // lanes
    steps = -(-m // rows)
    warps, stages, stage_bytes = ((LN_BWD_WARPS, LN_BWD_STAGES, LN_BWD_STAGE_BYTES) if backward
                                  else (LN_FWD_WARPS, LN_FWD_STAGES, LN_FWD_STAGE_BYTES))
    grid = min(-(-steps // warps), LN_BLOCKS_PER_SM * sms)
    return LnPlan(lanes, -(-chunks // lanes), rows, steps, warps, stages, stage_bytes, grid,
                  warps * stages * stage_bytes, -(-grid // LN_FOLD))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def layer_norm_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LN with fp32 statistics ``var = E[x^2] - E[x]^2`` (the JAX kernels'
    form), returned in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    xn = (xf - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    return xn.to(x.dtype)


def ln_bwd_plain(x: torch.Tensor, dxn: torch.Tensor, ln_w: torch.Tensor,
                 eps: float = 1e-5):
    """The LayerNorm backward from ``dxn``, the cotangent of its output, in
    fp32: returns dx ``(rows, c)``, dγ and dβ. The formulas of the JAX
    backward kernels (``_qkv_bwd_kernel``, ``_ff_bwd_kernel``) and of
    ``csrc/layer_norm.cu``'s ``ln_bwd_kernel``."""
    c = x.shape[-1]
    xf = x.float().reshape(-1, c)
    dxn = dxn.float().reshape(-1, c)
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0) + eps)
    xhat = (xf - mean) * rstd
    gx = dxn * ln_w.float()
    dx = rstd * (gx - gx.mean(-1, keepdim=True) - xhat * (gx * xhat).mean(-1, keepdim=True))
    return dx, (dxn * xhat).sum(0), dxn.sum(0)


def _check_params(ts, c: int) -> None:
    """γ (and β) in their own type, fp32 or bf16, the same for both."""
    for name, t in ts:
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != ts[0][1].dtype:
            raise TypeError(f"{name}: the LayerNorm kernels take fp32 or bf16 γ and β of one "
                            f"type, got {[t.dtype for _, t in ts]}")
        _build.check(t, name, t.dtype, (c,))


def layer_norm_kernel(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                      eps: float = 1e-5, site: str = "attn") -> torch.Tensor:
    """The forward alone: kernel on CUDA tensors, plain version on CPU ones.
    γ and β go to the kernel in their own type (fp32 or bf16)."""
    if _build.on_cpu(x):
        return layer_norm_plain(x, ln_w, ln_b, eps)
    c = x.shape[-1]
    _build.check(x, "x", torch.bfloat16)
    _check_params([("ln_w", ln_w), ("ln_b", ln_b)], c)
    out = torch.empty_like(x)
    if x.numel() == 0:  # no rows (an empty band of height-parallel sampling): nothing to launch
        return out
    plan = ln_plan(x.numel() // c, c, sm_count(x.device.index or 0))
    _build.launch("vk_layer_norm", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                  out.data_ptr(), x.numel() // c, c, plan.lanes, plan.grid,
                  int(ln_w.dtype == torch.bfloat16), float(eps))
    _build.count("layer_norm", site)
    return out


def ln_backward(x, dxn, ln_w, dres=None, eps=1e-5, want_ln=True, site: str = "ff"):
    """The gradient through ``LN(x)`` of its output's cotangent ``dxn`` (x
    and ``dxn`` of one shape, ``dxn`` fp32 or bf16): dx in x's dtype, plus
    ``dres`` (the cotangent of a residual of x) when given; with ``want_ln``
    also dγ and dβ in fp32. Returns (dx, dγ, dβ), None for the last two
    unless ``want_ln``.

    CUDA tensors: one ``ln_bwd_kernel`` launch (``vk_ln_bwd``), γ in its own
    type (fp32 or bf16); dγ and dβ come out of the same launch, the blocks'
    partial rows folded in an order fixed by the grid, so two calls give the
    same bits. The fold's arrival counters are kept per stream (a call on
    another stream gets its own). CPU tensors: :func:`ln_bwd_plain`."""
    c = x.shape[-1]
    m = x.numel() // c
    if _build.on_cpu(x, dxn, dres):
        dx, dln_w, dln_b = ln_bwd_plain(x, dxn, ln_w, eps)
        if dres is not None:
            dx = dx + dres.float().reshape(m, c)
        dx = dx.to(x.dtype).reshape(x.shape)
        return (dx, dln_w, dln_b) if want_ln else (dx, None, None)
    plan = ln_plan(m, c, sm_count(x.device.index or 0), backward=True)
    _build.check(x, "x", torch.bfloat16)
    if dxn.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dxn: expected fp32 or bf16, got {dxn.dtype}")
    _build.check(dxn, "dxn", dxn.dtype)
    if dxn.numel() != x.numel():
        raise ValueError(f"dxn: expected {tuple(x.shape)} elements, got {tuple(dxn.shape)}")
    if dres is not None:
        _build.check(dres, "dres", torch.bfloat16)
        if dres.numel() != x.numel():
            raise ValueError(f"dres: expected {tuple(x.shape)} elements, got {tuple(dres.shape)}")
    _check_params([("ln_w", ln_w)], c)
    dx = torch.empty_like(x)
    part = dln_w = dln_b = counters = None
    if want_ln:
        part = torch.empty((plan.grid + plan.groups) * 2 * c, dtype=torch.float32,
                           device=x.device)
        dln_w, dln_b = (torch.empty(c, dtype=torch.float32, device=x.device) for _ in range(2))
        counters = _build.stream_ints("ln_bwd", LN_COUNTERS, x.device)
    _build.launch("vk_ln_bwd", x.data_ptr(), dxn.data_ptr(), ln_w.data_ptr(), _build.ptr(dres),
                  dx.data_ptr(), _build.ptr(part), _build.ptr(dln_w), _build.ptr(dln_b),
                  _build.ptr(counters), m, c, plan.lanes, plan.grid,
                  int(dxn.dtype == torch.bfloat16), int(ln_w.dtype == torch.bfloat16),
                  float(eps))
    _build.count("ln_bwd", site)
    return dx, dln_w, dln_b


def ln_occupancy() -> dict:
    """Blocks an SM of each LayerNorm kernel instance at its launch (the
    card's occupancy calculator): the plan's ``LN_BLOCKS_PER_SM`` must fit."""
    out = (ctypes.c_int * 10)()
    rc = _build.lib().vk_ln_occupancy(ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"vk_ln_occupancy: CUDA error {rc}")
    names = ["layer_norm<fp32 γβ>", "layer_norm<bf16 γβ>"] + [
        f"ln_bwd<{g} γ, {d} dxn{', dγ/dβ' if want else ''}>"
        for g in ("fp32", "bf16") for d in ("fp32", "bf16") for want in (True, False)]
    return dict(zip(names, out))


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, eps, site):
        ctx.save_for_backward(x, ln_w, ln_b)
        ctx.args = (eps, site)
        return layer_norm_kernel(x, ln_w, ln_b, eps, site)

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b = ctx.saved_tensors
        eps, site = ctx.args
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dln_w, dln_b = ln_backward(x, dy.contiguous(), ln_w, None, eps, need_w or need_b,
                                       site)
        return (dx if need_x else None, dln_w.to(ln_w.dtype) if need_w else None,
                dln_b.to(ln_b.dtype) if need_b else None, None, None)


def layer_norm(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
               eps: float = 1e-5, site: str = "attn") -> torch.Tensor:
    """``LN(x) * ln_w + ln_b`` over the last dim; differentiable (the
    backward: :func:`ln_backward`)."""
    x = x.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, ln_w, ln_b)):
        return _LayerNorm.apply(x, ln_w, ln_b, eps, site)
    return layer_norm_kernel(x, ln_w, ln_b, eps, site)
