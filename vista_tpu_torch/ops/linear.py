"""LayerNorm-prologue and residual-epilogue GEMMs: kernels K2 and K3, and
their backward passes.

K2 ``ln_linear`` (``csrc/ln_linear.cu``): ``LN(x) @ W^T`` with fp32
LayerNorm statistics, and one of two epilogues:

- ``"split"``: the output columns are cut into ``splits`` equal parts,
  written as one ``(splits, tokens..., n // splits)`` tensor (q, k, v of a
  self-attention);
- ``"geglu"``: ``W`` holds ``[value; gate]`` rows and the kernel writes
  ``(LN(x) W_a^T + b_a) * gelu(LN(x) W_g^T + b_g)`` (exact erf GELU).

K3 ``linear_residual`` (``csrc/linear_residual.cu``): ``residual + a @ W^T +
b``, with the bias and residual added to the fp32 accumulator; a persistent
TMA + ``wgmma`` kernel on the GEMM skeleton of ``csrc/gemm_tma.cuh`` (both
operands K-major as stored, 128 x 320 tiles, residual in and output out
through shared memory with TMA), launched as :func:`linear_residual_plan`
says.

Weights are in ``torch.nn.Linear`` layout ``(out, in)``. Activations keep
the JAX package's row layout ``(tokens..., c)``. On CUDA tensors each
wrapper launches its kernel (bf16 activations and weights, fp32 norm
parameters and bias) or raises; on CPU tensors it runs its plain version.

Backward (training), on CUDA tensors hand-written kernels, on CPU tensors
explicit fp32 formulas:

- K2 ``"split"`` (the fused q/k/v of the LoRA-free self-attentions, phase
  1): :func:`ln_linear_split_bwd`, replacing the TPU kernel
  ``_qkv_bwd_kernel`` — xn recomputed by the layer_norm kernel, dxn =
  Σᵢ gᵢ Wᵢ as one segmented GEMM (``csrc/qkv_bwd.cu``), the LN backward
  (``ln_bwd_kernel``, ``csrc/layer_norm.cu``) and the split-K weight
  gradients of ``csrc/ff_bwd.cu``;
- K3: :func:`linear_residual_bwd` — da = g W (``csrc/qkv_bwd.cu``), dW =
  gᵀa and db = colsum(g) in one launch (``csrc/ff_bwd.cu``), dresidual = g;
- K2 ``"geglu"`` has no backward of its own: inside the differentiable
  feed-forward (``ops/fused_ff.py``) the gradient is ``csrc/ff_bwd.cu``,
  and elsewhere a call that would need one raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from vista_tpu_torch.ops import _build
from vista_tpu_torch.ops.norms import (MAX_C, layer_norm_kernel, layer_norm_plain, ln_backward,
                                       ln_bwd_plain, sm_count)

_TILE_K = 32  # K2 and qkv_bwd take c % 32 == 0
_K2_MAX_K = 1984  # K2 stages gamma and beta in shared memory


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def gelu_erf(g: torch.Tensor) -> torch.Tensor:
    return 0.5 * g * (1.0 + torch.erf(g * 0.7071067811865476))


# ------------------------------------------------------- split-K weight grads

GEMM_TILE = (128, 320)  # output tile of vk_wgrad, vk_seg_gemm and K3 (csrc/gemm_tma.cuh)
TOKEN_BOX = 64  # depth of one ring stage: tokens in vk_wgrad, K in K3 and ff_bwd_dh
_STAGE_US = 1.0  # one 64-token stage of one tile: the plan's unit of cost
_HBM_BYTES_PER_US = 3.35e6  # the H100's memory rate, for the partials' cost


@functools.lru_cache(maxsize=None)
def wgrad_plan(m: int, n1: int, n2: int, segs: int = 1, sms: int = 132):
    """The split-K plan of ``vk_wgrad`` for ``a^T b``, a (segs, m, n1) and b
    (m, n2): (tile_n, splits, rows_per_split). The kernel's tile is 128 x
    ``tile_n`` (320: it covers n2 in ceil(n2 / 320) tiles, the UNet widths
    exactly). Every split but the last has ``rows_per_split`` tokens, a
    multiple of the 64-token TMA box, because TMA zero-fills only past m and
    a box must not reach into the next split; the last ends at m. The count
    weighs the rounds of a persistent grid of ``sms`` blocks over
    splits x tiles items (each 64-token stage of a tile costs about the
    same) against the fp32 partials written and read back."""
    tiles = segs * -(-n1 // GEMM_TILE[0]) * -(-n2 // GEMM_TILE[1])
    boxes = -(-m // TOKEN_BOX)
    best = None
    for want in range(1, min(boxes, 4 * sms) + 1):
        per = -(-boxes // want)
        splits = -(-boxes // per)
        cost = (-(-tiles * splits // sms) * per * _STAGE_US
                + 8 * splits * segs * n1 * n2 / _HBM_BYTES_PER_US)
        if best is None or cost < best[0]:
            best = (cost, splits, per * TOKEN_BOX)
    return GEMM_TILE[1], best[1], best[2]


# The skeleton's shared memory (csrc/gemm_tma.cuh): a stage of A (two 8 KB
# boxes) and B (five), 1024 bytes of slack for the 1024-byte alignment of
# the swizzled tiles, 16 bytes of barriers per ring stage.
BOX_BYTES = 64 * 64 * 2
STAGE_BYTES = 7 * BOX_BYTES
ALIGN_SLACK = 1024
K3_RING = 3  # ring stages of K3
K3_STG_BOXES = 3  # K3's residual/output boxes per consumer warpgroup


class GemmPlan(NamedTuple):
    """How a kernel on the GEMM skeleton is launched for one shape: ``grid``
    persistent blocks, block ``b`` taking work items ``b, b + grid, ...``;
    item ``i`` is the output tile of rows ``i // col_tiles * tile[0]`` and
    columns ``i % col_tiles * tile[1]`` (its rows and columns past the
    output are dropped), summed over ``stages`` 64-deep stages of a ring of
    ``ring`` stages of ``stage_bytes``; ``smem`` is the dynamic shared
    memory a block asks for."""
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
        """The (first row, first column) of each tile that ``block`` takes, in order."""
        return [(i // self.col_tiles * self.tile[0], i % self.col_tiles * self.tile[1])
                for i in range(block, self.items, self.grid)]


def linear_residual_plan(m: int, k: int, n: int, sms: int = 132) -> GemmPlan:
    """K3's launch for a (m, k) x (n, k)^T product: 128 x 320 tiles (the
    column tile fastest), ceil(k / 64) stages an item, a 3-stage ring and
    three 8 KB residual/output boxes per consumer warpgroup. Raises on a
    shape the kernel does not take (k and n multiples of 8: TMA's 16-byte
    row strides)."""
    if m <= 0 or k <= 0 or n <= 0 or k % 8 or n % 8:
        raise ValueError(f"K3 needs m, k, n > 0 and k % 8 == 0, n % 8 == 0: {m}, {k}, {n}")
    col_tiles = -(-n // GEMM_TILE[1])
    items = -(-m // GEMM_TILE[0]) * col_tiles
    staging = 2 * K3_STG_BOXES * BOX_BYTES
    smem = ALIGN_SLACK + K3_RING * STAGE_BYTES + staging + 16 * K3_RING + 8 * 2 * K3_STG_BOXES
    return GemmPlan(GEMM_TILE, col_tiles, items, min(items, sms), -(-k // TOKEN_BOX), K3_RING,
                    STAGE_BYTES, staging, smem)


class WgradLaunch(NamedTuple):
    """How ``vk_wgrad`` is launched for a (segs, m, n1) x (m, n2) product:
    ``splits`` token ranges of ``rows_per_split`` (:func:`wgrad_plan`);
    ``items`` = splits x segments x row tiles x column tiles, the column
    tile fastest, taken by ``grid`` persistent blocks; with more than one
    split, each split's fp32 partial is ``part_len`` floats (dW's
    ``segs * n1 * n2``, then db's ``segs * n1`` when asked)."""
    splits: int
    rows_per_split: int
    items: int
    grid: int
    part_len: int


def wgrad_launch(m: int, n1: int, n2: int, segs: int = 1, sms: int = 132,
                 want_db: bool = False) -> WgradLaunch:
    _, splits, per = wgrad_plan(m, n1, n2, segs, sms)
    items = splits * segs * -(-n1 // GEMM_TILE[0]) * -(-n2 // GEMM_TILE[1])
    return WgradLaunch(splits, per, items, min(items, sms),
                       segs * n1 * n2 + (segs * n1 if want_db else 0))


def weight_grad_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^T b`` in fp32: a (M, N1) or (segs, M, N1), b (M, N2); segments'
    products stacked as rows, (segs * N1, N2)."""
    a3 = a.float().reshape(-1, *a.shape[-2:])
    return (a3.transpose(1, 2) @ b.float()).reshape(-1, b.shape[-1])


def bias_grad_plain(a: torch.Tensor) -> torch.Tensor:
    """The bias gradient beside :func:`weight_grad_plain`: ``a``'s sum over
    its M rows in fp32, segments stacked, (segs * N1,)."""
    return a.float().reshape(-1, *a.shape[-2:]).sum(1).reshape(-1)


def weight_grad(a: torch.Tensor, b: torch.Tensor, dtype=torch.float32, want_db: bool = False):
    """``a^T b`` over all rows, summed in fp32, in one ``vk_wgrad`` launch: a
    (M, N1) or (segs, M, N1), b (M, N2) bf16. With segments, one launch
    computes every segment's product, stacked as rows (segs * N1, N2). The
    result is stored as ``dtype`` (fp32 or bf16). With ``want_db`` it
    returns ``(dW, db)``, db = a's column sums in fp32 (segs * N1,), summed
    by the same launch's products (a column of ones beside b)."""
    if _build.on_cpu(a, b):
        dw = weight_grad_plain(a, b).to(dtype)
        return (dw, bias_grad_plain(a)) if want_db else dw
    a3 = a.view(1, *a.shape) if a.dim() == 2 else a
    segs, m, n1 = a3.shape
    n2 = b.shape[-1]
    if n1 % 8 or n2 % 8 or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weight_grad needs N1 % 8 == 0, N2 % 8 == 0 and an fp32 or bf16 "
                         f"result: {n1}, {n2}, {dtype}")
    _build.check(a3, "a", torch.bfloat16)
    _build.check(b, "b", torch.bfloat16, (m, n2))
    plan = wgrad_launch(m, n1, n2, segs, sm_count(a.device.index or 0), want_db)
    dw = torch.empty(segs * n1, n2, dtype=dtype, device=a.device)
    db = torch.empty(segs * n1, dtype=torch.float32, device=a.device) if want_db else None
    part = barrier = None
    if plan.splits > 1:
        part = torch.empty(plan.splits, plan.part_len, dtype=torch.float32, device=a.device)
        barrier = _build.stream_ints("vk_wgrad", 2, a.device)  # the grid barrier's pair
    _build.launch("vk_wgrad", a3.data_ptr(), b.data_ptr(), _build.ptr(part), dw.data_ptr(),
                  _build.ptr(db), _build.ptr(barrier), m, n1, n2, segs, plan.splits,
                  plan.rows_per_split, plan.grid, int(dtype == torch.bfloat16))
    return (dw, db) if want_db else dw


def weight_bias_grads(a: torch.Tensor, b: torch.Tensor, dtype, need_dw: bool, need_db: bool):
    """(dW, db) of a layer whose output cotangent is ``a`` and input ``b``,
    None where not needed: one :func:`weight_grad` launch for both; db
    without dW comes from the same launch, its dW dropped."""
    if not need_db:
        return (weight_grad(a, b, dtype) if need_dw else None), None
    dw, db = weight_grad(a, b, dtype, want_db=True)
    return (dw if need_dw else None), db


def seg_gemm_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``Σ_s a[s] @ w[s*k:(s+1)*k]`` in fp32: a (segs, M, k), w (segs * k, N)."""
    segs, _, k = a.shape
    return (a.float() @ w.float().view(segs, k, -1)).sum(0)


def seg_gemm(a: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype):
    """``Σ_s a[s] @ w[s*k:(s+1)*k]`` (``csrc/qkv_bwd.cu``): a (segs, M, k)
    bf16, w (segs * k, N) bf16, a weight as stored (dxn = Σ gᵢ Wᵢ with W in
    Linear layout); returns (M, N) in fp32 or bf16."""
    if _build.on_cpu(a, w):
        return seg_gemm_plain(a, w).to(out_dtype)
    segs, m, k = a.shape
    n = w.shape[1]
    if k % 8 or n % 8 or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"seg_gemm needs k % 8 == 0, N % 8 == 0 and an fp32 or bf16 "
                         f"output: {k}, {n}, {out_dtype}")
    _build.check(a, "a", torch.bfloat16)
    _build.check(w, "w", torch.bfloat16, (segs * k, n))
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    _build.launch("vk_seg_gemm", a.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, segs, n,
                  int(out_dtype == torch.float32))
    return out


# ------------------------------------------------------------------- K2

def ln_linear_plain(x, ln_w, ln_b, w, bias=None, epilogue="split", splits=1,
                    eps=1e-5):
    xn = layer_norm_plain(x, ln_w, ln_b, eps)
    h = torch.matmul(xn.float(), w.float().t())
    if bias is not None:
        h = h + bias.float()
    if epilogue == "geglu":
        a, g = h.chunk(2, dim=-1)
        return (a * gelu_erf(g)).to(x.dtype)
    return h.to(x.dtype).unflatten(-1, (splits, -1)).movedim(-2, 0)


def _ln_linear(x, ln_w, ln_b, w, bias, epilogue, splits, eps, site):
    if _build.on_cpu(x, w):
        return ln_linear_plain(x, ln_w, ln_b, w, bias, epilogue, splits, eps)
    lead, k = x.shape[:-1], x.shape[-1]
    m = x.numel() // k
    n_w = w.shape[0]
    if k % _TILE_K or k > _K2_MAX_K:
        raise ValueError(f"K2 needs c % {_TILE_K} == 0 and c <= {_K2_MAX_K}, got {k}")
    _build.check(x, "x", torch.bfloat16)
    _build.check(w, "w", torch.bfloat16, (n_w, k))
    _build.check(ln_w, "ln_w", torch.float32, (k,))
    _build.check(ln_b, "ln_b", torch.float32, (k,))
    if bias is not None:
        _build.check(bias, "bias", torch.float32, (n_w,))
    if epilogue == "geglu":
        n = n_w // 2
        if n_w % 128 or bias is None:
            raise ValueError("geglu needs 2n rows with n % 64 == 0 and a bias")
        out = torch.empty(*lead, n, dtype=x.dtype, device=x.device)
        mode, seg = 1, n
    else:
        if n_w % splits or (n_w // splits) % 8:
            raise ValueError(f"cannot split {n_w} columns into {splits} parts")
        n, seg = n_w, n_w // splits
        out = torch.empty(splits, *lead, seg, dtype=x.dtype, device=x.device)
        mode = 0
    if m == 0:  # no rows (an empty band of height-parallel sampling): nothing to launch
        return out
    stats = torch.empty(m, 2, dtype=torch.float32, device=x.device)  # (mean, rstd) per row
    _build.launch("vk_ln_linear", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                  w.data_ptr(), _build.ptr(bias), stats.data_ptr(), out.data_ptr(), m, k, n,
                  mode, seg, float(eps))
    _build.count("ln_linear", site)
    return out


def ln_linear_split_bwd_plain(x, ln_w, ln_b, w, g, eps=1e-5):
    """Every gradient of K2 split, explicit fp32 formulas on the forward's
    rounding of xn: ``g`` is the cotangent of the ``(splits, tokens..., n /
    splits)`` output. Returns (dx, dγ, dβ, dW) in the dtypes of (x, ln_w,
    ln_b, w)."""
    c = x.shape[-1]
    splits = g.shape[0]
    # (splits, m, seg) -> (m, splits * seg): the columns of W's rows
    gm = g.float().reshape(splits, -1, g.shape[-1]).permute(1, 0, 2).reshape(-1, w.shape[0])
    xn = layer_norm_plain(x.reshape(-1, c), ln_w, ln_b, eps).float()
    dxn = gm @ w.float()
    dx, dln_w, dln_b = ln_bwd_plain(x, dxn, ln_w, eps)
    return (dx.to(x.dtype).reshape(x.shape), dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype),
            (gm.t() @ xn).to(w.dtype))


def ln_linear_split_bwd(x, ln_w, ln_b, w, g, eps=1e-5, needs=(True,) * 4,
                        site: str = "spatial"):
    """Gradients of K2 split w.r.t. (x, ln_w, ln_b, w), None where ``needs``
    is false; the port of ``_qkv_bwd_kernel``. CUDA tensors: the layer_norm
    kernel (xn), ``vk_seg_gemm`` (dxn, fp32), :func:`ln_backward` (dx, dγ,
    dβ), one ``vk_wgrad`` launch for every split's dW, summed into w's dtype;
    CPU tensors: the plain version."""
    if _build.on_cpu(x, g):
        grads = ln_linear_split_bwd_plain(x, ln_w, ln_b, w, g, eps)
        return tuple(t if need else None for t, need in zip(grads, needs))
    c = x.shape[-1]
    m = x.numel() // c
    splits, n_w = g.shape[0], w.shape[0]
    seg = n_w // splits
    if c % _TILE_K or c > MAX_C or seg % _TILE_K:
        raise ValueError(f"qkv_bwd needs c % 32 == 0, c <= {MAX_C}, n / splits % 32 == 0: "
                         f"{c}, {seg}")
    _build.check(x, "x", torch.bfloat16)
    _build.check(w, "w", torch.bfloat16, (n_w, c))
    _build.check(g, "g", torch.bfloat16, (splits, *x.shape[:-1], seg))
    out = [None, None, None, None]
    xn = layer_norm_kernel(x, ln_w, ln_b, eps, site=f"{site}-qkv-bwd") \
        if needs[3] else None
    g3 = g.view(splits, m, seg)
    if needs[0] or needs[1] or needs[2]:
        dxn = seg_gemm(g3, w, torch.float32)
        want_ln = needs[1] or needs[2]
        out[0], dln_w, dln_b = ln_backward(x, dxn, ln_w, None, eps, want_ln,
                                           site=f"{site}-qkv-bwd")
        del dxn
        if want_ln:
            out[1], out[2] = dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype)
    if needs[3]:
        out[3] = weight_grad(g3, xn.view(m, c), dtype=w.dtype)
    _build.count("qkv_bwd", site)
    return tuple(out)


class _LnLinearSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w, splits, eps, site, bwd_site):
        ctx.save_for_backward(x, ln_w, ln_b, w)
        ctx.args = (eps, bwd_site)
        return _ln_linear(x, ln_w, ln_b, w, None, "split", splits, eps, site)

    @staticmethod
    def backward(ctx, g):
        x, ln_w, ln_b, w = ctx.saved_tensors
        eps, bwd_site = ctx.args
        grads = ln_linear_split_bwd(x, ln_w, ln_b, w, g.contiguous(), eps,
                                    ctx.needs_input_grad[:4], bwd_site)
        return (*grads, None, None, None, None)


def ln_linear(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
              w: torch.Tensor, bias: Optional[torch.Tensor] = None,
              epilogue: str = "split", splits: int = 1, eps: float = 1e-5,
              site: str = "qkv", bwd_site: str = "spatial") -> torch.Tensor:
    """``"split"``: returns ``(splits, *x.shape[:-1], n // splits)``;
    ``"geglu"``: returns ``(*x.shape[:-1], n // 2)``, where ``n = w.shape[0]``.
    ``"split"`` without a bias is differentiable; its backward counts its
    launches under ``bwd_site``."""
    if epilogue not in ("split", "geglu"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if _needs_grad(x, ln_w, ln_b, w, bias):
        if epilogue == "geglu" or bias is not None:
            raise NotImplementedError(
                "K2 with the GEGLU epilogue or a bias has no backward of its own: "
                "use ops.fused_ff.fused_geglu_ff")
        return _LnLinearSplit.apply(x.contiguous(), ln_w, ln_b, w, splits, eps, site,
                                    bwd_site)
    return _ln_linear(x, ln_w, ln_b, w, bias, epilogue, splits, eps, site)


# ------------------------------------------------------------------- K3

def linear_residual_plain(a, w, bias, residual):
    y = torch.matmul(a.float(), w.float().t()) + bias.float()
    return (residual.float() + y).to(residual.dtype)


def _linear_residual(a, w, bias, residual, site):
    if _build.on_cpu(a, w, residual):
        return linear_residual_plain(a, w, bias, residual)
    k = a.shape[-1]
    m = a.numel() // k if k else 0
    n = w.shape[0]
    if a.shape[:-1].numel() == 0:  # no rows (an empty band of height-parallel sampling)
        return torch.empty_like(residual)
    plan = linear_residual_plan(m, k, n, sm_count(a.device.index or 0))
    _build.check(a, "a", torch.bfloat16)
    _build.check(w, "w", torch.bfloat16, (n, k))
    _build.check(bias, "bias", torch.float32, (n,))
    _build.check(residual, "residual", torch.bfloat16, (*a.shape[:-1], n))
    out = torch.empty_like(residual)
    _build.launch("vk_linear_residual", a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                  residual.data_ptr(), out.data_ptr(), m, k, n, plan.grid)
    _build.count("linear_residual", site)
    return out


def linear_residual_bwd_plain(a, w, g):
    """da, dW, db of ``residual + a W^T + b`` for the cotangent ``g``,
    explicit fp32 formulas, in the dtypes of (a, w) and fp32 (db); the
    residual's gradient is ``g`` itself."""
    n, k = w.shape
    gf = g.float().reshape(-1, n)
    da = (gf @ w.float()).to(a.dtype).reshape(*a.shape)
    return da, (gf.t() @ a.float().reshape(-1, k)).to(w.dtype), gf.sum(0)


def linear_residual_bwd(a, w, g, needs=(True,) * 3, site: str = "attn-out"):
    """(da, dW, db) of K3, None where ``needs`` is false. CUDA tensors:
    ``vk_seg_gemm`` (da, bf16) and one ``vk_wgrad`` launch (dW and db);
    CPU tensors: the plain version."""
    if _build.on_cpu(a, g):
        grads = linear_residual_bwd_plain(a, w, g)
        return tuple(t if need else None for t, need in zip(grads, needs))
    n, k = w.shape
    m = a.numel() // k
    _build.check(a, "a", torch.bfloat16)
    _build.check(w, "w", torch.bfloat16, (n, k))
    _build.check(g, "g", torch.bfloat16, (*a.shape[:-1], n))
    g2 = g.view(m, n)
    out = [None, None, None]
    if needs[0]:
        out[0] = seg_gemm(g2.view(1, m, n), w, torch.bfloat16).view(a.shape)
    out[1], out[2] = weight_bias_grads(g2, a.view(m, k), w.dtype, needs[1], needs[2])
    _build.count("linear_residual_bwd", site)
    return tuple(out)


class _LinearResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, bias, residual, site):
        ctx.save_for_backward(a, w)
        ctx.args = (site, bias.dtype)
        return _linear_residual(a, w, bias, residual, site)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        site, bias_dtype = ctx.args
        g = g.contiguous()
        da, dw, db = linear_residual_bwd(a, w, g, ctx.needs_input_grad[:3], site)
        db = db.to(bias_dtype) if db is not None else None
        return da, dw, db, g if ctx.needs_input_grad[3] else None, None


def linear_residual(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    residual: torch.Tensor, site: str = "ff") -> torch.Tensor:
    """``residual + a @ w^T + bias``; a ``(..., k)``, residual ``(..., n)``;
    differentiable."""
    if _needs_grad(a, w, bias, residual):
        return _LinearResidual.apply(a.contiguous(), w, bias, residual.contiguous(), site)
    return _linear_residual(a, w, bias, residual, site)
