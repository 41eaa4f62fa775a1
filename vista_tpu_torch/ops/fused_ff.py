"""Pre-LN GEGLU feed-forward ``x + proj_out(geglu(proj_in(LN(x))))``.

Counterpart of ``vista_tpu/ops/fused_ff.py`` (``fused_geglu_ff``). The TPU
kernel kept both weights resident and ran the whole chain per token tile;
here the forward is two kernels: K2 with the GEGLU epilogue (LN -> proj_in
-> a * gelu(g), the 2x-wide proj_in output never written) and K3 (proj_out
+ bias + fp32 residual). The ``(tokens, 4c)`` GEGLU output is the one
intermediate in device memory. GELU is the exact erf form; the TPU kernel
used tanh.

Backward (training): ``csrc/ff_bwd.cu`` on CUDA tensors, replacing the TPU
backward kernels ``_ff_bwd_kernel`` (c <= 640) and ``_ff_bwd_wide_kernel``
(c > 640) with one design for every width (see the source); on CPU tensors
:func:`ff_bwd_plain`. It returns dx, dγ, dβ, dW1, db1, dW2, db2 and skips
the parameter grads nobody asked for. Its first step, :func:`ff_bwd_dh`
(hg and dH = [da | dg] from xn and dy), runs on the TMA + ``wgmma`` GEMM
skeleton of ``csrc/gemm_tma.cuh``, launched as :func:`ff_bwd_dh_plan`
says; it reads W1 and W2 as stored.
"""

from __future__ import annotations

from typing import Optional

import torch

from vista_tpu_torch.ops import _build, remat
from vista_tpu_torch.ops.linear import (ALIGN_SLACK, BOX_BYTES, GEMM_TILE, TOKEN_BOX, GemmPlan,
                                        gelu_erf, linear_residual, ln_linear, seg_gemm,
                                        weight_bias_grads)
from vista_tpu_torch.ops.norms import (MAX_C, layer_norm_kernel, layer_norm_plain, ln_backward,
                                       ln_bwd_plain, sm_count)


def _forward(x, ln_w, ln_b, w1, b1, w2, b2, eps, site):
    hg = ln_linear(x, ln_w.float(), ln_b.float(), w1, b1.float(), "geglu",
                   eps=eps, site=site)
    return linear_residual(hg, w2, b2.float(), x, site=site)


def gelu_erf_grad(g: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(g * 0.7071067811865476)) + \
        g * 0.3989422804014327 * torch.exp(-0.5 * g * g)


def ff_bwd_plain(x, ln_w, ln_b, w1, b1, w2, dy, eps=1e-5):
    """Every gradient of the feed-forward, explicit fp32 formulas on the
    forward's roundings (xn and hg in x's dtype). Returns (dx, dγ, dβ, dW1,
    db1, dW2) in the dtypes of (x, ln_w, ln_b, w1, b1, w2), and db2 in fp32."""
    c = x.shape[-1]
    n = w2.shape[1]
    dyf = dy.float().reshape(-1, c)
    xn = layer_norm_plain(x.reshape(-1, c), ln_w, ln_b, eps).float()
    h = xn @ w1.float().t() + b1.float()
    a, g = h[:, :n], h[:, n:]
    ge = gelu_erf(g)
    hg = (a * ge).to(x.dtype).float()
    dhg = dyf @ w2.float()
    dh = torch.cat([dhg * ge, dhg * a * gelu_erf_grad(g)], dim=1)
    dx, dln_w, dln_b = ln_bwd_plain(x, dh @ w1.float(), ln_w, eps)
    return ((dx + dyf).to(x.dtype).reshape(x.shape), dln_w.to(ln_w.dtype),
            dln_b.to(ln_b.dtype), (dh.t() @ xn).to(w1.dtype), dh.sum(0).to(b1.dtype),
            (dyf.t() @ hg).to(w2.dtype), dyf.sum(0))


FB_TILE = (GEMM_TILE[0], 64)  # ff_bwd_dh's tile: 128 rows x 64 inner columns
FB_RING = 5  # its ring stages: A (16 KB) and W1's value + gate rows (16 KB)


def ff_bwd_dh_plan(m: int, c: int, n: int, sms: int = 132) -> GemmPlan:
    """``ff_bwd_dh``'s launch for m rows of width c and n = 4c inner
    columns: 128 x 64 tiles of hg (with the matching da and dg columns of
    dH), each summed over ceil(c / 64) stages of [a | g] and as many of dhg;
    a 5-stage ring of 32 KB and three 8 KB output boxes per consumer
    warpgroup. Raises on a shape the kernel does not take."""
    if m <= 0 or c <= 0 or c % 8 or n <= 0 or n % FB_TILE[1]:
        raise ValueError(f"ff_bwd_dh needs c % 8 == 0 and inner % 64 == 0: {m}, {c}, {n}")
    col_tiles = n // FB_TILE[1]
    items = -(-m // FB_TILE[0]) * col_tiles
    stage_bytes = 2 * BOX_BYTES + 2 * FB_TILE[1] * TOKEN_BOX * 2
    staging = 2 * 3 * BOX_BYTES
    smem = ALIGN_SLACK + FB_RING * stage_bytes + staging + 16 * FB_RING
    return GemmPlan(FB_TILE, col_tiles, items, min(items, sms), 2 * -(-c // TOKEN_BOX), FB_RING,
                    stage_bytes, staging, smem)


def ff_bwd_dh_plain(xn, dy, w1, b1, w2):
    """hg = a * gelu(g) and dH = [dhg * gelu(g) | dhg * a * gelu'(g)], with
    [a | g] = xn W1^T + b1 and dhg = dy W2, fp32 formulas, in xn's dtype."""
    n = w2.shape[1]
    h = xn.float() @ w1.float().t() + b1.float()
    a, g = h[:, :n], h[:, n:]
    ge = gelu_erf(g)
    dhg = dy.float() @ w2.float()
    dh = torch.cat([dhg * ge, dhg * a * gelu_erf_grad(g)], dim=1)
    return (a * ge).to(xn.dtype), dh.to(xn.dtype)


def ff_bwd_dh(xn, dy, w1, b1, w2, site: str = "ff"):
    """(hg, dH) of :func:`ff_bwd_dh_plain` for xn, dy (M, c) bf16, w1 (8c,
    c), w2 (c, 4c) bf16 as stored and b1 (8c) fp32 (``vk_ff_bwd_dh``); on
    CPU tensors the plain version."""
    if _build.on_cpu(xn, dy):
        return ff_bwd_dh_plain(xn, dy, w1, b1, w2)
    m, c = xn.shape
    n = w2.shape[1]
    plan = ff_bwd_dh_plan(m, c, n, sm_count(xn.device.index or 0))
    _build.check(xn, "xn", torch.bfloat16)
    _build.check(dy, "dy", torch.bfloat16, (m, c))
    _build.check(w1, "w1", torch.bfloat16, (2 * n, c))
    _build.check(w2, "w2", torch.bfloat16, (c, n))
    _build.check(b1, "b1", torch.float32, (2 * n,))
    hg = torch.empty(m, n, dtype=xn.dtype, device=xn.device)
    dh = torch.empty(m, 2 * n, dtype=xn.dtype, device=xn.device)
    _build.launch("vk_ff_bwd_dh", xn.data_ptr(), dy.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                  b1.data_ptr(), hg.data_ptr(), dh.data_ptr(), m, c, n, plan.grid)
    _build.count("ff_bwd_dh", site)
    return hg, dh


def ff_bwd(x, ln_w, ln_b, w1, b1, w2, dy, eps=1e-5, needs=(True,) * 7,
           site: str = "ff"):
    """Gradients of the feed-forward w.r.t. (x, ln_w, ln_b, w1, b1, w2, b2);
    None where ``needs`` is false. CUDA tensors: ``csrc/ff_bwd.cu`` with the
    helpers of ``ops/linear.py`` (:func:`seg_gemm` for dxn; the split-K weight
    grads, each launch with its bias gradient) and ``ops/norms.py`` (the xn
    recompute and :func:`ln_backward`)."""
    if _build.on_cpu(x, dy):
        grads = ff_bwd_plain(x, ln_w, ln_b, w1, b1, w2, dy, eps)
        return tuple(g if need else None for g, need in zip(grads, needs))
    c = x.shape[-1]
    m = x.numel() // c
    n = w2.shape[1]
    if c > MAX_C:
        raise ValueError(f"ff_bwd needs c <= {MAX_C}: {c}")
    _build.check(x, "x", torch.bfloat16)
    _build.check(dy, "dy", torch.bfloat16, x.shape)
    xn = layer_norm_kernel(x, ln_w, ln_b, eps, site=f"{site}-bwd")
    hg, dh = ff_bwd_dh(xn.view(m, c), dy.view(m, c), w1, b1.float().contiguous(), w2, site)
    dxn = seg_gemm(dh.view(1, m, 2 * n), w1, torch.float32)
    want_ln = needs[1] or needs[2]
    dx, dln_w, dln_b = ln_backward(x, dxn, ln_w, dy, eps, want_ln, site=f"{site}-bwd")
    del dxn
    out = [dx, None, None, None, None, None, None]
    if want_ln:
        out[1], out[2] = dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype)
    out[3], db1 = weight_bias_grads(dh, xn.reshape(m, c), w1.dtype, needs[3], needs[4])
    out[4] = db1.to(b1.dtype) if needs[4] else None
    out[5], out[6] = weight_bias_grads(dy.reshape(m, c), hg, w2.dtype, needs[5], needs[6])
    _build.count("ff_bwd", site)
    return tuple(out)


class _FeedForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps, site, tag):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2)
        ctx.args = (eps, site, b2.dtype)
        return remat.reuse(tag, lambda: _forward(x, ln_w, ln_b, w1, b1, w2, b2, eps, site))

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, w1, b1, w2 = ctx.saved_tensors
        eps, site, b2_dtype = ctx.args
        grads = ff_bwd(x, ln_w, ln_b, w1, b1, w2, dy.contiguous(), eps,
                       ctx.needs_input_grad[:7], site)
        db2 = grads[6].to(b2_dtype) if grads[6] is not None else None
        return (*grads[:6], db2, None, None, None)


def fused_geglu_ff(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                   w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, eps: float = 1e-5,
                   site: str = "ff", tag: Optional[str] = None) -> torch.Tensor:
    """w1 (8c, c), b1 (8c), w2 (c, 4c), b2 (c) in Linear layout; differentiable.
    ``tag``: a remat ``"names"`` site, whose recompute takes the output from
    the forward (:func:`~vista_tpu_torch.ops.remat.reuse`)."""
    x = x.contiguous()
    params = (ln_w, ln_b, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return _FeedForward.apply(x, *params, eps, site, tag)
    return _forward(x, *params, eps, site)
