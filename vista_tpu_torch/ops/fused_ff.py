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
the parameter grads nobody asked for.
"""

from __future__ import annotations

import torch

from vista_tpu_torch.ops import _build
from vista_tpu_torch.ops.linear import (column_sum, gelu_erf, linear_residual, ln_backward,
                                        ln_linear, seg_gemm, weight_grad)
from vista_tpu_torch.ops.norms import MAX_C, layer_norm_kernel, layer_norm_plain, ln_bwd_plain


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


def ff_bwd(x, ln_w, ln_b, w1, b1, w2, dy, eps=1e-5, needs=(True,) * 7,
           site: str = "ff"):
    """Gradients of the feed-forward w.r.t. (x, ln_w, ln_b, w1, b1, w2, b2);
    None where ``needs`` is false. CUDA tensors: ``csrc/ff_bwd.cu`` with the
    helpers of ``ops/linear.py`` (:func:`seg_gemm` for dxn, :func:`ln_backward`,
    the split-K weight grads and column sums)."""
    if _build.on_cpu(x, dy):
        grads = ff_bwd_plain(x, ln_w, ln_b, w1, b1, w2, dy, eps)
        return tuple(g if need else None for g, need in zip(grads, needs))
    c = x.shape[-1]
    m = x.numel() // c
    n = w2.shape[1]
    if c % 32 or c > MAX_C or n % 64:
        raise ValueError(f"ff_bwd needs c % 32 == 0, c <= {MAX_C}, inner % 64 == 0: {c}, {n}")
    _build.check(x, "x", torch.bfloat16)
    _build.check(dy, "dy", torch.bfloat16, x.shape)
    _build.check(w1, "w1", torch.bfloat16, (2 * n, c))
    _build.check(w2, "w2", torch.bfloat16, (c, n))
    bias1 = b1.float().contiguous()
    _build.check(bias1, "b1", torch.float32, (2 * n,))
    dev = x.device
    xn = layer_norm_kernel(x, ln_w, ln_b, eps, site=f"{site}-bwd")
    hg = torch.empty(m, n, dtype=x.dtype, device=dev)
    dh = torch.empty(m, 2 * n, dtype=x.dtype, device=dev)
    w2t = w2.t().contiguous()
    _build.launch("vk_ff_bwd_dh", xn.data_ptr(), dy.data_ptr(), w1.data_ptr(),
                  w2t.data_ptr(), bias1.data_ptr(), hg.data_ptr(), dh.data_ptr(), m, c, n)
    del w2t
    dxn = seg_gemm(dh.view(1, m, 2 * n), w1, torch.float32)
    want_ln = needs[1] or needs[2]
    dx, dln_w, dln_b = ln_backward(x, dxn, ln_w, dy, eps, want_ln)
    del dxn
    out = [dx, None, None, None, None, None, None]
    if want_ln:
        out[1], out[2] = dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype)
    dy2 = dy.reshape(m, c)
    if needs[3]:
        out[3] = weight_grad(dh, xn.reshape(m, c), dtype=w1.dtype)
    if needs[4]:
        out[4] = column_sum(dh).to(b1.dtype)
    if needs[5]:
        out[5] = weight_grad(dy2, hg, dtype=w2.dtype)
    if needs[6]:
        out[6] = column_sum(dy2)
    _build.count("ff_bwd", site)
    return tuple(out)


class _FeedForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps, site):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2)
        ctx.args = (eps, site, b2.dtype)
        return _forward(x, ln_w, ln_b, w1, b1, w2, b2, eps, site)

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, w1, b1, w2 = ctx.saved_tensors
        eps, site, b2_dtype = ctx.args
        grads = ff_bwd(x, ln_w, ln_b, w1, b1, w2, dy.contiguous(), eps,
                       ctx.needs_input_grad[:7], site)
        db2 = grads[6].to(b2_dtype) if grads[6] is not None else None
        return (*grads[:6], db2, None, None)


def fused_geglu_ff(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                   w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, eps: float = 1e-5,
                   site: str = "ff") -> torch.Tensor:
    """w1 (8c, c), b1 (8c), w2 (c, 4c), b2 (c) in Linear layout; differentiable."""
    x = x.contiguous()
    params = (ln_w, ln_b, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return _FeedForward.apply(x, *params, eps, site)
    return _forward(x, *params, eps, site)
