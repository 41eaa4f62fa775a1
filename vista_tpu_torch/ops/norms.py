"""Row LayerNorm with fp32 statistics (counterpart of ``vista_tpu/ops/norms.py``).

On CUDA tensors :func:`layer_norm` launches the hand-written kernel
``csrc/layer_norm.cu`` (one warp per row, mean and ``E[x^2] - E[x]^2`` in
fp32, bf16 out); on CPU tensors it runs :func:`layer_norm_plain`. The JAX
package's backward is an XLA recompute of the formula, so the port's
backward is autograd through :func:`layer_norm_plain`, on either device.

Under LoRA this is the ``norm1`` of every spatial and temporal
self-attention (``vista_tpu/models/attention.py`` ``LayerNorm``); the
backward kernels of the feed-forward and of the fused q/k/v launch it to
recompute their normalised input.
"""

from __future__ import annotations

import torch

from vista_tpu_torch.ops import _build

MAX_C = 1280  # the row kernels (this one, ff_bwd's LN backward) hold a row in registers


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
    """The LayerNorm backward from ``dxn``, the fp32 cotangent of its output,
    in fp32: returns dx ``(rows, c)``, dγ and dβ. The formulas of the JAX
    backward kernels (``_qkv_bwd_kernel``, ``_ff_bwd_kernel``) and of
    ``csrc/ff_bwd.cu``'s ``ln_bwd``."""
    c = x.shape[-1]
    xf = x.float().reshape(-1, c)
    dxn = dxn.reshape(-1, c)
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0) + eps)
    xhat = (xf - mean) * rstd
    gx = dxn * ln_w.float()
    dx = rstd * (gx - gx.mean(-1, keepdim=True) - xhat * (gx * xhat).mean(-1, keepdim=True))
    return dx, (dxn * xhat).sum(0), dxn.sum(0)


def layer_norm_kernel(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                      eps: float = 1e-5, site: str = "attn") -> torch.Tensor:
    """The forward alone: kernel on CUDA tensors, plain version on CPU ones."""
    if _build.on_cpu(x):
        return layer_norm_plain(x, ln_w, ln_b, eps)
    c = x.shape[-1]
    if c % 8 or c > MAX_C:
        raise ValueError(f"layer_norm kernel needs c % 8 == 0 and c <= {MAX_C}, got {c}")
    _build.check(x, "x", torch.bfloat16)
    g, b = ln_w.float().contiguous(), ln_b.float().contiguous()
    _build.check(g, "ln_w", torch.float32, (c,))
    _build.check(b, "ln_b", torch.float32, (c,))
    out = torch.empty_like(x)
    _build.launch("vk_layer_norm", x.data_ptr(), g.data_ptr(), b.data_ptr(),
                  out.data_ptr(), x.numel() // c, c, float(eps))
    _build.count("layer_norm", site)
    return out


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, eps, site):
        ctx.save_for_backward(x, ln_w, ln_b)
        ctx.eps = eps
        return layer_norm_kernel(x, ln_w, ln_b, eps, site)

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_(need)
                    for t, need in zip((x, ln_w, ln_b), ctx.needs_input_grad)]
            y = layer_norm_plain(*args, ctx.eps)
            wanted = [a for a in args if a.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return (*[next(grads) if a.requires_grad else None for a in args], None, None)


def layer_norm(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
               eps: float = 1e-5, site: str = "attn") -> torch.Tensor:
    """``LN(x) * ln_w + ln_b`` over the last dim; differentiable."""
    x = x.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, ln_w, ln_b)):
        return _LayerNorm.apply(x, ln_w, ln_b, eps, site)
    return layer_norm_kernel(x, ln_w, ln_b, eps, site)
