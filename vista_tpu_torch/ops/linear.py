"""LayerNorm-prologue and residual-epilogue GEMMs: kernels K2 and K3.

K2 ``ln_linear`` (``csrc/ln_linear.cu``): ``LN(x) @ W^T`` with fp32
LayerNorm statistics, and one of two epilogues:

- ``"split"``: the output columns are cut into ``splits`` equal parts,
  each written as its own contiguous tensor (q, k, v of a self-attention);
- ``"geglu"``: ``W`` holds ``[value; gate]`` rows and the kernel writes
  ``(LN(x) W_a^T + b_a) * gelu(LN(x) W_g^T + b_g)`` (exact erf GELU).

K3 ``linear_residual`` (``csrc/linear_residual.cu``): ``residual + a @ W^T +
b``, with the residual added to the fp32 accumulator.

Weights are in ``torch.nn.Linear`` layout ``(out, in)``. Activations keep
the JAX package's row layout ``(tokens..., c)``. On CUDA tensors each
wrapper launches its kernel (bf16 activations and weights, fp32 norm
parameters and bias) or raises; on CPU tensors it runs its plain version.

Neither has a backward of its own: inside the differentiable feed-forward
(``ops/fused_ff.py``) the gradient is ``csrc/ff_bwd.cu``; elsewhere (the
fused q/k/v of the LoRA-free self-attention, the phase-1 path) a call that
would need one raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from vista_tpu_torch.ops import _build
from vista_tpu_torch.ops.norms import layer_norm_plain

_TILE_K = 32  # the kernels' K step


def _no_grad_needed(*tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "K2/K3 have no backward outside the feed-forward: the LoRA-free "
            "(phase-1) training path is not ported")


def gelu_erf(g: torch.Tensor) -> torch.Tensor:
    return 0.5 * g * (1.0 + torch.erf(g * 0.7071067811865476))


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


def ln_linear(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
              w: torch.Tensor, bias: Optional[torch.Tensor] = None,
              epilogue: str = "split", splits: int = 1, eps: float = 1e-5,
              site: str = "qkv") -> torch.Tensor:
    """``"split"``: returns ``(splits, *x.shape[:-1], n // splits)``;
    ``"geglu"``: returns ``(*x.shape[:-1], n // 2)``, where ``n = w.shape[0]``."""
    if epilogue not in ("split", "geglu"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    _no_grad_needed(x, ln_w, ln_b, w, bias)
    if _build.on_cpu(x, w):
        return ln_linear_plain(x, ln_w, ln_b, w, bias, epilogue, splits, eps)
    lead, k = x.shape[:-1], x.shape[-1]
    m = x.numel() // k
    n_w = w.shape[0]
    if k % _TILE_K:
        raise ValueError(f"K2 needs c % {_TILE_K} == 0, got {k}")
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
    _build.launch("vk_ln_linear", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                  w.data_ptr(), _build.ptr(bias), out.data_ptr(), m, k, n, mode,
                  seg, float(eps))
    _build.count("ln_linear", site)
    return out


def linear_residual_plain(a, w, bias, residual):
    y = torch.matmul(a.float(), w.float().t()) + bias.float()
    return (residual.float() + y).to(residual.dtype)


def linear_residual(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    residual: torch.Tensor, site: str = "ff") -> torch.Tensor:
    """``residual + a @ w^T + bias``; a ``(..., k)``, residual ``(..., n)``."""
    _no_grad_needed(a, w, bias, residual)
    if _build.on_cpu(a, w, residual):
        return linear_residual_plain(a, w, bias, residual)
    k = a.shape[-1]
    m = a.numel() // k
    n = w.shape[0]
    if k % _TILE_K or n % 8:
        raise ValueError(f"K3 needs k % {_TILE_K} == 0 and n % 8 == 0: {k}, {n}")
    _build.check(a, "a", torch.bfloat16)
    _build.check(w, "w", torch.bfloat16, (n, k))
    _build.check(bias, "bias", torch.float32, (n,))
    _build.check(residual, "residual", torch.bfloat16, (*a.shape[:-1], n))
    out = torch.empty_like(residual)
    _build.launch("vk_linear_residual", a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                  residual.data_ptr(), out.data_ptr(), m, k, n)
    _build.count("linear_residual", site)
    return out
