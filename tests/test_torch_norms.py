"""The port's layer_norm against the JAX package's Pallas LayerNorm
(``vista_tpu/ops/norms.py``, run in interpret mode on the CPU): forward and
``jax.vjp`` (an XLA recompute in JAX, ``ln_bwd_plain``'s explicit formulas
in the port), fp32, inputs made with numpy from a seed, on 2-D rows and on the
temporal ``(rows, 25, c)`` layout. Bound 1e-5 of each output's largest
magnitude (the same fp32 formula; sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vista_tpu.ops.norms import layer_norm as jax_layer_norm
from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu_torch.ops.norms import layer_norm


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("shape", [(96, 64), (12, 25, 32)])
def test_layer_norm_and_vjp_match_jax(shape):
    rng = np.random.default_rng(3)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jax_layer_norm(*a, eps=1e-5), *map(jnp.asarray, (x, g, b)))
    ref_grads = vjp(jnp.asarray(dy))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    out = layer_norm(tx, tg, tb, 1e-5)
    grads = torch.autograd.grad(out, (tx, tg, tb), torch.from_numpy(dy))
    assert _rel(out.detach().numpy(), ref) <= 1e-5
    for got, want in zip(grads, ref_grads):
        assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("shape", [(12, 25, 32)])
def test_lora_backward_matches_jax(shape, monkeypatch):
    """The LoRA call: a bf16-representable cotangent, γ and β frozen (no
    gradient asked for). dx against ``jax.vjp``'s, through ``ln_bwd_plain``
    on the CPU, bound 1e-5."""
    from vista_tpu_torch.ops import norms

    calls = []
    plain = norms.ln_bwd_plain
    monkeypatch.setattr(norms, "ln_bwd_plain", lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    rng = np.random.default_rng(4)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float()
    _, vjp = jax.vjp(lambda *a: jax_layer_norm(*a, eps=1e-5), *map(jnp.asarray, (x, g, b)))
    ref_dx = vjp(jnp.asarray(dy.numpy()))[0]
    tx = torch.from_numpy(x).requires_grad_()
    out = layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    (dx,) = torch.autograd.grad(out, (tx,), dy)
    assert calls == [1]
    assert _rel(dx.numpy(), ref_dx) <= 1e-5
