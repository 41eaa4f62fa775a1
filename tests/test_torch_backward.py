"""The port's backward ops against ``jax.vjp`` of the JAX package's kernels,
which run in interpret mode on the CPU (their custom VJPs are the Pallas
backward kernels the port replaces). fp32 throughout, inputs and
cotangents made with numpy from a seed; each bound is on
max|port - JAX| / max|JAX| per output:

- attention: ``flash_attention_packed`` at s = 256 (its dQ and dK/dV
  kernels) and ``tiny_attention_packed`` at t = 25 (its row-group
  backward), against the port's autograd Function (plain backward on the
  CPU): 1e-4, the same fp32 math summed in another order;
- feed-forward: ``fused_geglu_ff`` at c = 64 (``_ff_bwd_kernel``) and at
  c = 704 with few rows (``_ff_bwd_wide_kernel``): 5e-3, because the TPU
  kernels use tanh GELU and the port erf; and 1e-4 against ``jax.vjp`` of
  the same chain written with erf GELU in jnp;
- ``temporal_conv3`` (``_conv3_kernel`` for dx) against ``conv3_vjp``: 1e-4,
  also with db asked alone or beside one of dx and dW (db comes out of the
  middle tap's weight-grad launches);
- ``fused_gn_silu_conv3_emb`` / ``_res`` (recompute + conv VJP) against the
  port's K4 Functions, every input's gradient: 1e-4;
- ``fused_ln_qkv`` (``_qkv_bwd_kernel``) at c = 64 over one token tile and
  over three, against the port's K2 split Function and against
  ``fused_ln_qkv_bwd_plain``: 1e-4, fp32 math summed in another order (the
  kernel accumulates tile by tile);
- ``fused_temporal_self_attn`` (``_bwd_kernel``) on x zero-padded from t =
  25 to 32 with ``valid_t = 25`` and a zero cotangent on the padded rows, as
  the JAX UNet runs it, against the port's K2 + K1 + K3 chain at t = 25 and
  against ``fused_temporal_self_attn_bwd_plain``: dx on the real frames and
  all eight parameter grads, 1e-4;
- K3's backward against ``jax.vjp`` of ``o @ wo + bo + x``: 1e-4, also
  with only the bias trained, or the bias and one other input.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vista_tpu.ops.flash_attention import flash_attention_packed
from vista_tpu.ops.fused_ff import fused_geglu_ff as jax_ff
from vista_tpu.ops.fused_qkv import fused_ln_qkv as jax_qkv
from vista_tpu.ops.fused_temporal_attn import fused_temporal_self_attn as jax_temporal
from vista_tpu.ops.temporal_conv import (fused_gn_silu_conv3_emb as jax_emb,
                                         fused_gn_silu_conv3_res as jax_res,
                                         temporal_conv3)
from vista_tpu.ops.tiny_attention import tiny_attention_packed
from vista_tpu_torch.ops.attention import attention_packed
from vista_tpu_torch.ops.fused_ff import fused_geglu_ff
from vista_tpu_torch.ops.fused_qkv import fused_ln_qkv, fused_ln_qkv_bwd_plain
from vista_tpu_torch.ops.fused_temporal_attn import (fused_temporal_self_attn,
                                                     fused_temporal_self_attn_bwd_plain)
from vista_tpu_torch.ops.linear import linear_residual
from vista_tpu_torch.ops.temporal_conv import (conv3_vjp, fused_gn_silu_conv3_emb,
                                               fused_gn_silu_conv3_res)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _port_grads(fn, arrays, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return out.detach().numpy(), [g.numpy() for g in
                                  torch.autograd.grad(out, ts, torch.from_numpy(cot))]


def _jax_grads(fn, arrays, cot):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("kind,b,s,heads", [("flash", 2, 256, 2), ("tiny", 6, 25, 2)])
def test_attention_backward_matches_jax(kind, b, s, heads):
    rng = np.random.default_rng(11)
    q, k, v, cot = (rng.standard_normal((b, s, heads * 64)).astype(np.float32) for _ in range(4))
    jfn = flash_attention_packed if kind == "flash" else tiny_attention_packed
    ref_out, ref = _jax_grads(lambda *a: jfn(*a, heads), (q, k, v), cot)
    out, got = _port_grads(lambda *a: attention_packed(*a, heads), (q, k, v), cot)
    assert _rel(out, ref_out) <= 1e-4
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-4


def _ff_erf_jax(x, ln_s, ln_b, w1, b1, w2, b2):
    inner = w2.shape[0]
    mean = jnp.mean(x, -1, keepdims=True)
    var = jnp.mean(x * x, -1, keepdims=True) - mean * mean
    xn = (x - mean) * jax.lax.rsqrt(var + 1e-5) * ln_s + ln_b
    h = xn @ w1 + b1
    hg = h[..., :inner] * jax.nn.gelu(h[..., inner:], approximate=False)
    return x + hg @ w2 + b2


@pytest.mark.parametrize("rows,c", [(48, 64), (16, 704)])
def test_ff_backward_matches_jax(rows, c):
    rng = np.random.default_rng(c)
    f32 = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    x, cot = f32(rows, c), f32(rows, c)
    ln_s, ln_b = 1 + f32(c, s=0.1), f32(c, s=0.1)
    w1, b1 = f32(c, 8 * c, s=c ** -0.5), f32(8 * c, s=0.1)
    w2, b2 = f32(4 * c, c, s=(4 * c) ** -0.5), f32(c, s=0.1)
    jargs = (x, ln_s, ln_b, w1, b1, w2, b2)
    targs = (x, ln_s, ln_b, np.ascontiguousarray(w1.T), b1, np.ascontiguousarray(w2.T), b2)
    out, got = _port_grads(fused_geglu_ff, targs, cot)
    got[3], got[5] = got[3].T, got[5].T  # Linear (out, in) -> JAX (in, out)
    for jfn, bound in ((jax_ff, 5e-3), (_ff_erf_jax, 1e-4)):
        ref_out, ref = _jax_grads(jfn, jargs, cot)
        assert _rel(out, ref_out) <= bound
        for g, r in zip(got, ref):
            assert _rel(g, r) <= bound


def _conv_data(seed, bt=10, s=8, cin=16, cout=24):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, sc=1.0: (rng.standard_normal(shape) * sc).astype(np.float32)
    return f32, f32(bt, s, cin), f32(3, cin, cout, sc=(3 * cin) ** -0.5), f32(cout, sc=0.1)


def _torch_w(w):
    """JAX taps (3, cin, cout) -> Conv3d (cout, cin, 3, 1, 1)."""
    return np.ascontiguousarray(w.transpose(2, 1, 0)[..., None, None])


def test_temporal_conv3_vjp_matches_jax():
    f32, x, w, b = _conv_data(1)
    nf = 5
    gy = f32(10, 8, 24)
    _, ref = _jax_grads(lambda *a: temporal_conv3(*a, nf), (x, w, b), gy)
    dx, dw, db = conv3_vjp(torch.from_numpy(x), torch.from_numpy(_torch_w(w)),
                           torch.from_numpy(gy), nf)
    assert _rel(dx.numpy(), ref[0]) <= 1e-4
    assert _rel(dw.numpy()[..., 0, 0].transpose(2, 1, 0), ref[1]) <= 1e-4
    assert _rel(db.numpy(), ref[2]) <= 1e-4


@pytest.mark.parametrize("needs", [(False, False, True), (True, False, True),
                                   (False, True, True)])
def test_temporal_conv3_bias_grad_matches_jax(needs):
    """db taken from the middle tap's weight-grad launches, with dW or
    without it (then only that tap runs, its dW dropped)."""
    f32, x, w, b = _conv_data(3)
    nf = 5
    gy = f32(10, 8, 24)
    _, ref = _jax_grads(lambda *a: temporal_conv3(*a, nf), (x, w, b), gy)
    dx, dw, db = conv3_vjp(torch.from_numpy(x), torch.from_numpy(_torch_w(w)),
                           torch.from_numpy(gy), nf, needs)
    assert (dx is not None) == needs[0] and (dw is not None) == needs[1]
    assert _rel(db.numpy(), ref[2]) <= 1e-4
    if needs[1]:
        assert _rel(dw.numpy()[..., 0, 0].transpose(2, 1, 0), ref[1]) <= 1e-4


@pytest.mark.parametrize("epilogue", ["emb", "res"])
def test_gn_silu_conv3_vjp_matches_jax(epilogue):
    f32, x, w, b = _conv_data(2, cout=16)
    nf = 5
    scale, shift, gy = f32(10, 16, sc=0.5), f32(10, 16, sc=0.5), f32(10, 8, 16)
    if epilogue == "emb":
        extra = (f32(10, 16),)
        jfn = lambda x, sc, sh, w, b, e: jax_emb(x, sc, sh, w, b, e, nf)
        tfn = lambda x, sc, sh, w, b, e: fused_gn_silu_conv3_emb(x, sc, sh, w, b, e, nf)
    else:
        extra = (f32(10, 8, 16), np.array(0.3, np.float32))
        jfn = lambda x, sc, sh, w, b, r, rs: jax_res(x, sc, sh, w, b, r, rs, nf)
        tfn = lambda x, sc, sh, w, b, r, rs: fused_gn_silu_conv3_res(x, sc, sh, w, b, r, rs, nf)
    ref_out, ref = _jax_grads(jfn, (x, scale, shift, w, b, *extra), gy)
    out, got = _port_grads(tfn, (x, scale, shift, _torch_w(w), b, *extra), gy)
    got[3] = got[3][..., 0, 0].transpose(2, 1, 0)
    assert _rel(out, ref_out) <= 1e-4
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-4


def _lin(w):
    """JAX (in, out) <-> torch Linear (out, in)."""
    return np.ascontiguousarray(w.T)


def _ln_params(f32, c):
    return 1 + f32(c, s=0.1), f32(c, s=0.1)


@pytest.mark.parametrize("rows", [64, 96])  # one token tile of 64; three of 32
def test_fused_ln_qkv_backward_matches_jax(rows):
    c = inner = 64
    rng = np.random.default_rng(rows)
    f32 = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    x = f32(2, rows // 2, c)
    ln_s, ln_b = _ln_params(f32, c)
    ws = [f32(c, inner, s=c ** -0.5) for _ in range(3)]
    cots = [f32(2, rows // 2, inner) for _ in range(3)]
    ref_out, vjp = jax.vjp(jax_qkv, *map(jnp.asarray, (x, ln_s, ln_b, *ws)))
    ref = vjp(tuple(map(jnp.asarray, cots)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, ln_s, ln_b, *map(_lin, ws))]
    out = fused_ln_qkv(*ts)
    got = torch.autograd.grad(out, ts, [torch.from_numpy(g) for g in cots])
    for o, r in zip(out, ref_out):
        assert _rel(o.detach().numpy(), r) <= 1e-4
    plain = fused_ln_qkv_bwd_plain(*(t.detach() for t in ts), *map(torch.from_numpy, cots))
    for grads in (got, plain):
        for i, (g, r) in enumerate(zip(grads, ref)):
            g = g.numpy().T if i >= 3 else g.numpy()
            assert _rel(g, r) <= 1e-4, i


def test_fused_temporal_self_attn_backward_matches_jax():
    rows, t, t_pad, heads = 6, 25, 32, 2
    c = inner = heads * 64
    rng = np.random.default_rng(12)
    f32 = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    x, cot = f32(rows, t, c), f32(rows, t, c)
    ln_s, ln_b = _ln_params(f32, c)
    wq, wk, wv, wo = (f32(c, inner, s=c ** -0.5) for _ in range(4))
    bo = f32(c, s=0.1)
    pad = ((0, 0), (0, t_pad - t), (0, 0))
    ref_out, ref = _jax_grads(
        lambda x, *p: jax_temporal(x, *p, heads, t), (np.pad(x, pad), ln_s, ln_b, wq, wk, wv,
                                                      wo, bo), np.pad(cot, pad))
    args = (x, ln_s, ln_b, _lin(wq), _lin(wk), _lin(wv), _lin(wo), bo)
    out, got = _port_grads(lambda x, *p: fused_temporal_self_attn(x, *p, heads), args, cot)
    plain = [g.numpy() for g in fused_temporal_self_attn_bwd_plain(
        *map(torch.from_numpy, args), heads, torch.from_numpy(cot))]
    assert _rel(out, ref_out[:, :t]) <= 1e-4
    for grads in (got, plain):
        assert _rel(grads[0], ref[0][:, :t]) <= 1e-4
        for i in range(1, 8):
            g = grads[i].T if 3 <= i <= 6 else grads[i]
            assert _rel(g, ref[i]) <= 1e-4, i


def test_linear_residual_backward_matches_jax():
    rng = np.random.default_rng(13)
    f32 = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    o, x, cot = f32(3, 40, 96), f32(3, 40, 64), f32(3, 40, 64)
    wo, bo = f32(96, 64, s=96 ** -0.5), f32(64, s=0.1)
    ref_out, ref = _jax_grads(lambda o, wo, bo, x: o @ wo + bo + x, (o, wo, bo, x), cot)
    out, got = _port_grads(linear_residual, (o, _lin(wo), bo, x), cot)
    got[1] = got[1].T
    assert _rel(out, ref_out) <= 1e-4
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-4


@pytest.mark.parametrize("trained", [("bo",), ("wo", "bo"), ("o", "bo")])
def test_linear_residual_bias_grad_matches_jax(trained):
    """K3's backward asked for the bias gradient with or without dW."""
    rng = np.random.default_rng(14)
    f32 = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    o, x, cot = f32(3, 40, 96), f32(3, 40, 64), f32(3, 40, 64)
    wo, bo = f32(96, 64, s=96 ** -0.5), f32(64, s=0.1)
    _, ref = _jax_grads(lambda o, wo, bo, x: o @ wo + bo + x, (o, wo, bo, x), cot)
    ref = dict(zip(("o", "wo", "bo", "x"), ref))
    ts = {k: torch.from_numpy(v).requires_grad_(k in trained)
          for k, v in (("o", o), ("wo", _lin(wo)), ("bo", bo), ("x", x))}
    out = linear_residual(ts["o"], ts["wo"], ts["bo"], ts["x"])
    got = torch.autograd.grad(out, [ts[k] for k in trained], torch.from_numpy(cot))
    for k, g in zip(trained, got):
        g = g.numpy().T if k == "wo" else g.numpy()
        assert _rel(g, ref[k]) <= 1e-4, k
