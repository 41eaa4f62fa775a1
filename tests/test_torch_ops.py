"""The PyTorch port's ops (plain versions, CPU) against the JAX package's
kernel entries (Pallas in interpret mode on the CPU) and their XLA
references, on the same fp32 inputs made with numpy from a seed.

Weights cross in their framework's layout: the JAX entries take ``(in,
out)`` kernels, the port ``torch.nn.Linear`` ``(out, in)`` weights and
``Conv3d`` ``(cout, cin, 3, 1, 1)`` kernels.

Tolerances: fp32 on both sides, so the port holds to 1e-4 (absolute and
relative) wherever both compute the same function. The one stated
exception is the feed-forward against the TPU kernel, which uses tanh-form
GELU where the port (and upstream, and the JAX composed path) uses the
exact erf form: there the bound is 5e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vista_tpu.ops import flash_attention as jfa
from vista_tpu.ops import fused_ff as jff
from vista_tpu.ops import fused_qkv as jqkv
from vista_tpu.ops import fused_temporal_attn as jta
from vista_tpu.ops import temporal_conv as jtc
from vista_tpu.ops import tiny_attention as jtiny
from vista_tpu_torch.ops.attention import attention_forward, attention_packed
from vista_tpu_torch.ops.fused_ff import fused_geglu_ff
from vista_tpu_torch.ops.fused_qkv import fused_ln_qkv
from vista_tpu_torch.ops.fused_temporal_attn import fused_temporal_self_attn
from vista_tpu_torch.ops.temporal_conv import (fused_gn_silu_conv3_emb,
                                               fused_gn_silu_conv3_res, gn_affine)

TOL = dict(atol=1e-4, rtol=1e-4)
TANH_GELU_TOL = dict(atol=5e-3, rtol=5e-3)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("s_q,s_k", [(2048, 2048), (2100, 2100), (2304, 2432)])
def test_attention_matches_flash(s_q, s_k):
    """Long sequences (the JAX flash kernel's range, s >= 2048), including
    lengths that are not a multiple of 128 and s_q != s_k."""
    rng = np.random.default_rng(0)
    heads, d = 2, 64
    q, k, v = (_rand(rng, 1, s, heads * d) for s in (s_q, s_k, s_k))
    port = attention_packed(_t(q), _t(k), _t(v), heads)
    _close(port, jfa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), heads))
    ref = jfa._xla_reference(*(jnp.asarray(a).reshape(1, -1, heads, d) for a in (q, k, v)))
    _close(port, np.asarray(ref).reshape(1, s_q, heads * d))


def test_attention_lse_matches_flash():
    """The training forward's log-sum-exp, the residual the backward kernels
    read, against the JAX flash kernel's (interpret mode) at a ragged size:
    fp32 on both sides, both within 1e-5 (they differ by about 5e-7)."""
    rng = np.random.default_rng(4)
    b, s, heads = 2, 130, 2
    q, k, v = (_rand(rng, b, s, heads * 64) for _ in range(3))
    out, lse = attention_forward(_t(q), _t(k), _t(v), heads, want_lse=True)
    ref_out, ref_lse = jfa._flash_fwd_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             heads, interpret=True, want_lse=True)
    assert lse.shape == (b, heads, s) and ref_lse.shape == (b, heads, s, 1)
    tol = dict(atol=1e-5, rtol=1e-5)
    _close(out, ref_out, tol)
    _close(lse, np.asarray(ref_lse)[..., 0], tol)


@pytest.mark.parametrize("s,heads", [(25, 5), (45, 20), (144, 4)])
def test_attention_matches_tiny(s, heads):
    """Short sequences: temporal t = 25 and the mid-level spatial lengths."""
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, 6, s, heads * 64) for _ in range(3))
    port = attention_packed(_t(q), _t(k), _t(v), heads)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(port, jtiny.tiny_attention_packed(jq, jk, jv, heads))
    _close(port, jtiny._xla_packed_reference(jq, jk, jv, heads))


def test_attention_valid_k_masks_padding():
    """valid_k: keys at or past it do not count (JAX pads t = 25 -> 32 and
    masks; the port takes 25 directly, and masks when a caller pads)."""
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, 4, 32, 2 * 64) for _ in range(3))
    padded = attention_packed(_t(q), _t(k), _t(v), 2, valid_k=25)
    exact = attention_packed(_t(q[:, :25]), _t(k[:, :25]), _t(v[:, :25]), 2)
    _close(padded[:, :25], exact.numpy())


def _ln_params(rng, c):
    return 1.0 + _rand(rng, c, scale=0.1), _rand(rng, c, scale=0.1)


@pytest.mark.parametrize("c,inner", [(64, 64), (96, 128)])
def test_fused_ln_qkv(c, inner):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 16, c)
    ln_s, ln_b = _ln_params(rng, c)
    w = [_rand(rng, c, inner, scale=c ** -0.5) for _ in range(3)]
    port = fused_ln_qkv(_t(x), _t(ln_s), _t(ln_b), *(_t(a.T) for a in w))
    args = [jnp.asarray(a) for a in (x, ln_s, ln_b, *w)]
    for ref in (jqkv.fused_ln_qkv(*args), jqkv._xla_reference(*args)):
        for p, r in zip(port, ref):
            _close(p, r)


@pytest.mark.parametrize("op", ["qkv", "geglu_ff"])
def test_ln_ops_on_shifted_mean_rows(op):
    """Rows of mean 4 and std 1, as the UNet's residual streams are: the
    E[x^2] - mean^2 statistic that the port's K2 keeps (in fp32) against the
    JAX kernels' own (interpret mode) and their references."""
    rng = np.random.default_rng(7)
    c = 64
    x = _rand(rng, 2, 16, c) + np.float32(4.0)
    ln_s, ln_b = _ln_params(rng, c)
    if op == "qkv":
        w = [_rand(rng, c, c, scale=c ** -0.5) for _ in range(3)]
        port = fused_ln_qkv(_t(x), _t(ln_s), _t(ln_b), *(_t(a.T) for a in w))
        args = [jnp.asarray(a) for a in (x, ln_s, ln_b, *w)]
        for ref in (jqkv.fused_ln_qkv(*args), jqkv._xla_reference(*args)):
            for p, r in zip(port, ref):
                _close(p, r)
        return
    w1, b1 = _rand(rng, c, 8 * c, scale=c ** -0.5), _rand(rng, 8 * c, scale=0.1)
    w2, b2 = _rand(rng, 4 * c, c, scale=(4 * c) ** -0.5), _rand(rng, c, scale=0.1)
    port = fused_geglu_ff(_t(x), _t(ln_s), _t(ln_b), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    args = [jnp.asarray(a) for a in (x, ln_s, ln_b, w1, b1, w2, b2)]
    # tanh-GELU on the JAX side, as in test_fused_geglu_ff
    _close(port, jff.fused_geglu_ff(*args), TANH_GELU_TOL)
    _close(port, jff._xla_reference(*args), TANH_GELU_TOL)


@pytest.mark.parametrize("c", [32, 64])
def test_fused_geglu_ff(c):
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 16, c)
    ln_s, ln_b = _ln_params(rng, c)
    w1, b1 = _rand(rng, c, 8 * c, scale=c ** -0.5), _rand(rng, 8 * c, scale=0.1)
    w2, b2 = _rand(rng, 4 * c, c, scale=(4 * c) ** -0.5), _rand(rng, c, scale=0.1)
    port = fused_geglu_ff(_t(x), _t(ln_s), _t(ln_b), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    args = [jnp.asarray(a) for a in (x, ln_s, ln_b, w1, b1, w2, b2)]
    # the TPU kernel and its reference both use tanh-GELU
    _close(port, jff.fused_geglu_ff(*args), TANH_GELU_TOL)
    _close(port, jff._xla_reference(*args), TANH_GELU_TOL)
    # the exact-erf composition (JAX GEGLUFeedForward on an LN) holds tightly
    xf = jnp.asarray(x)
    mean = xf.mean(-1, keepdims=True)
    var = (xf * xf).mean(-1, keepdims=True) - mean * mean
    xn = (xf - mean) / jnp.sqrt(var + 1e-5) * ln_s + ln_b
    a, g = jnp.split(xn @ w1 + b1, 2, axis=-1)
    import jax

    _close(port, xf + (a * jax.nn.gelu(g, approximate=False)) @ w2 + b2)


def test_fused_temporal_self_attn_unpadded_vs_padded():
    """The port on t = 25 against the JAX kernel on t padded to 32 with
    valid_t = 25, compared on the 25 real frames."""
    rng = np.random.default_rng(5)
    rows, t, c, heads = 8, 25, 128, 2
    x = _rand(rng, rows, t, c)
    ln_s, ln_b = _ln_params(rng, c)
    wq, wk, wv, wo = (_rand(rng, c, c, scale=c ** -0.5) for _ in range(4))
    bo = _rand(rng, c, scale=0.1)
    port = fused_temporal_self_attn(_t(x), _t(ln_s), _t(ln_b), _t(wq.T), _t(wk.T),
                                    _t(wv.T), _t(wo.T), _t(bo), heads)
    xp = np.pad(x, ((0, 0), (0, 7), (0, 0)))
    args = [jnp.asarray(a) for a in (xp, ln_s, ln_b, wq, wk, wv, wo, bo)]
    _close(port, np.asarray(jta.fused_temporal_self_attn(*args, heads, t))[:, :t])
    _close(port, np.asarray(jta._xla_reference(*args, heads, valid_t=t))[:, :t])


def _gn_inputs(seed, b=2, t=4, s=16, c=32):
    rng = np.random.default_rng(seed)
    x = _rand(rng, b * t, s, c)
    gamma, beta = _ln_params(rng, c)
    w = _rand(rng, 3, c, c, scale=(3 * c) ** -0.5)
    bias = _rand(rng, c, scale=0.1)
    return rng, x, gamma, beta, w, bias, t


def _w_torch(w):
    """JAX (3, cin, cout) taps -> Conv3d (cout, cin, 3, 1, 1)."""
    return _t(np.ascontiguousarray(w.transpose(2, 1, 0))[..., None, None])


def _affine(x, gamma, beta, t):
    from vista_tpu.models.blocks import _gn_affine

    bt, s, c = x.shape
    sc, sh = _gn_affine(jnp.asarray(x).reshape(bt // t, t, 4, s // 4, c),
                        jnp.asarray(gamma), jnp.asarray(beta))
    port_sc, port_sh = gn_affine(_t(x), _t(gamma), _t(beta), t)
    _close(port_sc, sc)
    _close(port_sh, sh)
    return port_sc, port_sh, sc, sh


def test_fused_gn_silu_conv3_emb():
    rng, x, gamma, beta, w, bias, t = _gn_inputs(6)
    emb = _rand(rng, x.shape[0], x.shape[2])
    port_sc, port_sh, sc, sh = _affine(x, gamma, beta, t)
    port = fused_gn_silu_conv3_emb(_t(x), port_sc, port_sh, _w_torch(w), _t(bias),
                                   _t(emb), t)
    args = (jnp.asarray(x), sc, sh, jnp.asarray(w), jnp.asarray(bias), jnp.asarray(emb))
    _close(port, jtc.fused_gn_silu_conv3_emb(*args, t))
    _close(port, jtc._gn_conv3_compose(*args[:5], t, args[5], None, None))


def test_fused_gn_silu_conv3_res():
    rng, x, gamma, beta, w, bias, t = _gn_inputs(7)
    res = _rand(rng, *x.shape)
    rs = np.float32(0.37)
    port_sc, port_sh, sc, sh = _affine(x, gamma, beta, t)
    port = fused_gn_silu_conv3_res(_t(x), port_sc, port_sh, _w_torch(w), _t(bias),
                                   _t(res), torch.tensor(rs), t)
    args = (jnp.asarray(x), sc, sh, jnp.asarray(w), jnp.asarray(bias))
    _close(port, jtc.fused_gn_silu_conv3_res(*args, jnp.asarray(res), jnp.asarray(rs), t))
    _close(port, jtc._gn_conv3_compose(*args, t, None, jnp.asarray(res), jnp.asarray(rs)))


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The kernels' argument checks run before any launch: a CPU tensor
    next to a (fake) device tensor is refused, never silently computed."""
    from vista_tpu_torch.ops import _build

    with pytest.raises(ValueError):
        _build.on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))
    assert _build.on_cpu(torch.zeros(1), None)
