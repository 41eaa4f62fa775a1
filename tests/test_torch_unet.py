"""One preconditioned denoiser evaluation of the tiny VideoUNet: the JAX
package against the PyTorch port, with the same weights (exported by the
JAX key map, loaded by the port's bridge with ``strict=True``) and the same
inputs, made with numpy from a seed. Both in fp32 on the CPU.

Two JAX references:

- ``attn_backend="xla"``: the composed path (exact-erf GELU, XLA attention,
  unfused GroupNorm/conv) computes the same function as the port's plain
  versions, so the bound is 1e-4 of the output's largest magnitude;
- ``attn_backend="pallas"`` with the fused GroupNorm + conv path: the TPU
  kernels in interpret mode, whose feed-forward uses tanh-form GELU, so the
  bound is 1e-3 (measured 1.6e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vista_tpu.engine.engine import EngineConfig as JEngineConfig
from vista_tpu.engine.engine import VistaEngine as JVistaEngine
from vista_tpu.utils import torch_import as ti
from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
from vista_tpu_torch.utils.checkpoint import UNET_PREFIX, load_vista_state_dict

T, B, HL, WL = 4, 2, 8, 8


def _jax_cfg(backend):
    cfg = JEngineConfig().tiny()
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, dtype="float32", attn_backend=backend),
        vae=dataclasses.replace(cfg.vae, dtype="float32"))


def _port_cfg():
    cfg = EngineConfig().tiny()
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dtype="float32"),
                               vae=dataclasses.replace(cfg.vae, dtype="float32"))


def random_params(shapes, seed):
    """Random values for a param tree of shapes: none zero (the output convs
    the model zero-initialises included), kernels fan-in scaled, norm
    scales near 1."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        r = rng.standard_normal(s.shape).astype(np.float32)
        if "'kernel'" in name:
            r *= np.prod(s.shape[:-1]) ** -0.5
        elif "'scale'" in name:
            r = 1.0 + 0.1 * r
        elif "mix_factor" not in name:
            r *= 0.1
        return jnp.asarray(r)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def weights():
    cfg = _jax_cfg("xla")
    engine = JVistaEngine(cfg)
    n = B * T
    shapes = jax.eval_shape(
        lambda: engine.unet.init(
            jax.random.key(0), jnp.zeros((n, HL, WL, 8)), jnp.zeros((n,)),
            jnp.zeros((B, 1, cfg.unet.context_dim)),
            jnp.zeros((B, cfg.unet.adm_in_channels)), jnp.zeros((n,)), T))["params"]
    unet_params = random_params(shapes, 1)
    state = ti.export_key_map(unet_params, ti.unet_key_map(cfg.unet), UNET_PREFIX)
    port = VistaEngine(_port_cfg(), "cpu")
    load_vista_state_dict(port.unet, None, state)
    return unet_params, port


def _inputs(seed):
    rng = np.random.default_rng(seed)
    n = B * T
    cfg = _port_cfg().unet
    x = rng.standard_normal((n, HL, WL, 4)).astype(np.float32) * 3.0
    sigma = np.full((n,), 2.5, np.float32)
    cond = {"crossattn": rng.standard_normal((B, 1, cfg.context_dim)).astype(np.float32),
            "vector": rng.standard_normal((B, cfg.adm_in_channels)).astype(np.float32),
            "concat": rng.standard_normal((B, HL, WL, 4)).astype(np.float32)}
    mask = np.zeros((n,), np.float32)
    mask[::T] = 1.0
    return x, sigma, cond, mask


def _port_denoise(port, x, sigma, cond, mask):
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
    tcond = {"crossattn": torch.from_numpy(cond["crossattn"]),
             "vector": torch.from_numpy(cond["vector"]),
             "concat": nchw(cond["concat"])}
    with torch.no_grad():
        out = port.denoise_fn()(nchw(x), torch.from_numpy(sigma), tcond,
                                torch.from_numpy(mask))
    return out.permute(0, 2, 3, 1).numpy()


def _jax_denoise(backend, params, x, sigma, cond, mask):
    engine = JVistaEngine(_jax_cfg(backend))
    fn = jax.jit(lambda p, x, s, c, m: engine.denoise_fn({"unet": p})(x, s, c, m))
    return np.asarray(fn(params, jnp.asarray(x), jnp.asarray(sigma),
                         {k: jnp.asarray(v) for k, v in cond.items()}, jnp.asarray(mask)))


def _rel_err(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_denoiser_matches_jax_composed_path(weights):
    params, port = weights
    x, sigma, cond, mask = _inputs(2)
    ref = _jax_denoise("xla", params, x, sigma, cond, mask)
    got = _port_denoise(port, x, sigma, cond, mask)
    assert got.shape == ref.shape == (B * T, HL, WL, 4)
    assert _rel_err(got, ref) <= 1e-4


def test_denoiser_matches_jax_pallas_kernels(weights, monkeypatch):
    import vista_tpu.ops.temporal_conv as jtc

    monkeypatch.setattr(jtc, "_FUSED_GN_ON_CPU", True)
    params, port = weights
    x, sigma, cond, mask = _inputs(3)
    ref = _jax_denoise("pallas", params, x, sigma, cond, mask)
    got = _port_denoise(port, x, sigma, cond, mask)
    assert _rel_err(got, ref) <= 1e-3
