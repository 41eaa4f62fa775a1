"""The tiny VideoUNet with LoRA and action control, non-zero adapters: the
JAX package against the PyTorch port, with the same weights (exported by
the JAX key map, LoRA and action adapter keys included, loaded by the
port's bridge with ``strict=True``) and the same inputs, made with numpy
from a seed. Both in fp32 on the CPU, against the JAX composed path
(``attn_backend="xla"``: flax LayerNorm, XLA attention, erf GELU), which
computes the same function as the port's plain versions.

- forward: the preconditioned denoiser output, bound 1e-4 of its largest
  magnitude (measured 1.6e-6);
- backward: the gradient of ``<denoiser output, cotangent>`` w.r.t. every
  UNet parameter (adapters, feed-forwards, temporal convs, norms), through
  the port's autograd Functions and their plain backward formulas; bound
  1e-3 of each tensor's largest magnitude, floored at 1e-3 of the largest
  gradient of all (biases ahead of a GroupNorm get ~1e-7 of it, cancelling
  sums); measured 1.5e-4 at worst (a time-embedding projection).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_unet import random_params
from vista_tpu.engine.engine import EngineConfig as JEngineConfig
from vista_tpu.engine.engine import VistaEngine as JVistaEngine
from vista_tpu.utils import torch_import as ti
from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
from vista_tpu_torch.models.attention import ACTION_CONTEXT_DIM
from vista_tpu_torch.utils.checkpoint import UNET_PREFIX, load_vista_state_dict

T, B, HL, WL = 4, 1, 8, 8
ADAPTERS = dict(add_lora=True, action_control=True, dtype="float32")


@pytest.fixture(scope="module")
def setup():
    jcfg = JEngineConfig().tiny()
    jcfg = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, **ADAPTERS))
    ctx = jcfg.unet.context_dim + ACTION_CONTEXT_DIM
    n = B * T
    shapes = jax.eval_shape(lambda: JVistaEngine(jcfg).unet.init(
        jax.random.key(0), jnp.zeros((n, HL, WL, 8)), jnp.zeros((n,)), jnp.zeros((B, 1, ctx)),
        jnp.zeros((B, jcfg.unet.adm_in_channels)), jnp.zeros((n,)), T))["params"]
    params = random_params(shapes, 5)
    state = ti.export_key_map(params, ti.unet_key_map(jcfg.unet), UNET_PREFIX)
    cfg = EngineConfig().tiny()
    port = VistaEngine(dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, **ADAPTERS)),
                       "cpu")
    load_vista_state_dict(port.unet, None, state)
    rng = np.random.default_rng(7)
    inputs = dict(
        x=rng.standard_normal((n, HL, WL, 4)).astype(np.float32) * 3.0,
        sigma=np.full((n,), 2.5, np.float32),
        cond={"crossattn": rng.standard_normal((B, 1, ctx)).astype(np.float32),
              "vector": rng.standard_normal((B, jcfg.unet.adm_in_channels)).astype(np.float32),
              "concat": rng.standard_normal((B, HL, WL, 4)).astype(np.float32)},
        mask=np.array([1.0, 0.0, 0.0, 0.0], np.float32),
        cot=rng.standard_normal((n, HL, WL, 4)).astype(np.float32))
    return JVistaEngine(jcfg), params, state, port, inputs


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


def _port_out(port, inp):
    cond = {"crossattn": torch.from_numpy(inp["cond"]["crossattn"]),
            "vector": torch.from_numpy(inp["cond"]["vector"]),
            "concat": _nchw(inp["cond"]["concat"])}
    return port.denoise_fn()(_nchw(inp["x"]), torch.from_numpy(inp["sigma"]), cond,
                             torch.from_numpy(inp["mask"]))


def _jax_fn(engine, inp):
    cond = {k: jnp.asarray(v) for k, v in inp["cond"].items()}
    return lambda p: engine.denoise_fn({"unet": p})(
        jnp.asarray(inp["x"]), jnp.asarray(inp["sigma"]), cond, jnp.asarray(inp["mask"]))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_lora_action_denoiser_matches_jax(setup):
    engine, params, _, port, inp = setup
    ref = np.asarray(jax.jit(_jax_fn(engine, inp))(params))
    with torch.no_grad():
        got = _port_out(port, inp).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (B * T, HL, WL, 4)
    assert _rel(got, ref) <= 1e-4


def test_lora_action_gradients_match_jax(setup):
    engine, params, _, port, inp = setup
    cot = jnp.asarray(inp["cot"])
    fn = _jax_fn(engine, inp)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(fn(p) * cot)))(params)
    ref = ti.export_key_map(grads, ti.unet_key_map(engine.cfg.unet), UNET_PREFIX)
    for p in port.unet.parameters():
        p.requires_grad_(True)
        p.grad = None
    out = _port_out(port, inp)
    (out * _nchw(inp["cot"])).sum().backward()
    named = dict(port.unet.named_parameters())
    checked = {"adapter": 0, "ff.net": 0, "time_stack.in_layers.2": 0, "norm1": 0}
    floor = 1e-3 * max(float(np.abs(g).max()) for g in ref.values())
    for key, g in ref.items():
        name = key[len(UNET_PREFIX):]
        got = named[name].grad
        if got is None:  # dead in the one-token fast path (attn2's q/k, norm2)
            assert not np.any(g), name
            continue
        err = float(np.abs(got.numpy() - g).max())
        assert err <= 1e-3 * max(float(np.abs(g).max()), floor), name
        for tag in checked:
            checked[tag] += tag in name
    assert min(checked.values()) > 0, checked
