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

Then the port's selective checkpointing (``remat_max_ds``, the ``names`` /
``dots`` policies) against ``remat: false`` and the recompute counts of its
tagged sites (see the section's comment).
"""

import collections
import copy
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vista_tpu.engine.engine import EngineConfig as JEngineConfig
from vista_tpu.engine.engine import VistaEngine as JVistaEngine
from vista_tpu.utils import torch_import as ti
from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
from vista_tpu_torch.models.attention import ACTION_CONTEXT_DIM
from vista_tpu_torch.models.unet import VideoUNet
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


# ---------------------------------------------------------------- remat modes
#
# Selective checkpointing (``remat_max_ds``, ``remat_policy``) against
# ``remat: false``, the port alone: the tiny UNet in fp32 with every
# parameter drawn with numpy (the zero-initialised ones too), its blocks at
# ds 1 (32 channels) and ds 2 (64), so that ``remat_max_ds: 1`` mixes
# checkpointed and stored blocks. The bound is the one ``tests/test_unet.py``
# holds the JAX modes to; every case is bit-identical here.

REMAT_MODES = [{}, {"remat_max_ds": 1}, {"remat_policy": "names"}, {"remat_policy": "dots"},
               {"remat_max_ds": 1, "remat_policy": "names"}]
REMAT_ATOL = 1e-5


def _remat_unet(lora):
    cfg = dataclasses.replace(_port_cfg().unet, add_lora=lora, action_control=lora)
    unet = VideoUNet(cfg)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            r = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            p.copy_(1.0 + 0.1 * r if name.endswith(("norm.weight", "norm1.weight",
                                                  "norm2.weight", "norm3.weight"))
                    else 0.1 * r)
    n = B * T
    ctx_dim = cfg.context_dim + (ACTION_CONTEXT_DIM if lora else 0)
    mask = np.zeros((n,), np.float32)
    mask[::T] = 1.0
    inputs = [rng.standard_normal(s).astype(np.float32) for s in (
        (n, cfg.in_channels, HL, WL), (n,), (B, 1, ctx_dim), (B, cfg.adm_in_channels))]
    cot = rng.standard_normal((n, cfg.out_channels, HL, WL)).astype(np.float32)
    return unet, [torch.from_numpy(a) for a in (*inputs, mask)], torch.from_numpy(cot)


def _remat_run(unet, inputs, cot, **mode):
    """The forward and every parameter's gradient of one forward + backward
    (the one-token cross-attentions' q, k and norm2 get none)."""
    unet = copy.deepcopy(unet)
    unet.cfg = dataclasses.replace(unet.cfg, **mode)
    out = unet(*inputs, num_frames=T)
    (out * cot).sum().backward()
    return out.detach(), {n: p.grad for n, p in unet.named_parameters() if p.grad is not None}


def _identical(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


@pytest.fixture(scope="module")
def remat_refs():
    refs = {}
    for lora in (False, True):
        unet, inputs, cot = _remat_unet(lora)
        refs[lora] = (unet, inputs, cot, _remat_run(unet, inputs, cot, remat=False))
    return refs


@pytest.mark.parametrize("lora", [False, True], ids=["kernels", "lora"])
@pytest.mark.parametrize("mode", REMAT_MODES, ids=lambda m: "-".join(
    f"{k}={v}" for k, v in m.items()) or "full")
def test_remat_modes_match_no_remat(remat_refs, mode, lora):
    unet, inputs, cot, (ref, ref_grads) = remat_refs[lora]
    out, grads = _remat_run(unet, inputs, cot, remat=True, **mode)
    torch.testing.assert_close(out, ref, rtol=0, atol=REMAT_ATOL)
    assert grads.keys() == ref_grads.keys() and len(grads) > 500
    for name, g in ref_grads.items():
        torch.testing.assert_close(grads[name], g, rtol=0, atol=REMAT_ATOL, msg=name)
    assert torch.equal(out, ref) and _identical(grads, ref_grads)


def test_remat_keys_need_remat_and_grad(remat_refs):
    """Without ``remat`` or without gradients the keys change nothing, and
    an unknown policy raises, as in the JAX package."""
    unet, inputs, cot, (ref, ref_grads) = remat_refs[False]
    out, grads = _remat_run(unet, inputs, cot, remat=False, remat_max_ds=1,
                            remat_policy="names")
    assert torch.equal(out, ref) and _identical(grads, ref_grads)
    unet = copy.deepcopy(unet)
    unet.cfg = dataclasses.replace(unet.cfg, remat=True, remat_policy="names")
    with torch.no_grad():
        assert torch.equal(unet(*inputs, num_frames=T), ref)
    with pytest.raises(ValueError, match="unknown remat_policy 'all'"):
        dataclasses.replace(unet.cfg, remat_policy="all")


# (counter, site) -> (calls in one forward of a block, the block kind, a
# "names" tag covers it); the tags of models/attention.py on the kernel path
REMAT_SITES = {
    ("ln_linear", "qkv"): (1, "attn", False),
    ("attention", "spatial-short"): (1, "attn", True),           # attn1_out: (o, lse)
    ("linear_residual", "attn-out"): (1, "attn", False),
    ("cross", None): (2, "attn", True),                          # attn2_out, both blocks
    ("ln_linear", "ff"): (3, "attn", True),                      # ff_out: ff_in, ff, ff
    ("linear_residual", "ff"): (3, "attn", True),
    ("ln_linear", "temporal-qkv"): (1, "attn", True),            # temporal_attn_out
    ("attention", "temporal"): (1, "attn", True),
    ("linear_residual", "temporal-out"): (1, "attn", True),
    ("gn_silu_conv3", "emb"): (1, "res", False),                 # no tag in a res block
    ("gn_silu_conv3", "res"): (1, "res", False),
}
# blocks of the tiny UNet by (kind, channels): ds 1 runs 32 channels, ds 2 64
REMAT_BLOCKS = {("attn", 32): 3, ("attn", 64): 4, ("res", 32): 3, ("res", 64): 5}


def _expected_calls(mode):
    """Each site's plain forward runs once per forward, and again in the
    backward's recompute when its block is checkpointed and no tag covers
    it: a prediction from the config alone."""
    out = {}
    for (fn, site), (per_block, kind, tag) in REMAT_SITES.items():
        for (k, c), blocks in REMAT_BLOCKS.items():
            if k != kind:
                continue
            ds = 1 if c == 32 else 2
            if mode is None:
                again = False
            else:
                checkpointed = mode.get("remat_max_ds") is None or ds <= mode["remat_max_ds"]
                again = checkpointed and not (tag and mode.get("remat_policy") == "names")
            out[(fn, site, c)] = per_block * blocks * (2 if again else 1)
    return out


@pytest.mark.parametrize("mode", [None] + REMAT_MODES, ids=lambda m: "off" if m is None else (
    "-".join(f"{k}={v}" for k, v in m.items()) or "full"))
def test_remat_recompute_counts(remat_refs, monkeypatch, mode):
    """How often each site's plain forward runs in one forward + backward:
    a tagged site once under ``names``, every site twice in a checkpointed
    block otherwise, once in blocks deeper than ``remat_max_ds``."""
    from vista_tpu_torch.models.attention import CrossAttention
    from vista_tpu_torch.ops import attention, linear, temporal_conv

    calls = collections.Counter()

    def counting(module, name, fn_label, channels):
        orig = getattr(module, name)
        sig = inspect.signature(orig)

        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            calls[(fn_label, bound.arguments.get("site"), channels(bound.arguments))] += 1
            return orig(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    counting(attention, "attention_forward", "attention", lambda a: a["q"].shape[-1])
    counting(linear, "_ln_linear", "ln_linear", lambda a: a["x"].shape[-1])
    counting(linear, "_linear_residual", "linear_residual", lambda a: a["residual"].shape[-1])
    counting(temporal_conv, "gn_silu_conv3", "gn_silu_conv3", lambda a: a["x"].shape[-1])
    counting(CrossAttention, "cross", "cross", lambda a: a["self"].to_out[0].out_features)
    unet, inputs, cot, (ref, ref_grads) = remat_refs[False]
    out, grads = _remat_run(unet, inputs, cot, **(
        {"remat": False} if mode is None else {"remat": True, **mode}))
    assert dict(calls) == _expected_calls(mode)
    assert torch.equal(out, ref)
