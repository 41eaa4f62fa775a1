"""The port's conditioning against the JAX package, tiny configs in fp32 on
the CPU, same weights (``export_vista_checkpoint`` of random JAX params,
loaded by the port's bridge with ``strict=True``) and inputs made with
numpy from a seed:

- ``clip_preprocess``: ``jax.image.resize`` bicubic with antialias, at the
  tiny size and at 320x576 -> 224 (the phase-2 frames), bound 1e-4 (the
  same fp32 weights, the two contractions summed in another order:
  measured 1.2e-5);
- the CLIP tower, the VAE encoder's moments and the whole conditioner with
  action control (CLIP token, five action embeddings, vector, encoder +
  ``quant_conv`` mode), with the JAX ucg dropout masks (``fold_in`` +
  ``bernoulli``) injected: bound 1e-4 of each output's largest magnitude;
- ``encode_first_stage`` with the JAX posterior noise injected: 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_thread  # noqa: F401
from tests.test_torch_unet import random_params
from vista_tpu.engine.engine import EngineConfig as JEngineConfig
from vista_tpu.engine.engine import VistaEngine as JVistaEngine
from vista_tpu.models.clip import clip_preprocess as jax_clip_preprocess
from vista_tpu.models.conditioner import ACTION_SPECS
from vista_tpu.utils.checkpoint import export_vista_checkpoint
from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
from vista_tpu_torch.models.clip import clip_preprocess
from vista_tpu_torch.utils.checkpoint import load_vista_state_dict

H = W = 16
UCG_INDEX = {"cond_frames_without_noise": 0, "fps_id": 1, "motion_bucket_id": 2,
             "cond_aug": 3, "cond_frames": 4,
             **{name: 10 + i for i, (name, _) in enumerate(ACTION_SPECS)}}
PHASE2_UCG_KEYS = ("cond_frames_without_noise", "cond_frames", "command", "trajectory",
                   "speed", "angle", "goal")


def fp32_cfgs(ucg_rate, lora, action=True):
    """The tiny JAX and port engine configs, fp32, LoRA or not; with
    ``action``, action control and the phase-2 ucg keys, else neither (the
    phase-1 recipe's default keys)."""
    out = []
    for base in (JEngineConfig().tiny(), EngineConfig().tiny()):
        cond = base.conditioner
        keys = dict(ucg_keys=PHASE2_UCG_KEYS) if action else {}
        cond = dataclasses.replace(
            cond, action_control=action, ucg_rate=ucg_rate, **keys,
            clip=dataclasses.replace(cond.clip, dtype="float32"),
            vae=dataclasses.replace(cond.vae, dtype="float32"))
        out.append(dataclasses.replace(
            base, conditioner=cond, vae=dataclasses.replace(base.vae, dtype="float32"),
            unet=dataclasses.replace(base.unet, dtype="float32", add_lora=lora,
                                     action_control=action)))
    return out


def build(ucg_rate=0.0, lora=False, seed=20, action=True):
    """JAX engine + random params (the conditioner's encoder tied to the
    first stage's), and the port engine loaded from their export."""
    jcfg, pcfg = fp32_cfgs(ucg_rate, lora, action)
    jeng = JVistaEngine(jcfg)
    shapes = jax.eval_shape(lambda: jeng.init_params(jax.random.key(0), H, W))
    params = random_params(shapes, seed)
    params["conditioner"]["cond_frames_encoder"] = params["encoder"]
    port = VistaEngine(pcfg, "cpu")
    load_vista_state_dict(port.unet, port.decoder, export_vista_checkpoint(params, jcfg),
                          encoder=port.encoder, conditioner=port.conditioner)
    return jeng, params, port


def jax_ucg_keep(key, cfg, b):
    """The keep masks the JAX conditioner draws from ``key``."""
    return {k: np.asarray(jax.random.bernoulli(jax.random.fold_in(key, UCG_INDEX[k]),
                                               1.0 - cfg.ucg_rate, (b,)), np.float32)
            for k in cfg.ucg_keys}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).permute(0, 3, 1, 2).contiguous()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def engines():
    return build(ucg_rate=0.5)


@pytest.mark.parametrize("h,w,size", [(40, 72, 28), (320, 576, 224)])
def test_clip_preprocess_matches_jax(h, w, size):
    frames = np.random.default_rng(1).uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    ref = np.asarray(jax_clip_preprocess(jnp.asarray(frames), size))
    got = clip_preprocess(nchw(frames), size).permute(0, 2, 3, 1).numpy()
    assert _rel(got, ref) <= 1e-4


def test_clip_tower_and_encoder_match_jax(engines):
    jeng, params, port = engines
    rng = np.random.default_rng(2)
    s = jeng.cfg.conditioner.clip.image_size
    x = rng.standard_normal((2, s, s, 3)).astype(np.float32)
    ref = jeng.conditioner.apply({"params": params["conditioner"]}, jnp.asarray(x),
                                 method=lambda m, x: m.clip_tower(x))
    with torch.no_grad():
        got = port.conditioner.clip_tower(nchw(x))
    assert _rel(got.numpy(), ref) <= 1e-4
    px = rng.uniform(-1, 1, (3, H, W, 3)).astype(np.float32)
    ref = jeng.encoder.apply({"params": params["encoder"]}, jnp.asarray(px))
    with torch.no_grad():
        got = port.encoder(nchw(px)).permute(0, 2, 3, 1)
    assert _rel(got.numpy(), ref) <= 1e-4


def test_conditioner_and_first_stage_match_jax(engines):
    jeng, params, port = engines
    rng = np.random.default_rng(3)
    b = 4
    batch = {"cond_frames_without_noise": rng.uniform(-1, 1, (b, H, W, 3)),
             "cond_frames": rng.uniform(-1, 1, (b, H, W, 3)),
             "fps_id": np.full((b,), 9.0), "motion_bucket_id": np.full((b,), 127.0),
             "cond_aug": np.full((b,), 0.02),
             "trajectory": rng.standard_normal((b, 8)), "speed": rng.standard_normal((b, 4)),
             "command": rng.integers(0, 3, (b, 1)).astype(np.float64)}
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    key = jax.random.key(4)
    ref = jeng.conditions(params, {k: jnp.asarray(v) for k, v in batch.items()}, ucg_key=key)
    keep = jax_ucg_keep(key, jeng.cfg.conditioner, b)
    tb = {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in batch.items()}
    got = port.conditions(tb, ucg_keep={k: torch.from_numpy(v) for k, v in keep.items()})
    assert got["crossattn"].shape == (b, 1, jeng.cfg.unet.context_dim + 2432)
    assert _rel(got["crossattn"].numpy(), ref["crossattn"]) <= 1e-4
    assert _rel(got["vector"].numpy(), ref["vector"]) <= 1e-4
    assert _rel(got["concat"].permute(0, 2, 3, 1).numpy(), ref["concat"]) <= 1e-4

    px = rng.uniform(-1, 1, (5, H, W, 3)).astype(np.float32)
    ref = jeng.encode_first_stage(params, jnp.asarray(px), key=key)
    noise = jax.random.normal(key, ref.shape)
    got = port.encode_first_stage(nchw(px), nchw(noise))
    assert _rel(got.permute(0, 2, 3, 1).numpy(), ref) <= 1e-4
