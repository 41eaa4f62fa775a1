"""The port's slice as a whole against the JAX package: a tiny engine
samples 2 Euler-EDM steps with triangle CFG and frame 0 pinned, then decodes
with the temporal VAE decoder in windows of 3 frames overlapping by 1. Same
weights (exported by the JAX key maps, loaded by the port's bridge with
``strict=True``), same noise and conditioning (numpy, from a seed), fp32 on
the CPU on both sides; the JAX side runs its composed (XLA) path, which
computes the same functions as the port's plain versions, so latents and
pixels hold to 1e-4 of their largest magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_thread  # noqa: F401
from tests.test_torch_unet import random_params
from vista_tpu.diffusion.guidance import GuiderConfig as JGuiderConfig
from vista_tpu.diffusion.sampler import SamplerConfig as JSamplerConfig
from vista_tpu.engine.engine import EngineConfig as JEngineConfig
from vista_tpu.engine.engine import VistaEngine as JVistaEngine
from vista_tpu.utils import torch_import as ti
from vista_tpu_torch.diffusion.guidance import GuiderConfig
from vista_tpu_torch.diffusion.sampler import SamplerConfig
from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
from vista_tpu_torch.utils.checkpoint import (DECODER_PREFIX, UNET_PREFIX,
                                              load_vista_state_dict)

HL = WL = 8
STEPS = 2
TOL = 1e-4


def _fp32(cfg):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dtype="float32"),
                               vae=dataclasses.replace(cfg.vae, dtype="float32"))


@pytest.fixture(scope="module")
def engines():
    """Only the UNet and the decoder are initialised (shapes by eval_shape,
    values from numpy): the conditioner is not part of the slice."""
    jcfg = _fp32(JEngineConfig().tiny())
    jeng = JVistaEngine(jcfg)
    t, u = jcfg.num_frames, jcfg.unet
    key = jax.random.key(0)
    unet_shapes = jax.eval_shape(lambda: jeng.unet.init(
        key, jnp.zeros((t, HL, WL, u.in_channels)), jnp.zeros((t,)),
        jnp.zeros((1, 1, u.context_dim)), jnp.zeros((1, u.adm_in_channels)),
        jnp.zeros((t,)), t))["params"]
    dec_shapes = jax.eval_shape(lambda: jeng.decoder.init(
        key, jnp.zeros((t, HL, WL, jcfg.vae.z_channels)), t))["params"]
    params = {"unet": random_params(unet_shapes, 10), "decoder": random_params(dec_shapes, 11)}
    state = ti.export_key_map(params["unet"], ti.unet_key_map(u), UNET_PREFIX)
    state.update(ti.export_key_map(params["decoder"],
                                   ti.vae_decoder_key_map(jcfg.vae, video=True),
                                   DECODER_PREFIX))
    port = VistaEngine(_fp32(EngineConfig().tiny()), "cpu")
    load_vista_state_dict(port.unet, port.decoder, state)
    return jeng, params, port


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    t, u = cfg.num_frames, cfg.unet
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    cond = {"crossattn": r(1, 1, u.context_dim), "vector": r(1, u.adm_in_channels),
            "concat": r(1, HL, WL, 4)}
    uc = {k: np.zeros_like(v) for k, v in cond.items()}
    uc["vector"] = cond["vector"]
    mask = np.zeros((t,), np.float32)
    mask[0] = 1.0
    return r(t, HL, WL, 4), cond, uc, r(t, HL, WL, 4), mask


def test_sample_and_decode_match_jax(engines):
    jeng, params, port = engines
    t = jeng.cfg.num_frames
    noise, cond, uc, cond_frame, mask = _inputs(jeng.cfg, 0)

    jsampler = JSamplerConfig(num_steps=STEPS, guider=JGuiderConfig(
        kind="triangle", scale=2.5, num_frames=t))
    jlat = jax.jit(lambda p, *a: jeng.sample(p, *a, sampler=jsampler))(
        params, jnp.asarray(noise), jax.tree.map(jnp.asarray, cond),
        jax.tree.map(jnp.asarray, uc), jnp.asarray(cond_frame), jnp.asarray(mask))
    jpix = np.asarray(jax.jit(jeng.decode_first_stage)(params, jlat))
    jlat = np.asarray(jlat)

    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
    tdict = lambda d: {k: nchw(v) if k == "concat" else torch.from_numpy(v)
                       for k, v in d.items()}
    sampler = SamplerConfig(num_steps=STEPS, guider=GuiderConfig(
        kind="triangle", scale=2.5, num_frames=t))
    lat = port.sample(nchw(noise), tdict(cond), tdict(uc), nchw(cond_frame),
                      torch.from_numpy(mask), sampler)
    pix = port.decode_first_stage(lat)

    assert torch.equal(lat[0], nchw(cond_frame)[0]), "frame 0 must stay pinned"
    lat = lat.permute(0, 2, 3, 1).numpy()
    pix = pix.permute(0, 2, 3, 1).numpy()
    assert lat.shape == jlat.shape and pix.shape == jpix.shape == (t, 2 * HL, 2 * WL, 3)
    assert np.isfinite(pix).all()
    for got, ref in ((lat, jlat), (pix, jpix)):
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
