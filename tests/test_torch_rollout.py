"""The port's rollout, reward and ``condition_pair`` against the JAX package,
a tiny engine with action control in fp32 on the CPU on both sides: the same
weights (``export_vista_checkpoint`` of random JAX params, loaded by the
port's bridge with ``strict=True``), the same context frames and actions
(numpy, from a seed), and the JAX package's own random draws (the encoder
posterior, the ``cond_aug`` noise and each initial noise, made from the key
splits its functions perform) handed to the port as tensors. The JAX side
runs its XLA path.

- ``condition_pair``, from the pixels and with ``skip_encode``: c and uc
  within 1e-4 of each output's largest magnitude;
- ``autoregressive_rollout``, 2 rounds of 2 steps, triangle CFG, a
  trajectory in the batch: latents and pixels within 1e-4 of their largest
  magnitude (measured 7.1e-5 and 9.1e-5 to 9.3e-5 with 1, 3 or 8 threads,
  most of it already in round 1: the same weights and draws, sums in
  another order); round 2's slots 0-2 are round 1's last 3 latents, bit for
  bit, and round 1's frame 0 is the context latent; without the output
  decode (round 2's CLIP image from a decode of round 1's tail), the latents
  within 1e-4;
- ``estimate_reward``, an ensemble of 3 at 2 steps: the variance mean and
  the reward within 1e-4 relative (measured 2e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_thread  # noqa: F401
from tests.test_torch_conditioner import H, W, build, nchw
from vista_tpu.diffusion.guidance import GuiderConfig as JGuiderConfig
from vista_tpu.diffusion.sampler import SamplerConfig as JSamplerConfig
from vista_tpu.engine.reward import estimate_reward as jax_estimate_reward
from vista_tpu.engine.rollout import RolloutConfig as JRolloutConfig
from vista_tpu.engine.rollout import autoregressive_rollout as jax_rollout
from vista_tpu_torch.diffusion.guidance import GuiderConfig
from vista_tpu_torch.diffusion.sampler import SamplerConfig
from vista_tpu_torch.engine import RolloutConfig, autoregressive_rollout, estimate_reward
from vista_tpu_torch.engine.engine import UC_ZERO_KEYS
from vista_tpu_torch.engine.rollout import RolloutDraws

TOL = 1e-4
ROUNDS, STEPS, ENSEMBLE = 2, 2, 3
ROLLOUT_SEED, REWARD_SEED = 5, 6


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _inputs(t, seed=7):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (t, H, W, 3)).astype(np.float32)
    batch = {"fps_id": np.array([9.0], np.float32),
             "motion_bucket_id": np.array([127.0], np.float32),
             "cond_aug": np.array([0.02], np.float32),
             "trajectory": rng.standard_normal((1, 8)).astype(np.float32)}
    return images, batch


def _jax_tree(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch_tree(d):
    return {k: nchw(v) if np.asarray(v).ndim == 4 else torch.from_numpy(np.asarray(v))
            for k, v in d.items()}


def _rollout_draws(key, z_shape, images_shape, n):
    """The draws of the JAX rollout for ``key``: posterior, cond_aug, then
    one initial noise per round, in its split order."""
    k_enc, key = jax.random.split(key)
    k_aug, key = jax.random.split(key)
    noises = []
    for _ in range(n):
        k_noise, key = jax.random.split(key)
        noises.append(nchw(jax.random.normal(k_noise, z_shape)))
    return RolloutDraws(posterior=nchw(jax.random.normal(k_enc, z_shape)),
                        cond_aug=nchw(jax.random.normal(k_aug, (1, *images_shape[1:]))),
                        noise=torch.stack(noises))


def _reward_draws(key, z_shape, images_shape, n):
    """The draws of the JAX reward: ``split(key, 3)``, a member's noise from
    ``fold_in(k_ens, i)``."""
    k_enc, k_aug, k_ens = jax.random.split(key, 3)
    return RolloutDraws(
        posterior=nchw(jax.random.normal(k_enc, z_shape)),
        cond_aug=nchw(jax.random.normal(k_aug, (1, *images_shape[1:]))),
        noise=torch.stack([nchw(jax.random.normal(jax.random.fold_in(k_ens, i), z_shape))
                           for i in range(n)]))


@pytest.fixture(scope="module")
def runs(one_thread):
    jeng, params, port = build(seed=21)
    t = jeng.cfg.num_frames
    f = jeng.cfg.vae.downsample_factor
    z_shape = (t, H // f, W // f, jeng.cfg.vae.z_channels)
    images, batch = _inputs(t)
    out = {"t": t}

    # condition_pair, from pixels and from a latent (the shapes the rollout
    # passes, so the JAX rollout reuses these compiled programs)
    rng = np.random.default_rng(8)
    pixel_batch = dict(batch, cond_frames_without_noise=images[:1],
                       cond_frames=rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32))
    latent_batch = dict(batch, cond_frames_without_noise=images[1:2],
                        cond_frames=rng.standard_normal((1, *z_shape[1:])).astype(np.float32))
    out["pairs"] = {}
    for skip, b in ((False, pixel_batch), (True, latent_batch)):
        ref = jeng.jit_condition_pair(UC_ZERO_KEYS, skip_encode=skip)(params, _jax_tree(b))
        got = port.condition_pair(_torch_tree(b), skip_encode=skip)
        out["pairs"][skip] = (ref, got)

    # the rollout; the port's sampling passes recorded
    jsampler = JSamplerConfig(num_steps=STEPS, guider=JGuiderConfig(
        kind="triangle", scale=2.5, num_frames=t))
    key = jax.random.key(ROLLOUT_SEED)
    jpix, jlat = jax_rollout(jeng, params, jnp.asarray(images), _jax_tree(batch), jsampler,
                             JRolloutConfig(num_rounds=ROUNDS), key=key)
    sampler = SamplerConfig(num_steps=STEPS, guider=GuiderConfig(
        kind="triangle", scale=2.5, num_frames=t))
    draws = _rollout_draws(key, z_shape, images.shape, ROUNDS)
    passes = []
    sample = port.sample
    port.sample = lambda *a, **k: passes.append(sample(*a, **k)) or passes[-1]
    try:
        pix, lat = autoregressive_rollout(port, nchw(images), _torch_tree(batch), sampler,
                                          RolloutConfig(num_rounds=ROUNDS), draws)
    finally:
        del port.sample
    out["rollout"] = (np.asarray(jpix), np.asarray(jlat), pix, lat, passes)
    out["context_latent"] = port.encode_first_stage(nchw(images), draws.posterior)
    # without the output decode, round 2's CLIP image comes from a decode of
    # the tail of round 1
    jnone, jlat = jax_rollout(jeng, params, jnp.asarray(images), _jax_tree(batch), jsampler,
                              JRolloutConfig(num_rounds=ROUNDS), key=key, decode_output=False)
    none, lat = autoregressive_rollout(port, nchw(images), _torch_tree(batch), sampler,
                                       RolloutConfig(num_rounds=ROUNDS), draws,
                                       decode_output=False)
    out["latents_only"] = (jnone, np.asarray(jlat), none, lat)

    # the reward: vanilla CFG, as the reward CLI runs it
    jsampler = JSamplerConfig(num_steps=STEPS, guider=JGuiderConfig(
        kind="vanilla", scale=2.5, num_frames=t))
    key = jax.random.key(REWARD_SEED)
    jr = float(jax_estimate_reward(jeng, params, jnp.asarray(images), _jax_tree(batch),
                                   jsampler, ensemble_size=ENSEMBLE, key=key))
    sampler = SamplerConfig(num_steps=STEPS, guider=GuiderConfig(
        kind="vanilla", scale=2.5, num_frames=t))
    r = float(estimate_reward(port, nchw(images), _torch_tree(batch), sampler,
                              ensemble_size=ENSEMBLE,
                              draws=_reward_draws(key, z_shape, images.shape, ENSEMBLE)))
    out["reward"] = (jr, r)
    return out


@pytest.mark.parametrize("skip_encode", [False, True])
def test_condition_pair_matches_jax(runs, skip_encode):
    (ref_c, ref_uc), (c, uc) = runs["pairs"][skip_encode]
    for ref, got in ((ref_c, c), (ref_uc, uc)):
        assert set(got) == set(ref) == {"crossattn", "vector", "concat"}
        assert _rel(got["crossattn"].numpy(), ref["crossattn"]) <= TOL
        assert _rel(got["vector"].numpy(), ref["vector"]) <= TOL
        assert _rel(got["concat"].permute(0, 2, 3, 1).numpy(), ref["concat"]) <= TOL
    # the unconditional half zeroes the frames and the actions, keeps vector
    assert not uc["concat"].any() and not c["concat"].eq(0).all()
    width = c["crossattn"].shape[-1] - 2432
    assert not uc["crossattn"].any() and c["crossattn"][..., width:].any()
    assert torch.equal(uc["vector"], c["vector"])


def test_rollout_latents_and_pixels_match_jax(runs):
    jpix, jlat, pix, lat, _ = runs["rollout"]
    t = runs["t"]
    n = ROUNDS * (t - 3) + 3
    assert lat.shape == (n, 4, H // 2, W // 2) and pix.shape == (n, 3, H, W)
    assert bool(torch.isfinite(pix).all()) and 0.0 <= pix.min() and pix.max() <= 1.0
    assert _rel(lat.permute(0, 2, 3, 1).numpy(), jlat) <= TOL
    assert _rel(pix.permute(0, 2, 3, 1).numpy(), jpix) <= TOL


def test_rollout_without_decode_matches_jax(runs):
    jnone, jlat, none, lat = runs["latents_only"]
    assert jnone is None and none is None
    assert lat.shape == (ROUNDS * (runs["t"] - 3) + 3, 4, H // 2, W // 2)
    assert _rel(lat.permute(0, 2, 3, 1).numpy(), jlat) <= TOL
    # round 1 is the same pass with or without the decode; round 2 is not
    full = runs["rollout"][3]
    assert torch.equal(lat[:runs["t"]], full[:runs["t"]])


def test_rollout_carries_context_bit_for_bit(runs):
    _, _, _, lat, passes = runs["rollout"]
    assert len(passes) == ROUNDS
    assert torch.equal(lat[0], runs["context_latent"][0]), "round 1's frame 0 is pinned"
    assert torch.equal(passes[1][:3], passes[0][-3:]), "round 2 starts from round 1's tail"
    assert torch.equal(lat[:runs["t"]], passes[0])
    assert torch.equal(lat[runs["t"]:], passes[1][3:])


def test_reward_matches_jax(runs):
    jr, r = runs["reward"]
    assert 0.0 < r <= 1.0
    assert abs(r - jr) <= TOL * abs(jr)
    var, jvar = -np.log(r), -np.log(jr)
    assert abs(var - jvar) <= TOL * abs(jvar)
