"""Frame-, row- and weight-sharded sampling on 2 gloo ranks against the JAX
package and against the port's one-rank pass.

The tiny engine (t = 4, 8x8 latents, fp32) takes the JAX weights through the
bridge, as ``tests/test_torch_slice.py`` does; 2 Euler-EDM steps with
triangle CFG and frame 0 pinned. Held:

- ``sample_sharded`` in ``frames``, ``height`` and ``weights`` mode (every
  tensor of at least 128 elements sliced) against ``vista_tpu``'s
  ``jit_sample`` on the same weights and noise, to 1e-4 of the largest
  magnitude (``TOL``), and against the port's one-rank ``sample``:
  ``weights`` bit for bit (the gathered weights are the weights), ``frames``
  to two ulps of the first Euler step and one sharded denoiser call to
  ``DENOISE_TOL``; ``height`` to two ulps of the same band code on a
  one-rank mesh, the denoiser call to ``DENOISE_TOL`` and the pass to
  ``HEIGHT_ULPS`` of the one-rank ``sample`` (see their comments);
- ``height`` also at 6 latent rows (bands 3 / 3, rank 1's stride-2 input
  starting on an odd row, then 1 / 2) and 2 (1 / 1, then an empty band),
  to the same bounds;
- a 2-round ``autoregressive_rollout`` with the mesh (every mode) against
  the one-rank rollout: ``weights`` bit for bit, ``frames`` and ``height``
  as above;
- the refusals: a latent height the ranks do not divide (CLI, ``height``),
  a frame count the ranks do not divide (engine and CLI), a
  ``--mesh-data`` other than the group's size;
- the sample CLI under the group in ``frames`` and ``height`` mode: every
  rank holds the latents, rank 0 alone writes files.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_slice import HL, TOL, WL, _fp32, _inputs
from tests.test_torch_unet import random_params
from tests.torch_parallel_ranks import sampling
from tests.torch_ranks import start_ranks
from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu.diffusion.guidance import GuiderConfig as JGuiderConfig
from vista_tpu.diffusion.sampler import SamplerConfig as JSamplerConfig
from vista_tpu.engine.engine import EngineConfig as JEngineConfig
from vista_tpu.engine.engine import VistaEngine as JVistaEngine
from vista_tpu.utils import torch_import as ti
from vista_tpu_torch.utils.checkpoint import DECODER_PREFIX, UNET_PREFIX

STEPS = 2
# frames and height against one rank. Each sums GroupNorm statistics over
# each rank's tokens, then over the ranks (and height runs its convs and
# attention on bands), so its UNet rounds otherwise than one rank's: one
# denoiser call holds to DENOISE_TOL.
# A pass cannot hold tighter than the first Euler step's rounding: from
# sigma 700 it takes its O(1) result as the difference of numbers of 700 x
# noise, so a rounding change anywhere upstream moves a latent by an ulp of
# those (2.4e-4 here, 4.1e-5 of the largest latent). A pass holds to two of
# them; a later rollout round, conditioned on the first, to ROLLOUT_TOL (the
# JAX package's own bound for its sharded rollout, tests/test_sharded_sampling.py).
DENOISE_TOL = 1e-5
ROLLOUT_TOL = 2e-2
# height against one rank. Its GroupNorms sum their statistics over the
# bands in an order and a formula of their own (F.group_norm's CPU kernel
# cannot be repeated from PyTorch ops), so the band code rounds otherwise
# than the one-rank model even on one band: with F.group_norm in its place a
# one-band denoiser call repeats the model's bits, without it the pass lands
# 1 to 2.5 first-step ulps away (noise seeds 0-7 on these weights). The
# bands are held to two ulps of the same code on one band; the pass to
# HEIGHT_ULPS of the one-rank model and, beside TOL, of the JAX package.
HEIGHT_ULPS = 4


def first_step_ulps(noise_max: float, n: int = 2) -> float:
    """``n`` ulps of the first Euler step's operands for a noise whose
    largest magnitude is ``noise_max``."""
    sigma0 = np.float32(700.0)
    return n * float(np.spacing(np.float32(noise_max) * np.sqrt(1 + sigma0 * sigma0)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
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
    noise, cond, uc, cond_frame, mask = _inputs(jcfg, 0)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
    tdict = lambda d: {k: nchw(v) if k == "concat" else torch.from_numpy(v)
                       for k, v in d.items()}
    guider = dict(kind="triangle", scale=2.5, num_frames=t)
    save = [str(tmp_path_factory.mktemp(f"rank{r}")) for r in range(2)]
    ranks = start_ranks(sampling, 2, (
        {k: np.asarray(v) for k, v in state.items()},
        (nchw(noise), tdict(cond), tdict(uc), nchw(cond_frame), torch.from_numpy(mask)),
        {"guider": guider, "steps": STEPS}, save))

    jsampler = JSamplerConfig(num_steps=STEPS, guider=JGuiderConfig(**guider))
    ref = jeng.jit_sample(jsampler)(
        params, jnp.asarray(noise), jax.tree.map(jnp.asarray, cond),
        jax.tree.map(jnp.asarray, uc), jnp.asarray(cond_frame), jnp.asarray(mask))
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    return ranks.results(), ref, save, float(np.abs(noise).max())


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("mode", ["frames", "height", "weights"])
def test_sharded_sample_matches_jax_and_one_rank(runs, mode):
    results, ref, _, noise_max = runs
    for out in results:  # every rank returns the whole latents
        assert out[mode].shape == ref.shape
        assert np.array_equal(out[mode][0], out["one"][0]), "frame 0 stays pinned"
        assert _rel(out["one"], ref) <= TOL
        if mode == "weights":
            assert _rel(out[mode], ref) <= TOL
            assert np.array_equal(out[mode], out["one"])
        elif mode == "frames":
            assert _rel(out[mode], ref) <= TOL
            assert np.abs(out[mode] - out["one"]).max() <= first_step_ulps(noise_max)
            assert _rel(out["denoise_frames"], out["denoise_one"]) <= DENOISE_TOL
        else:
            ulps = first_step_ulps(noise_max, HEIGHT_ULPS)
            assert _rel(out[mode], ref) <= TOL + ulps / np.abs(ref).max()
            assert np.abs(out[mode] - out["one"]).max() <= ulps
            assert np.abs(out[mode] - out["height_one_band_8"]).max() <= first_step_ulps(noise_max)
            assert _rel(out["denoise_height_8"], out["denoise_one"]) <= DENOISE_TOL
    assert np.array_equal(results[0][mode], results[1][mode])
    assert all(out["unet_restored"] for out in results)


@pytest.mark.parametrize("rows", [6, 2])
def test_height_at_uneven_and_empty_bands_matches_one_rank(runs, rows):
    results, _, _, noise_max = runs
    for out in results:
        got, one = out[f"height_{rows}"], out[f"one_{rows}"]
        assert got.shape == one.shape == (4, 4, rows, WL)
        assert np.array_equal(got[0], one[0]), "frame 0 stays pinned"
        assert np.abs(got - one).max() <= first_step_ulps(noise_max, HEIGHT_ULPS)
        assert np.abs(got - out[f"height_one_band_{rows}"]).max() <= first_step_ulps(noise_max)
        assert _rel(out[f"denoise_height_{rows}"], out[f"denoise_one_{rows}"]) <= DENOISE_TOL
    assert np.array_equal(results[0][f"height_{rows}"], results[1][f"height_{rows}"])


@pytest.mark.parametrize("mode", ["frames", "height", "weights"])
def test_sharded_rollout_matches_one_rank(runs, mode):
    for out in runs[0]:
        (pix, lat), (pix1, lat1) = out[f"rollout_{mode}"], out["rollout_one"]
        assert lat.shape == lat1.shape == (2 * (4 - 3) + 3, 4, HL, WL)
        assert pix.shape == (lat.shape[0], 3, 2 * HL, 2 * WL)  # the tiny VAE: x2
        if mode == "weights":
            assert np.array_equal(lat, lat1) and np.array_equal(pix, pix1)
        else:
            first = np.abs(lat[:4] - lat1[:4]).max()
            assert first <= first_step_ulps(out["rollout_noise_max"])
            assert _rel(lat, lat1) <= ROLLOUT_TOL and _rel(pix, pix1) <= ROLLOUT_TOL


def test_refusals(runs):
    for out in runs[0]:
        e = out["errors"]
        assert e["--mesh-data 2 --mesh-mode height --height 40"] == (
            "--mesh-data 2 must divide the latent height 5")  # the JAX CLI's words
        assert "must divide num_frames=3" in e["frames"]
        assert "must divide n_frames=3" in e["--mesh-data 2 --n_frames 3"]
        assert "WORLD_SIZE=2" in e["--mesh-data 3"]


def test_sample_cli_under_the_group(runs):
    results = runs[0]
    for mode in ("frames", "height"):
        (wrote0, files0, lat0), (wrote1, files1, lat1) = (out[f"cli_{mode}"] for out in results)
        assert wrote0 and not wrote1
        assert files0 == ["grids", "images", "videos", "videos_real"] and files1 == []
        assert np.array_equal(lat0, lat1) and np.isfinite(lat0).all()
        assert _rel(lat0, results[0]["cli_frames"][2]) <= ROLLOUT_TOL
