"""The port's sampler modes and the rest of its diffusion math against the
JAX package, on the CPU in fp32, with inputs made with numpy from a seed:

- stochastic churn and sequential CFG of ``sample_euler_edm`` through a toy
  analytic denoiser written the same way in JAX (NHWC) and in torch (NCHW),
  so that no UNet compiles: churn with the JAX draws
  ``normal(fold_in(key, i), shape)`` passed in, sequential against JAX
  sequential and against the port's own batched mode, the ``s_tmin`` /
  ``s_tmax`` gate (see its test for the steps it compares), the raise
  without noise and on an unknown mode; bound
  1e-5 of the largest magnitude (the same float32 steps, summed in another
  order);
- ``sampling_utils``, ``sigma_to_idx``, ``precondition_denoise_discrete``
  and ``legacy_ddpm_sigmas`` (n < 1000 and n = 1000) against JAX;
- the loss's 3-D Fourier high-pass (mask and filter, within 1e-5) and the
  discrete-table sigma draw (the JAX draw's indices handed to the port)
  against JAX;
- the tiny engine, torch only: ``sample`` in sequential mode equals batched
  within 1e-5, and with churn from a ``torch.Generator`` keeps frame 0
  pinned.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu.diffusion import denoiser as jden
from vista_tpu.diffusion import loss as jloss
from vista_tpu.diffusion import sigma_sampling as jsigma
from vista_tpu.diffusion import discretization as jdisc
from vista_tpu.diffusion import sampling_utils as jsu
from vista_tpu.diffusion.guidance import GuiderConfig as JGuiderConfig
from vista_tpu.diffusion.sampler import SamplerConfig as JSamplerConfig
from vista_tpu.diffusion.sampler import sample_euler_edm as jsample
from vista_tpu_torch.diffusion import denoiser as den
from vista_tpu_torch.diffusion import loss
from vista_tpu_torch.diffusion import sigma_sampling
from vista_tpu_torch.diffusion import discretization as disc
from vista_tpu_torch.diffusion import sampling_utils as su
from vista_tpu_torch.diffusion.guidance import GuiderConfig
from vista_tpu_torch.diffusion.sampler import SamplerConfig, sample_euler_edm
from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine

T, HW, C = 4, 4, 3
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).permute(0, 3, 1, 2).contiguous()


def toy_jax(x, sigma, cond, mask):
    s = sigma[:, None, None, None]
    out = x / (1.0 + s**2) + jnp.tanh(cond["bias"])[:, None, None, :] * s / (1.0 + s)
    if mask is not None:
        out = out + 0.1 * mask[:, None, None, None]
    return out


def toy_torch(x, sigma, cond, mask):
    s = sigma[:, None, None, None]
    out = x / (1.0 + s**2) + torch.tanh(cond["bias"])[:, :, None, None] * s / (1.0 + s)
    if mask is not None:
        out = out + 0.1 * mask[:, None, None, None]
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    noise = rng.standard_normal((T, HW, HW, C)).astype(np.float32)
    cond_frame = rng.standard_normal((T, HW, HW, C)).astype(np.float32)
    mask = np.zeros(T, np.float32)
    mask[0] = 1.0
    cond = {"bias": rng.standard_normal((T, C)).astype(np.float32)}
    uc = {"bias": rng.standard_normal((T, C)).astype(np.float32)}
    return noise, cond, uc, cond_frame, mask


def run_both(inputs, churn=0.0, mode="batched", tmin=0.0, tmax=999.0, steps=5):
    noise, cond, uc, cond_frame, mask = inputs
    key = jax.random.key(7)
    jcfg = JSamplerConfig(num_steps=steps, s_churn=churn, s_tmin=tmin, s_tmax=tmax,
                          cfg_mode=mode, guider=JGuiderConfig(kind="triangle", scale=2.5,
                                                              num_frames=T))
    ref = jsample(toy_jax, jnp.asarray(noise), {k: jnp.asarray(v) for k, v in cond.items()},
                  {k: jnp.asarray(v) for k, v in uc.items()}, jnp.asarray(cond_frame),
                  jnp.asarray(mask), jcfg, num_frames=T, key=key if churn else None)
    draws = lambda i: nchw(jax.random.normal(jax.random.fold_in(key, i), noise.shape,
                                             dtype=jnp.float32))
    cfg = SamplerConfig(num_steps=steps, s_churn=churn, s_tmin=tmin, s_tmax=tmax,
                        cfg_mode=mode, guider=GuiderConfig(kind="triangle", scale=2.5,
                                                           num_frames=T))
    got = sample_euler_edm(toy_torch, nchw(noise), {k: torch.from_numpy(v) for k, v in cond.items()},
                           {k: torch.from_numpy(v) for k, v in uc.items()}, nchw(cond_frame),
                           torch.from_numpy(mask), cfg, num_frames=T,
                           churn_noise=draws if churn else None)
    return got.permute(0, 2, 3, 1).numpy(), np.asarray(ref)


def test_churn_matches_jax(inputs):
    got, ref = run_both(inputs, churn=1.0)
    assert _rel(got, ref) <= TOL
    assert np.array_equal(got[0], inputs[3][0])  # frame 0 pinned bit for bit
    plain, _ = run_both(inputs, churn=0.0)
    assert _rel(got, plain) > 1e-3  # the churn reached the result


def test_churn_gate_matches_jax(inputs):
    """Churn only where ``s_tmin <= sigma <= s_tmax``: of the 5 steps'
    sigmas (700, 134.9, 15.59, 0.678, 0.002) the gate (0.5, 20) takes the
    middle two. A step outside the gate adds nothing in the port, as
    upstream's ``if gamma > 0``; the JAX scan adds ``eps * sqrt(max(sigma_hat^2
    - sigma^2, 0))`` there, which XLA on the CPU contracts into an FMA that
    leaves sigma^2's rounding error under the root (at 15.59 and 0.678:
    2.3e-3 and 1.1e-4 times eps), so the gate is checked where that error
    is zero, and the port's off steps against its own plain loop."""
    got, ref = run_both(inputs, churn=1.0, tmin=0.5, tmax=20.0)
    assert _rel(got, ref) <= TOL
    plain, _ = run_both(inputs)
    full, _ = run_both(inputs, churn=1.0)
    assert _rel(got, plain) > 1e-3 and _rel(got, full) > 1e-3
    never, _ = run_both(inputs, churn=1.0, tmin=1000.0, tmax=2000.0)
    assert np.array_equal(never, plain)


def test_sequential_matches_jax_and_batched(inputs):
    got, ref = run_both(inputs, mode="sequential")
    assert _rel(got, ref) <= TOL
    batched, _ = run_both(inputs, mode="batched")
    assert _rel(got, batched) <= TOL


def test_raises_without_noise_and_on_unknown_mode(inputs):
    noise = nchw(inputs[0])
    cond = {"bias": torch.from_numpy(inputs[1]["bias"])}
    with pytest.raises(ValueError, match="churn_noise"):
        sample_euler_edm(toy_torch, noise, cond, config=SamplerConfig(num_steps=2, s_churn=1.0))
    with pytest.raises(ValueError, match="cfg_mode"):
        sample_euler_edm(toy_torch, noise, cond, config=SamplerConfig(num_steps=2,
                                                                      cfg_mode="parallel"))


def test_sampling_utils_match_jax():
    rng = np.random.default_rng(1)
    x, den_ = (rng.standard_normal((3, 2, 4, 4)).astype(np.float32) for _ in range(2))
    sigma = rng.uniform(0.1, 5.0, (3,)).astype(np.float32)
    assert _rel(su.to_d(torch.from_numpy(x), torch.from_numpy(sigma), torch.from_numpy(den_)),
                jsu.to_d(jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(den_))) <= TOL
    got = su.apply_cfg_with_rescale(torch.from_numpy(x), torch.from_numpy(den_), 3.0, 0.7)
    assert _rel(got, jsu.apply_cfg_with_rescale(jnp.asarray(x), jnp.asarray(den_), 3.0,
                                                0.7)) <= TOL
    s_from, s_to = np.float32([3.0, 1.0, 0.5]), np.float32([1.0, 0.5, 0.0])
    for eta in (1.0, 0.5, 0.0):
        got = su.get_ancestral_step(torch.from_numpy(s_from), torch.from_numpy(s_to), eta)
        ref = jsu.get_ancestral_step(jnp.asarray(s_from), jnp.asarray(s_to), eta)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=TOL, atol=1e-7)
    t = [float(v) for v in disc.edm_sigmas(8, sigma_max=80.0)]
    for order, i, j in ((1, 0, 0), (2, 3, 1), (3, 4, 2), (4, 6, 0)):
        assert su.linear_multistep_coeff(order, t, i, j) == pytest.approx(
            jsu.linear_multistep_coeff(order, t, i, j), rel=1e-12)
    got = su.to_sigma(su.to_neg_log_sigma(torch.from_numpy(sigma)))
    np.testing.assert_allclose(su.to_neg_log_sigma(torch.from_numpy(sigma)).numpy(),
                               np.asarray(jsu.to_neg_log_sigma(jnp.asarray(sigma))), rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsu.to_sigma(
        jsu.to_neg_log_sigma(jnp.asarray(sigma)))), rtol=TOL)


@pytest.mark.parametrize("n", [25, 1000])
def test_legacy_ddpm_sigmas_match_jax(n):
    got = disc.legacy_ddpm_sigmas(n).numpy()
    ref = np.asarray(jdisc.legacy_ddpm_sigmas(n))
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    assert np.array_equal(disc.legacy_ddpm_sigmas(n, append_zero=False).numpy(),
                          np.asarray(jdisc.legacy_ddpm_sigmas(n, append_zero=False)))
    with pytest.raises(ValueError):
        disc.legacy_ddpm_sigmas(1001)


@pytest.mark.parametrize("t,h,w,d_s,d_t", [(5, 8, 12, 0.25, 0.25), (4, 6, 6, 0.3, 0.5)])
def test_fourier_highpass_3d_matches_jax(t, h, w, d_s, d_t):
    mask = loss.fourier_highpass_mask_3d(t, h, w, d_s, d_t)
    jmask = jloss.fourier_highpass_mask_3d(t, h, w, d_s, d_t)
    assert np.array_equal(mask, jmask) and 0 < mask.sum() < mask.size
    x = np.random.default_rng(t).standard_normal((2 * t, 3, h, w)).astype(np.float32)
    got = loss.fourier_filter_highpass_3d(torch.from_numpy(x), torch.from_numpy(mask), t)
    ref = jloss.fourier_filter_highpass_3d(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                           jnp.asarray(jmask), t)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got.permute(0, 2, 3, 1), ref) <= TOL


@pytest.mark.parametrize("n", [1, 6])
def test_discrete_sigmas_match_jax(n):
    table = disc.legacy_ddpm_sigmas(1000, append_zero=False)
    key = jax.random.key(n)
    index = np.array(jax.random.randint(key, (n,), 0, table.shape[0]))  # the JAX draw's
    got = sigma_sampling.discrete_sigmas(torch.from_numpy(index), table, 5)
    ref = jsigma.sample_discrete_sigmas(key, jnp.asarray(table.numpy()), n, 5)
    assert got.shape == (n * 5,) and np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quantize", [True, False])
def test_discrete_denoiser_matches_jax(quantize):
    rng = np.random.default_rng(2)
    table = disc.legacy_ddpm_sigmas(1000, append_zero=False)
    jtable = jdisc.legacy_ddpm_sigmas(1000, append_zero=False)
    x = rng.standard_normal((5, HW, HW, C)).astype(np.float32)
    sigma = rng.uniform(0.05, 12.0, (5,)).astype(np.float32)
    bias = {"bias": rng.standard_normal((5, C)).astype(np.float32)}

    def net_jax(x, c_noise, cond, mask):
        return x * 0.5 + 0.01 * c_noise[:, None, None, None] + cond["bias"][:, None, None, :]

    def net_torch(x, c_noise, cond, mask):
        return x * 0.5 + 0.01 * c_noise[:, None, None, None] + cond["bias"][:, :, None, None]

    idx = den.sigma_to_idx(torch.from_numpy(sigma), table)
    assert np.array_equal(idx.numpy(), np.asarray(jden.sigma_to_idx(jnp.asarray(sigma), jtable)))
    ref = jden.precondition_denoise_discrete(net_jax, jnp.asarray(x), jnp.asarray(sigma),
                                             {"bias": jnp.asarray(bias["bias"])}, jtable,
                                             quantize_c_noise=quantize)
    got = den.precondition_denoise_discrete(net_torch, nchw(x), torch.from_numpy(sigma),
                                            {"bias": torch.from_numpy(bias["bias"])}, table,
                                            quantize_c_noise=quantize)
    assert _rel(got.permute(0, 2, 3, 1).numpy(), ref) <= TOL


def test_engine_sequential_equals_batched_and_churn_pins():
    """The tiny engine (torch only, its own initialisation from a seed):
    sequential and batched CFG agree, and churn from a generator moves the
    result but not the pinned frame."""
    torch.manual_seed(0)
    cfg = EngineConfig().tiny()
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dtype="float32"),
                              vae=dataclasses.replace(cfg.vae, dtype="float32"))
    engine = VistaEngine(cfg, "cpu")
    t, u = cfg.num_frames, cfg.unet
    gen = torch.Generator().manual_seed(3)
    cond = {"crossattn": torch.randn(1, 1, u.context_dim, generator=gen),
            "vector": torch.randn(1, u.adm_in_channels, generator=gen),
            "concat": torch.randn(1, 4, 4, 4, generator=gen)}
    uc = {k: torch.zeros_like(v) for k, v in cond.items()}
    noise, cond_frame = torch.randn(2, t, 4, 4, 4, generator=gen)
    mask = torch.zeros(t)
    mask[0] = 1.0
    guider = GuiderConfig(kind="triangle", scale=2.5, num_frames=t)
    out = {mode: engine.sample(noise, cond, uc, cond_frame, mask,
                               SamplerConfig(num_steps=2, guider=guider, cfg_mode=mode))
           for mode in ("batched", "sequential")}
    assert _rel(out["sequential"].numpy(), out["batched"].numpy()) <= TOL
    churned = engine.sample(noise, cond, uc, cond_frame, mask,
                            SamplerConfig(num_steps=2, guider=guider, s_churn=1.0),
                            churn_noise=torch.Generator().manual_seed(4))
    assert bool(torch.isfinite(churned).all())
    assert torch.equal(churned[0], cond_frame[0])
    assert _rel(churned.numpy(), out["batched"].numpy()) > 1e-3
