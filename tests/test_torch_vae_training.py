"""The port's VAE training against the JAX package, tiny configs in fp32 on
the CPU, same weights (random JAX params carried across through the
``torch_import`` key maps; the discriminator's through
``discriminator_state_from_flax``) and inputs made with numpy from a seed:

- the image ``VAEDecoder``, and the encoder and decoder with the ``linear``
  and ``none`` mid-block attention, bound 1e-5 of the largest magnitude;
  ``gaussian_kl``; the ``hinge_d_loss`` values;
- one AE step and one discriminator step of ``VAETrainer`` against one
  jitted JAX ``step_fn`` (``disc_start`` 0, so the generator's adversarial
  term is on): the metrics within 1e-5 relative, the Adam moments within
  1e-5 of each module's largest, and every updated parameter within
  ``STEP_TOL`` of lr of the JAX one where its gradient is past Adam's eps
  (see ``check_step``);
- torch only: which modules a step moves (an AE step leaves the
  discriminator bit-identical, a discriminator step the autoencoder), the
  parity and ``disc_start`` gates, and ``disc_weight = 0``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.torch_threads import one_thread  # noqa: F401
from tests.test_torch_unet import random_params
from vista_tpu.engine import vae_training as jvt
from vista_tpu.models import vae as jvae
from vista_tpu.utils import torch_import as ti
from vista_tpu_torch.engine.vae_training import (PatchDiscriminator, VAETrainConfig,
                                                 VAETrainer, discriminator_state_from_flax,
                                                 hinge_d_loss)
from vista_tpu_torch.models import vae

H = W = 16
TOL = 1e-5
# a first Adam step moves an element by lr g / (|g| + eps): by lr, whatever
# the gradient's size, wherever |g| >> eps = 1e-8. The updated parameters
# are held to 1e-3 of lr where |g| >= 1e-5 (see check_step). The step test
# runs at ch 64, two channels a GroupNorm group as in the full model (four
# there): at one channel a group (ch 16) the bias of a conv under a
# GroupNorm has a gradient that is zero in exact arithmetic, all rounding
STEP_TOL = 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).permute(0, 3, 1, 2).contiguous()


def vae_cfgs(attn_type="vanilla", ch=16):
    j = jvae.VAEConfig(ch=ch, ch_mult=(1, 2), num_res_blocks=1, dtype="float32",
                       attn_type=attn_type)
    return j, vae.VAEConfig(**dataclasses.asdict(j))


def torch_state(params, entries, attn_type):
    """The JAX params in the port's names: the key map's entries, and the
    linear attention's ``to_qkv`` / ``to_out`` (which the map does not name)."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in ti.export_key_map(params, entries).items()}
    if attn_type == "linear":
        attn = params["mid_attn_1"]
        sd["mid.attn_1.to_qkv.weight"] = torch.from_numpy(
            np.array(attn["to_qkv"]["kernel"]).transpose(3, 2, 0, 1).copy())
        sd["mid.attn_1.to_out.weight"] = torch.from_numpy(
            np.array(attn["to_out"]["kernel"]).transpose(3, 2, 0, 1).copy())
        sd["mid.attn_1.to_out.bias"] = torch.from_numpy(np.array(attn["to_out"]["bias"]))
    return {k: v for k, v in sd.items() if not (attn_type != "vanilla"
                                                and k.startswith("mid.attn_1.")
                                                and k.split(".")[2] in ("norm", "q", "k", "v",
                                                                        "proj_out"))}


@pytest.mark.parametrize("attn_type", ["vanilla", "linear", "none"])
def test_encoder_and_image_decoder_match_jax(attn_type):
    jcfg, cfg = vae_cfgs(attn_type)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    z = rng.standard_normal((2, H // 2, W // 2, 4)).astype(np.float32)
    jenc, jdec = jvae.VAEEncoder(jcfg), jvae.VAEDecoder(jcfg)
    key = jax.random.key(0)
    enc_p = random_params(jax.eval_shape(lambda: jenc.init(key, jnp.asarray(x)))["params"], 4)
    dec_p = random_params(jax.eval_shape(lambda: jdec.init(key, jnp.asarray(z)))["params"], 5)
    enc, dec = vae.VAEEncoder(cfg), vae.VAEDecoder(cfg)
    enc.load_state_dict(torch_state(enc_p, ti.vae_encoder_key_map(jcfg), attn_type), strict=True)
    dec.load_state_dict(torch_state(dec_p, ti.vae_decoder_key_map(jcfg, video=False),
                                    attn_type), strict=True)
    with torch.no_grad():
        got_m = enc(nchw(x)).permute(0, 2, 3, 1).numpy()
        got_x = dec(nchw(z)).permute(0, 2, 3, 1).numpy()
    ref_m = jenc.apply({"params": enc_p}, jnp.asarray(x))
    ref_x = jdec.apply({"params": dec_p}, jnp.asarray(z))
    assert got_x.shape == (2, H, W, 3)
    assert _rel(got_m, ref_m) <= TOL and _rel(got_x, ref_x) <= TOL
    if attn_type == "vanilla":
        kl = vae.gaussian_kl(torch.from_numpy(got_m).permute(0, 3, 1, 2))
        np.testing.assert_allclose(kl.numpy(), np.asarray(jvae.gaussian_kl(ref_m)), rtol=TOL)


def test_make_attn_rejects_unknown_type():
    with pytest.raises(ValueError, match="unknown"):
        vae.make_attn("sparse", 32)


def test_hinge_loss_values():
    real, fake = torch.tensor([2.0]), torch.tensor([-2.0])
    assert float(hinge_d_loss(real, fake)) == 0.0
    assert float(hinge_d_loss(-real, -fake)) == 3.0
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal((2, 1, 3, 3)).astype(np.float32)
    assert float(hinge_d_loss(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(
        float(jvt.hinge_d_loss(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)


def port_names(trainer):
    """The port's tensors as the JAX side names them: (JAX tree, torch name)
    for each, and the Adam moments of each."""
    for opt, modules in ((trainer.ae_opt, (("encoder", trainer.encoder),
                                           ("decoder", trainer.decoder))),
                         (trainer.disc_opt, (("disc", trainer.disc),))):
        names = [(tree, n) for tree, m in modules for n, _ in m.named_parameters()]
        yield from ((tree, n, p, mu, nu)
                    for (tree, n), p, mu, nu in zip(names, opt.params, opt.mu, opt.nu))


def check_step(trainer, state, jcfg, lr):
    """The port's Adam moments against optax's (within 1e-5 of the largest
    moment of the module: some gradients, such as the attention's key bias,
    are zero in exact arithmetic, all rounding), and each updated parameter
    against the JAX
    one: within ``STEP_TOL * lr`` where the gradient is at least 1e-5 (1000
    times Adam's eps), else within 2 lr, the most a first Adam step moves
    an element (there the gradient's rounding sets the update's size)."""
    maps = {"encoder": ti.vae_encoder_key_map(jcfg),
            "decoder": ti.vae_decoder_key_map(jcfg, video=False)}
    ref = {}
    for tree, params, opt in (("encoder", state.ae_params["encoder"], state.ae_opt[0]),
                              ("decoder", state.ae_params["decoder"], state.ae_opt[0]),
                              ("disc", state.disc_params, state.disc_opt[0])):
        moments = (opt.mu, opt.nu) if tree == "disc" else (opt.mu[tree], opt.nu[tree])
        if tree == "disc":
            ref[tree] = [discriminator_state_from_flax(t) for t in (params, *moments)]
        else:
            ref[tree] = [ti.export_key_map(t, maps[tree]) for t in (params, *moments)]
    top = {(tree, i): max(float(np.abs(np.asarray(v)).max()) for v in r[i].values())
           for tree, r in ref.items() for i in (1, 2)}
    for tree, n, p, mu, nu in port_names(trainer):
        want_p, want_mu, want_nu = (torch.as_tensor(np.asarray(r[n])) for r in ref[tree])
        for i, got, want in ((1, mu, want_mu), (2, nu, want_nu)):
            assert float((got - want).abs().max()) <= 1e-5 * top[tree, i], (tree, n, i)
        g = want_mu.abs() / 0.5  # mu = (1 - b1) g after the first step
        limit = torch.where(g >= 1e-5, STEP_TOL * lr, 2.0 * lr)
        assert bool(((p.detach() - want_p).abs() <= limit).all()), (tree, n)


def test_ae_and_disc_steps_match_jax():
    tcfg = jvt.VAETrainConfig(learning_rate=1e-4, disc_weight=0.5, disc_start=0,
                              disc_channels=8, disc_layers=2)
    jcfg, cfg = vae_cfgs(ch=64)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, H, W, 3)) * 0.3).astype(np.float32)
    jenc, jdec = jvae.VAEEncoder(jcfg), jvae.VAEDecoder(jcfg)
    jdisc = jvt.PatchDiscriminator(tcfg.disc_channels, tcfg.disc_layers)
    key = jax.random.key(0)
    z0 = jnp.zeros((1, H // 2, W // 2, 4))
    ae = {"encoder": random_params(jax.eval_shape(
              lambda: jenc.init(key, jnp.asarray(x[:1])))["params"], 8),
          "decoder": random_params(jax.eval_shape(lambda: jdec.init(key, z0))["params"], 9)}
    dp = random_params(jax.eval_shape(lambda: jdisc.init(key, jnp.asarray(x[:1])))["params"], 10)
    ae_tx = optax.adam(tcfg.learning_rate, b1=0.5, b2=0.9)
    disc_tx = optax.adam(tcfg.learning_rate, b1=0.5, b2=0.9)
    state = jvt.VAETrainState(step=jnp.zeros((), jnp.int32), ae_params=ae,
                              ae_opt=ae_tx.init(ae), disc_params=dp, disc_opt=disc_tx.init(dp))
    step_fn = jax.jit(jvt.make_vae_train_step(tcfg, jenc, jdec, jdisc, ae_tx, disc_tx))

    enc, dec, disc = vae.VAEEncoder(cfg), vae.VAEDecoder(cfg), PatchDiscriminator(8, 2)
    enc.load_state_dict(torch_state(ae["encoder"], ti.vae_encoder_key_map(jcfg), "vanilla"))
    dec.load_state_dict(torch_state(ae["decoder"], ti.vae_decoder_key_map(jcfg, video=False),
                                    "vanilla"))
    disc.load_state_dict(discriminator_state_from_flax(dp), strict=True)
    trainer = VAETrainer(VAETrainConfig(**dataclasses.asdict(tcfg)), cfg, "cpu", enc, dec, disc)

    for i, which in enumerate((0.0, 1.0)):
        k = jax.random.key(20 + i)
        noise = jax.random.normal(k, (2, H // 2, W // 2, 4), jnp.float32)
        before = {n: p.detach().clone() for n, p in trainer.disc.named_parameters()}
        state, jm = step_fn(state, jnp.asarray(x), k)
        m = trainer.step(nchw(x), nchw(noise))
        assert m["which"] == which == float(jm["which"])
        for name in ("loss", "rec", "kl"):
            assert m[name] == pytest.approx(float(jm[name]), rel=TOL, abs=1e-7), name
        check_step(trainer, state, jcfg, tcfg.learning_rate)
        moved = [n for n, p in trainer.disc.named_parameters() if not torch.equal(p, before[n])]
        assert (len(moved) > 0) == (which == 1.0)
    assert trainer.steps == int(state.step) == 2


def test_parity_and_disc_start_gates():
    """disc_start 3: steps 0-2 train the autoencoder without the adversarial
    term (the loss is rec + kl_weight * kl), step 3 the discriminator, step
    4 the autoencoder with it; an AE step leaves the discriminator
    bit-identical and a discriminator step the autoencoder. With
    disc_weight 0 every step trains the autoencoder."""
    torch.manual_seed(0)
    _, cfg = vae_cfgs()
    x = torch.rand(1, 3, H, W) * 2 - 1
    noise = torch.randn(1, 4, H // 2, W // 2)
    trainer = VAETrainer(VAETrainConfig(learning_rate=1e-3, disc_start=3, disc_channels=8,
                                        disc_layers=2), cfg, "cpu")
    snap = lambda m: {n: p.detach().clone() for n, p in m.named_parameters()}
    whiches = []
    for i in range(5):
        ae, d = snap(nn_list(trainer)), snap(trainer.disc)
        m = trainer.step(x, noise)
        whiches.append(m["which"])
        ae_same = all(torch.equal(p, ae[n]) for n, p in nn_list(trainer).named_parameters())
        d_same = all(torch.equal(p, d[n]) for n, p in trainer.disc.named_parameters())
        assert (ae_same, d_same) == ((True, False) if m["which"] else (False, True)), i
        plain = m["rec"] + 1e-6 * m["kl"]
        if m["which"] == 0.0:
            assert (m["loss"] == pytest.approx(plain, rel=1e-6)) == (i < 3), i
    assert whiches == [0.0, 0.0, 0.0, 1.0, 0.0]
    off = VAETrainer(VAETrainConfig(disc_weight=0.0, disc_start=0, disc_channels=8,
                                    disc_layers=2), cfg, "cpu")
    assert [off.step(x, noise)["which"] for _ in range(3)] == [0.0, 0.0, 0.0]


def nn_list(trainer):
    return torch.nn.ModuleList([trainer.encoder, trainer.decoder])
