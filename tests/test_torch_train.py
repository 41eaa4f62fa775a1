"""One tiny phase-2 (``lora_only``, LoRA + action control, dynamics loss,
condition-frame replacement, ucg dropout) train step: the port's
``Trainer`` against the JAX package's ``make_train_step``, fp32 on the CPU,
same weights (non-zero adapters) and batch, and the JAX draws reproduced
from the same keys (``training.py:158`` split into encode / cond-aug / ucg /
loss keys, ``loss.py:159`` into sigma / mask / noise) and injected.

Compared: the loss and its metrics (1e-4), the adapters' clipped
gradients (the first Adam moment after one step is ``(1 - beta1) * g``;
1e-3 of each tensor's largest magnitude, floored at 1e-3 of the largest of
all), the updated adapters
and their EMA after the optimizer step (within lr / 10 of each value: the
first Adam step moves an element by lr * g / (|g| + 1e-8), so an element
whose gradient is near 1e-8 moves by a fraction of lr that depends on the
last bits of g; measured 2.7e-5 at lr 1e-3), and that every
frozen parameter is unchanged. Also ``lr_mult`` for all three policies
against ``lr_mult_tree`` through the key map.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_conditioner import H, W, build, jax_ucg_keep, nchw
from vista_tpu.diffusion.loss import LossConfig as JLossConfig
from vista_tpu.engine.training import TrainConfig as JTrainConfig
from vista_tpu.engine.training import create_train_state, lr_mult_tree, make_train_step
from vista_tpu.models.unet import VideoUNet as JVideoUNet
from vista_tpu.models.unet import VideoUNetConfig as JVideoUNetConfig
from vista_tpu.utils import torch_import as ti
from vista_tpu_torch.diffusion.loss import LossConfig, LossDraws
from vista_tpu_torch.engine.training import TrainConfig, TrainDraws, Trainer, lr_mult
from vista_tpu_torch.models.unet import VideoUNet, VideoUNetConfig
from vista_tpu_torch.utils.checkpoint import UNET_PREFIX

OPT = dict(learning_rate=1e-3, warmup_steps=0, policy="lora_only", ema_decay=0.9999)
LOSS = dict(use_additional_loss=True, replace_cond_frames=True)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _batch(t, b=1):
    rng = np.random.default_rng(30)
    batch = {"frames": rng.uniform(-1, 1, (b, t, H, W, 3)), "fps_id": np.full((b,), 9.0),
             "motion_bucket_id": np.full((b,), 127.0), "cond_aug": np.full((b,), 0.02),
             "trajectory": rng.standard_normal((b, 8)), "speed": rng.standard_normal((b, 4)),
             "angle": rng.standard_normal((b, 4)), "goal": rng.standard_normal((b, 2)),
             "command": np.ones((b, 1))}
    return {k: np.asarray(v, np.float32) for k, v in batch.items()}


def _jax_draws(jeng, batch, key, cfg):
    """The numbers make_train_step draws from ``key``, in the port's layout."""
    k_enc, k_aug, k_ucg, k_loss = jax.random.split(key, 4)
    b, t = batch["frames"].shape[:2]
    f = jeng.cfg.vae.downsample_factor
    z = jeng.cfg.vae.z_channels
    lat = (b * t, H // f, W // f, z)
    k_sigma, k_mask, k_noise, _ = jax.random.split(k_loss, 4)
    weights = np.array([2.0 ** n for n in range(len(cfg.loss.cond_frames_choices))])
    choice = jax.random.categorical(k_mask, jnp.log(jnp.asarray(weights / weights.sum())),
                                    shape=(b,))
    keep = jax_ucg_keep(k_ucg, jeng.cfg.conditioner, b)
    return TrainDraws(
        posterior=nchw(jax.random.normal(k_enc, lat)),
        cond_aug=nchw(jax.random.normal(k_aug, (b, H, W, 3))),
        ucg_keep={k: torch.from_numpy(v) for k, v in keep.items()},
        loss=LossDraws(sigma_normal=torch.from_numpy(np.asarray(jax.random.normal(k_sigma, (b,)))),
                       choice=torch.from_numpy(np.asarray(choice)),
                       noise=nchw(jax.random.normal(k_noise, lat))))


def _adam_mu(opt_state, params):
    """The first Adam moment of the trained leaves, zeros for the frozen ones."""
    import optax

    mu = optax.tree_utils.tree_get(opt_state, "mu")
    masked = lambda x: type(x).__name__ == "MaskedNode"
    return jax.tree.map(lambda m, p: np.zeros(p.shape, np.float32) if masked(m) else m,
                        mu, params, is_leaf=masked)


@pytest.fixture(scope="module")
def step():
    jeng, params, port = build(ucg_rate=0.15, lora=True, seed=31)
    t = jeng.cfg.num_frames
    jcfg = JTrainConfig(**OPT, loss=JLossConfig(num_frames=t, **LOSS))
    pcfg = TrainConfig(**OPT, loss=LossConfig(num_frames=t, **LOSS))
    batch = _batch(t)
    key = jax.random.key(32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, tx = create_train_state(jcfg, params)
    frozen = {k: v for k, v in params.items() if k != "unet"}
    new_state, metrics = jax.jit(make_train_step(jeng, jcfg, tx))(state, frozen, jbatch, key)
    clipped = jax.tree.map(lambda m: np.asarray(m) / (1.0 - jcfg.beta1),
                           _adam_mu(new_state.opt_state, params["unet"]))

    before = {k: v.clone() for k, v in port.unet.state_dict().items()}
    trainer = Trainer(port, pcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["frames"] = torch.from_numpy(batch["frames"]).permute(0, 1, 4, 2, 3).contiguous()
    draws = _jax_draws(jeng, batch, key, jcfg)
    loss, aux = trainer.loss_and_grads(tb, draws)
    port_grads = trainer.grads()
    norm = trainer.apply()
    clip = min(1.0, pcfg.grad_clip / norm)
    export = lambda tree: ti.export_key_map(tree, ti.unet_key_map(jeng.cfg.unet), UNET_PREFIX)
    return dict(metrics=metrics, loss=float(loss), aux=aux, trainer=trainer,
                port_grads={n: g * clip for n, g in port_grads.items()}, before=before,
                port=port, grads=export(clipped), new=export(new_state.unet_params),
                ema=export(new_state.ema_params))


def test_train_step_loss_and_metrics_match_jax(step):
    m = step["metrics"]
    assert np.isfinite(step["loss"])
    assert _rel(step["loss"], m["loss"]) <= 1e-4
    for k in ("loss_main", "loss_hf", "sigma_mean"):
        assert _rel(float(step["aux"][k]), m[k]) <= 1e-4, k


def test_train_step_adapter_grads_match_jax(step):
    got = step["port_grads"]
    assert got and all("adapter" in n for n in got)
    ref = {n: step["grads"][UNET_PREFIX + n] for n in got}
    floor = 1e-3 * max(float(np.abs(g).max()) for g in ref.values())
    for n, g in got.items():
        err = float(np.abs(g.numpy() - ref[n]).max())
        assert err <= 1e-3 * max(float(np.abs(ref[n]).max()), floor), n


def test_train_step_update_and_ema_match_jax(step):
    trainer = step["trainer"]
    bound = 0.1 * OPT["learning_rate"]
    for n, master in trainer.master.items():
        assert float(np.abs(master.numpy() - step["new"][UNET_PREFIX + n]).max()) <= bound, n
        assert float(np.abs(trainer.ema[n].numpy() - step["ema"][UNET_PREFIX + n]).max()) \
            <= bound, n
    after = step["port"].unet.state_dict()
    changed = [n for n, v in step["before"].items() if not torch.equal(v, after[n])]
    assert changed and all("adapter" in n for n in changed)


@pytest.mark.parametrize("policy", ["full", "slow_spatial", "lora_only"])
def test_lr_mult_matches_jax(policy):
    jcfg = dataclasses.replace(JVideoUNetConfig().tiny(), add_lora=True, action_control=True)
    t = jcfg.num_frames
    shapes = jax.eval_shape(lambda: JVideoUNet(jcfg).init(
        jax.random.key(0), jnp.zeros((t, 8, 8, 8)), jnp.zeros((t,)),
        jnp.zeros((1, 1, jcfg.context_dim + 2432)), jnp.zeros((1, jcfg.adm_in_channels)),
        jnp.zeros((t,)), t))["params"]
    mults = lr_mult_tree(shapes, policy)
    tree = jax.tree.map(lambda m, s: np.full(s.shape, m, np.float32), mults, shapes)
    ref = {k[len(UNET_PREFIX):]: float(v.reshape(-1)[0])
           for k, v in ti.export_key_map(tree, ti.unet_key_map(jcfg), UNET_PREFIX).items()}
    with torch.device("meta"):
        unet = VideoUNet(dataclasses.replace(VideoUNetConfig().tiny(), add_lora=True,
                                             action_control=True))
    got = {n: float(np.float32(lr_mult(n, policy))) for n, _ in unet.named_parameters()}
    assert set(got) == set(ref)
    assert got == ref
