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

The same step at ``(data 2, fsdp 1)`` on 2 gloo ranks (``tests/torch_ranks.py``,
started before the JAX step compiles) on a global batch of 2 videos, the
first the one above: each rank's step alone on its video against
``make_train_step`` on that video (its draws from keys 32 and 33), and the
data-parallel step against ``make_train_step`` on the global batch, at the
bounds above. The JAX step runs here at one video only (its compile takes
most of this file's time), so its global step is built from those two: the
loss terms are means over the videos (``diffusion_loss`` normalises each
video's dynamics weight on its own), so its gradient is the mean of theirs,
each unclipped (``clip_by_global_norm`` scaled it by ``grad_clip / norm``
when the norm passed ``grad_clip``; the norm is the rank's, held by the
check of that video's clipped gradient), and ``tx`` and ``ema_update``
apply it. Where the global gradient is within 100 eps (``well_posed``) the
update is held to 2 lr: there the step follows the gradient's last bits
(0.15 lr measured at |g| = 7.5e-9, a gradient 1e-5 of the largest).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.torch_threads import one_thread  # noqa: F401
from tests.test_torch_conditioner import H, W, build, jax_ucg_keep, nchw
from tests.torch_parallel_ranks import data_parallel_step
from tests.torch_ranks import start_ranks
from vista_tpu.engine.ema import ema_update
from vista_tpu.diffusion.loss import LossConfig as JLossConfig
from vista_tpu.engine.training import TrainConfig as JTrainConfig
from vista_tpu.engine.training import create_train_state, lr_mult_tree, make_train_step
from vista_tpu.models.unet import VideoUNet as JVideoUNet
from vista_tpu.models.unet import VideoUNetConfig as JVideoUNetConfig
from vista_tpu.utils import torch_import as ti
from vista_tpu.utils.checkpoint import export_vista_checkpoint
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


def _cat_draws(a: TrainDraws, b: TrainDraws) -> TrainDraws:
    """The draws of two batches as those of one, ``a``'s rows first."""
    cat = lambda x, y: torch.cat([x, y])
    return TrainDraws(posterior=cat(a.posterior, b.posterior), cond_aug=cat(a.cond_aug, b.cond_aug),
                      ucg_keep={k: cat(v, b.ucg_keep[k]) for k, v in a.ucg_keep.items()},
                      loss=LossDraws(sigma_normal=cat(a.loss.sigma_normal, b.loss.sigma_normal),
                                     choice=cat(a.loss.choice, b.loss.choice),
                                     noise=cat(a.loss.noise, b.loss.noise)))


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["frames"] = out["frames"].permute(0, 1, 4, 2, 3).contiguous()
    return out


def _adam_mu(opt_state, params):
    """The first Adam moment of the trained leaves, zeros for the frozen ones."""
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
    draws = _jax_draws(jeng, batch, key, jcfg)
    # the data-parallel step's second video and its draws; its ranks run
    # while the JAX step compiles
    video2, key2 = {k: v[1:] for k, v in _batch(t, b=2).items()}, jax.random.key(33)
    ranks = start_ranks(data_parallel_step, 2, (
        export_vista_checkpoint(params, jeng.cfg), port.cfg, pcfg,
        _torch_batch({k: np.concatenate([v, video2[k]]) for k, v in batch.items()}),
        _cat_draws(draws, _jax_draws(jeng, video2, key2, jcfg))))

    state, tx = create_train_state(jcfg, params)
    frozen = {k: v for k, v in params.items() if k != "unet"}
    jstep = jax.jit(make_train_step(jeng, jcfg, tx))
    clipped_of = lambda s: jax.tree.map(lambda m: np.asarray(m) / (1.0 - jcfg.beta1),
                                        _adam_mu(s.opt_state, params["unet"]))
    new_state, metrics = jstep(state, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    new2, metrics2 = jstep(state, frozen, {k: jnp.asarray(v) for k, v in video2.items()}, key2)
    clipped = clipped_of(new_state)

    before = {k: v.clone() for k, v in port.unet.state_dict().items()}
    trainer = Trainer(port, pcfg)
    loss, aux = trainer.loss_and_grads(_torch_batch(batch), draws)
    port_grads = trainer.grads()
    norm = trainer.apply()
    clip = min(1.0, pcfg.grad_clip / norm)
    export = lambda tree: ti.export_key_map(tree, ti.unet_key_map(jeng.cfg.unet), UNET_PREFIX)

    # the JAX step on the global batch from its steps on each video
    ranks = ranks.results()
    unclip = [max(1.0, r["video_metrics"]["grad_norm"] / jcfg.grad_clip) for r in ranks]
    mean = jax.tree.map(lambda a, b: (a * unclip[0] + b * unclip[1]) / 2.0,
                        clipped, clipped_of(new2))

    @jax.jit  # 851 leaves: eager, the optimizer takes twice as long as its compile
    def apply(grads, state):
        updates, opt_state = tx.update(grads, state.opt_state, state.unet_params)
        new = optax.apply_updates(state.unet_params, updates)
        return new, opt_state, ema_update(state.ema_params, new, 1, jcfg.ema_decay)

    new_global, opt_state, ema_global = apply(mean, state)
    global_metrics = {k: (float(metrics[k]) + float(metrics2[k])) / 2.0
                      for k in ("loss", "loss_main", "loss_hf", "sigma_mean")}
    global_metrics["grad_norm"] = float(optax.global_norm(mean))  # the trained leaves'
    return dict(metrics=metrics, loss=float(loss), aux=aux, trainer=trainer,
                port_grads={n: g * clip for n, g in port_grads.items()}, before=before,
                port=port, grads=export(clipped), new=export(new_state.unet_params),
                ema=export(new_state.ema_params), ranks=ranks,
                video_metrics=[metrics, metrics2],
                video_grads=[export(clipped), export(clipped_of(new2))],
                global_metrics=global_metrics,
                global_grads=export(clipped_of(state.replace(opt_state=opt_state))),
                global_new=export(new_global),
                global_ema=export(ema_global))


def test_train_step_loss_and_metrics_match_jax(step):
    m = step["metrics"]
    assert np.isfinite(step["loss"])
    assert _rel(step["loss"], m["loss"]) <= 1e-4
    for k in ("loss_main", "loss_hf", "sigma_mean"):
        assert _rel(float(step["aux"][k]), m[k]) <= 1e-4, k


def _grads_close(got, exported):
    """Each of ``got`` (clipped gradients by port name) within 1e-3 of the
    JAX one's largest magnitude, floored at 1e-3 of the largest of all."""
    assert got and all("adapter" in n for n in got)
    ref = {n: exported[UNET_PREFIX + n] for n in got}
    floor = 1e-3 * max(float(np.abs(g).max()) for g in ref.values())
    for n, g in got.items():
        err = float(np.abs(np.asarray(g) - ref[n]).max())
        assert err <= 1e-3 * max(float(np.abs(ref[n]).max()), floor), n


def well_posed(g):
    """The elements where Adam's first step is set by the clipped gradient
    ``g``. The step moves an element by lr * g / (|g| + eps), so where |g|
    is within 100 eps the step follows the gradient's last bits, up to 2 lr
    apart between two correct gradients."""
    return np.abs(g) >= 100 * TrainConfig().eps


def _update_close(master, ema, new, new_ema, grads=None):
    """The updated adapters and their EMA within lr / 10 of JAX's; with the
    clipped ``grads`` (JAX's, exported), within 2 lr where the step is not
    well posed."""
    lr = OPT["learning_rate"]
    for n, m in master.items():
        posed = (np.ones(np.shape(m), bool) if grads is None
                 else well_posed(grads[UNET_PREFIX + n]))
        for got, ref in ((m, new), (ema[n], new_ema)):
            err = np.abs(np.asarray(got) - ref[UNET_PREFIX + n])
            assert float(err[posed].max(initial=0.0)) <= 0.1 * lr, n
            assert float(err[~posed].max(initial=0.0)) <= 2 * lr, n


def test_train_step_adapter_grads_match_jax(step):
    _grads_close({n: g.numpy() for n, g in step["port_grads"].items()}, step["grads"])


def test_train_step_update_and_ema_match_jax(step):
    trainer = step["trainer"]
    _update_close({n: m.numpy() for n, m in trainer.master.items()},
                  {n: e.numpy() for n, e in trainer.ema.items()}, step["new"], step["ema"])
    after = step["port"].unet.state_dict()
    changed = [n for n, v in step["before"].items() if not torch.equal(v, after[n])]
    assert changed and all("adapter" in n for n in changed)


def _clipped(out):
    """The clipped gradient of a rank's state after one step (its first
    Adam moment is ``(1 - beta1) * g``)."""
    return {n: m / (1.0 - TrainConfig().beta1) for n, m in out["mu"].items()}


def test_data_parallel_ranks_match_jax_on_their_videos(step):
    for out, metrics, grads in zip(step["ranks"], step["video_metrics"], step["video_grads"]):
        for k in ("loss", "loss_main", "loss_hf", "sigma_mean"):
            assert _rel(out["video_metrics"][k], metrics[k]) <= 1e-4, k
        _grads_close(_clipped(out["video"]), grads)


def test_data_parallel_step_matches_jax_on_the_global_batch(step):
    for out in step["ranks"]:
        for k, ref in step["global_metrics"].items():
            assert _rel(out["data2_metrics"][k], ref) <= (1e-3 if k == "grad_norm" else 1e-4), k
        got = out["data2"]
        _grads_close(_clipped(got), step["global_grads"])
        _update_close(got["master"], got["ema"], step["global_new"], step["global_ema"],
                      step["global_grads"])
        assert got["counts"] == (1, 1)
    # the two ranks hold the same state
    for g in ("master", "mu", "nu", "ema"):
        a, b = (out["data2"][g] for out in step["ranks"])
        assert all(np.array_equal(a[n], b[n]) for n in a), g


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
