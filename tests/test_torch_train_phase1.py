"""A tiny phase-1 step (LoRA-free, action-free UNet, ``slow_spatial``,
``accum_steps = 2``, dynamics loss, condition-frame replacement, ucg
dropout on the default keys): the port's ``Trainer`` called twice (one
micro-step each, per-block remat) against the JAX package's
``make_train_step``, jitted once, called twice, fp32 on the CPU, same weights
and batch, the JAX draws of each call's key injected.

The LoRA-free self-attentions train through K2 split's, K1's and K3's
backward here (their plain versions on the CPU), the path the JAX package's
``_qkv_bwd_kernel`` and temporal ``_bwd_kernel`` serve.

Compared, with the bounds ``tests/test_torch_train.py`` states:

- after call 1 (accumulates, applies nothing): loss, its metrics and the
  micro-batch's gradient norm (1e-4; the norm 1e-3, a sum of squares over
  every gradient, each within ~1e-4), every parameter unchanged on both
  sides (exactly), the EMA equal to the parameters on both sides;
- after call 2 (applies the mean of both micro-steps' gradients): loss and
  metrics (1e-4), the parameters and their EMA (within lr / 10 of each
  value) and Adam's first moment, ``(1 - beta1)`` times the clipped mean
  gradient (1e-3 of each tensor's largest magnitude, floored at 1e-3 of the
  largest of all).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_conditioner import build
from tests.test_torch_train import LOSS, _adam_mu, _batch, _jax_draws, _rel
from vista_tpu.diffusion.loss import LossConfig as JLossConfig
from vista_tpu.engine.training import TrainConfig as JTrainConfig
from vista_tpu.engine.training import create_train_state, make_train_step
from vista_tpu.utils import torch_import as ti
from vista_tpu_torch.diffusion.loss import LossConfig
from vista_tpu_torch.engine.training import TrainConfig, Trainer
from vista_tpu_torch.utils.checkpoint import UNET_PREFIX

OPT = dict(learning_rate=1e-3, warmup_steps=0, policy="slow_spatial", accum_steps=2,
           ema_decay=0.9999)
ACTIONS = ("command", "trajectory", "speed", "angle", "goal")


@pytest.fixture(scope="module")
def run():
    jeng, params, port = build(ucg_rate=0.15, lora=False, seed=41, action=False)
    port.unet.cfg = dataclasses.replace(port.unet.cfg, remat=True)
    t = jeng.cfg.num_frames
    jcfg = JTrainConfig(**OPT, loss=JLossConfig(num_frames=t, **LOSS))
    pcfg = TrainConfig(**OPT, loss=LossConfig(num_frames=t, **LOSS))
    batch = {k: v for k, v in _batch(t).items() if k not in ACTIONS}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["frames"] = tb["frames"].permute(0, 1, 4, 2, 3).contiguous()
    state, tx = create_train_state(jcfg, params)
    frozen = {k: v for k, v in params.items() if k != "unet"}
    jstep = jax.jit(make_train_step(jeng, jcfg, tx))
    trainer = Trainer(port, pcfg)
    export = lambda tree: ti.export_key_map(tree, ti.unet_key_map(jeng.cfg.unet), UNET_PREFIX)
    start = {n: m.clone() for n, m in trainer.master.items()}
    calls = []
    for key in (jax.random.key(42), jax.random.key(43)):
        state, metrics = jstep(state, frozen, jbatch, key)
        got = trainer(tb, _jax_draws(jeng, batch, key, jcfg))
        calls.append(dict(
            jax_metrics={k: float(v) for k, v in metrics.items()}, port_metrics=got,
            params=export(state.unet_params), ema=export(state.ema_params),
            master={n: m.clone() for n, m in trainer.master.items()},
            port_ema={n: e.clone() for n, e in trainer.ema.items()}))
    calls[1]["mu"] = export(_adam_mu(state.opt_state, params["unet"]))
    return dict(calls=calls, trainer=trainer, start=start, init=export(params["unet"]))


@pytest.mark.parametrize("call", [0, 1])
def test_phase1_metrics_match_jax(run, call):
    ref, got = run["calls"][call]["jax_metrics"], run["calls"][call]["port_metrics"]
    assert np.isfinite(got["loss"])
    for k in ("loss", "loss_main", "loss_hf", "sigma_mean"):
        assert _rel(got[k], ref[k]) <= 1e-4, k
    assert _rel(got["grad_norm"], ref["grad_norm"]) <= 1e-3


def test_phase1_first_call_applies_nothing(run):
    first = run["calls"][0]
    for n, m in first["master"].items():
        ref_now, ref_init = first["params"][UNET_PREFIX + n], run["init"][UNET_PREFIX + n]
        assert np.array_equal(np.asarray(ref_now), np.asarray(ref_init)), n
        assert torch.equal(m, run["start"][n]), n
        assert np.array_equal(np.asarray(first["ema"][UNET_PREFIX + n]), np.asarray(ref_init)), n
        assert torch.equal(first["port_ema"][n], m), n


def test_phase1_second_call_update_moments_and_ema_match_jax(run):
    second = run["calls"][1]
    trainer = run["trainer"]
    assert trainer.updates == 1 and trainer.step == 2
    bound = 0.1 * OPT["learning_rate"]
    moved = 0
    for n, master in second["master"].items():
        ref = np.asarray(second["params"][UNET_PREFIX + n])
        assert float(np.abs(master.numpy() - ref).max()) <= bound, n
        assert float(np.abs(second["port_ema"][n].numpy()
                            - np.asarray(second["ema"][UNET_PREFIX + n])).max()) <= bound, n
        moved += not torch.equal(master, run["start"][n])
    assert moved == len(second["master"])
    ref_mu = {n: np.asarray(second["mu"][UNET_PREFIX + n]) for n in trainer.mu}
    floor = 1e-3 * max(float(np.abs(m).max()) for m in ref_mu.values())
    for n, mu in trainer.mu.items():
        err = float(np.abs(mu.numpy() - ref_mu[n]).max())
        assert err <= 1e-3 * max(float(np.abs(ref_mu[n]).max()), floor), n
