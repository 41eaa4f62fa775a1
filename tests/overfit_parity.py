"""The overfit arc's training, the port against the JAX package, on the CPU:
the port's ``Trainer`` (``tools/torch_overfit.py``'s config) from the JAX
test's initial parameters (``init_params(key(0))``, exported into the
port), with either the JAX test's draws (key ``--key``, one ``fold_in`` a
step, split as ``make_train_step`` splits it) or a ``torch.Generator``'s at
``--key``; with ``--jax-steps N`` the JAX test's jitted step runs beside it
for the first N steps and both losses print. Prints the loss margin's
medians (first and last 20 steps) and the medians of 25-step windows.

    JAX_PLATFORMS=cpu python -m tests.overfit_parity --draws jax --key 7 --jax-steps 40
    JAX_PLATFORMS=cpu python -m tests.overfit_parity --draws torch --key 0

Not a test: 250 steps take about 3 min on one thread, and the JAX step's
compile about 1 min.
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_overfit_fidelity import _fp32
from tools import torch_overfit as arc
from vista_tpu.engine.engine import EngineConfig as JEngineConfig
from vista_tpu.engine.engine import VistaEngine as JVistaEngine
from vista_tpu.engine.training import TrainConfig as JTrainConfig
from vista_tpu.engine.training import create_train_state, make_train_step
from vista_tpu.diffusion.loss import LossConfig as JLossConfig
from vista_tpu.utils.checkpoint import export_vista_checkpoint
from vista_tpu_torch.diffusion.loss import LossDraws
from vista_tpu_torch.engine.training import TrainDraws, Trainer, draw_train
from vista_tpu_torch.utils.checkpoint import load_vista_state_dict

def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).permute(0, 3, 1, 2).contiguous()


def jax_draws(key, b: int, t: int, side: int, f: int, z: int) -> TrainDraws:
    """The draws ``make_train_step`` makes from ``key`` (no ucg dropout, no
    condition-frame replacement), in the port's layout."""
    k_enc, k_aug, _, k_loss = jax.random.split(key, 4)
    lat = (b * t, side // f, side // f, z)
    k_sigma, _, k_noise, _ = jax.random.split(k_loss, 4)
    return TrainDraws(
        posterior=_nchw(jax.random.normal(k_enc, lat)),
        cond_aug=_nchw(jax.random.normal(k_aug, (b, side, side, 3))), ucg_keep=None,
        loss=LossDraws(sigma_normal=torch.from_numpy(np.asarray(jax.random.normal(k_sigma, (b,)))),
                       choice=torch.zeros(b, dtype=torch.long),
                       noise=_nchw(jax.random.normal(k_noise, lat))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--draws", choices=["jax", "torch"], default="jax")
    p.add_argument("--key", type=int, default=7)
    p.add_argument("--steps", type=int, default=250)
    p.add_argument("--jax-steps", type=int, default=0)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    jax.config.update("jax_default_matmul_precision", "highest")
    side = arc.SIDE
    jeng = JVistaEngine(_fp32(JEngineConfig().tiny()))
    t = jeng.cfg.num_frames
    params = jeng.init_params(jax.random.key(0), side, side)
    port = arc.build_engine(True, "cpu", 0)
    load_vista_state_dict(port.unet, port.decoder, export_vista_checkpoint(params, jeng.cfg),
                          encoder=port.encoder, conditioner=port.conditioner)
    clips = arc.make_clips(side, side, t)
    tcfg = arc.train_config(t)
    trainer, batch = Trainer(port, tcfg), arc.train_batch(torch.from_numpy(clips))
    if args.jax_steps:
        jcfg = JTrainConfig(learning_rate=2e-3, warmup_steps=5, ema_decay=0.9,
                            loss=JLossConfig(num_frames=t))
        state, tx = create_train_state(jcfg, params)
        step = jax.jit(make_train_step(jeng, jcfg, tx))
        frozen = {k: v for k, v in params.items() if k != "unet"}
        jbatch = {"frames": jnp.asarray(clips), "fps_id": jnp.full((2,), 9.0),
                  "motion_bucket_id": jnp.full((2,), 127.0), "cond_aug": jnp.zeros((2,))}
    key = jax.random.key(args.key)
    gen = torch.Generator().manual_seed(args.key)
    f, z = port.cfg.vae.downsample_factor, port.cfg.vae.z_channels
    losses, rel = [], []
    for i in range(args.steps):
        k = jax.random.fold_in(key, i)
        draws = (jax_draws(k, 2, t, side, f, z) if args.draws == "jax"
                 else draw_train(port, tcfg, batch, gen))
        m = trainer(batch, draws)
        losses.append(m["loss"])
        if i < args.jax_steps:
            state, jm = step(state, frozen, jbatch, k)
            rel.append([abs(a / float(b) - 1) for a, b in ((m["loss"], jm["loss"]),
                                                           (m["grad_norm"], jm["grad_norm"]))])
            print(f"step {i}: loss port {m['loss']:.6g} jax {float(jm['loss']):.6g}, grad norm "
                  f"port {m['grad_norm']:.6g} jax {float(jm['grad_norm']):.6g}, sigma "
                  f"{m['sigma_mean']:.5g}", flush=True)
    if rel:
        worst = np.max(rel, axis=0)
        print(f"over the {len(rel)} steps beside the JAX step: the port's loss within "
              f"{worst[0]:.3g} of JAX's (relative), its gradient norm within {worst[1]:.3g}")
    first, last, ratio = arc.median_ratio(losses)
    print(f"{args.draws} draws at {args.key}: loss median first {arc.WINDOW} {first:.5f}, last "
          f"{arc.WINDOW} {last:.5f}, ratio {ratio:.4f} (limit {arc.LOSS_RATIO}); 25-step window "
          f"medians {[round(float(np.median(losses[i:i + 25])), 4) for i in range(0, len(losses), 25)]}")


if __name__ == "__main__":
    main()
