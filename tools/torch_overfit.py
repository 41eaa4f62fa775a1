"""The overfit-then-sample arc of the port (counterpart of
``tests/test_overfit_fidelity.py``): data -> loss -> optimizer -> EMA ->
sampler -> decode.

The engine overfits two fixed clips (band-limited patterns moving at
constant velocity) for ``--steps`` optimizer steps of the port's
``Trainer``, then samples each clip's continuation from the EMA weights,
conditioned on its first frame, and from the weights it had before step 1,
on the same noise. The arc holds, at the JAX test's margins, when the loss
fell to under half and the trained samples lie far closer to the encoded
clips than the untrained ones (latent MSE over frames 1..t-1 under a
quarter of the untrained one's). The loss is held at 40 fixed draws,
evaluated before step 1 and under the EMA weights after the last: the JAX
test compares the medians of the first and last 20 steps' training
losses, each at its own sigmas, a statistic of the sigma draws more than
of the training (it holds for about half of all draw sequences, in either
package; PERF.md), which is reported beside it. The frozen VAE is
at random init, so the margin is taken in latent space; the decode is the
arc's last link, held to finite pixels. It also holds frame 0 of every
sample to its conditioning latent bit for bit, and the UNet's trained
weights to their fp32 masters after the sampling.

Usage:
  python3 tools/torch_overfit.py --tiny --device cpu   # the JAX test's engine, ~3 min
  python3 tools/torch_overfit.py                       # kernel widths in bf16 on the card
  python3 tools/torch_overfit.py --seed 0 1 2 3        # one arc a seed: the margins' spread
  python3 tools/torch_overfit.py --fp32 --device cpu   # the kernel widths in fp32, ~14 min

``--tiny``: the JAX test's fp32 tiny engine at 32x32 and 4 frames (its
head dim of 16 is the plain versions' only), 250 steps. Without it: the
widths every hand-written kernel takes (``model_channels`` 64, head dim
64, ``context_dim`` 64, 5 frames, remat) in bf16 on the same clips, 400
steps. The weights follow the JAX package's initialisers from ``--seed``
(``jax_init_``: the untrained UNet outputs zero, as in the JAX test). The
engine runs on the card unless ``--device cpu`` is given; it raises
without one. Exits non-zero when a margin is missed; times are on one
thread of the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vista_tpu_torch.diffusion.guidance import GuiderConfig  # noqa: E402
from vista_tpu_torch.diffusion.loss import LossConfig  # noqa: E402
from vista_tpu_torch.diffusion.sampler import SamplerConfig  # noqa: E402
from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine  # noqa: E402
from vista_tpu_torch.engine.training import (TrainConfig, TrainDraws, Trainer,  # noqa: E402
                                             draw_train, eval_loss)

STEPS = 250  # the JAX test's, for its tiny engine
# the kernel widths train more slowly a step at the JAX test's lr: at 250
# steps their fp32 arc on the CPU misses the margins for some seeds, at 400
# it holds them for every seed tried (PERF.md)
KERNEL_STEPS = 400
WINDOW = 20  # steps at each end of the run whose median losses the JAX test compares
EVAL_DRAWS = 2 * WINDOW  # fixed draws the loss is evaluated at before and after training
LOSS_RATIO = 0.5  # median loss after training < this x the median before
MSE_RATIO = 0.25  # trained latent MSE < this x the untrained one's
NOISE_SEED = 100  # the sampling noise's generator (the JAX test's keys 100 + clip)
# the JAX test's frames, 16 x 16 latents (the VAE halves them): at the kernel
# widths K1 and attention_bwd take the wgmma route at ds1 (256 keys) and the
# short one at ds2 (64 keys) and over the frames
SIDE = 32


def make_clips(h: int, w: int, t: int) -> np.ndarray:
    """Two clips ``(2, t, h, w, 3)`` in [-1, 1]: a 4 x 4 grid of random
    colour blocks (``RandomState(42)``) rolled (3, 5) and (-5, 3) pixels a
    frame, so each continuation follows from frame 0."""
    rng = np.random.RandomState(42)
    clips = []
    for vel in [(3, 5), (-5, 3)]:
        base = np.kron(rng.uniform(-1, 1, (4, 4, 3)), np.ones((h // 4, w // 4, 1)))
        clips.append(np.stack([np.roll(base, (i * vel[0], i * vel[1]), axis=(0, 1))
                               for i in range(t)]))
    return np.stack(clips).astype(np.float32)


def engine_config(tiny: bool, fp32: bool = False) -> EngineConfig:
    """``tiny``: the JAX test's engine (``EngineConfig().tiny()``, fp32).
    Else the kernel widths: the phase-1 slice of ``chip_smoke.py``
    (``small_cfg("phase1")``: ``model_channels`` 64, head dim 64,
    ``context_dim`` 64, 5 frames, remat) without its ucg dropout, in bf16,
    or in fp32 with ``fp32`` (then the plain versions only: the kernels take
    bf16)."""
    if tiny:
        cfg = EngineConfig().tiny()
        cond = cfg.conditioner
        return dataclasses.replace(
            cfg, unet=dataclasses.replace(cfg.unet, dtype="float32"),
            vae=dataclasses.replace(cfg.vae, dtype="float32"),
            conditioner=dataclasses.replace(
                cond, clip=dataclasses.replace(cond.clip, dtype="float32"),
                vae=dataclasses.replace(cond.vae, dtype="float32")))
    from chip_smoke import small_cfg, to_bf16

    cfg = small_cfg("phase1")
    cfg = dataclasses.replace(cfg, conditioner=dataclasses.replace(cfg.conditioner,
                                                                   ucg_rate=0.0))
    return cfg if fp32 else to_bf16(cfg)


# the layers the JAX package zero-initialises (``zero_init``): the UNet's
# transformer ``proj_out``, each res block's last conv (spatial and
# temporal) and ``conv_out``; the temporal VAE decoder's time-stack out conv
ZERO_INIT = {"unet": ("proj_out", "out_layers.3", "out.2"),
             "encoder": (), "decoder": ("time_stack.out_layers.3",)}


@torch.no_grad()
def jax_init_(engine: VistaEngine, seed: int) -> None:
    """The JAX package's initialisers (flax's defaults) on the UNet, the VAE
    encoder and decoder: every Linear and conv kernel lecun-normal (a normal
    of std 1/sqrt(fan_in) / 0.8796 truncated at two of its stds), biases
    zero, the :data:`ZERO_INIT` layers zero; norms keep their ones and
    zeros, the mix factors their zeros, the conditioner its own. So the
    untrained UNet outputs zero, as the JAX test's random-init baseline
    does."""
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    for name, zero in ZERO_INIT.items():
        for path, m in getattr(engine, name).named_modules():
            if not isinstance(m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.Conv3d)):
                continue
            std = m.weight[0].numel() ** -0.5 / 0.87962566103423978
            w = torch.empty(m.weight.shape, device=engine.device)
            torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
            m.weight.copy_(w.zero_() if zero and path.endswith(zero) else w)
            if m.bias is not None:
                m.bias.zero_()


def build_engine(tiny: bool, device: str, seed: int, fp32: bool = False) -> VistaEngine:
    """The arc's engine of :func:`engine_config` on ``device``, its weights
    from :func:`jax_init_` at ``seed`` (the conditioner's: the modules' own
    initialisation after ``torch.manual_seed(seed)``)."""
    torch.manual_seed(seed)
    engine = VistaEngine(engine_config(tiny, fp32), device)
    jax_init_(engine, seed)
    return engine


def train_config(t: int) -> TrainConfig:
    """The JAX test's optimizer: lr 2e-3, 5 warm-up steps, EMA 0.9, the
    rest at the defaults (policy ``full``)."""
    return TrainConfig(learning_rate=2e-3, warmup_steps=5, ema_decay=0.9,
                       loss=LossConfig(num_frames=t))


def sampler_config(t: int) -> SamplerConfig:
    """The JAX test's sampler: 10 Euler steps, triangle CFG at 2.0."""
    return SamplerConfig(num_steps=10, guider=GuiderConfig(kind="triangle", scale=2.0,
                                                           num_frames=t))


def train_batch(clips: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The fixed batch of both clips ``(2, t, h, w, 3)``: frames ``(2, t, 3,
    h, w)``, fps_id 9, motion_bucket_id 127, cond_aug 0."""
    n = clips.shape[0]
    full = lambda v: torch.full((n,), v, device=clips.device)
    return {"frames": clips.permute(0, 1, 4, 2, 3).contiguous(), "fps_id": full(9.0),
            "motion_bucket_id": full(127.0), "cond_aug": full(0.0)}


def overfit(engine: VistaEngine, tcfg: TrainConfig, clips: torch.Tensor, steps: int,
            gen: torch.Generator):
    """``steps`` optimizer steps of a new ``Trainer`` on the fixed batch of
    both clips, each step's draws from ``draw_train(..., gen)``. Returns the
    trainer, the per-step losses and the per-step host seconds of the whole
    step and of its optimizer update (``Trainer.apply``, from the end of the
    backward on the device to the loss's read back)."""
    trainer = Trainer(engine, tcfg)
    batch = train_batch(clips)
    sync = torch.cuda.synchronize if clips.is_cuda else (lambda: None)
    losses, seconds, apply_s = [], [], []
    for _ in range(steps):
        draws = draw_train(engine, tcfg, batch, gen)
        t0 = time.perf_counter()
        loss, _ = trainer.loss_and_grads(batch, draws)
        sync()
        t1 = time.perf_counter()
        trainer.apply()
        losses.append(float(loss))
        t2 = time.perf_counter()
        seconds.append(t2 - t0)
        apply_s.append(t2 - t1)
    return trainer, losses, seconds, apply_s


@dataclasses.dataclass
class Samples:
    """What :func:`latent_mse` measured: the mean over clips of the latent
    MSE over frames 1..t-1 (``mse``) and each clip's, the sampled and the
    encoded latents (fp32, ``(t, z, h, w)`` a clip) and the decoded pixels
    of the last clip, fp32 ``(t, h, w, 3)``; seconds on the host clock,
    synchronised on the card."""

    mse: float
    mses: List[float]
    latents: List[torch.Tensor]
    targets: List[torch.Tensor]
    pixels: torch.Tensor
    sample_s: float  # host seconds of the conditioning, encode and sampling
    decode_s: float  # host seconds of the decode


def cond_batch(frames: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The conditioning of one clip ``(t, 3, h, w)`` on its frame 0."""
    one = lambda v: torch.full((1,), v, device=frames.device)
    return {"fps_id": one(9.0), "motion_bucket_id": one(127.0), "cond_aug": one(0.0),
            "cond_frames_without_noise": frames[:1], "cond_frames": frames[:1]}


def draw_noises(engine: VistaEngine, clips: torch.Tensor, seed: int = NOISE_SEED):
    """One starting noise a clip, the latents' shape, shared by the runs it
    compares."""
    n, t, h, w, _ = clips.shape
    f, z = engine.cfg.vae.downsample_factor, engine.cfg.vae.z_channels
    gen = torch.Generator(device=clips.device).manual_seed(seed)
    return [torch.randn(t, z, h // f, w // f, generator=gen, device=clips.device)
            for _ in range(n)]


@torch.no_grad()
def latent_mse(engine: VistaEngine, clips: torch.Tensor, sampler: SamplerConfig,
               noises: List[torch.Tensor]) -> Samples:
    """For each clip, under the weights the UNet holds: ``condition_pair``
    on frame 0, ``encode_first_stage`` of the clip (the posterior's mode),
    ``VistaEngine.sample`` from its noise with frame 0 pinned to the encoded
    frame 0, and the MSE over frames 1..t-1; then ``decode_first_stage`` of
    the last clip's samples (the JAX test's ``_sample_latent_mse``)."""
    t = clips.shape[1]
    mask = torch.zeros(t, device=clips.device)
    mask[0] = 1.0
    sync = torch.cuda.synchronize if clips.is_cuda else (lambda: None)
    mses, latents, targets = [], [], []
    t0 = time.perf_counter()
    for clip, noise in zip(clips, noises):
        frames = clip.permute(0, 3, 1, 2).contiguous()
        c, uc = engine.condition_pair(cond_batch(frames))
        z = engine.encode_first_stage(frames).float()
        lat = engine.sample(noise, c, uc, cond_frame=z, cond_mask=mask, sampler=sampler)
        mses.append(float(torch.mean((lat[1:] - z[1:]) ** 2)))
        latents.append(lat)
        targets.append(z)
    sync()
    t1 = time.perf_counter()
    px = engine.decode_first_stage(latents[-1].to(engine.cfg.vae.compute_dtype))
    sync()
    return Samples(float(np.mean(mses)), mses, latents, targets,
                   px.float().permute(0, 2, 3, 1), t1 - t0, time.perf_counter() - t1)


@contextlib.contextmanager
def loaded(module: torch.nn.Module, state: Dict[str, torch.Tensor]):
    """For the span of the block ``module``'s parameters hold ``state``
    (by name); on exit they hold what they held before, bit for bit."""
    params = dict(module.named_parameters())
    with torch.no_grad():
        saved = {n: params[n].detach().clone() for n in state}
        for n, v in state.items():
            params[n].copy_(v)
    try:
        yield
    finally:
        with torch.no_grad():
            for n, v in saved.items():
                params[n].copy_(v)


def median_ratio(losses: List[float]):
    """(first-20 median, last-20 median, their ratio): the JAX test's
    statistic over the per-step training losses."""
    first, last = float(np.median(losses[:WINDOW])), float(np.median(losses[-WINDOW:]))
    return first, last, last / first


def eval_draws(engine: VistaEngine, tcfg: TrainConfig, batch: Dict[str, torch.Tensor],
               gen: torch.Generator) -> List[TrainDraws]:
    """``EVAL_DRAWS`` draws of the batch (no ucg dropout) whose videos' sigmas
    are the training distribution's quantiles ``(i + 0.5) / n`` over all
    ``n`` of their videos, in order, two neighbours a draw; the noises are
    ``gen``'s."""
    draws = [draw_train(engine, tcfg, batch, gen, dropout=False) for _ in range(EVAL_DRAWS)]
    b = draws[0].loss.sigma_normal.shape[0]
    n = b * len(draws)
    normal = torch.special.ndtri((torch.arange(n, dtype=torch.float64) + 0.5) / n).float()
    for i, d in enumerate(draws):
        d.loss.sigma_normal = normal[i * b:(i + 1) * b].to(d.loss.sigma_normal.device)
    return draws


def eval_losses(engine: VistaEngine, tcfg: TrainConfig, batch: Dict[str, torch.Tensor],
                draws: List[TrainDraws]) -> List[float]:
    """The training loss under the weights the UNet holds, without a
    gradient, at each of ``draws`` (``eval_loss``)."""
    return [float(eval_loss(engine, tcfg, batch, d)[0]) for d in draws]


def run_arc(engine: VistaEngine, steps: int = STEPS, seed: int = 0) -> Dict:
    """The whole arc on ``engine`` (trained in place): the clips at the
    engine's frame count, ``steps`` steps of :func:`overfit` with the loss at
    :func:`eval_draws` before and after, then :func:`latent_mse` under the
    EMA weights and under the weights saved before step 1 on the same noise.
    Returns the readings (JSON-able), the seconds of each stage and
    ``faults``, the margins and checks that missed (empty when the arc
    holds)."""
    dev = engine.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t = engine.cfg.num_frames
    clips = torch.from_numpy(make_clips(SIDE, SIDE, t)).to(dev)
    tcfg, sampler = train_config(t), sampler_config(t)
    initial = {n: p.detach().clone() for n, p in engine.unet.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    batch = train_batch(clips)
    fixed = eval_draws(engine, tcfg, batch, gen)
    before = eval_losses(engine, tcfg, batch, fixed)
    sync()
    t0 = time.perf_counter()
    trainer, losses, step_s, apply_s = overfit(engine, tcfg, clips, steps, gen)
    sync()
    train_s = time.perf_counter() - t0
    after = eval_losses(engine, tcfg, batch, fixed)
    with trainer.ema_weights():
        after_ema = eval_losses(engine, tcfg, batch, fixed)
    held = {n: p.detach().clone() for n, p in engine.unet.named_parameters()}
    masters = {n: m.clone() for n, m in trainer.master.items()}
    noises = draw_noises(engine, clips)
    with trainer.ema_weights():
        trained = latent_mse(engine, clips, sampler, noises)
    with loaded(engine.unet, initial):
        baseline = latent_mse(engine, clips, sampler, noises)
    first, last, loss_ratio = median_ratio(losses)
    fell = float(np.median(after_ema)) / float(np.median(before))
    faults = []
    if not all(np.isfinite(losses + before + after + after_ema)):
        faults.append("a loss is not finite")
    if not fell < LOSS_RATIO:
        faults.append(f"the EMA weights' loss did not fall at the {EVAL_DRAWS} fixed draws: "
                      f"median {np.median(before):.4f} -> {np.median(after_ema):.4f}")
    if not trained.mse < MSE_RATIO * baseline.mse:
        faults.append(f"trained latent MSE {trained.mse:.4f} is not under {MSE_RATIO} x the "
                      f"random-init {baseline.mse:.4f}")
    for name, run in (("trained", trained), ("random-init", baseline)):
        for i, (lat, z) in enumerate(zip(run.latents, run.targets)):
            if not torch.equal(lat[0], z[0]):
                faults.append(f"{name} clip {i}: frame 0 is not its conditioning latent")
    px = trained.pixels
    if tuple(px.shape) != (t, SIDE, SIDE, 3) or not bool(torch.isfinite(px).all()):
        faults.append(f"decoded pixels {tuple(px.shape)} not finite or not "
                      f"{(t, SIDE, SIDE, 3)}")
    moved = [n for n, p in engine.unet.named_parameters() if not torch.equal(p, held[n])]
    moved += [n for n, m in trainer.master.items() if not torch.equal(m, masters[n])]
    if moved:
        faults.append(f"sampling changed {len(moved)} UNet parameters or masters: {moved[:3]}")
    timed, timed_apply = step_s[10:] or step_s, apply_s[10:] or apply_s
    return dict(steps=steps, frames=t, losses=losses,
                eval_before=before, eval_after=after, eval_after_ema=after_ema,
                eval_before_median=float(np.median(before)),
                eval_after_median=float(np.median(after)),
                eval_after_ema_median=float(np.median(after_ema)), eval_ratio=fell,
                loss_first_median=first, loss_last_median=last, loss_ratio=loss_ratio,
                trained_mse=trained.mse, baseline_mse=baseline.mse,
                mse_ratio=trained.mse / baseline.mse, trained_mses=trained.mses,
                baseline_mses=baseline.mses, s_per_step=float(np.mean(timed)),
                apply_s_per_step=float(np.mean(timed_apply)),
                train_s=train_s, sample_s=trained.sample_s, decode_s=trained.decode_s,
                faults=faults)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="the port's overfit-then-sample arc")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs (default: the card; it raises without one)")
    p.add_argument("--tiny", action="store_true",
                   help="the JAX test's fp32 tiny engine at 32x32, 4 frames")
    p.add_argument("--fp32", action="store_true",
                   help="the kernel widths in fp32 (the plain versions: with --device cpu)")
    p.add_argument("--steps", type=int, default=None,
                   help=f"optimizer steps (default {STEPS} with --tiny, else {KERNEL_STEPS})")
    p.add_argument("--seed", type=int, nargs="+", default=[0],
                   help="the weights' seed (the draws': seed + 7); several: one arc each")
    p.add_argument("--out", default=None, help="also write the readings as JSON here")
    args = p.parse_args(argv)
    if args.steps is None:
        args.steps = STEPS if args.tiny else KERNEL_STEPS
    return args


def main(argv=None) -> List[Dict]:
    args = parse_args(argv)
    runs, faults = [], []
    for seed in args.seed:
        engine = build_engine(args.tiny, args.device, seed, args.fp32)
        out = dict(seed=seed, device=str(engine.device), **run_arc(engine, args.steps, seed))
        del engine
        print(f"seed {seed}: loss median at {EVAL_DRAWS} fixed draws "
              f"{out['eval_before_median']:.5f} -> EMA {out['eval_after_ema_median']:.5f} (ratio "
              f"{out['eval_ratio']:.4f}, limit {LOSS_RATIO}; online "
              f"{out['eval_after_median']:.5f}); per-step loss median, first "
              f"{WINDOW} steps {out['loss_first_median']:.5f} -> last {WINDOW} "
              f"{out['loss_last_median']:.5f} (ratio {out['loss_ratio']:.4f}: the JAX test's "
              f"statistic, not held); latent MSE trained {out['trained_mse']:.5f} vs random-init "
              f"{out['baseline_mse']:.5f} (ratio {out['mse_ratio']:.4f}, limit {MSE_RATIO}); "
              f"{out['s_per_step']:.4f} s a step ({out['apply_s_per_step']:.4f} s of it the "
              f"optimizer); the trained run's sampling "
              f"{out['sample_s']:.2f} s, decode {out['decode_s']:.2f} s", flush=True)
        runs.append(out)
        faults += [f"seed {seed}: {f}" for f in out["faults"]]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    if faults:
        raise SystemExit("overfit arc: " + "; ".join(faults))
    return runs


if __name__ == "__main__":
    main()
