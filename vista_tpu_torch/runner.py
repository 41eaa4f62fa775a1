"""Training runtime: setup, loop, logging, validation, checkpoints, resume and
signals (counterpart of ``vista_tpu/runner.py``).

- the run directory and ``config.yaml`` (the port's own fields);
- ``metrics.csv`` with a union-of-keys header: train and val rows carry
  different metrics, and the small file is rewritten with the wider header
  when a key first appears;
- validation: the training loss over fixed, cached held-out batches under
  the EMA weights, no ucg dropout, fixed draws per batch index, ``val_*``;
- image logs at the reference's schedule (every ``image_log_every`` steps
  and the powers of two below it): a sample from the EMA weights with the
  linear guider 1.5 -> 3.0, the input and the VAE reconstruction;
- checkpoints (``utils/checkpoint.save_checkpoint``) every ``ckpt_every``
  steps and at the end, and ``resume``;
- SIGUSR1 checkpoints and continues, SIGTERM checkpoints and stops, SIGUSR2
  opens pdb at the next step; the flags are agreed over the ranks after
  every step, so that every rank leaves or saves at the same step;
- the LR scaling rule ``lr = accum x n_data x batch x base_lr`` (opt-in).

``parallel`` is the JAX mesh: ``data`` x ``fsdp`` ranks of the process
group (``parallel/mesh.py``; one rank without a group). ``data.batch_size``
is the global batch; each rank takes its data rank's rows, so ``fsdp`` peers
see the same batch. Each step's draws are the global batch's, from a
generator seeded from ``(run.seed, step)`` (so a resumed run draws what an
unbroken one would), cut to the data rank's rows. Rank 0 alone writes
``config.yaml``, ``metrics.csv``, images and checkpoints; the others join
the collectives of the EMA context and of the checkpoint's gather.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import signal
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vista_tpu_torch.config import save_config
from vista_tpu_torch.data.pipeline import DataConfig, build_pipeline
from vista_tpu_torch.diffusion.guidance import GuiderConfig
from vista_tpu_torch.diffusion.sampler import SamplerConfig
from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
from vista_tpu_torch.engine.training import TrainConfig, Trainer, draw_train, eval_loss
from vista_tpu_torch.parallel.mesh import Mesh, make_mesh
from vista_tpu_torch.utils import checkpoint as ckpt_io
from vista_tpu_torch.utils.video import save_grid_png, save_video_mp4


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The mesh: ``data`` ranks split the global batch (DDP), ``fsdp`` ranks
    slice the optimizer state (ZeRO); ``data: -1`` takes the ranks left.
    Tensors under ``fsdp_min_size`` elements stay whole."""

    data: int = -1
    fsdp: int = 1
    fsdp_min_size: int = 2**16


@dataclasses.dataclass(frozen=True)
class RunConfig:
    logdir: str = "logs/run"
    max_steps: int = 1000
    log_every: int = 50
    image_log_every: int = 1000
    ckpt_every: int = 1000
    image_log_steps: int = 15        # sampling steps of an image log
    image_log_cfg_max: float = 3.0   # linear guider 1.5 -> 3.0
    image_log_cfg_min: float = 1.5
    scale_lr: bool = False
    seed: int = 0
    # validation every N steps (0: never) over ``val_batches`` batches
    val_every: int = 0
    val_batches: int = 2


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    height: int = 320
    width: int = 576


def _is_log_step(step: int, every: int) -> bool:
    """The reference's image-log schedule: every N steps, plus the powers of
    two below N."""
    if step % every == 0:
        return True
    return step < every and (step & (step - 1)) == 0 and step > 0


def step_generator(seed: int, index: int, device) -> torch.Generator:
    """A generator seeded from ``(seed, index)`` alone."""
    s = int(np.random.SeedSequence([seed, index]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def run_mesh(cfg: ExperimentConfig) -> Mesh:
    """The ``parallel`` mesh over the process group's ranks; raises where the
    sizes do not fit the rank count or the data axis does not divide the
    global batch."""
    par = cfg.parallel
    mesh = make_mesh({"data": par.data, "fsdp": par.fsdp})
    n_data = mesh.size("data")
    if cfg.data.batch_size % n_data:
        raise ValueError(f"global batch {cfg.data.batch_size} not divisible by "
                         f"data-parallel degree {n_data}")
    return mesh


def rank_data(cfg: DataConfig, mesh: Mesh) -> DataConfig:
    """The data rank's share of the global batch ``cfg.batch_size``."""
    return dataclasses.replace(cfg, batch_size=cfg.batch_size // mesh.size("data"))


class Runner:
    """The training loop: the counterpart of the JAX package's
    ``runner.Trainer`` (the port's :class:`Trainer` is the step it drives).

    ``engine`` defaults to the modules' own initialisation under
    ``run.seed`` on ``device``. ``synthetic`` makes the validation batches
    synthetic too, as ``--synthetic-data`` does the training ones.
    ``mesh`` defaults to :func:`run_mesh`; ``pipeline`` yields this data
    rank's rows (:func:`rank_data`, ``process_index`` the data rank).
    """

    def __init__(self, cfg: ExperimentConfig, pipeline=None,
                 engine: Optional[VistaEngine] = None, device="cuda",
                 synthetic: bool = False, mesh: Optional[Mesh] = None):
        self.mesh = mesh = mesh if mesh is not None else run_mesh(cfg)
        self.cfg = cfg
        run = cfg.run
        if engine is None:
            torch.manual_seed(run.seed)
            engine = VistaEngine(cfg.engine, device)
        self.engine = engine
        self.device = engine.device
        self.pipeline = pipeline
        self._stop = False
        self._ckpt_requested = False
        self._debug_requested = False
        # host seconds of each fit() step: (waiting for the batch, the step)
        self.step_times: List[Tuple[float, float]] = []

        if mesh.is_first:
            os.makedirs(os.path.join(run.logdir, "checkpoints"), exist_ok=True)
            os.makedirs(os.path.join(run.logdir, "images"), exist_ok=True)
            save_config(cfg, os.path.join(run.logdir, "config.yaml"))

        tcfg = cfg.train
        n_data = mesh.size("data")
        # the global batch (the pipeline yields the data rank's rows)
        bs = pipeline.cfg.batch_size * n_data if pipeline is not None else cfg.data.batch_size
        if run.scale_lr:  # the JAX rule: accum x n_data x global batch x base lr
            tcfg = dataclasses.replace(
                tcfg, learning_rate=tcfg.accum_steps * n_data * bs * tcfg.learning_rate)
        self.tcfg = tcfg
        self.trainer = Trainer(engine, tcfg, mesh, cfg.parallel.fsdp_min_size)

        self.val_pipeline = None
        self._val_batches = None
        if run.val_every > 0:
            # one worker thread: the cached set is then the same in every run,
            # a resumed one included, and no extra batch is decoded
            dcfg = cfg.data
            val_cfg = dataclasses.replace(
                dcfg, sources=dcfg.val_sources or dcfg.sources, seed=dcfg.seed + 1,
                batch_size=bs // n_data, samples_per_epoch=max(run.val_batches * bs, 1),
                num_threads=1)
            self.val_pipeline = build_pipeline(val_cfg, cfg.height, cfg.width,
                                               cfg.engine.num_frames, synthetic=synthetic,
                                               process_index=mesh.coord("data"))

        self._metrics_path = os.path.join(run.logdir, "metrics.csv")
        self._csv_initialized = os.path.exists(self._metrics_path)
        self._csv_fields = None

    # ---- signals: SIGUSR1 checkpoints and continues; SIGTERM checkpoints and
    # stops; SIGUSR2 opens pdb at the top of the next step
    def install_signal_handlers(self) -> Dict:
        """Install the handlers; returns the ones they replace."""
        def on_usr1(signum, frame):
            self._ckpt_requested = True

        def on_term(signum, frame):
            self._ckpt_requested = True
            self._stop = True

        def on_usr2(signum, frame):
            self._debug_requested = True

        return {s: signal.signal(s, h) for s, h in ((signal.SIGUSR1, on_usr1),
                                                    (signal.SIGTERM, on_term),
                                                    (signal.SIGUSR2, on_usr2))}

    def _agreed_flags(self) -> Tuple[bool, bool]:
        """(stop, checkpoint) as any rank has them: the local signal flags,
        all-reduced (max) over the ranks."""
        if not self.mesh.distributed:
            return self._stop, self._ckpt_requested
        flags = torch.tensor([self._stop, self._ckpt_requested], dtype=torch.int32,
                             device=self.device)
        dist.all_reduce(flags, op=dist.ReduceOp.MAX)
        self._stop, self._ckpt_requested = (bool(f) for f in flags.tolist())
        return self._stop, self._ckpt_requested

    def _maybe_divein(self):
        if self._debug_requested:
            self._debug_requested = False
            if not self.mesh.is_first:
                return
            import pdb

            print("SIGUSR2: entering pdb (c to continue training)", flush=True)
            pdb.Pdb().set_trace()

    def _log_metrics(self, step: int, metrics: Dict):
        """Append a row to metrics.csv (rank 0); when a new key first appears
        the file is rewritten with the wider header, so every row keeps its
        columns."""
        if not self.mesh.is_first:
            return
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        if self._csv_fields is None and self._csv_initialized:
            with open(self._metrics_path, newline="") as f:
                self._csv_fields = next(csv.reader(f), None)
        if self._csv_fields is None:
            self._csv_fields = list(row)
            self._csv_initialized = False
        new_keys = [k for k in row if k not in self._csv_fields]
        if new_keys:
            self._csv_fields = self._csv_fields + new_keys
            if self._csv_initialized:
                with open(self._metrics_path, newline="") as f:
                    old = list(csv.DictReader(f))
                with open(self._metrics_path, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=self._csv_fields, restval="")
                    w.writeheader()
                    w.writerows(old)
        with open(self._metrics_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_fields, restval="")
            if not self._csv_initialized:
                w.writeheader()
                self._csv_initialized = True
            w.writerow(row)

    def _put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> tensors on the engine's device (through pinned
        memory to the card); frames ``(b, t, H, W, 3)`` -> ``(b, t, 3, H, W)``."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        out["frames"] = out["frames"].permute(0, 1, 4, 2, 3).contiguous()
        return out

    def _print(self, msg: str) -> None:
        if self.mesh.is_first:
            print(msg, flush=True)

    def _modules(self) -> Dict[str, torch.nn.Module]:
        e = self.engine
        return {"unet": e.unet, "encoder": e.encoder, "decoder": e.decoder,
                "conditioner": e.conditioner}

    def _shard_of(self) -> Tuple[int, int]:
        return self.mesh.coord("data"), self.mesh.size("data")

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One micro-step on this data rank's rows of the global batch, its
        draws the global batch's from ``(run.seed, step)``. Under
        ``lora_only`` the gradient norm (over the trained leaves only) is
        reported as ``grad_norm_trained``."""
        device_batch = self._put_batch(batch)
        gen = step_generator(self.cfg.run.seed, self.trainer.step, self.device)
        metrics = self.trainer(device_batch, draw_train(self.engine, self.tcfg, device_batch, gen,
                                                        shard_of=self._shard_of()))
        if self.tcfg.policy == "lora_only":
            metrics["grad_norm_trained"] = metrics.pop("grad_norm")
        return metrics

    def validate(self) -> Dict[str, float]:
        """The training loss averaged over fixed held-out batches under the
        EMA weights, without ucg dropout, with the draws of each batch index
        fixed: only the weights change between evaluations. Each data rank
        takes its rows; the means are the ranks' mean."""
        run = self.cfg.run
        if self._val_batches is None:
            it = iter(self.val_pipeline)
            self._val_batches = [next(it) for _ in range(run.val_batches)]
            self.val_pipeline.stop()
        totals: Dict[str, float] = {}
        with self.trainer.ema_weights():
            for i, batch in enumerate(self._val_batches):
                b = self._put_batch(batch)
                draws = draw_train(self.engine, self.tcfg, b,
                                   step_generator(run.seed + 17, i, self.device), dropout=False,
                                   shard_of=self._shard_of())
                loss, aux = eval_loss(self.engine, self.tcfg, b, draws)
                vals = self.trainer.data_mean(
                    {"val_loss": loss, **{f"val_{k}": v for k, v in aux.items()}})
                for k, v in vals.items():
                    totals[k] = totals.get(k, 0.0) + float(v) / run.val_batches
        return totals

    def save_checkpoint(self, tag: Optional[str] = None) -> str:
        """Every rank gathers the trainer state; rank 0 writes it."""
        step = self.trainer.step
        path = os.path.join(self.cfg.run.logdir, "checkpoints", tag or f"step_{step:08d}")
        state = self.trainer.state_dict()
        if self.mesh.is_first:
            ckpt_io.save_checkpoint(path, state, self._modules())
        return path

    def resume(self, path: str) -> None:
        state = ckpt_io.load_checkpoint(path)
        for name, module in self._modules().items():
            module.load_state_dict(state["modules"][name])
        self.trainer.load_state_dict(state["trainer"])

    @torch.no_grad()
    def log_images(self, batch: Dict[str, np.ndarray]) -> None:
        """A sample from the EMA weights (the first clip's frame 0 pinned,
        linear guider), the input clip and its VAE reconstruction: a video
        and three grids under ``images/``, from rank 0; the other ranks only
        join the EMA context's gathers."""
        with self.trainer.ema_weights():
            if self.mesh.is_first:
                self._log_images(batch)

    def _log_images(self, batch: Dict[str, np.ndarray]) -> None:
        run = self.cfg.run
        t = self.cfg.engine.num_frames
        eng = self.engine
        first = self._put_batch({k: batch[k][:1] for k in
                                 ("frames", "fps_id", "motion_bucket_id", "cond_aug")})
        frames = first.pop("frames")[0]  # (t, 3, H, W)
        cond_batch = {**first, "cond_frames_without_noise": frames[:1],
                      "cond_frames": frames[:1]}
        sampler = SamplerConfig(
            num_steps=run.image_log_steps,
            guider=GuiderConfig(kind="linear", scale=run.image_log_cfg_max,
                                min_scale=run.image_log_cfg_min, num_frames=t))
        c, uc = eng.condition_pair(cond_batch)
        z = eng.encode_first_stage(frames).float()
        mask = torch.zeros(t, device=self.device)
        mask[0] = 1.0
        step = self.trainer.step
        noise = torch.randn(z.shape, generator=step_generator(run.seed, step, self.device),
                            device=self.device)
        sample = eng.sample(noise, c, uc, z, mask, sampler)
        to_host = lambda px: torch.clamp((px + 1.0) / 2.0, 0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy()
        pixels = to_host(eng.decode_first_stage(sample))
        img_dir = os.path.join(run.logdir, "images")
        save_video_mp4(os.path.join(img_dir, f"sample_{step:08d}.mp4"), pixels)
        save_grid_png(os.path.join(img_dir, f"sample_{step:08d}.png"), pixels)
        save_grid_png(os.path.join(img_dir, f"input_{step:08d}.png"), batch["frames"][0], real=True)
        save_grid_png(os.path.join(img_dir, f"recon_{step:08d}.png"),
                      to_host(eng.decode_first_stage(z)))

    def fit(self) -> Trainer:
        """Train to ``run.max_steps`` (or a SIGTERM), then save ``last``; the
        pipeline's threads are stopped on the way out."""
        run = self.cfg.run
        assert self.pipeline is not None, "fit() needs a data pipeline"
        previous = self.install_signal_handlers()
        try:
            it = iter(self.pipeline)
            t_last = time.perf_counter()
            while self.trainer.step < run.max_steps:
                self._maybe_divein()
                t0 = time.perf_counter()
                batch = next(it)
                t1 = time.perf_counter()
                metrics = self.train_step(batch)
                self.step_times.append((t1 - t0, time.perf_counter() - t1))
                step = self.trainer.step
                if step % run.log_every == 0 or step == 1:
                    now = time.perf_counter()
                    metrics["steps_per_sec"] = run.log_every / max(now - t_last, 1e-9)
                    t_last = now
                    self._log_metrics(step, metrics)
                    self._print(f"step {step}: loss={metrics['loss']:.4f} "
                                f"({metrics['steps_per_sec']:.2f} it/s)")
                if run.val_every > 0 and step % run.val_every == 0:
                    val_metrics = self.validate()
                    self._log_metrics(step, val_metrics)
                    self._print(f"step {step}: val_loss={val_metrics['val_loss']:.4f}")
                if _is_log_step(step, run.image_log_every):
                    try:
                        self.log_images(batch)
                    except Exception as e:  # an image log never stops training
                        print(f"image logging failed at step {step}: {e!r}", flush=True)
                stop, ckpt = self._agreed_flags()
                if step % run.ckpt_every == 0 or ckpt:
                    self.save_checkpoint()
                    self._ckpt_requested = False
                if stop:
                    break
            self.save_checkpoint("last")
        finally:
            self.pipeline.stop()
            for s, h in previous.items():
                signal.signal(s, h)
        return self.trainer
