"""The port's training runtime on the CPU, held against the JAX package:

- the eval loss against ``make_eval_step`` (one jit) on the tiny phase-2
  engine (LoRA + action, non-zero adapters) under EMA weights that differ
  from the online ones, the JAX draws reproduced from the key
  (``split(key, 3)`` -> encode / cond-aug / loss), to 1e-4; the EMA context
  restores every parameter bit for bit, in bf16 too;
- ``lambda_linear`` and ``warmup_cosine`` against the JAX schedules, and
  ``_is_log_step`` against the JAX one;
- resume, bit for bit: 2 steps and a save, then one more step in memory,
  against a new ``Runner`` that resumes and takes the same step; also
  between the micro-steps of ``accum_steps=2``, where the accumulation
  buffer must come back; both runs cache the same validation batches;
- ``cli.train.main`` end to end on ``configs/tiny_smoke.yaml`` (CSV rows and
  columns, ``grad_norm`` or ``grad_norm_trained`` by policy, images,
  checkpoint, ``--resume`` appending to the CSV), the module entry point,
  and the card default raising without one;
- the signal handlers' flags, and the ``parallel`` mesh without a process
  group (one rank).
"""

import csv
import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_conditioner import H, W, build, nchw
from tests.test_torch_train import _batch
from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu import runner as jrunner
from vista_tpu.diffusion.loss import LossConfig as JLossConfig
from vista_tpu.engine import lr_schedule as jlr
from vista_tpu.engine.training import TrainConfig as JTrainConfig
from vista_tpu.engine.training import make_eval_step
from vista_tpu.utils import torch_import as ti
from vista_tpu_torch import runner
from vista_tpu_torch.cli import train as train_cli
from vista_tpu_torch.config import load_config
from vista_tpu_torch.data.pipeline import build_pipeline
from vista_tpu_torch.diffusion.loss import LossConfig, LossDraws
from vista_tpu_torch.engine import lr_schedule
from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
from vista_tpu_torch.engine.training import (TrainConfig, TrainDraws, Trainer, draw_train,
                                             eval_loss)
from vista_tpu_torch.utils.checkpoint import UNET_PREFIX

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / "configs" / "tiny_smoke.yaml")
OPT = dict(learning_rate=1e-3, warmup_steps=0, policy="lora_only")
LOSS = dict(use_additional_loss=True, replace_cond_frames=True)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_eval_draws(jeng, batch, key, cfg):
    """The numbers ``make_eval_step`` draws from ``key``, in the port's layout."""
    k_enc, k_aug, k_loss = jax.random.split(key, 3)
    b, t = batch["frames"].shape[:2]
    f = jeng.cfg.vae.downsample_factor
    lat = (b * t, H // f, W // f, jeng.cfg.vae.z_channels)
    k_sigma, k_mask, k_noise, _ = jax.random.split(k_loss, 4)
    weights = np.array([2.0 ** n for n in range(len(cfg.loss.cond_frames_choices))])
    choice = jax.random.categorical(k_mask, jnp.log(jnp.asarray(weights / weights.sum())),
                                    shape=(b,))
    return TrainDraws(
        posterior=nchw(jax.random.normal(k_enc, lat)),
        cond_aug=nchw(jax.random.normal(k_aug, (b, H, W, 3))), ucg_keep=None,
        loss=LossDraws(sigma_normal=torch.from_numpy(np.asarray(jax.random.normal(k_sigma, (b,)))),
                       choice=torch.from_numpy(np.asarray(choice)),
                       noise=nchw(jax.random.normal(k_noise, lat))))


def test_eval_loss_matches_jax():
    jeng, params, port = build(ucg_rate=0.15, lora=True, seed=41)
    t = jeng.cfg.num_frames
    jcfg = JTrainConfig(**OPT, loss=JLossConfig(num_frames=t, **LOSS))
    pcfg = TrainConfig(**OPT, loss=LossConfig(num_frames=t, **LOSS))
    rng = np.random.default_rng(42)
    ema = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
        if "adapter" in jax.tree_util.keystr(path) else x, params["unet"])
    batch = _batch(t)
    key = jax.random.key(43)
    frozen = {k: v for k, v in params.items() if k != "unet"}
    ref_loss, ref_aux = jax.jit(make_eval_step(jeng, jcfg))(
        ema, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    trainer = Trainer(port, pcfg)
    shadows = ti.export_key_map(ema, ti.unet_key_map(jeng.cfg.unet), UNET_PREFIX)
    for n in trainer.ema:
        trainer.ema[n].copy_(torch.from_numpy(np.asarray(shadows[UNET_PREFIX + n])))
    before = {k: v.clone() for k, v in port.unet.state_dict().items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["frames"] = tb["frames"].permute(0, 1, 4, 2, 3).contiguous()
    draws = _jax_eval_draws(jeng, batch, key, jcfg)
    with trainer.ema_weights():
        assert all(torch.equal(p, trainer.ema[n]) for n, p in trainer.params.items())
        loss, aux = eval_loss(port, pcfg, tb, draws)
    assert abs(float(loss) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    assert set(aux) == set(ref_aux)
    for k in aux:
        assert _rel(float(aux[k]), float(ref_aux[k])) <= 1e-4, k
    # the online weights give another loss; the context restored them
    online, _ = eval_loss(port, pcfg, tb, draws)
    assert abs(float(online) - float(loss)) > 1e-4 * abs(float(loss))
    after = port.unet.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    with pytest.raises(ValueError, match="ucg"):
        eval_loss(port, pcfg, tb, dataclasses.replace(draws, ucg_keep={}))


def test_ema_context_restores_bf16_bits():
    """Two optimizer steps in bf16 move the masters off the bf16 grid of the
    initial weights; the EMA context puts bf16(ema) in and bf16(master) back."""
    base = EngineConfig().tiny()
    cfg = dataclasses.replace(base, unet=dataclasses.replace(
        base.unet, dtype="bfloat16", add_lora=True, action_control=True))
    cfg = dataclasses.replace(cfg, conditioner=dataclasses.replace(cfg.conditioner,
                                                                   action_control=True))
    torch.manual_seed(0)
    engine = VistaEngine(cfg, "cpu")
    tcfg = TrainConfig(**OPT, loss=LossConfig(num_frames=cfg.num_frames))
    trainer = Trainer(engine, tcfg)
    gen = torch.Generator().manual_seed(1)
    batch = {"frames": torch.rand(1, cfg.num_frames, 3, 16, 16, generator=gen) * 2 - 1,
             "fps_id": torch.full((1,), 9.0), "motion_bucket_id": torch.full((1,), 127.0),
             "cond_aug": torch.full((1,), 0.02), "trajectory": torch.randn(1, 8, generator=gen)}
    for _ in range(2):
        trainer(batch, draw_train(engine, tcfg, batch, gen))
    before = {k: v.clone() for k, v in engine.unet.state_dict().items()}
    with trainer.ema_weights():
        inside = engine.unet.state_dict()
        moved = [n for n in trainer.params if not torch.equal(inside[n], before[n])]
        assert moved
        for n in trainer.params:
            assert torch.equal(inside[n], trainer.ema[n].to(torch.bfloat16))
        assert all(torch.equal(inside[k], v) for k, v in before.items() if k not in trainer.params)
    after = engine.unet.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_schedules_match_jax():
    pairs = [(lr_schedule.lambda_linear(10, 1e-6, 0.5, 1.0, 40),
              jlr.lambda_linear(10, 1e-6, 0.5, 1.0, 40)),
             (lr_schedule.lambda_linear(1000), jlr.lambda_linear(1000)),
             (lr_schedule.warmup_cosine(10, 1e-6, 0.1, 1.0, 40),
              jlr.warmup_cosine(10, 1e-6, 0.1, 1.0, 40)),
             (lr_schedule.warmup_cosine(0, 0.0, 0.0, 2.0, 30),
              jlr.warmup_cosine(0, 0.0, 0.0, 2.0, 30))]
    for port, ref in pairs:
        got = np.array([port(s) for s in range(50)])
        want = np.array([float(ref(s)) for s in range(50)])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)  # JAX: float32


def test_is_log_step_matches_jax():
    for every in (1, 3, 1000):
        got = [runner._is_log_step(s, every) for s in range(2101)]
        assert got == [jrunner._is_log_step(s, every) for s in range(2101)]
    assert [s for s in range(1, 1001) if runner._is_log_step(s, 1000)] == [
        1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1000]


def _tiny_cfg(logdir, *overrides):
    return load_config(runner.ExperimentConfig, [TINY],
                       [f"run.logdir={logdir}", "data.num_threads=1", *overrides])


def _state(r):
    """Copies of everything a step changes: the trainer state and the modules."""
    s = r.trainer.state_dict()
    out = {f"{g}.{n}": t.clone() for g in ("master", "mu", "nu", "ema", "acc")
           for n, t in s[g].items()}
    out.update({f"{m}.{n}": t.clone() for m, mod in r._modules().items()
                for n, t in mod.state_dict().items()})
    return out, (s["step"], s["updates"])


@pytest.mark.parametrize("policy,accum,steps", [("full", 1, 2), ("lora_only", 2, 3)])
def test_resume_is_bit_exact(tmp_path, monkeypatch, policy, accum, steps):
    monkeypatch.setattr(runner.Runner, "log_images", lambda self, batch: None)
    cfg = _tiny_cfg(tmp_path, f"run.max_steps={steps}", f"train.policy={policy}",
                    f"train.accum_steps={accum}", "engine.unet.add_lora=true",
                    "train.warmup_steps=1", "train.learning_rate=0.01", "run.val_every=1000",
                    "run.val_batches=2")
    pipe = lambda: build_pipeline(cfg.data, cfg.height, cfg.width, cfg.engine.num_frames,
                                  synthetic=True)
    first = runner.Runner(cfg, pipe(), device="cpu")
    first.fit()
    if accum > 1:  # saved between two micro-steps: the buffer holds a gradient
        assert first.trainer.step % accum == 1
        assert any(bool(a.abs().max() > 0) for a in first.trainer.acc.values())
    batch = next(iter(pipe()))
    first.train_step(batch)
    a, counts_a = _state(first)

    second = runner.Runner(cfg, pipe(), device="cpu")
    second.resume(str(tmp_path / "checkpoints" / "last"))
    assert (second.trainer.step, second.trainer.updates) == (steps, (steps // accum))
    second.train_step(batch)
    b, counts_b = _state(second)
    assert counts_a == counts_b == (steps + 1, (steps + 1) // accum)
    assert set(a) == set(b)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, differ[:5]
    # the val pipeline's one thread: the same cached set in both runs
    first.validate()
    second.validate()
    for x, y in zip(first._val_batches, second._val_batches):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("policy,norm_key", [("full", "grad_norm"),
                                             ("lora_only", "grad_norm_trained")])
def test_cli_end_to_end(tmp_path, policy, norm_key):
    logdir = tmp_path / "run"
    overrides = [f"run.logdir={logdir}", "run.max_steps=3", "run.val_every=2",
                 "run.image_log_steps=1", "data.num_threads=2", f"train.policy={policy}",
                 f"engine.unet.add_lora={'true' if policy == 'lora_only' else 'false'}"]
    r = train_cli.main([*overrides, "--base", TINY, "--device", "cpu", "--synthetic-data"])
    assert r.trainer.step == 3 and r.device.type == "cpu"
    assert not any(t.is_alive() for t in r.pipeline._threads)
    csv1 = (logdir / "metrics.csv").read_text()
    rows = _rows(logdir / "metrics.csv")
    train = [row for row in rows if row["loss"]]
    val = [row for row in rows if row["val_loss"]]
    assert [int(row["step"]) for row in train] == [1, 2, 3]
    assert [int(row["step"]) for row in val] == [2]
    header = list(rows[0])
    other = {"grad_norm", "grad_norm_trained"} - {norm_key}
    assert norm_key in header and not other & set(header)
    assert {"loss", "loss_main", "sigma_mean", "steps_per_sec", "val_loss",
            "val_loss_main"} <= set(header)
    assert all(np.isfinite(float(row[k])) for row in train for k in ("loss", norm_key))
    images = sorted(os.listdir(logdir / "images"))
    for step in (1, 2):
        for kind in ("sample", "input", "recon"):
            assert f"{kind}_{step:08d}.png" in images
        assert any(n.startswith(f"sample_{step:08d}.") and not n.endswith(".png")
                   for n in images)
    assert load_config(runner.ExperimentConfig, [str(logdir / "config.yaml")]) == r.cfg
    assert (logdir / "checkpoints" / "last").exists()
    if policy != "full":  # the resume does not depend on the policy
        return

    r = train_cli.main([*overrides, "run.max_steps=4", "--resume",
                        str(logdir / "checkpoints" / "last"), "--base", TINY, "--device", "cpu",
                        "--synthetic-data"])
    assert r.trainer.step == 4 and len(r.step_times) == 1
    csv2 = (logdir / "metrics.csv").read_text()
    assert csv2.startswith(csv1)
    assert [int(row["step"]) for row in _rows(logdir / "metrics.csv")][len(rows):] == [4, 4]


def test_cli_module_runs_and_needs_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "vista_tpu_torch.cli.train", "--device", "cpu", "--base", TINY,
         "--synthetic-data", f"run.logdir={tmp_path}", "run.max_steps=1",
         "run.image_log_steps=1", "data.num_threads=1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done at step 1" in out.stdout
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="found none"):
            train_cli.main(["--base", TINY, "--synthetic-data", f"run.logdir={tmp_path}"])


def test_signal_handlers(tmp_path):
    r = runner.Runner(_tiny_cfg(tmp_path), device="cpu")
    before = {s: signal.getsignal(s) for s in (signal.SIGUSR1, signal.SIGTERM, signal.SIGUSR2)}
    previous = r.install_signal_handlers()
    try:
        assert previous == before
        os.kill(os.getpid(), signal.SIGUSR1)
        assert r._ckpt_requested and not r._stop
        r._ckpt_requested = False
        os.kill(os.getpid(), signal.SIGUSR2)
        assert r._debug_requested and not r._ckpt_requested
        r._debug_requested = False
        os.kill(os.getpid(), signal.SIGTERM)
        assert r._ckpt_requested and r._stop
    finally:
        for s, h in previous.items():
            signal.signal(s, h)


def test_fit_stops_on_sigterm_and_restores_handlers(tmp_path, monkeypatch):
    monkeypatch.setattr(runner.Runner, "log_images", lambda self, batch: None)
    cfg = _tiny_cfg(tmp_path, "run.max_steps=5")
    r = runner.Runner(cfg, build_pipeline(cfg.data, cfg.height, cfg.width, cfg.engine.num_frames,
                                          synthetic=True), device="cpu")
    step = r.train_step

    def step_then_term(batch):
        out = step(batch)
        if r.trainer.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    r.train_step = step_then_term
    before = signal.getsignal(signal.SIGTERM)
    r.fit()
    assert r.trainer.step == 2 and signal.getsignal(signal.SIGTERM) == before
    ckpts = sorted(os.listdir(tmp_path / "checkpoints"))
    assert ckpts == ["last", "step_00000002"]


@pytest.mark.parametrize("par", ["parallel.data=2", "parallel.fsdp=2"])
def test_one_card_only(tmp_path, par):
    """Without a process group the mesh is one rank: two raise, naming the
    rank count, as ``make_mesh`` does with too few devices."""
    with pytest.raises(ValueError, match=r"needs 2 ranks, have 1|^1 ranks not divisible by 2"):
        runner.Runner(_tiny_cfg(tmp_path, par), device="cpu")
