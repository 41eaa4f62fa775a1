"""Checks of the port at the released widths that need no weights.

- The full-width VideoUNet (plain, and with LoRA + action adapters), the
  temporal VAE decoder, the VAE encoder and the ViT-H CLIP tower, built on
  the ``meta`` device, carry exactly the keys the JAX package's key maps
  name, with the shapes the JAX modules' own parameters imply
  (``jax.eval_shape`` of their init, mapped through the key map's
  transforms).
- ``VistaEngine`` runs on the card unless asked for the CPU.
- The port imports no JAX: checked in a fresh interpreter.
- The port's config dataclasses have the JAX ones' fields and defaults,
  minus the TPU-only fields.
- The phase-1 ``Trainer``'s fp32 state for the full-width UNet (masters,
  Adam moments, EMA, the accumulation buffer), on ``meta``.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jax
import jax.numpy as jnp

from vista_tpu.diffusion import guidance as jguidance
from vista_tpu.diffusion import loss as jloss
from vista_tpu.diffusion import sampler as jsampler
from vista_tpu.engine import engine as jengine
from vista_tpu.engine import rollout as jrollout
from vista_tpu.engine import training as jtraining
from vista_tpu.models import clip as jclip
from vista_tpu.models import conditioner as jconditioner
from vista_tpu.models import unet as junet
from vista_tpu.models import vae as jvae
from vista_tpu import runner as jrunner
from vista_tpu.data import datasets as jdatasets
from vista_tpu.data import pipeline as jpipeline
from vista_tpu.utils import torch_import as ti
from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu_torch import runner
from vista_tpu_torch.data import datasets, pipeline
from vista_tpu_torch.diffusion import guidance, loss, sampler
from vista_tpu_torch.engine import engine, rollout, training
from vista_tpu_torch.models import conditioner
from vista_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower
from vista_tpu_torch.models.unet import VideoUNet, VideoUNetConfig
from vista_tpu_torch.models.vae import VAEConfig, VAEEncoder, VideoVAEDecoder

ROOT = Path(__file__).resolve().parents[1]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: tuple(v.shape)})
    return out


def _torch_shape(flax_shape, kind):
    if kind == "linear":
        return flax_shape[::-1]
    if kind == "conv2d":
        h, w, i, o = flax_shape
        return (o, i, h, w)
    if kind == "conv3d":
        t, h, w, i, o = flax_shape
        return (o, i, t, h, w)
    return flax_shape


def _audit(module, entries, flax_shapes):
    got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    want = {tkey: _torch_shape(flax_shapes[fpath], kind) for tkey, fpath, kind in entries}
    assert sorted(set(got) - set(want)) == []
    assert sorted(set(want) - set(got)) == []
    assert {k: got[k] for k in want if got[k] != want[k]} == {}


@pytest.mark.parametrize("adapters", [False, True])
def test_full_width_unet_keys_and_shapes(adapters):
    """``adapters``: the phase-2 UNet, rank-16 LoRA + action control."""
    extra = dict(add_lora=adapters, action_control=adapters)
    jcfg = dataclasses.replace(junet.VideoUNetConfig(), **extra)
    t = jcfg.num_frames
    ctx = jcfg.context_dim + (2432 if adapters else 0)
    shapes = jax.eval_shape(lambda: junet.VideoUNet(jcfg).init(
        jax.random.key(0), jnp.zeros((t, 8, 8, jcfg.in_channels)), jnp.zeros((t,)),
        jnp.zeros((1, 1, ctx)), jnp.zeros((1, jcfg.adm_in_channels)),
        jnp.zeros((t,)), t))["params"]
    with torch.device("meta"):
        unet = VideoUNet(dataclasses.replace(VideoUNetConfig(), **extra))
    _audit(unet, ti.unet_key_map(jcfg), _flat(shapes))
    n_adapters = sum(p.numel() for k, p in unet.named_parameters() if "adapter" in k)
    n = sum(p.numel() for p in unet.parameters()) - n_adapters
    assert 1.45e9 < n < 1.6e9, n
    assert (n_adapters > 0) == adapters


def test_full_width_encoder_and_clip_keys_and_shapes():
    jcfg = jvae.VAEConfig()
    shapes = jax.eval_shape(lambda: jvae.VAEEncoder(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3))))["params"]
    with torch.device("meta"):
        encoder = VAEEncoder(VAEConfig())
    _audit(encoder, ti.vae_encoder_key_map(jcfg), _flat(shapes))
    ccfg = jclip.CLIPVisionConfig()
    shapes = jax.eval_shape(lambda: jclip.CLIPVisionTower(ccfg).init(
        jax.random.key(0), jnp.zeros((1, ccfg.image_size, ccfg.image_size, 3))))["params"]
    with torch.device("meta"):
        tower = CLIPVisionTower(CLIPVisionConfig())
    _audit(tower, ti.clip_key_map(ccfg), _flat(shapes))
    n = sum(p.numel() for p in tower.parameters())
    assert 6.0e8 < n < 6.5e8, n


def test_phase1_trainer_state_bytes_on_meta():
    """Every UNet weight trains under ``slow_spatial``; with ``accum_steps =
    2`` the Trainer holds five fp32 copies of each (master, mu, nu, EMA,
    the running mean of the micro-steps' gradients) and nothing more:
    about 30.5 GB for the 1.527 B parameters."""
    import types

    with torch.device("meta"):
        unet = VideoUNet(VideoUNetConfig())
    trainer = training.Trainer(types.SimpleNamespace(unet=unet), training.TrainConfig(
        policy="slow_spatial", accum_steps=2))
    n = sum(p.numel() for p in unet.parameters())
    assert len(trainer.params) == len(list(unet.parameters()))
    state = (trainer.master, trainer.mu, trainer.nu, trainer.ema, trainer.acc)
    assert all(t.dtype == torch.float32 for d in state for t in d.values())
    nbytes = sum(t.numel() * t.element_size() for d in state for t in d.values())
    assert nbytes == 5 * 4 * n
    assert 30.0e9 < nbytes < 31.0e9, nbytes


def test_engine_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    import inspect

    assert inspect.signature(engine.VistaEngine).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        engine.VistaEngine(engine.EngineConfig().tiny())
    cpu = engine.VistaEngine(engine.EngineConfig().tiny(), "cpu")
    assert next(cpu.unet.parameters()).device.type == "cpu"


def test_full_width_decoder_keys_and_shapes():
    jcfg = jvae.VAEConfig()
    shapes = jax.eval_shape(lambda: jvae.VideoVAEDecoder(jcfg).init(
        jax.random.key(0), jnp.zeros((3, 8, 8, jcfg.z_channels)), 3))["params"]
    with torch.device("meta"):
        decoder = VideoVAEDecoder(VAEConfig())
    _audit(decoder, ti.vae_decoder_key_map(jcfg, video=True), _flat(shapes))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vista_tpu_torch\n"
        "for m in pkgutil.walk_packages(vista_tpu_torch.__path__, 'vista_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vista_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('vista_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def _defaults(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory()) for f in dataclasses.fields(cls)}


def _as_plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


UNET_TPU_ONLY = {"attn_backend", "remat_max_ds", "remat_policy"}


def _without_tpu_only(v):
    """A plain config dict with the UNet's TPU-only keys dropped wherever a
    UNet config sits in it."""
    if not isinstance(v, dict):
        return v
    if "attn_backend" in v:
        v = {k: x for k, x in v.items() if k not in UNET_TPU_ONLY}
    return {k: _without_tpu_only(x) for k, x in v.items()}


@pytest.mark.parametrize("port_cls,jax_cls,tpu_only", [
    (VideoUNetConfig, junet.VideoUNetConfig, UNET_TPU_ONLY),
    (VAEConfig, jvae.VAEConfig, set()),
    (engine.EngineConfig, jengine.EngineConfig, set()),
    (sampler.SamplerConfig, jsampler.SamplerConfig, set()),
    (guidance.GuiderConfig, jguidance.GuiderConfig, set()),
    (CLIPVisionConfig, jclip.CLIPVisionConfig, set()),
    (conditioner.ConditionerConfig, jconditioner.ConditionerConfig, set()),
    (training.TrainConfig, jtraining.TrainConfig, set()),
    (loss.LossConfig, jloss.LossConfig, set()),
    (rollout.RolloutConfig, jrollout.RolloutConfig, set()),
    (runner.RunConfig, jrunner.RunConfig, set()),
    (runner.ParallelConfig, jrunner.ParallelConfig, set()),
    (runner.ExperimentConfig, jrunner.ExperimentConfig, set()),
    (pipeline.DataConfig, jpipeline.DataConfig, set()),
    (pipeline.SourceConfig, jpipeline.SourceConfig, set()),
    (pipeline.PipelineConfig, jpipeline.PipelineConfig, set()),
    (datasets.DatasetConfig, jdatasets.DatasetConfig, set()),
])
def test_config_defaults_match_jax(port_cls, jax_cls, tpu_only):
    port, ref = _defaults(port_cls), _defaults(jax_cls)
    assert set(port) == set(ref) - tpu_only
    for name in port:
        p, r = _as_plain(port[name]), _without_tpu_only(_as_plain(ref[name]))
        assert p == r, name
