"""Checks of the port at the released widths that need no weights.

- The full-width VideoUNet and temporal VAE decoder, built on the ``meta``
  device, carry exactly the keys the JAX package's key maps name, with the
  shapes the JAX modules' own parameters imply (``jax.eval_shape`` of their
  init, mapped through the key map's transforms).
- The port imports no JAX: checked in a fresh interpreter.
- The port's config dataclasses have the JAX ones' fields and defaults,
  minus the TPU-only fields.
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
from vista_tpu.diffusion import sampler as jsampler
from vista_tpu.engine import engine as jengine
from vista_tpu.models import unet as junet
from vista_tpu.models import vae as jvae
from vista_tpu.utils import torch_import as ti
from vista_tpu_torch.diffusion import guidance, sampler
from vista_tpu_torch.engine import engine
from vista_tpu_torch.models.unet import VideoUNet, VideoUNetConfig
from vista_tpu_torch.models.vae import VAEConfig, VideoVAEDecoder

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


def test_full_width_unet_keys_and_shapes():
    jcfg = junet.VideoUNetConfig()
    t = jcfg.num_frames
    shapes = jax.eval_shape(lambda: junet.VideoUNet(jcfg).init(
        jax.random.key(0), jnp.zeros((t, 8, 8, jcfg.in_channels)), jnp.zeros((t,)),
        jnp.zeros((1, 1, jcfg.context_dim)), jnp.zeros((1, jcfg.adm_in_channels)),
        jnp.zeros((t,)), t))["params"]
    with torch.device("meta"):
        unet = VideoUNet(VideoUNetConfig())
    _audit(unet, ti.unet_key_map(jcfg), _flat(shapes))
    n = sum(p.numel() for p in unet.parameters())
    assert 1.45e9 < n < 1.6e9, n


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


@pytest.mark.parametrize("port_cls,jax_cls,tpu_only", [
    (VideoUNetConfig, junet.VideoUNetConfig,
     {"attn_backend", "remat", "remat_max_ds", "remat_policy"}),
    (VAEConfig, jvae.VAEConfig, set()),
    (engine.EngineConfig, jengine.EngineConfig, {"conditioner"}),
    (sampler.SamplerConfig, jsampler.SamplerConfig, set()),
    (guidance.GuiderConfig, jguidance.GuiderConfig, set()),
])
def test_config_defaults_match_jax(port_cls, jax_cls, tpu_only):
    """``conditioner`` is not TPU-only: it is not ported yet."""
    port, ref = _defaults(port_cls), _defaults(jax_cls)
    assert set(port) == set(ref) - tpu_only
    for name in port:
        p, r = _as_plain(port[name]), _as_plain(ref[name])
        if name in ("unet", "vae"):
            r = {k: v for k, v in r.items()
                 if k not in {"attn_backend", "remat", "remat_max_ds", "remat_policy"}}
        assert p == r, name
