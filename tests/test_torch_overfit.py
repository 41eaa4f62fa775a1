"""The port's overfit-then-sample arc (``tools/torch_overfit.py``) against
``tests/test_overfit_fidelity.py`` (no JAX jit):

- ``make_clips(32, 32, 4)`` is the JAX test's ``_make_clips(4)`` bit for
  bit;
- the arc's engine (``--tiny``), optimizer and sampler configs equal the
  JAX test's, field by field against ``vista_tpu``'s dataclasses;
- three optimizer steps of the tiny fp32 engine on the CPU (the plain
  versions), then the arc's sampling: the losses are finite; the latent MSE
  under ``Trainer.ema_weights`` equals the same function's on a second
  engine loaded with the trainer's EMA shadows, bit for bit, and differs
  from the one under the online masters (at EMA 0.9 after three steps they
  differ); sampling leaves the UNet's parameters and the fp32 masters as
  they were, bit for bit; frame 0 of every sample is its conditioning
  latent; the decoded pixels are finite, ``(4, 32, 32, 3)``;
- the tool raises without a card unless ``--device cpu`` is given.

The 250-step arc itself runs on the card (``chip_smoke.py``'s ``overfit``
phase): each of its pieces is held to ``vista_tpu`` here (the train step in
``test_torch_train*.py``, sampling and the decode in
``test_torch_slice.py``), and 250 steps take about 100 s on one thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_overfit_fidelity import _fp32, _make_clips
from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu.diffusion.guidance import GuiderConfig as JGuiderConfig
from vista_tpu.diffusion.loss import LossConfig as JLossConfig
from vista_tpu.diffusion.sampler import SamplerConfig as JSamplerConfig
from vista_tpu.engine.engine import EngineConfig as JEngineConfig
from vista_tpu.engine.training import TrainConfig as JTrainConfig

STEPS = 3


@pytest.fixture(scope="module")
def arc():
    from tools import torch_overfit

    return torch_overfit


def _shared_fields(port, ref, path=""):
    """The names of the dataclass fields both configs have, recursively,
    each asserted equal; fails on a port field the JAX config lacks."""
    names = []
    for f in dataclasses.fields(port):
        assert hasattr(ref, f.name), f"{path}{f.name}: not a field of the JAX config"
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            names += _shared_fields(a, b, f"{path}{f.name}.")
        else:
            assert (tuple(a) if isinstance(a, (list, tuple)) else a) == \
                (tuple(b) if isinstance(b, (list, tuple)) else b), f"{path}{f.name}: {a} != {b}"
            names.append(path + f.name)
    return names


def test_clips_match_jax(arc):
    got, ref = arc.make_clips(32, 32, 4), _make_clips(4)
    assert got.dtype == ref.dtype and got.shape == ref.shape == (2, 4, 32, 32, 3)
    np.testing.assert_array_equal(got, ref)


def test_configs_match_jax(arc):
    t = 4
    ref_train = JTrainConfig(learning_rate=2e-3, warmup_steps=5, ema_decay=0.9,
                             loss=JLossConfig(num_frames=t))
    assert dataclasses.asdict(arc.train_config(t)) == dataclasses.asdict(ref_train)
    ref_sampler = JSamplerConfig(num_steps=10, guider=JGuiderConfig(
        kind="triangle", scale=2.0, num_frames=t))
    assert dataclasses.asdict(arc.sampler_config(t)) == dataclasses.asdict(ref_sampler)
    cfg = arc.engine_config(tiny=True)
    assert cfg.num_frames == t
    names = _shared_fields(cfg, _fp32(JEngineConfig().tiny()))
    assert {"unet.dtype", "vae.dtype", "conditioner.clip.dtype", "unet.model_channels",
            "unet.num_head_channels", "conditioner.vae.ch"} <= set(names)


@pytest.fixture(scope="module")
def three_steps(arc):
    engine = arc.build_engine(True, "cpu", 0)
    t = engine.cfg.num_frames
    clips = torch.from_numpy(arc.make_clips(32, 32, t))
    trainer, losses, _, _ = arc.overfit(engine, arc.train_config(t), clips, STEPS,
                                        torch.Generator().manual_seed(7))
    sampler, noises = arc.sampler_config(t), arc.draw_noises(engine, clips)
    params = {n: p.detach().clone() for n, p in engine.unet.named_parameters()}
    masters = {n: m.clone() for n, m in trainer.master.items()}
    with trainer.ema_weights():
        ema = arc.latent_mse(engine, clips, sampler, noises)
    online = arc.latent_mse(engine, clips, sampler, noises)
    other = arc.build_engine(True, "cpu", 0)
    other.unet.load_state_dict(trainer.ema)
    loaded = arc.latent_mse(other, clips, sampler, noises)
    return dict(engine=engine, trainer=trainer, losses=losses, params=params, masters=masters,
                ema=ema, online=online, loaded=loaded)


def test_losses_are_finite(three_steps):
    assert len(three_steps["losses"]) == STEPS
    assert np.isfinite(three_steps["losses"]).all()


def test_ema_weights_sample_as_the_loaded_shadows(three_steps):
    ema, loaded = three_steps["ema"], three_steps["loaded"]
    assert ema.mse == loaded.mse and ema.mses == loaded.mses
    assert all(torch.equal(a, b) for a, b in zip(ema.latents, loaded.latents))
    assert torch.equal(ema.pixels, loaded.pixels)


def test_ema_differs_from_the_online_masters(three_steps):
    assert three_steps["ema"].mse != three_steps["online"].mse


def test_sampling_leaves_parameters_and_masters(three_steps):
    unet, trainer = three_steps["engine"].unet, three_steps["trainer"]
    for n, p in unet.named_parameters():
        assert torch.equal(p, three_steps["params"][n]), n
    assert set(trainer.master) == set(three_steps["params"])  # policy full: every weight
    for n, m in trainer.master.items():
        assert torch.equal(m, three_steps["masters"][n]), n
        assert torch.equal(m, three_steps["params"][n]), n  # fp32: the module holds the master


@pytest.mark.parametrize("run", ["ema", "online", "loaded"])
def test_frame_zero_is_pinned(three_steps, run):
    samples = three_steps[run]
    for lat, z in zip(samples.latents, samples.targets):
        assert lat.shape == z.shape == (4, 4, 16, 16)
        assert torch.equal(lat[0], z[0])


def test_decoded_pixels(three_steps):
    px = three_steps["ema"].pixels
    assert px.shape == (4, 32, 32, 3) and px.dtype == torch.float32
    assert bool(torch.isfinite(px).all())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine "
                    "without a card")
def test_cli_needs_a_card_unless_cpu(arc):
    with pytest.raises(RuntimeError, match="runs on the card"):
        arc.main(["--tiny", "--steps", "1"])
