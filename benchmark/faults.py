"""Faults planted in the system under test, to show that the check catches
them: each breaks the timed path underneath the harness, which runs as
always and has to report ``correct`` false.

- ``unchanged_step``: the denoiser returns its input, so every Euler step
  leaves the state as it was;
- ``half_batch_cfg``: guidance's conditional half left out, the
  unconditional half's output standing for both;
- ``altered_frame``: one decoded frame negated where the decoder makes it;
- ``sigmas_shifted``: the noise schedule read one place late, so every
  Euler step runs at the next step's sigma;
- ``pin_dropped``: the sampler no longer pins the context frames into its
  state (the denoiser still gets their mask);
- ``guider_scales_one``: the guider's per-frame scales all 1, so the
  conditional half stands alone;
- ``unchanged_state``: the optimizer's update leaves the parameters as
  they were;
- ``half_batch``: half of each optimizer step's batch left out: the second
  micro-step takes the first's batch again, so the mean is the first's;
- ``altered_loss``: the loss 5% off where the loss function makes it.

The exchange between chips has no fault here: every cell runs on one chip.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

SAMPLING = ("unchanged_step", "half_batch_cfg", "altered_frame", "sigmas_shifted", "pin_dropped",
            "guider_scales_one")
TRAINING = ("unchanged_state", "half_batch", "altered_loss")


def _patches(name: str):
    """``[(owner, attribute, replacement)]`` of a fault."""
    from vista_tpu_torch.diffusion import sampler
    from vista_tpu_torch.engine import engine, training
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.models.vae import VideoVAEDecoder

    if name == "unchanged_step":
        return [(VistaEngine, "denoise_fn",
                 lambda self, num_frames=None: lambda x, sigma, cond, mask: x.clone())]
    if name == "half_batch_cfg":
        inner = VistaEngine.denoise_fn

        def denoise_fn(self, num_frames=None):
            fn = inner(self, num_frames)

            def half(x, sigma, cond, mask):
                t = x.shape[0] // 2
                out = fn(x[:t], sigma[:t], {k: v[:v.shape[0] // 2] for k, v in cond.items()},
                         None if mask is None else mask[:t])
                return torch.cat([out, out])

            return half

        return [(VistaEngine, "denoise_fn", denoise_fn)]
    if name == "altered_frame":
        inner_dec = VideoVAEDecoder.forward

        def forward(self, z, num_frames):
            out = inner_dec(self, z, num_frames)
            out[0] = -out[0]
            return out

        return [(VideoVAEDecoder, "forward", forward)]
    if name == "sigmas_shifted":
        inner_sigmas = sampler.edm_sigmas
        return [(sampler, "edm_sigmas", lambda n, *args: inner_sigmas(n + 1, *args)[1:])]
    if name == "pin_dropped":
        inner_sample = engine.sample_euler_edm

        def sample_euler_edm(*args, **kwargs):
            return inner_sample(*args, **dict(kwargs, cond_frame=None))

        return [(engine, "sample_euler_edm", sample_euler_edm)]
    if name == "guider_scales_one":
        inner_scales = sampler.guider_frame_scales

        def guider_frame_scales(cfg):
            scales = inner_scales(cfg)
            return None if scales is None else np.ones_like(scales)

        return [(sampler, "guider_frame_scales", guider_frame_scales)]
    if name == "unchanged_state":
        return [(training.Trainer, "_update", lambda self, grad, norm: None)]
    if name == "half_batch":
        inner_lg = training.Trainer.loss_and_grads
        first = []

        def loss_and_grads(self, batch, draws):
            if self.step % self.cfg.accum_steps == 0:
                first[:] = [(batch, draws)]
            return inner_lg(self, *first[0])

        return [(training.Trainer, "loss_and_grads", loss_and_grads)]
    if name == "altered_loss":
        inner_loss = training.diffusion_loss

        def diffusion_loss(*args, **kwargs):
            loss, aux = inner_loss(*args, **kwargs)
            return loss * 1.05, aux

        return [(training, "diffusion_loss", diffusion_loss)]
    raise ValueError(f"unknown fault {name!r}; one of {SAMPLING + TRAINING}")


@contextlib.contextmanager
def planted(name: str):
    """The system with fault ``name`` for the span of the block."""
    patches = _patches(name)
    saved = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in patches]
    try:
        for owner, attr, new in patches:
            setattr(owner, attr, new)
        yield
    finally:
        for owner, attr, old in saved:
            setattr(owner, attr, old)
