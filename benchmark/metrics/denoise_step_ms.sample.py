"""Sampler (``diffusion/sampler.py`` through ``engine.sample``): device
milliseconds inside the ``sample`` spans per denoiser step (one
CFG-doubled UNet call each), over every step traced."""

from benchmark import trace


def read(rec):
    steps = rec["denoiser_steps"]
    ops = trace.within(rec, "sample")
    return 1e3 * trace.device_time(ops) / steps if steps and ops else None
