"""The plain reference that decides ``correct``: Vista's networks and
arithmetic in fp32 PyTorch with TF32 off, built from a configuration file
of ``benchmark/configs`` and filled by ``benchmark.weights`` from the run's
seed, as the system under test was. It imports nothing of the system under test.

Every product can be computed from fp8 operands instead
(``nn.precision("fp8")``): that is the control, the reference put in the
system's place one precision below the bf16 the configurations state.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from benchmark import weights
from benchmark.reference.conditioner import GeneralConditioner
from benchmark.reference.diffusion import guided
from benchmark.reference.unet import VideoUNet
from benchmark.reference.vae import VAEEncoder, VideoVAEDecoder, gaussian_sample

ENCODE_FRAMES = 5  # frames an encoder call: the encoder is per frame; this bounds its memory


class Reference:
    """The configuration's networks in fp32 on ``device``: ``parts`` of
    ``unet``, ``decoder``, ``encoder``, ``conditioner``. ``layout`` maps each
    parameter name of the system to its ``(shape, kind, dtype)``: the
    reference has to hold the same parameters, and rounds the seeded values
    to the dtype the system stores them in."""

    def __init__(self, cfg: dict, device, seed: int, layout: Dict[str, tuple],
                 parts: Iterable[str] = ("unet", "decoder", "encoder", "conditioner"),
                 checkpoint: bool = False):
        eng = cfg["engine"]
        self.cfg, self.device = eng, torch.device(device)
        build = {"unet": lambda: VideoUNet(eng["unet"], checkpoint),
                 "decoder": lambda: VideoVAEDecoder(eng["vae"]),
                 "encoder": lambda: VAEEncoder(eng["vae"]),
                 "conditioner": lambda: GeneralConditioner(eng["conditioner"])}
        with torch.device("meta"):
            shapes = weights.shapes_of({p: make() for p, make in build.items()})
        theirs = {n: (shape, kind) for n, (shape, kind, _) in layout.items()}
        if shapes != theirs:
            raise ValueError("the reference's parameters differ from the system's: "
                             f"{sorted(set(shapes.items()) ^ set(theirs.items()))[:4]}")
        with torch.device(device):
            self.parts = {p: build[p]().eval() for p in parts}
        for m in self.parts.values():
            m.requires_grad_(False)
        weights.fill_(self.parts, seed, {n: d for n, (_, _, d) in layout.items()}, shapes)

    def __getattr__(self, name):
        parts = self.__dict__.get("parts", {})
        if name in parts:
            return parts[name]
        raise AttributeError(name)

    @torch.no_grad()
    def encode(self, pixels: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Scaled latents of ``pixels`` ``(n, 3, H, W)``, the posterior
        sampled with ``noise``."""
        moments = torch.cat([self.encoder(pixels[i:i + ENCODE_FRAMES].float())
                             for i in range(0, pixels.shape[0], ENCODE_FRAMES)])
        return gaussian_sample(moments, noise.float()) * self.cfg["vae"]["scale_factor"]

    @torch.no_grad()
    def conditions(self, batch, force_zero=frozenset(), skip_encode=False, ucg_keep=None):
        return self.conditioner(batch, self.encoder, force_zero, skip_encode, ucg_keep)

    @torch.no_grad()
    def guided_denoise(self, x, sigma, c, uc, cond_mask, scales) -> torch.Tensor:
        """The guided denoiser on one video's state ``x`` ``(t, z, h, w)``."""
        return guided(self.unet, x.float(), sigma, c, uc, cond_mask, scales, x.shape[0])
