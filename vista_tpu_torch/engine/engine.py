"""The diffusion engine: networks + diffusion math (counterpart of
``vista_tpu/engine/engine.py``, its sampling and first-stage decode).

Holds the VideoUNet and the temporal VAE decoder as modules; latents are
``(n, z, h, w)`` (NCHW, frame-major). ``decode_first_stage`` decodes windows
of ``decode_chunk`` frames sharing ``decode_overlap`` frames and averages
the seams, one window after the other. The conditioner (CLIP image
embedding, VAE encoder) is not ported yet: callers pass the ``crossattn``,
``vector`` and ``concat`` conditioning tensors themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from vista_tpu_torch.diffusion.denoiser import precondition_denoise
from vista_tpu_torch.diffusion.sampler import SamplerConfig, sample_euler_edm
from vista_tpu_torch.diffusion.scaling import get_scaling
from vista_tpu_torch.models.unet import VideoUNet, VideoUNetConfig
from vista_tpu_torch.models.vae import VAEConfig, VideoVAEDecoder


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX config's fields and defaults, without ``conditioner`` (not
    ported yet)."""

    unet: VideoUNetConfig = dataclasses.field(default_factory=VideoUNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    scaling: str = "v_edm_cnoise"
    num_frames: int = 25
    decode_chunk: int = 14
    decode_overlap: int = 3
    encode_chunk: int = 14

    def tiny(self) -> "EngineConfig":
        unet = self.unet.tiny()
        return dataclasses.replace(
            self, unet=unet, vae=self.vae.tiny(), num_frames=unet.num_frames,
            decode_chunk=3, decode_overlap=1, encode_chunk=4)


class VistaEngine:
    """Modules are built on ``device`` in the configs' dtypes. Weights come
    from :func:`vista_tpu_torch.utils.checkpoint.load_vista_state_dict`."""

    def __init__(self, cfg: EngineConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        with self.device:
            self.unet = VideoUNet(cfg.unet).to(cfg.unet.compute_dtype).eval()
            self.decoder = VideoVAEDecoder(cfg.vae).to(cfg.vae.compute_dtype).eval()
        self.scaling = get_scaling(cfg.scaling)

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents ``(n, z, h, w)`` -> fp32 pixels ``(n, 3, H, W)``."""
        cfg = self.cfg
        z = z / cfg.vae.scale_factor
        n = z.shape[0]
        chunk, overlap = cfg.decode_chunk, cfg.decode_overlap
        if n <= chunk:
            return self.decoder(z, n)
        outs = []
        prev = z[:overlap]
        step = chunk - overlap
        for start in range(overlap, n, step):
            cur = z[start:start + step]
            window = torch.cat([prev, cur])
            out = self.decoder(window, window.shape[0])
            if outs:
                outs[-1][-overlap:] = (outs[-1][-overlap:] + out[:overlap]) / 2.0
                out = out[overlap:]
            outs.append(out)
            prev = cur[-overlap:]
        return torch.cat(outs)

    def network_fn(self, num_frames: int):
        """Channel-concat the ``concat`` condition (per video or per frame)
        and map the condition dict onto the UNet's inputs."""

        def fn(x, c_noise, cond: Dict[str, torch.Tensor], cond_mask):
            concat = cond.get("concat")
            if concat is not None:
                if concat.shape[0] != x.shape[0]:
                    concat = concat.repeat_interleave(num_frames, dim=0)
                x = torch.cat([x, concat.to(x.dtype)], dim=1)
            return self.unet(x, c_noise, cond.get("crossattn"), cond.get("vector"),
                             cond_mask, num_frames)

        return fn

    def denoise_fn(self, num_frames: Optional[int] = None):
        net = self.network_fn(num_frames or self.cfg.num_frames)

        def fn(x, sigma, cond, cond_mask):
            return precondition_denoise(net, x, sigma, cond, cond_mask, self.scaling)

        return fn

    @torch.no_grad()
    def sample(self, noise: torch.Tensor, cond: Dict[str, torch.Tensor],
               uc: Optional[Dict[str, torch.Tensor]] = None,
               cond_frame: Optional[torch.Tensor] = None,
               cond_mask: Optional[torch.Tensor] = None,
               sampler: SamplerConfig = SamplerConfig()) -> torch.Tensor:
        """One sampling pass over ``num_frames`` latents."""
        return sample_euler_edm(self.denoise_fn(), noise, cond, uc,
                                cond_frame=cond_frame, cond_mask=cond_mask,
                                config=sampler, num_frames=self.cfg.num_frames)
