"""The diffusion engine: networks + diffusion math (counterpart of
``vista_tpu/engine/engine.py``).

Holds the VideoUNet, the temporal VAE decoder, the VAE encoder and the
conditioner (CLIP tower + ``quant_conv``; it shares the encoder, as the JAX
package ties the two). Latents are ``(n, z, h, w)`` (NCHW, frame-major).

- ``encode_first_stage``: pixels -> scaled latents, in chunks of
  ``encode_chunk`` frames, sampling the posterior with given noise or taking
  its mode;
- ``conditions``: the conditioner on a typed batch; ``condition_pair``: the
  (c, uc) pair sampling takes, uc with ``UC_ZERO_KEYS`` zeroed;
- ``decode_first_stage``: windows of ``decode_chunk`` frames sharing
  ``decode_overlap`` frames, the seams averaged, one window after the other;
- ``sample``: one sampling pass (Euler-EDM; batched or sequential CFG,
  stochastic churn from the caller's noise); ``sample_sharded``: the same
  pass over the ranks of a mesh, frame-, row- or weight-sharded.

The engine runs on the card unless the caller asks for the CPU: building it
on ``"cuda"`` without one raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Mapping, Optional, Tuple

import torch

from vista_tpu_torch.diffusion.denoiser import precondition_denoise
from vista_tpu_torch.diffusion.sampler import ChurnNoise, SamplerConfig, sample_euler_edm
from vista_tpu_torch.diffusion.scaling import get_scaling
from vista_tpu_torch.models.conditioner import ConditionerConfig, GeneralConditioner
from vista_tpu_torch.models.unet import VideoUNet, VideoUNetConfig
from vista_tpu_torch.models.vae import (VAEConfig, VAEEncoder, VideoVAEDecoder,
                                        gaussian_mode, gaussian_sample)
from vista_tpu_torch.parallel.frames import frame_parallel
from vista_tpu_torch.parallel.height import band_of, gather_rows, height_parallel
from vista_tpu_torch.parallel.mesh import Mesh, gather_frames
from vista_tpu_torch.parallel.weights import sharded_weights

# the conditions the unconditional half of classifier-free guidance zeroes
UC_ZERO_KEYS: FrozenSet[str] = frozenset(
    {"cond_frames", "cond_frames_without_noise",
     "command", "trajectory", "speed", "angle", "goal"})


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX config's fields and defaults."""

    unet: VideoUNetConfig = dataclasses.field(default_factory=VideoUNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    conditioner: ConditionerConfig = dataclasses.field(default_factory=ConditionerConfig)
    scaling: str = "v_edm_cnoise"
    num_frames: int = 25
    decode_chunk: int = 14
    decode_overlap: int = 3
    encode_chunk: int = 14

    def tiny(self) -> "EngineConfig":
        unet = self.unet.tiny()
        cond = self.conditioner.tiny()
        cond = dataclasses.replace(
            cond, vector_outdim=unet.adm_in_channels // 3,
            clip=dataclasses.replace(cond.clip, output_dim=unet.context_dim))
        return dataclasses.replace(
            self, unet=unet, vae=self.vae.tiny(), conditioner=cond,
            num_frames=unet.num_frames, decode_chunk=3, decode_overlap=1, encode_chunk=4)


class VistaEngine:
    """Modules are built on ``device`` (the card unless the caller passes
    ``"cpu"``) in the configs' dtypes, the conditioner's ``quant_conv`` in
    fp32. Weights come from
    :func:`vista_tpu_torch.utils.checkpoint.load_vista_state_dict`."""

    def __init__(self, cfg: EngineConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VistaEngine runs on the card and found none; "
                               "pass device='cpu' to build it on the CPU")
        with self.device:
            self.unet = VideoUNet(cfg.unet).to(cfg.unet.compute_dtype).eval()
            self.decoder = VideoVAEDecoder(cfg.vae).to(cfg.vae.compute_dtype).eval()
            self.encoder = VAEEncoder(cfg.vae).to(cfg.vae.compute_dtype).eval()
            self.conditioner = GeneralConditioner(cfg.conditioner).eval()
            self.conditioner.clip_tower.to(cfg.conditioner.clip.compute_dtype)
        for module in (self.decoder, self.encoder, self.conditioner):
            module.requires_grad_(False)
        self.scaling = get_scaling(cfg.scaling)

    @torch.no_grad()
    def encode_first_stage(self, pixels: torch.Tensor,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pixels ``(n, 3, H, W)`` in [-1, 1] -> scaled latents ``(n, z, h, w)``:
        the posterior sampled with the standard-normal ``noise`` when given,
        else its mode. Chunks of ``encode_chunk`` frames bound the encoder's
        activations."""
        chunk = self.cfg.encode_chunk
        moments = torch.cat([self.encoder(pixels[i:i + chunk])
                             for i in range(0, pixels.shape[0], chunk)])
        z = gaussian_sample(moments, noise) if noise is not None else gaussian_mode(moments)
        return z * self.cfg.vae.scale_factor

    @torch.no_grad()
    def conditions(self, batch: Mapping[str, torch.Tensor],
                   force_zero: FrozenSet[str] = frozenset(), skip_encode: bool = False,
                   ucg_keep: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``{"crossattn", "vector", "concat"}`` for a typed batch (see
        :class:`GeneralConditioner`)."""
        return self.conditioner(batch, self.encoder, force_zero, skip_encode, ucg_keep)

    @torch.no_grad()
    def condition_pair(self, batch: Mapping[str, torch.Tensor],
                       force_uc_zero: FrozenSet[str] = UC_ZERO_KEYS,
                       skip_encode: bool = False
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """``(c, uc)`` for sampling: the conditioner on ``batch`` with nothing
        forced to zero, and with the ``force_uc_zero`` keys zeroed."""
        return (self.conditions(batch, frozenset(), skip_encode),
                self.conditions(batch, force_uc_zero, skip_encode))

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
               sampler: SamplerConfig = SamplerConfig(),
               churn_noise: Optional[ChurnNoise] = None) -> torch.Tensor:
        """One sampling pass over ``num_frames`` latents. ``churn_noise``
        (the JAX ``key``'s counterpart: a callable ``i -> eps`` or a
        ``torch.Generator``) feeds the stochastic churn of ``s_churn > 0``."""
        return sample_euler_edm(self.denoise_fn(), noise, cond, uc,
                                cond_frame=cond_frame, cond_mask=cond_mask,
                                config=sampler, num_frames=self.cfg.num_frames,
                                churn_noise=churn_noise)

    @torch.no_grad()
    def sample_sharded(self, noise: torch.Tensor, cond: Dict[str, torch.Tensor],
                       uc: Optional[Dict[str, torch.Tensor]] = None,
                       cond_frame: Optional[torch.Tensor] = None,
                       cond_mask: Optional[torch.Tensor] = None,
                       sampler: SamplerConfig = SamplerConfig(), mesh: Optional[Mesh] = None,
                       mode: str = "frames", fsdp_min_size: int = 2**16) -> torch.Tensor:
        """One sampling pass over the ranks of ``mesh``'s ``data`` axis
        (counterpart of ``jit_sample_sharded``); every rank passes the same
        whole inputs and gets the whole latents back.

        - ``frames``: each rank samples its contiguous run of ``num_frames /
          n`` frames of each video (of ``noise``, ``cond_frame``,
          ``cond_mask`` and a per-frame ``concat``; the guider's scales at
          the run's indices in the video); the UNet's temporal stages run
          frame-parallel (``parallel/frames.py``). ``n`` must divide
          ``num_frames``.
        - ``height``: each rank samples its band of the latent rows of every
          frame (of ``noise``, ``cond_frame`` and every 4-d condition, the
          per-video and per-frame ``concat``); the UNet runs on the bands
          (``parallel/height.py``: conv halos, band-summed GroupNorm, K and
          V gathered over the bands) and the rows are gathered at the end.
        - ``weights``: the UNet's parameters are sliced over the ranks by
          ``fsdp_shard_dim`` and gathered block by block just in time
          (``parallel/weights.py``); activations stay whole.
        """
        if mode not in ("frames", "height", "weights"):
            raise ValueError(f"unknown sharded-sampling mode {mode!r}")
        if mesh is None or not mesh.distributed:
            raise ValueError("sample_sharded needs a mesh over a process group (torchrun)")
        group = mesh.group("data")
        if mode == "weights":
            with sharded_weights(self.unet.blocks(), group, fsdp_min_size):
                return self.sample(noise, cond, uc, cond_frame, cond_mask, sampler)
        if mode == "height":
            with height_parallel(group, *noise.shape[2:]):
                rows = lambda c: None if c is None else {
                    k: band_of(v) if v.ndim == 4 else v for k, v in c.items()}
                out = sample_euler_edm(self.denoise_fn(), band_of(noise), rows(cond), rows(uc),
                                       cond_frame=band_of(cond_frame), cond_mask=cond_mask,
                                       config=sampler, num_frames=self.cfg.num_frames)
                return gather_rows(out)
        t, n = self.cfg.num_frames, mesh.size("data")
        if t % n:
            raise ValueError(f"the data axis of {n} ranks must divide num_frames={t}")
        tl = t // n
        frames = slice(mesh.coord("data") * tl, (mesh.coord("data") + 1) * tl)
        take = lambda a: None if a is None else (
            a.reshape(-1, t, *a.shape[1:])[:, frames].reshape(-1, *a.shape[1:]))
        per_frame = lambda c: None if c is None else {
            k: take(v) if k == "concat" and v.shape[0] == noise.shape[0] else v
            for k, v in c.items()}
        with frame_parallel(group):
            out = sample_euler_edm(self.denoise_fn(tl), take(noise), per_frame(cond),
                                   per_frame(uc), cond_frame=take(cond_frame),
                                   cond_mask=take(cond_mask), config=sampler, num_frames=tl,
                                   frames=frames)
        return gather_frames(out, noise.shape[0] // t, group)
