"""The conditioning stack (counterpart of ``vista_tpu/models/conditioner.py``,
``GeneralConditioner``): a typed batch -> ``{"crossattn", "vector",
"concat"}``.

- ``cond_frames_without_noise`` -> frozen CLIP image token ``(b, 1, 1024)``;
  with action control the five action embeddings (command 1, trajectory 8,
  speed 4, angle 4, goal 2 scalars, 128-d sinusoidal each, zero-filled when
  absent) follow on the feature axis: ``(b, 1, 1024 + 2432)``;
- ``fps_id`` / ``motion_bucket_id`` / ``cond_aug`` -> 256-d sinusoidal
  embeddings concatenated into ``vector`` ``(b, 768)``;
- ``cond_frames`` -> the first-stage encoder (shared with the engine, passed
  in), a learned 1x1 ``quant_conv`` (identity at init, fp32) and the
  posterior mode, unscaled -> ``concat`` ``(b, z, h, w)``.

Classifier-free dropout takes its keep masks as an argument
(:func:`draw_ucg_keep` draws them from an explicit ``torch.Generator``), so
tests can inject the JAX package's Bernoulli draws. Frames are NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from vista_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower, clip_preprocess
from vista_tpu_torch.models.layers import timestep_embedding
from vista_tpu_torch.models.vae import VAEConfig, gaussian_mode
from vista_tpu_torch.utils.profiling import span

ACTION_SPECS: Tuple[Tuple[str, int], ...] = (
    ("command", 1), ("trajectory", 8), ("speed", 4), ("angle", 4), ("goal", 2))
ACTION_EMB_DIM = 128


@dataclasses.dataclass(frozen=True)
class ConditionerConfig:
    clip: CLIPVisionConfig = dataclasses.field(default_factory=CLIPVisionConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    vector_outdim: int = 256
    action_control: bool = False
    ucg_rate: float = 0.0
    ucg_keys: Tuple[str, ...] = ("cond_frames_without_noise", "cond_frames")

    def tiny(self) -> "ConditionerConfig":
        return dataclasses.replace(self, clip=self.clip.tiny(), vae=self.vae.tiny())


def concat_timestep_embed(x: torch.Tensor, outdim: int) -> torch.Tensor:
    """Embed each scalar of ``(b, d)`` (or ``(b,)``) -> ``(b, d * outdim)``."""
    if x.ndim == 1:
        x = x[:, None]
    b, d = x.shape
    return timestep_embedding(x.reshape(-1), outdim).reshape(b, d * outdim)


def draw_ucg_keep(cfg: ConditionerConfig, b: int, gen: torch.Generator,
                  device) -> Dict[str, torch.Tensor]:
    """Bernoulli(1 - ucg_rate) keep masks ``(b,)`` for the embedders in
    ``ucg_keys``."""
    return {k: (torch.rand(b, generator=gen, device=device) < 1.0 - cfg.ucg_rate).float()
            for k in cfg.ucg_keys}


class GeneralConditioner(nn.Module):
    def __init__(self, cfg: ConditionerConfig):
        super().__init__()
        self.cfg = cfg
        self.clip_tower = CLIPVisionTower(cfg.clip)
        zc = 2 * cfg.vae.z_channels if cfg.vae.double_z else cfg.vae.z_channels
        self.quant_conv = nn.Conv2d(zc, zc, 1)
        with torch.no_grad():
            self.quant_conv.weight.copy_(torch.eye(zc)[:, :, None, None])
            self.quant_conv.bias.zero_()

    def forward(self, batch: Mapping[str, torch.Tensor], encoder: nn.Module,
                force_zero: FrozenSet[str] = frozenset(), skip_encode: bool = False,
                ucg_keep: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        b = batch["cond_aug"].shape[0]

        def drop(emb: torch.Tensor, name: str) -> torch.Tensor:
            if name in force_zero:
                return torch.zeros_like(emb)
            if ucg_keep is not None and name in ucg_keep:
                return emb * ucg_keep[name].to(emb.dtype).reshape(-1, *(1,) * (emb.ndim - 1))
            return emb

        with span("condition.clip"):
            clip_in = clip_preprocess(batch["cond_frames_without_noise"], cfg.clip.image_size)
            crossattn = drop(self.clip_tower(clip_in)[:, None], "cond_frames_without_noise")
        if cfg.action_control:
            parts = [crossattn]
            for name, d in ACTION_SPECS:
                if name in batch:
                    parts.append(drop(concat_timestep_embed(batch[name], ACTION_EMB_DIM)[:, None],
                                      name))
                else:
                    parts.append(crossattn.new_zeros(b, 1, d * ACTION_EMB_DIM))
            crossattn = torch.cat(parts, dim=-1)
        vector = torch.cat([drop(concat_timestep_embed(batch[k], cfg.vector_outdim), k)
                            for k in ("fps_id", "motion_bucket_id", "cond_aug")], dim=-1)
        cf = batch["cond_frames"]
        if skip_encode:
            latent = cf
        else:
            with span("condition.encode"):
                moments = encoder(cf)
                qc = self.quant_conv
                latent = gaussian_mode(nn.functional.conv2d(moments.float(), qc.weight.float(),
                                                            qc.bias.float()))
        return {"crossattn": crossattn, "vector": vector, "concat": drop(latent, "cond_frames")}
