"""Vista's conditioner in plain fp32 PyTorch (a frozen copy of the system's
``GeneralConditioner`` with its dtype casts taken out): a typed batch ->
``{"crossattn", "vector", "concat"}``.

- ``cond_frames_without_noise`` -> the CLIP image embedding ``(b, 1, 1024)``,
  with action control followed by the five action embeddings (command 1,
  trajectory 8, speed 4, angle 4, goal 2 scalars, 128-d sinusoidal each,
  zero where absent);
- ``fps_id``, ``motion_bucket_id``, ``cond_aug`` -> 256-d sinusoidal
  embeddings, concatenated: ``vector``;
- ``cond_frames`` -> the VAE encoder, a 1x1 ``quant_conv`` and the
  posterior's mode, unscaled: ``concat``.

Keys in ``force_zero`` are zeroed (the unconditional half of guidance);
``ucg_keep`` masks (training's condition dropout) multiply their embedding.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference.clip import CLIPVisionTower, clip_preprocess
from benchmark.reference.nn import Conv2d, timestep_embedding
from benchmark.reference.vae import gaussian_mode

ACTION_SPECS = (("command", 1), ("trajectory", 8), ("speed", 4), ("angle", 4), ("goal", 2))
ACTION_EMB_DIM = 128


def concat_timestep_embed(x: torch.Tensor, outdim: int) -> torch.Tensor:
    if x.ndim == 1:
        x = x[:, None]
    b, d = x.shape
    return timestep_embedding(x.reshape(-1), outdim).reshape(b, d * outdim)


class GeneralConditioner(nn.Module):
    """``cfg``: the configuration file's ``conditioner`` entry."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.clip_tower = CLIPVisionTower(cfg["clip"])
        zc = cfg["vae"]["z_channels"] * (2 if cfg["vae"]["double_z"] else 1)
        self.quant_conv = Conv2d(zc, zc, 1)

    def forward(self, batch, encoder, force_zero=frozenset(), skip_encode=False, ucg_keep=None):
        cfg = self.cfg
        b = batch["cond_aug"].shape[0]

        def drop(emb, name):
            if name in force_zero:
                return torch.zeros_like(emb)
            if ucg_keep is not None and name in ucg_keep:
                return emb * ucg_keep[name].float().reshape(-1, *(1,) * (emb.ndim - 1))
            return emb

        clip_in = clip_preprocess(batch["cond_frames_without_noise"], cfg["clip"]["image_size"])
        crossattn = drop(self.clip_tower(clip_in)[:, None], "cond_frames_without_noise")
        if cfg["action_control"]:
            parts = [crossattn]
            for name, d in ACTION_SPECS:
                if name in batch:
                    parts.append(drop(concat_timestep_embed(batch[name], ACTION_EMB_DIM)[:, None],
                                      name))
                else:
                    parts.append(crossattn.new_zeros(b, 1, d * ACTION_EMB_DIM))
            crossattn = torch.cat(parts, dim=-1)
        vector = torch.cat([drop(concat_timestep_embed(batch[k], cfg["vector_outdim"]), k)
                            for k in ("fps_id", "motion_bucket_id", "cond_aug")], dim=-1)
        cf = batch["cond_frames"].float()
        latent = cf if skip_encode else gaussian_mode(self.quant_conv(encoder(cf)))
        return {"crossattn": crossattn, "vector": vector, "concat": drop(latent, "cond_frames")}
