"""The weight bridge: upstream-key state dicts -> the port's modules.

``load_vista_state_dict`` takes the flat dict of numpy arrays in the
upstream torch layout that ``vista_tpu.utils.checkpoint.export_vista_checkpoint``
writes, or a safetensors file with the same keys (the released
``vista.safetensors``), and loads each subset with ``strict=True``: a
missing or extra key raises.

- ``model.diffusion_model.*`` -> the VideoUNet, LoRA (``{q,k,v,out}_adapter_{down,up}``)
  and action (``{k,v}_adapter_action_control``) adapters included when the
  UNet has them;
- ``first_stage_model.decoder.*`` -> the temporal VAE decoder;
- ``first_stage_model.encoder.*`` -> the VAE encoder. The conditioner's
  copy of it (``conditioner.embedders.3.encoder.encoder.*``) is the same
  trunk: the port holds one encoder, as the JAX package does;
- ``conditioner.embedders.0.open_clip.model.visual.*`` -> the CLIP tower and
  ``conditioner.embedders.3.encoder.quant_conv.*`` -> ``quant_conv``.

``save_checkpoint`` / ``load_checkpoint`` are the training run's own files
(the torch counterpart of the JAX package's Orbax pair): the trainer's state
and every module's state dict, written by ``torch.save`` to a temporary file
that ``os.replace`` then moves into place, read back with
``weights_only=True`` onto the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

UNET_PREFIX = "model.diffusion_model."
DECODER_PREFIX = "first_stage_model.decoder."
ENCODER_PREFIX = "first_stage_model.encoder."
CLIP_PREFIX = "conditioner.embedders.0.open_clip.model.visual."
QUANT_PREFIX = "conditioner.embedders.3.encoder.quant_conv."


def _subset(state: Mapping[str, np.ndarray], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in state.items() if k.startswith(prefix)}


def _load(module: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    ref = module.state_dict()
    for k, v in sd.items():
        if k in ref:
            sd[k] = v.to(ref[k].dtype)
    module.load_state_dict(sd, strict=True)


def load_vista_state_dict(unet: Optional[nn.Module], decoder: Optional[nn.Module],
                          state: Union[str, Mapping[str, np.ndarray]],
                          encoder: Optional[nn.Module] = None,
                          conditioner: Optional[nn.Module] = None) -> None:
    """Load the subsets of ``state`` into the modules given (None skips one);
    ``conditioner`` is a ``GeneralConditioner`` (its CLIP tower and
    ``quant_conv``)."""
    if isinstance(state, str):
        from safetensors.numpy import load_file

        state = load_file(state)
    if unet is not None:
        _load(unet, _subset(state, UNET_PREFIX))
    if decoder is not None:
        _load(decoder, _subset(state, DECODER_PREFIX))
    if encoder is not None:
        _load(encoder, _subset(state, ENCODER_PREFIX))
    if conditioner is not None:
        _load(conditioner.clip_tower, _subset(state, CLIP_PREFIX))
        _load(conditioner.quant_conv, _subset(state, QUANT_PREFIX))


def save_checkpoint(path: str, trainer_state: Mapping, modules: Mapping[str, nn.Module]) -> None:
    """Write ``{"trainer": trainer_state, "modules": {name: state_dict}}`` to
    ``path`` whole or not at all."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"trainer": dict(trainer_state),
                "modules": {name: m.state_dict() for name, m in modules.items()}}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    """What :func:`save_checkpoint` wrote, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
