"""The weight bridge: upstream-key state dicts -> the port's modules.

``load_vista_state_dict`` takes the flat dict of numpy arrays in the
upstream torch layout (keys ``model.diffusion_model.*`` for the UNet,
``first_stage_model.decoder.*`` for the temporal VAE decoder) that
``vista_tpu.utils.checkpoint.export_vista_checkpoint`` writes, or a
safetensors file with the same keys (the released ``vista.safetensors``),
and loads both subsets with ``strict=True``: a missing or extra key raises.
Keys of other parts of the checkpoint (encoder, conditioner) are ignored.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
import torch.nn as nn

UNET_PREFIX = "model.diffusion_model."
DECODER_PREFIX = "first_stage_model.decoder."


def _subset(state: Mapping[str, np.ndarray], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in state.items() if k.startswith(prefix)}


def _load(module: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    ref = module.state_dict()
    for k, v in sd.items():
        if k in ref:
            sd[k] = v.to(ref[k].dtype)
    module.load_state_dict(sd, strict=True)


def load_vista_state_dict(unet: nn.Module, decoder: nn.Module,
                          state: Union[str, Mapping[str, np.ndarray]]) -> None:
    """Load the UNet and decoder subsets of ``state`` into the modules."""
    if isinstance(state, str):
        from safetensors.numpy import load_file

        state = load_file(state)
    if unet is not None:
        _load(unet, _subset(state, UNET_PREFIX))
    if decoder is not None:
        _load(decoder, _subset(state, DECODER_PREFIX))
