"""Checkpoint converter (counterpart of ``vista_tpu/cli/convert.py``).

Converts between the upstream safetensors layout (``vista.safetensors``),
the reference's DeepSpeed pickles and the port's own training checkpoint
(``utils/checkpoint.save_checkpoint``: what the train CLI's ``Runner``
writes to ``<logdir>/checkpoints/last``), optionally merging the LoRA
adapters into the base weights (``W += up @ down * scale``). Nothing runs
on the card: every branch is file and numpy work on the host.

Usage:
    # a training run -> upstream safetensors (EMA weights, LoRA merged),
    # which the sample CLI's --ckpt loads
    python -m vista_tpu_torch.cli.convert --input run/checkpoints/last \\
        --output vista_lora.safetensors --merge-lora --action-control

    # merge LoRA inside an upstream safetensors
    python -m vista_tpu_torch.cli.convert --input in.safetensors --output out.safetensors --merge-lora

    # upstream safetensors -> the port's checkpoint (the modules' state)
    python -m vista_tpu_torch.cli.convert --input vista.safetensors --output vista.pt

    # DeepSpeed-merged torch pickle -> the released layout (the reference's
    # bin_to_st pipeline: LoRA merge, prefix strip, EMA swap)
    python -m vista_tpu_torch.cli.convert --input pytorch_model.bin --output vista.safetensors

Inputs ending in ``.safetensors`` are upstream files; ``.bin``, ``.ckpt`` and
``.pt`` files are DeepSpeed pickles unless they hold the port's checkpoint
(``{"trainer", "modules"}``), which any other name is read as. Outputs
ending in ``.safetensors`` are upstream files, any other name the port's
checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict

import numpy as np
import torch

from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
from vista_tpu_torch.utils import checkpoint as io

PICKLE_SUFFIXES = (".bin", ".ckpt", ".pt")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="vista_tpu_torch checkpoint converter")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--merge-lora", action="store_true")
    p.add_argument("--lora-scale", type=float, default=1.0)
    p.add_argument("--action-control", action="store_true",
                   help="config has action-control adapters")
    p.add_argument("--lax", action="store_true", help="non-strict key matching")
    return p.parse_args(argv)


def engine_config(args: argparse.Namespace) -> EngineConfig:
    """The full-size engine, with action control under ``--action-control``."""
    cfg = EngineConfig()
    if args.action_control:
        cfg = dataclasses.replace(
            cfg, unet=dataclasses.replace(cfg.unet, action_control=True),
            conditioner=dataclasses.replace(cfg.conditioner, action_control=True))
    return cfg


def native_to_upstream(state: Dict) -> Dict[str, np.ndarray]:
    """A training checkpoint's modules in the upstream layout, the UNet's
    trained tensors replaced by their EMA shadows where it holds them (as
    ``bin_to_st`` swaps ``model_ema`` in)."""
    modules = state["modules"]
    unet = dict(modules["unet"])
    for name, shadow in state.get("trainer", {}).get("ema", {}).items():
        unet[name] = shadow
    return io.upstream_state_dict(unet, modules.get("decoder"), modules.get("encoder"),
                                  modules.get("conditioner"))


def upstream_to_native(sd: Dict[str, np.ndarray], cfg: EngineConfig, strict: bool) -> Dict:
    """The modules' state dicts of ``cfg``'s engine from an upstream dict,
    each tensor in its module's dtype; the key sets and shapes are checked
    against modules built on the meta device (nothing is allocated)."""
    meta = VistaEngine(cfg, "meta")
    prefixes = {"unet": [("", io.UNET_PREFIX)], "decoder": [("", io.DECODER_PREFIX)],
                "encoder": [("", io.ENCODER_PREFIX)],
                "conditioner": [("clip_tower.", io.CLIP_PREFIX),
                                ("quant_conv.", io.QUANT_PREFIX)]}
    modules = {}
    for name, pairs in prefixes.items():
        ref = getattr(meta, name).state_dict()
        out = {}
        for own, prefix in pairs:
            for k, v in sd.items():
                if k.startswith(prefix):
                    out[own + k[len(prefix):]] = torch.from_numpy(np.array(v))
        missing, extra = sorted(set(ref) - set(out)), sorted(set(out) - set(ref))
        if strict and (missing or extra):
            raise KeyError(f"{name}: {len(missing)} keys missing (first {missing[:3]}), "
                           f"{len(extra)} unexpected (first {extra[:3]})")
        for k in list(out):
            if k not in ref:
                del out[k]
            elif tuple(out[k].shape) != tuple(ref[k].shape):
                raise ValueError(f"{name}.{k}: shape {tuple(out[k].shape)}, the module's "
                                 f"{tuple(ref[k].shape)}")
            else:
                out[k] = out[k].to(ref[k].dtype)
        modules[name] = out
    return {"trainer": {}, "modules": modules}


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.input.endswith(".safetensors"):
        sd = io.load_safetensors(args.input)
        if args.merge_lora:
            sd = io.merge_lora_weights(sd, args.lora_scale)
    else:
        obj = torch.load(args.input, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and {"trainer", "modules"} <= set(obj):
            sd = native_to_upstream(obj)
            if args.merge_lora:
                sd = io.merge_lora_weights(sd, args.lora_scale)
        elif args.input.endswith(PICKLE_SUFFIXES):
            del obj
            # the reference's bin_to_st pipeline runs whole, its LoRA merge
            # included, whatever --merge-lora says
            sd = io.bin_to_state_dict(io.load_torch_bin(args.input))
        else:
            raise ValueError(f"{args.input}: not the port's checkpoint, and not a "
                             f"{'/'.join(PICKLE_SUFFIXES)} pickle or a .safetensors file")
    if args.output.endswith(".safetensors"):
        io.save_safetensors(args.output, sd)
    else:
        state = upstream_to_native(sd, engine_config(args), strict=not args.lax)
        io.save_checkpoint(args.output, state["trainer"], state["modules"])
    print(f"converted {args.input} -> {args.output}")


if __name__ == "__main__":
    main()
