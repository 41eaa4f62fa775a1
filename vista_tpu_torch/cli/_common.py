"""What the sample and reward CLIs share: the device flag, the engine built
from the arguments, the conditioning scalars and the context frames."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict

import numpy as np
import torch

from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine


def add_engine_args(p: argparse.ArgumentParser) -> None:
    """The flags both CLIs take to build the engine."""
    p.add_argument("--ckpt", default=None, help="vista.safetensors weights")
    p.add_argument("--n_frames", type=int, default=25)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--cfg_scale", type=float, default=2.5)
    p.add_argument("--sample_index", type=int, default=0)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--fp32", action="store_true", help="run fp32 (CPU debugging)")
    p.add_argument("--tiny", action="store_true", help="tiny model (CPU smoke run)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs (default: the card; it raises without one)")


def finish_args(args: argparse.Namespace) -> argparse.Namespace:
    """``--tiny`` takes the tiny model's frame count and 32x32 frames."""
    if args.tiny:
        args.n_frames = EngineConfig().tiny().num_frames
        args.height, args.width = 32, 32
    return args


def engine_config(args: argparse.Namespace) -> EngineConfig:
    """The JAX CLIs' engine: ``n_frames`` frames, action control unless
    ``--action free``, bf16 unless ``--fp32`` or ``--tiny`` (here every
    module's dtype, not the UNet's alone)."""
    cfg = EngineConfig().tiny() if args.tiny else EngineConfig()
    dtype = "float32" if (args.fp32 or args.tiny) else "bfloat16"
    action = args.action != "free"
    cond = cfg.conditioner
    return dataclasses.replace(
        cfg, num_frames=args.n_frames,
        unet=dataclasses.replace(cfg.unet, num_frames=args.n_frames, action_control=action,
                                 dtype=dtype),
        vae=dataclasses.replace(cfg.vae, dtype=dtype),
        conditioner=dataclasses.replace(
            cond, action_control=action, clip=dataclasses.replace(cond.clip, dtype=dtype),
            vae=dataclasses.replace(cond.vae, dtype=dtype)))


def build_engine(args: argparse.Namespace) -> VistaEngine:
    """The engine on ``--device`` with the ``--ckpt`` weights, or without one
    the modules' own initialisation from seed 0."""
    if not args.ckpt:
        print("WARNING: no --ckpt given; using random weights (smoke mode)")
        torch.manual_seed(0)
    engine = VistaEngine(engine_config(args), args.device)
    if args.ckpt:
        from vista_tpu_torch.utils.checkpoint import load_vista_state_dict

        load_vista_state_dict(engine.unet, engine.decoder, args.ckpt,
                              encoder=engine.encoder, conditioner=engine.conditioner)
    return engine


def scalar_batch(cond_aug: float, device) -> Dict[str, torch.Tensor]:
    """The conditioning scalars of every sample: fps_id 9, motion bucket 127."""
    return {"fps_id": torch.tensor([9.0], device=device),
            "motion_bucket_id": torch.tensor([127.0], device=device),
            "cond_aug": torch.tensor([cond_aug], device=device)}


def random_frames(rng: np.random.RandomState, n: int, h: int, w: int) -> np.ndarray:
    """Context frames without a dataset, ``(n, h, w, 3)``, as the JAX CLIs
    draw them."""
    return rng.randn(n, h, w, 3).astype(np.float32) * 0.2


def to_engine(frames: np.ndarray, engine: VistaEngine) -> torch.Tensor:
    """``(n, h, w, 3)`` numpy frames -> ``(n, 3, h, w)`` fp32 on the engine's
    device."""
    return torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2).contiguous().to(
        engine.device)
