"""Sampling CLI (counterpart of ``vista_tpu/cli/sample.py``).

Runs the autoregressive rollout and writes videos, a grid and frames. The
action modes are the reference's: traj / cmd / steer / goal.

Usage:
    python -m vista_tpu_torch.cli.sample --n_rounds 2 --n_steps 10 \\
        [--ckpt vista.safetensors] [--anno path.json --data-root DIR] \\
        [--action traj] [--device cpu]

Without ``--image`` or ``--anno`` the context frames are random (seeded).
The engine runs on the card unless ``--device cpu`` is given.

On N cards the denoise rounds run sharded, one process a card::

    torchrun --nproc_per_node N -m vista_tpu_torch.cli.sample --mesh-data N \
        [--mesh-mode frames|height|weights]

``frames`` splits each video's frames over the ranks (N must divide
``--n_frames``), ``height`` the latent rows of every frame (N must divide
the latent height, ``--height`` / 8), ``weights`` slices the UNet's weights
over them; every rank holds the whole result and rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from vista_tpu_torch.cli._common import (add_engine_args, build_engine, finish_args,
                                         random_frames, scalar_batch, to_engine)
from vista_tpu_torch.data.datasets import (ACTION_MODES, anno_actions, load_anno_frames,
                                           load_image)
from vista_tpu_torch.diffusion.guidance import GuiderConfig
from vista_tpu_torch.diffusion.sampler import SamplerConfig
from vista_tpu_torch.engine.engine import VistaEngine
from vista_tpu_torch.engine.rollout import (RolloutConfig, autoregressive_rollout,
                                            draw_rollout_noise)
from vista_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from vista_tpu_torch.utils.video import save_frames_png, save_grid_png, save_video_mp4


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="vista_tpu_torch sampler")
    p.add_argument("--anno", default=None, help="annotation JSON (nuScenes-style)")
    p.add_argument("--image", default=None,
                   help="single conditioning image (the reference's IMG mode)")
    p.add_argument("--data-root", default="", help="frame root dir")
    p.add_argument("--save", default="outputs", help="output dir")
    p.add_argument("--action", default="free", choices=ACTION_MODES)
    p.add_argument("--n_rounds", type=int, default=1)
    p.add_argument("--n_steps", type=int, default=50)
    p.add_argument("--n_conds", type=int, default=1)
    p.add_argument("--cond_aug", type=float, default=0.0)
    p.add_argument("--mesh-data", type=int, default=0,
                   help="shard the denoise rounds over this many ranks (run under torchrun "
                        "with as many processes; 0 = one process, unsharded)")
    p.add_argument("--mesh-mode", default="frames", choices=["frames", "height", "weights"],
                   help="sharded-denoise layout: frames (each rank a run of frames), height "
                        "(each rank a band of latent rows), weights (the UNet's weights sliced "
                        "over the ranks)")
    add_engine_args(p)
    return finish_args(p.parse_args(argv))


def context(args: argparse.Namespace) -> tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The context frames ``(n_frames, h, w, 3)`` in [-1, 1] and the actions
    of ``--image``, ``--anno`` or seeded random frames."""
    if args.image:  # IMG mode: one image conditions the whole clip
        frame = load_image(args.image, args.height, args.width)
        return np.repeat(frame[None], args.n_frames, axis=0), {}
    if args.anno:
        with open(args.anno) as f:
            anno = json.load(f)[args.sample_index]
        frames = load_anno_frames(anno, args.data_root, args.n_frames, args.height, args.width)
        return frames, anno_actions(anno, args.action)
    print("no --anno: using random context frames (smoke mode)")
    return random_frames(np.random.RandomState(args.seed), args.n_frames, args.height,
                         args.width), {}


def sample_mesh(args: argparse.Namespace) -> Mesh:
    """The ``--mesh-data`` mesh: joins torchrun's process group and raises
    unless it has ``--mesh-data`` ranks, and on the JAX CLI's divisibility
    rules. Returns the mesh and sets ``args.device`` to this rank's device."""
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if world != args.mesh_data:
        raise SystemExit(f"--mesh-data {args.mesh_data}: run under torchrun with as many "
                         f"processes (WORLD_SIZE={world or 'unset'})")
    if args.mesh_mode == "frames" and args.n_frames % args.mesh_data:
        raise SystemExit(f"--mesh-data {args.mesh_data} must divide n_frames={args.n_frames}")
    if args.mesh_mode == "height" and (args.height // 8) % args.mesh_data:
        raise SystemExit(f"--mesh-data {args.mesh_data} must divide the "
                         f"latent height {args.height // 8}")
    args.device = init_distributed(args.device)
    return make_mesh({"data": args.mesh_data})


def run(args: argparse.Namespace, engine: VistaEngine, mesh: Optional[Mesh] = None) -> dict:
    """Roll out from the context (sharded over ``mesh``'s ``data`` axis in
    ``--mesh-mode`` when given) and write the outputs under ``--save`` (rank
    0); returns the latents, the pixels, the context frames and the paths
    (None on the other ranks)."""
    frames, actions = context(args)
    images = to_engine(frames, engine)
    batch = scalar_batch(args.cond_aug, engine.device)
    batch.update({k: torch.from_numpy(v).to(engine.device) for k, v in actions.items()})
    guider = GuiderConfig(kind="triangle" if args.n_rounds > 1 else "vanilla",
                          scale=args.cfg_scale, min_scale=1.0, num_frames=args.n_frames)
    sampler = SamplerConfig(num_steps=args.n_steps, guider=guider)
    rollout = RolloutConfig(num_rounds=args.n_rounds,
                            initial_cond_indices=tuple(range(args.n_conds)))
    gen = torch.Generator(device=engine.device).manual_seed(args.seed)
    draws = draw_rollout_noise(engine, images, args.n_rounds, gen)
    pixels, latents = autoregressive_rollout(engine, images, batch, sampler, rollout, draws,
                                             mesh=mesh, mesh_mode=args.mesh_mode)
    out = dict(latents=latents, pixels=pixels, images=images, batch=batch, paths=None)
    if mesh is not None and not mesh.is_first:
        return out

    video = pixels.permute(0, 2, 3, 1).cpu().numpy()
    name = f"sample_{args.sample_index:06d}"
    paths = {
        "video": save_video_mp4(os.path.join(args.save, "videos", name + ".mp4"), video),
        "grid": save_grid_png(os.path.join(args.save, "grids", name + ".png"), video),
        "frames": save_frames_png(os.path.join(args.save, "images"), video, prefix=name),
        "real": save_video_mp4(os.path.join(args.save, "videos_real", name + ".mp4"), frames,
                               real=True)}
    for kind in ("video", "grid", "real"):
        print(f"wrote {paths[kind]}")
    print(f"wrote {len(paths['frames'])} frames to {os.path.join(args.save, 'images')}")
    out["paths"] = paths
    return out


def main(argv=None) -> None:
    args = parse_args(argv)
    mesh = sample_mesh(args) if args.mesh_data else None
    run(args, build_engine(args), mesh)


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
