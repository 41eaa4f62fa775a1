"""Reward CLI (counterpart of ``vista_tpu/cli/reward.py``).

Estimates the ensemble-variance confidence reward of an action-conditioned
future; the defaults are the reference's (10 steps, an ensemble of 5, the
``traj`` action, the vanilla guider). Prints one JSON line,
``{"sample_index": ..., "reward": ...}``.

Usage:
    python -m vista_tpu_torch.cli.reward [--ckpt vista.safetensors] \\
        [--anno path.json --data-root DIR] [--save DIR] [--device cpu]

Without ``--anno`` the context frames and the trajectory are random
(seeded). The engine runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from vista_tpu_torch.cli._common import (add_engine_args, build_engine, finish_args,
                                         random_frames, scalar_batch, to_engine)
from vista_tpu_torch.data.datasets import ACTION_MODES, anno_actions, load_anno_frames
from vista_tpu_torch.diffusion.guidance import GuiderConfig
from vista_tpu_torch.diffusion.sampler import SamplerConfig
from vista_tpu_torch.engine.engine import VistaEngine
from vista_tpu_torch.engine.reward import estimate_reward
from vista_tpu_torch.engine.rollout import draw_rollout_noise
from vista_tpu_torch.utils.video import save_grid_png, save_video_mp4


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="vista_tpu_torch reward estimator")
    p.add_argument("--save", default=None, help="save the real inputs")
    p.add_argument("--anno", default=None)
    p.add_argument("--data-root", default="")
    p.add_argument("--action", default="traj", choices=ACTION_MODES)
    p.add_argument("--n_steps", type=int, default=10)
    p.add_argument("--ens_size", type=int, default=5)
    add_engine_args(p)
    return finish_args(p.parse_args(argv))


def run(args: argparse.Namespace, engine: VistaEngine) -> dict:
    """Estimate the reward and print its JSON line; returns the reward, the
    context frames, the batch and the paths written."""
    batch = scalar_batch(0.0, engine.device)
    if args.anno:
        with open(args.anno) as f:
            anno = json.load(f)[args.sample_index]
        frames = load_anno_frames(anno, args.data_root, args.n_frames, args.height, args.width)
        # the reference's reward reads the trajectory alone
        actions = anno_actions(anno, "traj") if args.action == "traj" else {}
    else:
        rng = np.random.RandomState(args.seed)
        frames = random_frames(rng, args.n_frames, args.height, args.width)
        actions = ({"trajectory": rng.randn(1, 8).astype(np.float32)}
                   if args.action == "traj" else {})
    batch.update({k: torch.from_numpy(v).to(engine.device) for k, v in actions.items()})
    images = to_engine(frames, engine)

    sampler = SamplerConfig(num_steps=args.n_steps, guider=GuiderConfig(
        kind="vanilla", scale=args.cfg_scale, num_frames=args.n_frames))
    gen = torch.Generator(device=engine.device).manual_seed(args.seed)
    draws = draw_rollout_noise(engine, images, args.ens_size, gen)
    reward = float(estimate_reward(engine, images, batch, sampler,
                                   ensemble_size=args.ens_size, draws=draws))
    paths = {}
    if args.save:  # the reference saves only the real inputs of a reward run
        name = f"reward_{args.sample_index:06d}"
        paths = {"real": save_video_mp4(os.path.join(args.save, "real", "videos", name + ".mp4"),
                                        frames, real=True),
                 "grid": save_grid_png(os.path.join(args.save, "real", "grids", name + ".png"),
                                       frames, real=True)}
        for path in paths.values():
            print(f"wrote {path}")
    print(json.dumps({"sample_index": args.sample_index, "reward": reward}))
    return dict(reward=reward, images=images, batch=batch, paths=paths)


def main(argv=None) -> None:
    args = parse_args(argv)
    run(args, build_engine(args))


if __name__ == "__main__":
    main()
