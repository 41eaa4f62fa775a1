"""Quality harness of the port (counterpart of ``tools/quality_bench.py``):
the Fréchet CLIP distance (FCD, per-frame CLIP ViT-H features through the
engine's own frozen tower, an offline proxy for FVD) and PSNR / SSIM of
rollouts against their clips, or, with ``--calibrate``, the metrics'
sensitivity to graded corruptions of the clips.

Pipeline: ``autoregressive_rollout`` (one round) on each clip's frames,
then ``clip_preprocess`` and ``CLIPVisionTower`` on the real and the
generated frames, then ``vista_tpu_torch.utils.metrics`` (PSNR and SSIM
computed where the frames lie). The rollout's pixels come back in [0, 1]
and are mapped to the clips' [-1, 1] before any metric; the JAX harness
compares them as they come. Real FVD protocols use hundreds of clips: with
a handful this is a harness check, not a quality claim.

Usage:
  python tools/torch_quality_bench.py --smoke --device cpu     # harness check
  python tools/torch_quality_bench.py --calibrate --n-clips 2  # FCD sensitivity sweep
  python tools/torch_quality_bench.py --ckpt vista.safetensors \\
      --anno annos/val.json --data-root data/ --n-clips 128     # real eval

The engine runs on the card unless ``--device cpu`` is given. Without
``--anno`` the clips are synthetic (a smooth random pattern drifting 2
pixels a frame, from ``--seed``); without ``--ckpt`` the weights are the
modules' own initialisation from seed 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vista_tpu_torch.models.clip import clip_preprocess, resize_weights  # noqa: E402
from vista_tpu_torch.utils.metrics import (corrupt_clip, frechet_feature_distance,  # noqa: E402
                                           psnr, ssim)

GRADES = [0.15, 0.4, 0.8]
NOTE = ("CLIP-feature Fréchet proxy for FVD: per-frame ViT-H embeddings instead of I3D "
        "clip features. A regression statistic for appearance quality (FCD rises with "
        "graded noise / blur while PSNR / SSIM fall: --calibrate); per-frame features are "
        "order-invariant, so temporal-ordering regressions are carried by PSNR, not FCD.")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="vista_tpu_torch quality harness")
    p.add_argument("--ckpt", default=None, help="vista.safetensors weights")
    p.add_argument("--anno", default=None, help="annotation JSON of real clips")
    p.add_argument("--data-root", default="")
    p.add_argument("--n-clips", type=int, default=2)
    p.add_argument("--n_steps", type=int, default=3)
    p.add_argument("--cfg_scale", type=float, default=2.5)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--smoke", action="store_true",
                   help="tiny engine + synthetic clips (harness check)")
    p.add_argument("--calibrate", action="store_true",
                   help="corrupt the clips with graded noise / blur / temporal shuffle and "
                        "require FCD to rise monotonically (PSNR / SSIM to fall) instead of "
                        "a rollout eval")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write the JSON payload to this path")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs (default: the card; it raises without one)")
    args = p.parse_args(argv)
    if args.smoke:
        args.height = args.width = 32  # the tiny VAE's 4x4 latents
    return args


def engine_config(args: argparse.Namespace):
    """The JAX harness's engine: no action control; tiny and fp32 under
    ``--smoke``, else full width in bf16."""
    from vista_tpu_torch.engine.engine import EngineConfig

    cfg = EngineConfig().tiny() if args.smoke else EngineConfig()
    dtype = "float32" if args.smoke else "bfloat16"
    cond = cfg.conditioner
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, dtype=dtype),
        vae=dataclasses.replace(cfg.vae, dtype=dtype),
        conditioner=dataclasses.replace(cond, clip=dataclasses.replace(cond.clip, dtype=dtype),
                                        vae=dataclasses.replace(cond.vae, dtype=dtype)))


def build_engine(args: argparse.Namespace):
    from vista_tpu_torch.engine.engine import VistaEngine

    torch.manual_seed(0)
    engine = VistaEngine(engine_config(args), args.device)
    if args.ckpt:
        from vista_tpu_torch.utils.checkpoint import load_vista_state_dict

        load_vista_state_dict(engine.unet, engine.decoder, args.ckpt, encoder=engine.encoder,
                              conditioner=engine.conditioner)
    else:
        print("no --ckpt: random weights (harness check only)", flush=True)
    return engine


def synthetic_clips(n: int, t: int, h: int, w: int, seed: int) -> list:
    """``n`` clips ``(t, h, w, 3)`` in [-1, 1]: a random pattern at 1/8 size,
    linearly upsampled (``jax.image.resize``'s weights), rolled 2 pixels a
    frame."""
    rng = np.random.RandomState(seed)
    wh = resize_weights(h // 8, h, "linear")
    ww = resize_weights(w // 8, w, "linear")
    clips = []
    for _ in range(n):
        base = (rng.randn(h // 8, w // 8, 3) * 0.5).astype(np.float32)
        big = np.einsum("abc,ah,bw->hwc", base, wh, ww, optimize=True)
        clip = np.stack([np.roll(big, 2 * i, axis=1) for i in range(t)])
        clips.append(np.clip(clip, -1, 1).astype(np.float32))
    return clips


def load_clips(args: argparse.Namespace, t: int) -> list:
    if not args.anno:
        return synthetic_clips(args.n_clips, t, args.height, args.width, args.seed)
    from vista_tpu_torch.data.datasets import load_anno_frames

    with open(args.anno) as f:
        annos = json.load(f)
    return [load_anno_frames(a, args.data_root, t, args.height, args.width)
            for a in annos[:args.n_clips]]


def to_device(clip, device) -> torch.Tensor:
    """A ``(t, h, w, 3)`` clip as an fp32 tensor on ``device``."""
    if isinstance(clip, torch.Tensor):
        return clip.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(clip)).to(device)


@torch.no_grad()
def features(tower, clip, device) -> np.ndarray:
    """Per-frame CLIP features ``(t, d)`` of a ``(t, h, w, 3)`` clip."""
    x = to_device(clip, device).permute(0, 3, 1, 2)
    return tower(clip_preprocess(x, tower.cfg.image_size)).float().cpu().numpy().astype(np.float64)


def run_eval(args: argparse.Namespace, engine, clips: list) -> dict:
    from vista_tpu_torch.diffusion.guidance import GuiderConfig
    from vista_tpu_torch.diffusion.sampler import SamplerConfig
    from vista_tpu_torch.engine.rollout import (RolloutConfig, autoregressive_rollout,
                                                draw_rollout_noise)
    from vista_tpu_torch.utils.profiling import StepTimer

    t, dev = engine.cfg.num_frames, engine.device
    batch = {k: torch.tensor([v], device=dev) for k, v in
             (("fps_id", 9.0), ("motion_bucket_id", 127.0), ("cond_aug", 0.0))}
    sampler = SamplerConfig(num_steps=args.n_steps, guider=GuiderConfig(
        kind="vanilla", scale=args.cfg_scale, num_frames=t))
    timer, gen_clips = StepTimer(), []
    for i, real in enumerate(clips):
        images = to_device(real, dev).permute(0, 3, 1, 2).contiguous()
        gen = torch.Generator(device=dev).manual_seed(args.seed + i)
        with timer.step() as out:
            pixels, _ = autoregressive_rollout(engine, images, batch, sampler,
                                               RolloutConfig(num_rounds=1),
                                               draw_rollout_noise(engine, images, 1, gen))
            out["result"] = pixels
        gen_clips.append((pixels * 2.0 - 1.0).permute(0, 2, 3, 1))  # [0, 1] -> [-1, 1]
        print(f"clip {i}: generated {tuple(gen_clips[-1].shape)} in "
              f"{timer.durations[-1]:.3f} s", flush=True)
    tower = engine.conditioner.clip_tower
    real_feats = np.concatenate([features(tower, c, dev) for c in clips])
    gen_feats = np.concatenate([features(tower, c, dev) for c in gen_clips])
    fcd = frechet_feature_distance(real_feats, gen_feats)
    pairs = [(g, to_device(r, dev)) for g, r in zip(gen_clips, clips)]
    psnrs = [psnr(g, r) for g, r in pairs]
    ssims = [ssim(g, r) for g, r in pairs]
    if not (np.isfinite(fcd) and all(np.isfinite(v) for v in psnrs + ssims)):
        raise SystemExit(f"non-finite metrics: fcd {fcd}, psnr {psnrs}, ssim {ssims}")
    return {
        "metric": f"quality ({len(clips)} clips x {t} frames, {args.width}x{args.height}, "
                  f"{args.n_steps} steps, "
                  f"{os.path.basename(args.ckpt) if args.ckpt else 'random weights'})",
        "frechet_clip_distance": round(fcd, 3),
        "psnr_db": round(float(np.mean(psnrs)), 2),
        "ssim": round(float(np.mean(ssims)), 4),
        "config": {"height": args.height, "width": args.width, "frames": t,
                   "n_clips": len(clips), "n_steps": args.n_steps,
                   "cfg_scale": args.cfg_scale, "seed": args.seed,
                   "weights": os.path.basename(args.ckpt) if args.ckpt else "random",
                   "clips": "anno" if args.anno else "synthetic", "backend": backend(dev)},
        "rollout_timing": timer.report(),
        "note": NOTE,
    }


def backend(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def corrupted(clips: list, kind: str, strength: float) -> list:
    """The clips under one grade of one corruption, from the grade's own seed."""
    rng = np.random.RandomState(1000 + int(strength * 100))
    return [corrupt_clip(c, kind, strength, rng) for c in clips]


def run_calibration(args: argparse.Namespace, tower, clips: list, device) -> dict:
    """FCD must rise monotonically over the noise and blur grades while PSNR
    falls; temporal shuffle leaves the frame multiset, so FCD must stay far
    below the appearance corruptions' (the proxy's pinned blind spot). The
    corruptions run on host threads, one a (kind, grade)."""
    t = clips[0].shape[0]
    real_feats = np.concatenate([features(tower, c, device) for c in clips])
    jobs = [(kind, s) for kind in ("noise", "blur", "shuffle") for s in GRADES]
    with ThreadPoolExecutor(max_workers=min(len(jobs), os.cpu_count() or 1)) as pool:
        made = dict(zip(jobs, pool.map(lambda j: corrupted(clips, *j), jobs)))
    reals = [to_device(c, device) for c in clips]
    results = {}
    for kind in ("noise", "blur", "shuffle"):
        fcds, psnrs, ssims = [], [], []
        for s in GRADES:
            cor = [to_device(c, device) for c in made.pop((kind, s))]
            feats = np.concatenate([features(tower, c, device) for c in cor])
            fcds.append(float(frechet_feature_distance(real_feats, feats)))
            psnrs.append(float(np.mean([psnr(a, b) for a, b in zip(cor, reals)])))
            ssims.append(float(np.mean([ssim(a, b) for a, b in zip(cor, reals)])))
            del cor
        results[kind] = {
            "grades": GRADES, "fcd": [round(v, 4) for v in fcds],
            "psnr_db": [round(v, 2) for v in psnrs], "ssim": [round(v, 4) for v in ssims],
            "fcd_monotone_increasing": all(b > a for a, b in zip(fcds, fcds[1:])),
            "psnr_monotone_decreasing": all(b < a for a, b in zip(psnrs, psnrs[1:])),
            "ssim_monotone_decreasing": all(b < a for a, b in zip(ssims, ssims[1:])),
        }
        print(f"{kind}: fcd={results[kind]['fcd']} psnr={results[kind]['psnr_db']} "
              f"ssim={results[kind]['ssim']}", flush=True)
    appearance_ok = all(results[k][m] for k in ("noise", "blur")
                        for m in ("fcd_monotone_increasing", "psnr_monotone_decreasing"))
    shuffle_blind = max(results["shuffle"]["fcd"]) < 0.5 * min(
        results["noise"]["fcd"] + results["blur"]["fcd"])
    return {
        "metric": f"FCD sensitivity calibration ({len(clips)} clips x {t} frames, "
                  f"{args.width}x{args.height})",
        "calibration": results,
        "validated": bool(appearance_ok and shuffle_blind),
        "config": {"backend": backend(device)},
        "note": NOTE,
    }


def main(argv=None) -> dict:
    """Run the harness; returns the payload it printed. A calibration that
    does not validate exits with 1 after printing."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the harness runs on the card and found none; pass --device cpu")
    if args.calibrate:
        from vista_tpu_torch.models.clip import CLIPVisionTower

        cfg = engine_config(args)
        torch.manual_seed(0)
        with torch.device(args.device):
            tower = CLIPVisionTower(cfg.conditioner.clip).to(cfg.conditioner.clip.compute_dtype)
        tower.eval()
        if args.ckpt:
            from vista_tpu_torch.utils.checkpoint import CLIP_PREFIX, load_safetensors

            sd = {k[len(CLIP_PREFIX):]: torch.from_numpy(np.array(v))
                  for k, v in load_safetensors(args.ckpt).items() if k.startswith(CLIP_PREFIX)}
            tower.load_state_dict({k: v.to(tower.state_dict()[k].dtype) for k, v in sd.items()},
                                  strict=True)
        payload = run_calibration(args, tower, load_clips(args, cfg.num_frames), args.device)
    else:
        engine = build_engine(args)
        payload = run_eval(args, engine, load_clips(args, engine.cfg.num_frames))
    print(json.dumps(payload))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    if args.calibrate and not payload["validated"]:
        raise SystemExit(1)
    return payload


if __name__ == "__main__":
    main()
