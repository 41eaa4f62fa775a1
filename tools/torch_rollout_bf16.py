"""Where the small rollout's bf16 error comes from: the 2-round rollout of
``chip_smoke.rollout_reference`` (2 steps, triangle CFG 2.5, action control,
seeded random weights) in fp32 against the same with every module in bf16,
and with one module at a time in bf16 (the UNet; the VAE encoder and
decoder; CLIP), after one round and after two. Max-normalised errors of the
latents and of the pixels in [0, 1].

    python3 tools/torch_rollout_bf16.py            # on the CPU: the plain versions
    python3 tools/torch_rollout_bf16.py --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from vista_tpu_torch.diffusion.guidance import GuiderConfig  # noqa: E402
from vista_tpu_torch.diffusion.sampler import SamplerConfig  # noqa: E402
from vista_tpu_torch.engine import RolloutConfig, autoregressive_rollout  # noqa: E402
from vista_tpu_torch.engine.engine import VistaEngine  # noqa: E402


def variants(cfg):
    """The fp32 config with every module, or one module, in bf16."""
    bf = lambda c: dataclasses.replace(c, dtype="bfloat16")
    cond = cfg.conditioner
    return {
        "all bf16": chip_smoke.to_bf16(cfg),
        "UNet bf16": dataclasses.replace(cfg, unet=bf(cfg.unet)),
        "VAE bf16": dataclasses.replace(cfg, vae=bf(cfg.vae),
                                        conditioner=dataclasses.replace(cond, vae=bf(cond.vae))),
        "CLIP bf16": dataclasses.replace(cfg, conditioner=dataclasses.replace(
            cond, clip=bf(cond.clip))),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = chip_smoke.small_cfg("rollout")
    ref_engine = VistaEngine(cfg, "cpu")
    chip_smoke.init_engine(ref_engine, torch.Generator().manual_seed(args.seed))
    images, batch, draws = chip_smoke.rollout_inputs(
        ref_engine, torch.Generator().manual_seed(args.seed + 1), 3)
    sampler = SamplerConfig(num_steps=2, guider=GuiderConfig(
        kind="triangle", scale=2.5, num_frames=cfg.num_frames))

    def rollout(engine, rounds):
        dev = engine.device
        moved = dataclasses.replace(draws, **{f.name: getattr(draws, f.name).to(dev)
                                              for f in dataclasses.fields(draws)})
        px, lat = autoregressive_rollout(engine, images.to(dev),
                                         {k: v.to(dev) for k, v in batch.items()}, sampler,
                                         RolloutConfig(num_rounds=rounds), moved)
        return lat.cpu().float(), px.cpu().float()

    refs = {rounds: rollout(ref_engine, rounds) for rounds in (1, 2)}
    print(f"small rollout, {args.device} against fp32 on the CPU (max-normalised):")
    for name, c in variants(cfg).items():
        engine = VistaEngine(c, args.device)
        for module in ("unet", "decoder", "encoder", "conditioner"):
            getattr(engine, module).load_state_dict(getattr(ref_engine, module).state_dict())
        for rounds, (lat_ref, px_ref) in refs.items():
            lat, px = rollout(engine, rounds)
            e_lat = float((lat - lat_ref).abs().max() / lat_ref.abs().max())
            e_px = float((px - px_ref).abs().max() / px_ref.abs().max())
            print(f"  {name:10s} {rounds} round(s): latents {e_lat:.3e}, pixels {e_px:.3e}")


if __name__ == "__main__":
    main()
