"""Training CLI (counterpart of ``vista_tpu/cli/train.py``).

Usage:
    python -m vista_tpu_torch.cli.train --base configs/vista_phase2_stage2.yaml \\
        [--resume logs/run/checkpoints/last] [--ckpt vista.safetensors] \\
        [--synthetic-data] [--device cuda|cpu] [run.max_steps=100 ...]

Configs are typed YAML (``vista_tpu_torch/config.py``) merged left to right,
then the dotlist overrides. It runs on the card unless ``--device cpu``, and
raises without one. Without ``--ckpt`` the weights are the modules' own
initialisation under ``run.seed``. ``main(argv)`` runs in-process and
returns the :class:`~vista_tpu_torch.runner.Runner`.

On N cards, one process a card::

    torchrun --nproc_per_node N -m vista_tpu_torch.cli.train \
        --base configs/vista_phase1.yaml parallel.data=N

Under torchrun (``WORLD_SIZE`` set) every process joins the group (NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``), the ``parallel`` mesh
takes its ranks and the pipeline yields the data rank's rows.
"""

from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="vista_tpu_torch trainer")
    p.add_argument("--base", nargs="*", default=[],
                   help="YAML config paths (merged left to right)")
    p.add_argument("--resume", default=None, help="checkpoint file to resume from")
    p.add_argument("--ckpt", default=None, help="vista.safetensors initial weights")
    p.add_argument("--synthetic-data", action="store_true",
                   help="use the synthetic dataset (smoke runs)")
    p.add_argument("--debug", action="store_true",
                   help="open pdb post mortem if training crashes (SIGUSR2 also "
                        "opens a live pdb at the next step)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where training runs (default: the card; it raises without one)")
    p.add_argument("overrides", nargs="*", help="a.b.c=value dotlist overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from vista_tpu_torch.config import load_config
    from vista_tpu_torch.data.pipeline import build_pipeline
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.parallel.mesh import init_distributed
    from vista_tpu_torch.runner import ExperimentConfig, Runner, rank_data, run_mesh

    device = args.device
    if os.environ.get("WORLD_SIZE"):
        device = init_distributed(args.device)
    cfg = load_config(ExperimentConfig, args.base, args.overrides)
    mesh = run_mesh(cfg)
    torch.manual_seed(cfg.run.seed)
    engine = VistaEngine(cfg.engine, device)
    if args.ckpt:
        from vista_tpu_torch.utils.checkpoint import load_vista_state_dict

        print(f"loading weights from {args.ckpt}")
        load_vista_state_dict(engine.unet, engine.decoder, args.ckpt,
                              encoder=engine.encoder, conditioner=engine.conditioner)
    pipeline = build_pipeline(rank_data(cfg.data, mesh), cfg.height, cfg.width,
                              cfg.engine.num_frames, synthetic=args.synthetic_data,
                              process_index=mesh.coord("data"))
    try:
        runner = Runner(cfg, pipeline, engine=engine, synthetic=args.synthetic_data, mesh=mesh)
        if args.resume:
            runner.resume(args.resume)
            if mesh.is_first:
                print(f"resumed from {args.resume} at step {runner.trainer.step}")
        runner.fit()
    except Exception:
        pipeline.stop()
        if args.debug and mesh.is_first:
            import pdb
            import traceback

            traceback.print_exc()
            pdb.post_mortem()
        raise
    if mesh.is_first:
        print(f"done at step {runner.trainer.step}")
    return runner


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
