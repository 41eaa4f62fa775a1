"""The rank programs of ``tests/test_torch_parallel*.py``: each runs in a
spawned gloo rank (``tests/torch_ranks.py``), imports no JAX and returns
numpy arrays and plain values for the test process to check."""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from vista_tpu_torch.parallel import mesh as pm
from vista_tpu_torch.parallel.frames import frame_parallel
from vista_tpu_torch.parallel.mesh import (Mesh, all_gather_dim, frames_to_tokens,
                                           gather_frames, grad_mean_, make_mesh, shard,
                                           token_splits, tokens_to_frames)


def mesh_outcome(axis_sizes):
    """``("ok", shape)`` or ``("err", message)`` of ``make_mesh``."""
    try:
        return "ok", make_mesh(axis_sizes).shape
    except ValueError as e:
        return "err", str(e)


# ---- tests/test_torch_parallel.py

def collectives(rank, mesh_cases):
    """make_mesh's outcomes; the all-to-all, gather and mean helpers; the
    partial-sum GroupNorm statistics, on 2 ranks at s = 9 tokens."""
    from vista_tpu_torch.ops.temporal_conv import gn_affine

    out = {"mesh": [mesh_outcome(c) for c in mesh_cases]}
    group = dist.group.WORLD
    n = dist.get_world_size()
    g = torch.Generator().manual_seed(5)
    b, t, s, c = 2, 4, 9, 64
    tl = t // n
    whole = torch.randn(b, t, s, c, generator=g)
    x = whole[:, rank * tl:(rank + 1) * tl].reshape(b * tl, s, c).contiguous()
    off = sum(token_splits(s, n)[:rank])
    mine = token_splits(s, n)[rank]
    tokens = whole[:, :, off:off + mine]
    out["splits"] = token_splits(s, n)
    for seq_major in (True, False):
        y = frames_to_tokens(x, b, group, seq_major)
        want = (tokens.permute(0, 2, 1, 3).reshape(b * mine, t, c) if seq_major
                else tokens.reshape(b * t, mine, c))
        back = tokens_to_frames(y, b, s, group, seq_major)
        out[f"a2a_{seq_major}"] = (torch.equal(y, want), y.is_contiguous(),
                                   torch.equal(back, x), back.is_contiguous())
    out["gather_frames"] = torch.equal(gather_frames(x, b, group), whole.reshape(b * t, s, c))

    tensor = torch.randn(4, 6, 8, generator=g)
    out["gather_dims"] = [torch.equal(all_gather_dim(shard(tensor, d, group), d, group), tensor)
                          for d in (None, 0, 1, 2)]
    base = [torch.randint(-50, 50, shape, generator=g).float() for shape in ((3, 5), (7,), (2, 2))]
    grads = [v + 2 * rank for v in base]
    pm.BUCKET_ELEMS = 16  # several buckets
    grad_mean_(grads, group)
    out["grad_mean"] = all(torch.equal(got, v + 1.0) for got, v in zip(grads, base))

    rows = whole.reshape(b * t, s, c)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=g)
    beta = 0.1 * torch.randn(c, generator=g)
    ref = gn_affine(rows, gamma, beta, t)
    got = gn_affine(tokens.reshape(b * t, mine, c).contiguous(), gamma, beta, t, 1e-5, group)
    out["gn_rel"] = [float((a - r).abs().max() / r.abs().max()) for a, r in zip(got, ref)]
    out["height"] = height_primitives(group)
    return out


def height_primitives(group):
    """The band code of ``parallel/height.py`` against the whole-frame op on
    the same inputs, at an uneven level (9 rows: bands 4 / 5) and an empty
    band (1 row: 0 / 1; a 2 -> 1 row stride-2 conv leaves rank 0 none): the
    UNet's 3x3 conv at stride 1 and 2, its 1x1 conv, ``Upsample``,
    ``GroupNorm32`` and band-local queries against gathered K and V. Each
    rank's bands are gathered whole; the largest difference relative to the
    whole op's largest magnitude, by case."""
    from vista_tpu_torch.models.blocks import Upsample
    from vista_tpu_torch.models.layers import Conv2d, GroupNorm32
    from vista_tpu_torch.ops.attention import attention_packed, attention_plain
    from vista_tpu_torch.parallel.height import (band, band_of, band_sizes, gather_bands,
                                                 gather_keys, height_parallel)

    torch.manual_seed(6)
    g = torch.Generator().manual_seed(7)
    f, c, w = 3, 64, 6
    mods = {"conv": Conv2d(c, 16, 3, padding=1), "conv_s2": Conv2d(c, c, 3, stride=2, padding=1),
            "conv_1x1": Conv2d(c, 16, 1), "upsample": Upsample(c), "group_norm": GroupNorm32(c)}
    with torch.no_grad():
        mods["group_norm"].weight.normal_(1.0, 0.1)
        mods["group_norm"].bias.normal_(0.0, 0.1)
    out = {}
    for rows in (9, 1, 2):
        x = torch.randn(f, c, rows, w, generator=g).contiguous(memory_format=torch.channels_last)
        for name, mod in mods.items():
            if rows == 2 and name != "conv_s2":
                continue
            with torch.no_grad():
                ref = mod(x)
                with height_parallel(group, rows, w):
                    got = gather_bands(mod(band_of(x)), 2, band_sizes(ref.shape[2]))
            out[f"{name} {rows} rows"] = float((got - ref).abs().max() / ref.abs().max())
        if rows == 2:
            continue
        heads = 2
        q, k, v = (torch.randn(f, rows * w, heads * 16, generator=g) for _ in range(3))
        ref = attention_plain(q, k, v, heads)
        with height_parallel(group, rows, w):
            start, stop = band(rows)
            mine = lambda t: t[:, start * w:stop * w]
            kk, vv = gather_keys(mine(k), mine(v), w)
            part = attention_packed(mine(q), kk, vv, heads)
            got = gather_bands(part, 1, [size * w for size in band_sizes(rows)])
        out[f"attention {rows} rows"] = float((got - ref).abs().max() / ref.abs().max())
    return out


# ---- tests/test_torch_parallel_sample.py

def fp32(cfg):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dtype="float32"),
                               vae=dataclasses.replace(cfg.vae, dtype="float32"))


class OneRank:
    """The part of a ``DeviceMesh`` that ``Mesh`` reads, for a one-rank
    ``group`` of the world (each rank its own)."""

    def __init__(self, group):
        self.group = group

    def get_group(self, axis):
        return self.group

    def get_local_rank(self, axis):
        return 0


def tiny_engine(state, **changes):
    """The tiny fp32 engine: the UNet and the decoder from ``state`` (the
    JAX weights' export), the rest its own initialisation under seed 0."""
    from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
    from vista_tpu_torch.utils.checkpoint import load_vista_state_dict

    torch.manual_seed(0)
    engine = VistaEngine(dataclasses.replace(fp32(EngineConfig().tiny()), **changes), "cpu")
    load_vista_state_dict(engine.unet, engine.decoder, state)
    return engine


def sampling(rank, state, inputs, sampler_kw, save_dir):
    """The one-rank pass, the frames, height and weights passes, the height
    pass and one denoiser call at 6 and 2 latent rows, a 2-round rollout
    with and without the mesh, the refusals, and the sample CLI in frames
    and height mode."""
    from vista_tpu_torch.cli import sample as sample_cli
    from vista_tpu_torch.diffusion.guidance import GuiderConfig
    from vista_tpu_torch.diffusion.sampler import SamplerConfig
    from vista_tpu_torch.engine.rollout import (RolloutConfig, autoregressive_rollout,
                                                draw_rollout_noise)
    from vista_tpu_torch.parallel.height import band_of, gather_rows, height_parallel

    mesh = make_mesh({"data": 2})
    engine = tiny_engine(state)
    t = engine.cfg.num_frames
    sampler = SamplerConfig(guider=GuiderConfig(**sampler_kw["guider"]), num_steps=sampler_kw["steps"])
    noise, cond, uc, cond_frame, mask = inputs
    args = (noise, cond, uc, cond_frame, mask, sampler)
    out = {"one": engine.sample(*args).numpy()}
    # one denoiser call on the CFG-doubled batch, whole and frame-parallel
    x = torch.cat([noise, noise])
    sigma = torch.ones(x.shape[0])
    both = {k: torch.cat([uc[k], cond[k]]) for k in cond}
    m2 = torch.cat([mask, mask])
    tl = t // dist.get_world_size()
    mine = lambda a: a.view(2, t, *a.shape[1:])[:, rank * tl:(rank + 1) * tl].reshape(
        -1, *a.shape[1:])
    with torch.no_grad():
        out["denoise_one"] = engine.denoise_fn()(x, sigma, both, m2).numpy()
        with frame_parallel(mesh.group("data")):
            part = engine.denoise_fn(tl)(mine(x), mine(sigma), both, mine(m2))
    out["denoise_frames"] = gather_frames(part, 2, mesh.group("data")).numpy()
    before = {k: v.clone() for k, v in engine.unet.state_dict().items()}
    for mode in ("frames", "height", "weights"):
        out[mode] = engine.sample_sharded(*args, mesh=mesh, mode=mode, fsdp_min_size=128).numpy()
    # height: 8 rows (bands 4 / 4, then 2 / 2), 6 (3 / 3, so rank 1's stride-2
    # input starts on an odd row, then 1 / 2) and 2 (1 / 1, then an empty
    # band); each also on a one-rank mesh of this rank alone (one band)
    solo = Mesh({"data": 1, "fsdp": 1}, OneRank([dist.new_group([r]) for r in range(2)][rank]))
    for rows in (8, 6, 2):
        cut = lambda a: a[:, :, :rows]
        conds = [{k: cut(v) if v.ndim == 4 else v for k, v in c.items()} for c in (cond, uc)]
        rows_args = (cut(noise), *conds, cut(cond_frame), mask, sampler)
        out[f"height_one_band_{rows}"] = engine.sample_sharded(*rows_args, mesh=solo,
                                                               mode="height").numpy()
        if rows != 8:
            out[f"one_{rows}"] = engine.sample(*rows_args).numpy()
            out[f"height_{rows}"] = engine.sample_sharded(*rows_args, mesh=mesh,
                                                          mode="height").numpy()
        both = {k: torch.cat([conds[1][k], conds[0][k]]) for k in cond}
        with torch.no_grad():
            out[f"denoise_one_{rows}"] = engine.denoise_fn()(cut(x), sigma, both, m2).numpy()
            with height_parallel(mesh.group("data"), rows, x.shape[3]):
                part = engine.denoise_fn()(band_of(cut(x)), sigma, {
                    k: band_of(v) if v.ndim == 4 else v for k, v in both.items()}, m2)
                out[f"denoise_height_{rows}"] = gather_rows(part).numpy()
    out["unet_restored"] = all(torch.equal(before[k], v)
                               for k, v in engine.unet.state_dict().items())

    # 16x16 pixels: the tiny VAE's 8x8 latents, as the passes above
    images = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, (t, 3, 16, 16))
                              .astype(np.float32))
    batch = {"fps_id": torch.tensor([9.0]), "motion_bucket_id": torch.tensor([127.0]),
             "cond_aug": torch.tensor([0.02])}
    rollout = RolloutConfig(num_rounds=2)
    tri = SamplerConfig(num_steps=2, guider=GuiderConfig(kind="triangle", scale=2.5,
                                                         num_frames=t))
    draws = draw_rollout_noise(engine, images, 2, torch.Generator().manual_seed(3))
    out["rollout_noise_max"] = float(draws.noise[0].abs().max())
    for name, kw in (("rollout_one", {}), ("rollout_frames", {"mesh": mesh}),
                     ("rollout_height", {"mesh": mesh, "mesh_mode": "height"}),
                     ("rollout_weights", {"mesh": mesh, "mesh_mode": "weights"})):
        pixels, latents = autoregressive_rollout(engine, images, batch, tri, rollout, draws, **kw)
        out[name] = (pixels.numpy(), latents.numpy())

    errors = {}
    odd = tiny_engine(state, num_frames=3)
    try:
        odd.sample_sharded(noise[:3], cond, uc, cond_frame[:3], mask[:3], sampler, mesh=mesh)
    except ValueError as e:
        errors["frames"] = str(e)
    for argv in (["--mesh-data", "2", "--mesh-mode", "height", "--height", "40"],
                 ["--mesh-data", "2", "--n_frames", "3"], ["--mesh-data", "3"]):
        try:
            sample_cli.sample_mesh(sample_cli.parse_args(["--device", "cpu", *argv]))
        except SystemExit as e:
            errors[" ".join(argv)] = str(e)
    out["errors"] = errors

    # the CLI under the group: rank 0 writes, every rank holds the latents
    for mode in ("frames", "height"):
        save = os.path.join(save_dir[rank], mode)
        cli_args = sample_cli.parse_args(["--tiny", "--device", "cpu", "--n_steps", "2",
                                          "--mesh-data", "2", "--mesh-mode", mode,
                                          "--save", save])
        result = sample_cli.run(cli_args, sample_cli.build_engine(cli_args),
                                sample_cli.sample_mesh(cli_args))
        out[f"cli_{mode}"] = (result["paths"] is not None, sorted(os.listdir(save))
                              if os.path.isdir(save) else [], result["latents"].numpy())
    return out


# ---- tests/test_torch_parallel_train.py

def phase2_engine(pcfg, seed=31):
    """The tiny phase-2 engine with seeded random weights, none zero (the
    LoRA ``up`` and action adapters the model zero-initialises included):
    norms near 1, fan-in scaled weights, small biases; the frozen modules
    their own initialisation under the same seed."""
    from vista_tpu_torch.engine.engine import VistaEngine

    torch.manual_seed(seed)
    engine = VistaEngine(pcfg, "cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in engine.unet.modules():
            for name, p in module.named_parameters(recurse=False):
                r = torch.randn(p.shape, generator=gen)
                if isinstance(module, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
                    r = 1.0 + 0.1 * r if name == "weight" else 0.1 * r
                elif p.ndim >= 2:
                    r = r * p[0].numel() ** -0.5
                elif name != "mix_factor":
                    r = 0.02 * r
                p.copy_(r)
    return engine


def state_engine(pcfg, state):
    """The tiny engine of config ``pcfg`` holding ``state``, the JAX
    weights' export."""
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.utils.checkpoint import load_vista_state_dict

    torch.manual_seed(0)
    engine = VistaEngine(pcfg, "cpu")
    load_vista_state_dict(engine.unet, engine.decoder, state, encoder=engine.encoder,
                          conditioner=engine.conditioner)
    return engine


def snapshot(trainer):
    """The trainer's whole state as numpy, each slice gathered on every rank
    (a collective over a mesh), with its counts and the module's trained
    parameters."""
    out = {g: {n: trainer._whole(n, t).numpy().copy() for n, t in group.items()}
           for g, group in trainer._groups()}
    out["counts"] = (trainer.step, trainer.updates)
    out["module"] = {n: p.detach().numpy().copy() for n, p in trainer.params.items()}
    return out


def digest(tensors) -> str:
    """A hash of the names, shapes and bits of ``tensors``."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].detach().cpu().contiguous()
        h.update(f"{k}{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


def data_parallel_step(rank, state, pcfg, tcfg, batch, draws):
    """One step on each rank's video of the global ``batch`` (the tiny
    engine holding ``state``, the JAX weights' export): on one rank with the
    video's rows of the global ``draws``, then at (data 2, fsdp 1). Each
    step's metrics and state."""
    from vista_tpu_torch.engine.training import Trainer, shard_draws

    n = dist.get_world_size()
    video = {k: v.chunk(n)[rank] for k, v in batch.items()}
    mine = shard_draws(draws, rank, n)
    out = {}
    for name, mesh in (("video", None), ("data2", make_mesh({"data": n, "fsdp": 1}))):
        trainer = Trainer(state_engine(pcfg, state), tcfg, mesh)
        out[f"{name}_metrics"] = trainer(video, mine)
        out[name] = snapshot(trainer)
    return out


def training(rank, pcfg, tcfg, batch, tiny_yaml, tmp):
    """The tiny phase-2 trainer on a global batch, its draws from seeds 32
    and 33: two micro-steps at ``accum_steps`` 2 on one rank, at (data 2,
    fsdp 1) on the rank's row and at (data 1, fsdp 2); checkpoints across
    the meshes; the Runner at fsdp 2; the LR rule, the batch rule and the
    signal flags."""
    from vista_tpu_torch import runner as R
    from vista_tpu_torch.config import load_config
    from vista_tpu_torch.data.pipeline import build_pipeline
    from vista_tpu_torch.engine.training import Trainer, draw_train, shard_draws
    from vista_tpu_torch.parallel.mesh import Mesh
    from vista_tpu_torch.utils import checkpoint as ckpt_io

    n = dist.get_world_size()
    min_size = 1024  # the adapters: some sliced, some whole
    engine = phase2_engine(pcfg)
    draws = [draw_train(engine, tcfg, batch, torch.Generator().manual_seed(seed))
             for seed in (32, 33)]

    def run(mesh, rows, cfg=tcfg, calls=draws):
        trainer = Trainer(phase2_engine(pcfg), cfg, mesh, min_size)
        metrics = []
        for d in calls:
            b, dd = batch, d
            if rows:
                b = {k: v.chunk(n)[rank] for k, v in batch.items()}
                dd = shard_draws(d, rank, n)
            metrics.append(trainer(b, dd))
        return trainer, metrics

    out = {}
    one, out["one_metrics"] = run(None, False)
    out["one"] = snapshot(one)
    data2, out["data2_metrics"] = run(make_mesh({"data": 2, "fsdp": 1}), True)
    out["data2"] = snapshot(data2)
    fsdp_mesh = make_mesh({"data": 1, "fsdp": 2})
    fsdp2, out["fsdp2_metrics"] = run(fsdp_mesh, False)
    out["fsdp2"] = snapshot(fsdp2)
    out["fsdp2_local"] = {n_: tuple(m.shape) for n_, m in fsdp2.master.items()}
    out["fsdp2_dims"] = dict(fsdp2.shard_dims)
    # state_dict: rank 0 keeps the gathered state (the sliced tensors on the
    # host), the other ranks nothing
    s = fsdp2.state_dict()
    groups = {g: s[g] for g in ("master", "mu", "nu", "ema", "acc")}
    out["fsdp2_state_dict"] = (
        digest({f"{g}.{k}": v for g, d in groups.items() for k, v in d.items()}),
        sorted({str(v.device) for d in groups.values() for v in d.values()}),
        {g: len(d) for g, d in groups.items()})

    # checkpoints across meshes: fsdp 2 -> one rank, one rank -> fsdp 2
    paths = [os.path.join(tmp, "fsdp2.pt"), os.path.join(tmp, "one.pt")]
    for path, trainer in zip(paths, (fsdp2, one)):
        s = trainer.state_dict()
        if rank == 0:
            ckpt_io.save_checkpoint(path, s, {})
    dist.barrier()
    one_b = Trainer(phase2_engine(pcfg), tcfg)
    one_b.load_state_dict(ckpt_io.load_checkpoint(paths[0])["trainer"])
    fsdp2_b = Trainer(phase2_engine(pcfg), tcfg, fsdp_mesh, min_size)
    fsdp2_b.load_state_dict(ckpt_io.load_checkpoint(paths[1])["trainer"])
    for trainer in (fsdp2, one_b, fsdp2_b, one):
        trainer(batch, draws[0])
    out["resumed"] = [snapshot(t) for t in (fsdp2, one_b, fsdp2_b, one)]

    # the Runner at fsdp 2: rank 0 alone writes; its checkpoint resumes on one rank
    logdir = os.path.join(tmp, f"run{rank}")
    over = [f"run.logdir={logdir}", "data.num_threads=1", "run.max_steps=2",
            "run.image_log_steps=1", "run.val_every=2", "run.val_batches=1"]
    cfg = load_config(R.ExperimentConfig, [tiny_yaml],
                      over + ["parallel.data=1", "parallel.fsdp=2", "parallel.fsdp_min_size=1024"])
    mesh = R.run_mesh(cfg)
    pipeline = build_pipeline(R.rank_data(cfg.data, mesh), cfg.height, cfg.width,
                              cfg.engine.num_frames, synthetic=True,
                              process_index=mesh.coord("data"))
    runner = R.Runner(cfg, pipeline, device="cpu", synthetic=True, mesh=mesh)
    runner.fit()
    out["files"] = sorted(os.path.relpath(os.path.join(d, f), logdir)
                          for d, _, fs in os.walk(logdir) for f in fs)
    state = snapshot(runner.trainer)
    out["runner_digest"] = digest({f"{g}.{k}": torch.from_numpy(v)
                                   for g in ("master", "mu", "nu", "ema", "acc")
                                   for k, v in state[g].items()})
    mine = {**{f"{g}.{k}": v for g, d in runner.trainer.state_dict().items()
               if isinstance(d, dict) for k, v in d.items()},
            **{f"unet.{k}": v for k, v in runner.engine.unet.state_dict().items()}}
    if rank == 0:
        alone = R.Runner(load_config(R.ExperimentConfig, [tiny_yaml],
                                     over[1:] + [f"run.logdir={tmp}/alone"]),
                         device="cpu", mesh=Mesh({"data": 1, "fsdp": 1}))
        alone.resume(os.path.join(logdir, "checkpoints", "last"))
        theirs = {**{f"{g}.{k}": v for g, d in alone.trainer.state_dict().items()
                     if isinstance(d, dict) for k, v in d.items()},
                  **{f"unet.{k}": v for k, v in alone.engine.unet.state_dict().items()}}
        out["alone_differs"] = sorted(set(mine) ^ set(theirs)) + [
            k for k in mine if k in theirs and not torch.equal(mine[k], theirs[k])]

    # the signal flags agree over the ranks
    runner._stop = rank == 1
    out["flags"] = runner._agreed_flags()

    # the global batch rule and the LR rule at 2 data ranks
    try:
        R.run_mesh(load_config(R.ExperimentConfig, [tiny_yaml], ["parallel.data=2"]))
    except ValueError as e:
        out["batch_error"] = str(e)
    scaled = R.Runner(load_config(R.ExperimentConfig, [tiny_yaml], over + [
        "parallel.data=2", "data.batch_size=2", "run.scale_lr=true", "train.accum_steps=2"]),
        device="cpu")
    out["scaled_lr"] = scaled.tcfg.learning_rate
    return out
