"""The training driver: optimizer steps back to back through
``vista_tpu_torch.engine.training.Trainer``, as ``runner.Runner`` calls it,
each of ``accum_steps`` micro-steps on its own batch.

A traffic file names this driver and gives ``check_steps`` (the optimizer
steps the set-up takes and the reference follows) and ``trace_units``
(optimizer steps in a traced run). Every micro-step's batch comes from the
run's seed and its index: a clip of 25 frames uniform in [-1, 1], an fps id
(3 to 30), a motion bucket (0 to 255) and ``cond_aug`` (lognormal around
e^-3), with the step's draws (the encoder's and ``cond_aug``'s noise, the
condition-dropout masks, the loss's sigma, condition-frame pattern and
noise).

The set-up builds one trainer and drives it from the seed through its first
``check_steps`` optimizer steps, which also warm up every shape; the window
goes on with the same trainer. After the window the reference follows those
first steps from the same weights and batches, and the check compares each
micro-step's loss, the first update's gradient as the optimizer holds it
(Adam's first moment over ``1 - beta1``) leaf by leaf, and each leaf's
change and its EMA's change after the checked steps.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import counts, harness, trace, weights
from benchmark.reference import Reference
from benchmark.reference.diffusion import diffusion_loss
from benchmark.reference.nn import no_tf32, precision
from benchmark.reference.optim import Optimizer

CHECKS = ("loss", "grad", "change", "ema")
STILL = 1e-3  # leaves whose reference gradient is under this share of the median leaf's


def micro_batch(device, cfg: dict, seed: int):
    """One micro-step's batch and draws as plain tensors."""
    gen = torch.Generator(device=device).manual_seed(seed)
    e, tr = cfg["engine"], cfg["train"]
    b, t, hh, ww = tr["batch_size"], e["num_frames"], cfg["height"], cfg["width"]
    f, zc = counts.downsample(cfg), e["vae"]["z_channels"]
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    ints = lambda lo, hi: torch.randint(lo, hi, (b,), generator=gen, device=device).float()
    batch = {"frames": torch.rand(b, t, 3, hh, ww, generator=gen, device=device) * 2 - 1,
             "fps_id": ints(3, 31), "motion_bucket_id": ints(0, 256),
             "cond_aug": torch.exp(-3.0 + 0.5 * rnd(b))}
    c = e["conditioner"]
    lat = (b * t, zc, hh // f, ww // f)
    choices = len(tr["loss"]["cond_frames_choices"])
    draws = {"posterior": rnd(*lat), "cond_aug": rnd(b, 3, hh, ww),
             "ucg_keep": {k: (torch.rand(b, generator=gen, device=device) < 1.0 - c["ucg_rate"]).float()
                          for k in c["ucg_keys"]} if c["ucg_rate"] > 0 else None,
             "sigma_normal": rnd(b),
             "choice": torch.multinomial(torch.tensor([2.0 ** i for i in range(choices)],
                                                      device=device), b, replacement=True,
                                         generator=gen),
             "noise": rnd(*lat), "offset": rnd(*lat[:2])}
    return batch, draws


def system_draws(d: dict):
    from vista_tpu_torch.diffusion.loss import LossDraws
    from vista_tpu_torch.engine.training import TrainDraws

    return TrainDraws(posterior=d["posterior"], cond_aug=d["cond_aug"], ucg_keep=d["ucg_keep"],
                      loss=LossDraws(sigma_normal=d["sigma_normal"], choice=d["choice"],
                                     noise=d["noise"], offset=d["offset"]))


def train_config(cfg: dict):
    from vista_tpu_torch.engine.training import TrainConfig

    return harness.replace(TrainConfig(), {k: v for k, v in cfg["train"].items()
                                           if k != "batch_size"})


def leaf_norms(tensors) -> dict:
    """``{name: |t|_2}`` in fp64."""
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def initial(layout: dict, seed: int, device, names):
    """The seeded initial values of ``names`` (as the system stores them, in fp32)."""
    shapes = {n: (shape, kind) for n, (shape, kind, _) in layout.items()}
    for name, values in weights.stream(shapes, seed, device):
        if name in names:
            yield name, values.to(layout[name][2]).float()


def changes(tensors: dict, layout: dict, seed: int, device, prefix="unet.") -> dict:
    """``{leaf: |t - t_0|_2}`` of the trained leaves against their seeded start."""
    full = {prefix + n: t for n, t in tensors.items()}
    out = {}
    for name, t0 in initial(layout, seed, device, full):
        out[name[len(prefix):]] = float(torch.linalg.vector_norm(full[name].double() - t0.double()))
    return out


def measure(cfg, traffic, seed, seconds, traced, device, readers):
    """Set up (the checked steps), run the window. Returns the window's
    numbers, what the check reads of the system, and its parameter layout;
    the trainer and engine are freed."""
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.engine.training import Trainer
    from vista_tpu_torch.ops import _build

    t0 = time.perf_counter()
    engine = VistaEngine(harness.engine_config(cfg), device)
    layout = harness.engine_layout(engine)
    wseed = harness.sub_seed(seed, 0)
    weights.fill_(harness.components(engine), wseed)
    tcfg = train_config(cfg)
    trainer = Trainer(engine, tcfg)
    harness.log(f"engine and trainer built in {time.perf_counter() - t0:.1f} s "
                f"(process {harness.process_age():.1f} s)")
    spans = trace.Spans()
    for obj, m in ((trainer, "loss_and_grads"), (trainer, "apply"),
                   (engine, "encode_first_stage"), (engine, "conditions")):
        spans.wrap(obj, m)
    accum = tcfg.accum_steps
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    micro = iter(range(10 ** 9))

    def step(_=None):
        losses = []
        with spans.span("step"):
            for _ in range(accum):
                batch, d = micro_batch(device, cfg, harness.sub_seed(seed, 1, next(micro)))
                losses.append(trainer(batch, system_draws(d))["loss"])
        sync()
        return losses

    t0 = time.perf_counter()
    seen = {"loss": []}
    for k in range(traffic["check_steps"]):
        seen["loss"] += step()
        if k == 0:
            seen["grad"] = {n: v / (1.0 - tcfg.beta1) for n, v in leaf_norms(trainer.mu).items()}
    seen["change"] = changes(trainer.master, layout, wseed, device)
    seen["ema"] = changes(trainer.ema, layout, wseed, device)
    harness.log(f"{traffic['check_steps']} checked optimizer steps "
                f"{time.perf_counter() - t0:.1f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _build.reset_counts()
    out = {"setup_s": harness.process_age()}
    if traced:
        record = {}
        units = traffic["trace_units"]
        e = cfg["engine"]
        f = counts.downsample(cfg)
        shape = (e["unet"], cfg["train"]["batch_size"], e["num_frames"], cfg["height"] // f,
                 cfg["width"] // f)
        per = 2 * counts.unet_launches(*shape) + counts.unet_backward_launches(*shape)
        with trace.profiled(spans, record):
            for _ in range(units):
                step()
        record.update(units=units, sites=dict(_build.SITES),
                      model_flops=units * counts.train_step_flops(cfg),
                      launches=[(l, units * accum) for l in per])
        out.update(per_layer=harness.per_layer(readers, record), busy_s=trace.busy_s(record),
                   window_s=trace.window_s(record), breakdown=trace.breakdown(record),
                   attempted=units)
    else:
        wall, n, _ = harness.window(seconds, lambda i: len(step()) // accum)
        out.update(wall=wall, attempted=n)
    sync()
    out["peak"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del engine, trainer, spans, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out, seen, layout


def follow(cfg, traffic, seed, layout, device, control=False) -> dict:
    """The reference through the checked steps: each micro-step's loss, the
    first update's gradient and the leaves' and EMA's changes."""
    e, tr = cfg["engine"], cfg["train"]
    wseed = harness.sub_seed(seed, 0)
    ref = Reference(cfg, device, wseed, layout, parts=("unet", "encoder", "conditioner"),
                    checkpoint=True)
    params = dict(ref.unet.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    opt = Optimizer(params, tr)
    t = e["num_frames"]
    got = {"loss": []}
    with no_tf32(), precision("fp8" if control else "fp32"):
        for i in range(traffic["check_steps"] * tr["accum_steps"]):
            batch, d = micro_batch(device, cfg, harness.sub_seed(seed, 1, i))
            frames = batch["frames"]
            b = frames.shape[0]
            latents = ref.encode(frames.reshape(b * t, *frames.shape[2:]), d["posterior"])
            first = frames[:, 0]
            cond_batch = {k: v for k, v in batch.items() if k != "frames"}
            cond_batch["cond_frames_without_noise"] = first
            cond_batch["cond_frames"] = first + batch["cond_aug"].reshape(-1, 1, 1, 1) * d["cond_aug"]
            cond = ref.conditions(cond_batch, ucg_keep=d["ucg_keep"])
            loss = diffusion_loss(ref.unet, latents, cond, tr["loss"], d)
            loss.backward()
            got["loss"].append(float(loss.detach()))
            opt.micro_step({n: p.grad for n, p in params.items()})
            for p in params.values():
                p.grad = None
            if i == tr["accum_steps"] - 1:
                got["grad"] = {n: v / (1.0 - tr["beta1"]) for n, v in leaf_norms(opt.mu).items()}
    got["change"] = changes({n: p.detach() for n, p in params.items()}, layout, wseed, device)
    got["ema"] = changes(opt.ema, layout, wseed, device)
    del ref, opt, params
    gc.collect()
    return got


def worst_leaf(got: dict, want: dict, keep) -> float:
    """The worst leaf's gap of norms against the larger of its reference
    norm and the median leaf's."""
    median = float(np.median([want[n] for n in keep]))
    return max(abs(got[n] - want[n]) / max(want[n], median, 1e-30) for n in keep)


def readings(seen: dict, ref: dict) -> dict:
    """The numbers compared. Leaves whose reference gradient is under
    ``STILL`` of the median leaf's move by round-off alone and are left out
    of the changes."""
    names = sorted(ref["grad"])
    median = float(np.median([ref["grad"][n] for n in names]))
    moving = [n for n in names if ref["grad"][n] >= STILL * median]
    return {"loss": max(abs(a - b) / abs(b) for a, b in zip(seen["loss"], ref["loss"])),
            "grad": worst_leaf(seen["grad"], ref["grad"], names),
            "change": worst_leaf(seen["change"], ref["change"], moving),
            "ema": worst_leaf(seen["ema"], ref["ema"], moving)}


def run(cfg, traffic, limits, seed, seconds, traced, device, readers, control=False):
    """One run of a cell: ``(result, checks)``. With ``control`` the
    reference from fp8 operands is judged in the system's place."""
    out, seen, layout = measure(cfg, traffic, seed, seconds, traced, device, readers)
    rate = {} if traced else {"opt_step_s": {"value": out["wall"] / out["attempted"],
                                             "unit": "s/step"}}
    result = harness.result(out, device, rate)
    t0 = time.perf_counter()
    if control:
        seen = follow(cfg, traffic, seed, layout, device, control=True)
    got = readings(seen, follow(cfg, traffic, seed, layout, device))
    harness.log(f"check of {traffic['check_steps']} optimizer steps against the reference: "
                f"{time.perf_counter() - t0:.1f} s")
    result["correct"], checks = harness.judge(got, limits)
    return result, checks


def survey(cfg, traffic, limits, seed, control, device) -> dict:
    """One seed's readings for :mod:`benchmark.control`: the system's checked
    steps against the reference and, with ``control``, the fp8 reference's,
    each judged against ``limits``."""
    out, seen, layout = measure(cfg, traffic, seed, 0.0, False, device, {})
    ref = follow(cfg, traffic, seed, layout, device)
    row = {"system": readings(seen, ref), "opt_step_s": out["wall"] / out["attempted"],
           "peak_gib": out["peak"] / 2 ** 30}
    row["system_correct"] = harness.judge(row["system"], limits)[0]
    if control:
        row["control"] = readings(follow(cfg, traffic, seed, layout, device, control=True), ref)
        row["control_correct"] = harness.judge(row["control"], limits)[0]
    return row
