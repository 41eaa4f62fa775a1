"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py            # every phase (needs one H100)
    python3 chip_smoke.py --profile  # and a traced 576x1024 request

Phases, each timed on its own line:

1. card: the card's name and power limit (nvidia-smi); exit non-zero when
   ``torch.cuda.is_available()`` is false;
2. build: compile the kernels of ``vista_tpu_torch/csrc/`` with nvcc;
3. kernels: each hand-written kernel against its plain PyTorch version (fp32
   on the same bf16 inputs) at the shapes of the main path, with times;
4. slice: full-width VideoUNet + temporal VAE decoder in bf16 with seeded
   random weights, answering sampling requests through ``VistaEngine.sample``
   and ``decode_first_stage`` (triangle CFG 2.5, frame 0 pinned, 14/3
   decode), with the launch counts of every kernel.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before it. Tables too long for the end of the output go to ``chiprun_out/``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

TOL = 1e-2  # max|kernel - plain| / max|plain|
OUT = Path("chiprun_out")
CARD = ""

KERNELS = {
    "attention": dict(
        route="cuda", source="vista_tpu_torch/csrc/attention.cu",
        replaces="vista_tpu/ops/flash_attention.py:194 (_flash_kernel); "
                 "vista_tpu/ops/tiny_attention.py:95 (_tiny_kernel); "
                 "vista_tpu/ops/fused_temporal_attn.py:138 (attention core)"),
    "ln_linear": dict(
        route="cuda", source="vista_tpu_torch/csrc/ln_linear.cu",
        replaces="vista_tpu/ops/fused_qkv.py:95 (_qkv_kernel); "
                 "vista_tpu/ops/fused_ff.py:146 (_ff_kernel, LN+proj_in+GEGLU); "
                 "vista_tpu/ops/fused_temporal_attn.py:138 (LN+q/k/v)"),
    "linear_residual": dict(
        route="cuda", source="vista_tpu_torch/csrc/linear_residual.cu",
        replaces="vista_tpu/ops/fused_ff.py:146 (_ff_kernel, proj_out+residual); "
                 "vista_tpu/ops/fused_temporal_attn.py:138 (out-proj+residual)"),
    "gn_silu_conv3": dict(
        route="cuda", source="vista_tpu_torch/csrc/gn_silu_conv3.cu",
        replaces="vista_tpu/ops/temporal_conv.py:357 (_gn_conv3_kernel)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")
    return out


# ---------------------------------------------------------------- phase 1

def card_check():
    global CARD
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        sys.exit(1)
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {CARD}; torch {torch.__version__}, cuda {torch.version.cuda}")


# ---------------------------------------------------------------- phase 2

def build():
    from vista_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    log(f"kernels: {so.name} ({time.perf_counter() - t0:.1f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas: " + line.strip())


# ---------------------------------------------------------------- phase 3

def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare(name, shape, kernel_fn, plain_fn, plain_inputs_fn, rows, reps=5):
    """Run the kernel, its plain version in fp32 on the same bf16 inputs,
    compare, and time both (the plain version on the bf16 inputs)."""
    got = kernel_fn()
    torch.cuda.synchronize()
    ref = plain_inputs_fn()
    if isinstance(got, torch.Tensor):
        got, ref = [got], [ref]
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    scale = max(r.float().abs().max().item() for r in ref)
    rel = err / max(scale, 1e-30)
    del got, ref
    ms = time_ms(kernel_fn, reps)
    plain_ms = time_ms(plain_fn, max(1, reps // 2))
    ok = math.isfinite(rel) and rel <= TOL
    rows.append(dict(kernel=name, shape=shape, max_abs_err=err, rel_err=rel,
                     ms=ms, plain_ms=plain_ms, ok=ok))
    log(f"  {name:16s} {shape:34s} rel {rel:.2e} abs {err:.3e}  "
        f"kernel {ms:9.3f} ms  plain {plain_ms:9.3f} ms  {'ok' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return ok


def kernel_checks():
    from vista_tpu_torch.ops.attention import attention_packed, attention_plain
    from vista_tpu_torch.ops.linear import (linear_residual, linear_residual_plain,
                                            ln_linear, ln_linear_plain)
    from vista_tpu_torch.ops.temporal_conv import (gn_silu_conv3,
                                                   gn_silu_conv3_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    f32 = lambda *ts: [None if t is None else t.float() for t in ts]
    rows, ok = [], True

    # K1: (batch rows, tokens, heads) at the main path's shapes; the ds1
    # and 2880-token cases use a few of the 50 frames so that the plain
    # fp32 logits fit.
    for b, s, h, tag in [(2, 9216, 5, "ds1 576x1024"), (8, 2304, 10, "ds2 576x1024"),
                         (50, 576, 20, "ds4 576x1024"), (50, 144, 20, "mid 576x1024"),
                         (10, 2880, 5, "ds1 320x576"), (50, 720, 10, "ds2 320x576"),
                         (50, 180, 20, "ds4 320x576"), (50, 45, 20, "mid 320x576"),
                         (18432, 25, 5, "temporal ds1 576x1024")]:
        q, k, v = (rnd(b, s, h * 64) for _ in range(3))
        ok &= compare("attention", f"{tag} ({b},{s},{h}x64)",
                      lambda: attention_packed(q, k, v, h),
                      lambda: attention_plain(q, k, v, h),
                      lambda: attention_plain(*f32(q, k, v), h), rows)
        del q, k, v
    # K2 and K3 at c = 320 (ds1 rows) and 1280 (ds4 rows), 576x1024.
    for m, c in [(50 * 9216, 320), (50 * 576, 1280)]:
        x = rnd(m, c)
        lw, lb = rnd(c, std=0.2, dtype=torch.float32) + 1, rnd(c, std=0.2, dtype=torch.float32)
        w = rnd(3 * c, c, std=c ** -0.5)
        ok &= compare("ln_linear", f"split q/k/v ({m},{c})->3x{c}",
                      lambda: ln_linear(x, lw, lb, w, None, "split", 3),
                      lambda: ln_linear_plain(x, lw, lb, w, None, "split", 3),
                      lambda: ln_linear_plain(*f32(x, lw, lb, w), None, "split", 3), rows)
        w1, b1 = rnd(8 * c, c, std=c ** -0.5), rnd(8 * c, std=0.1, dtype=torch.float32)
        ok &= compare("ln_linear", f"geglu ({m},{c})->{4 * c}",
                      lambda: ln_linear(x, lw, lb, w1, b1, "geglu"),
                      lambda: ln_linear_plain(x, lw, lb, w1, b1, "geglu"),
                      lambda: ln_linear_plain(*f32(x, lw, lb, w1, b1), "geglu"), rows)
        del w, w1
        hg = rnd(m, 4 * c)
        w2, b2 = rnd(c, 4 * c, std=(4 * c) ** -0.5), rnd(c, std=0.1, dtype=torch.float32)
        ok &= compare("linear_residual", f"ff out ({m},{4 * c})->{c}",
                      lambda: linear_residual(hg, w2, b2, x),
                      lambda: linear_residual_plain(hg, w2, b2, x),
                      lambda: linear_residual_plain(*f32(hg, w2, b2, x)), rows)
        del hg
        o, wo = rnd(m, c), rnd(c, c, std=c ** -0.5)
        ok &= compare("linear_residual", f"attn out ({m},{c})->{c}",
                      lambda: linear_residual(o, wo, b2, x),
                      lambda: linear_residual_plain(o, wo, b2, x),
                      lambda: linear_residual_plain(*f32(o, wo, b2, x)), rows)
        del x, o
    # K4 at (50, 9216, 320) and (50, 576, 1280), both epilogues, t = 25.
    for bt, s, c in [(50, 9216, 320), (50, 576, 1280)]:
        x = rnd(bt, s, c)
        sc, sh = rnd(bt, c, std=0.5, dtype=torch.float32), rnd(bt, c, std=0.5, dtype=torch.float32)
        w, b = rnd(c, c, 3, 1, 1, std=(3 * c) ** -0.5), rnd(c, std=0.1, dtype=torch.float32)
        emb = rnd(bt, c, dtype=torch.float32)
        ok &= compare("gn_silu_conv3", f"emb ({bt},{s},{c})",
                      lambda: gn_silu_conv3(x, sc, sh, w, b, 25, emb=emb),
                      lambda: gn_silu_conv3_plain(x, sc, sh, w, b, 25, emb=emb),
                      lambda: gn_silu_conv3_plain(*f32(x, sc, sh, w, b), 25, emb=emb), rows)
        rs = torch.full((1,), 0.4, device=dev)
        ok &= compare("gn_silu_conv3", f"res ({bt},{s},{c})",
                      lambda: gn_silu_conv3(x, sc, sh, w, b, 25, residual=x, res_scale=rs),
                      lambda: gn_silu_conv3_plain(x, sc, sh, w, b, 25, residual=x,
                                                  res_scale=rs),
                      lambda: gn_silu_conv3_plain(*f32(x, sc, sh, w, b), 25,
                                                  residual=x.float(), res_scale=rs), rows)
        del x
    OUT.mkdir(exist_ok=True)
    (OUT / "kernel_checks.json").write_text(json.dumps(dict(card=CARD, rows=rows), indent=1))
    if not ok:
        raise SystemExit("a kernel disagrees with its plain version")
    return rows


# ---------------------------------------------------------------- phase 4

SLICE_TOL = 5e-2  # small slice, bf16 kernels on the card vs fp32 plain on the CPU
REQUESTS = [  # (height, width, frames, steps)
    (320, 576, 25, 5), (320, 576, 25, 5), (576, 1024, 25, 25)]


def random_init_(module, gen):
    """Seeded random weights, none zero: norms near 1, fan-in scaled weights,
    small biases, and random mix factors (including the parameters the
    model zero-initialises, so that every kernel's output reaches the
    result)."""
    import torch.nn as nn

    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                r = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
                if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
                    r = 1.0 + 0.1 * r if name == "weight" else 0.1 * r
                elif name == "mix_factor":
                    pass
                elif p.ndim >= 2:
                    r = r * (p[0].numel() ** -0.5)
                else:
                    r = 0.02 * r
                p.copy_(r)


def requests_inputs(cfg, h, w, frames, gen, device):
    """bench.py's conditioning: one-token crossattn, vector, concat; frame 0
    pinned to the cond frame; triangle CFG 2.5."""
    from vista_tpu_torch.diffusion.guidance import GuiderConfig

    f = cfg.vae.downsample_factor
    hl, wl = h // f, w // f
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    cond = {"crossattn": rnd(1, 1, cfg.unet.context_dim),
            "vector": rnd(1, cfg.unet.adm_in_channels),
            "concat": rnd(1, 4, hl, wl)}
    uc = {k: torch.zeros_like(v) for k, v in cond.items()}
    uc["vector"] = cond["vector"]
    noise = rnd(frames, 4, hl, wl)
    cond_frame = rnd(frames, 4, hl, wl)
    cond_mask = torch.zeros(frames, device=device)
    cond_mask[0] = 1.0
    guider = GuiderConfig(kind="triangle", scale=2.5, num_frames=frames)
    return noise, cond, uc, cond_frame, cond_mask, guider


def run_request(engine, inputs, steps):
    """Sample and decode one request; returns latents, pixels and the
    seconds of each half (host clock, synchronised on the card)."""
    from vista_tpu_torch.diffusion.sampler import SamplerConfig

    noise, cond, uc, cf, cm, guider = inputs
    sync = torch.cuda.synchronize if noise.is_cuda else (lambda: None)
    t0 = time.perf_counter()
    lat = engine.sample(noise, cond, uc, cf, cm, SamplerConfig(num_steps=steps, guider=guider))
    sync()
    t1 = time.perf_counter()
    px = engine.decode_first_stage(lat.to(engine.cfg.vae.compute_dtype))
    sync()
    return lat, px, t1 - t0, time.perf_counter() - t1


def slice_reference(seed):
    """A small slice (widths the kernels take: head_dim 64, c % 32 == 0) on
    the card in bf16 against the same weights and inputs in fp32 on the CPU
    through the plain versions."""
    import dataclasses

    from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine

    base = EngineConfig().tiny()
    unet = dataclasses.replace(base.unet, model_channels=64, num_head_channels=64,
                               context_dim=64, adm_in_channels=48, num_frames=5,
                               dtype="float32")
    cfg = dataclasses.replace(base, unet=unet, num_frames=5,
                              vae=dataclasses.replace(base.vae, ch=32, dtype="float32"))
    cpu = VistaEngine(cfg, "cpu")
    gen = torch.Generator().manual_seed(seed)
    random_init_(cpu.unet, gen)
    random_init_(cpu.decoder, gen)
    bf = dict(unet=dataclasses.replace(unet, dtype="bfloat16"),
              vae=dataclasses.replace(cfg.vae, dtype="bfloat16"))
    gpu = VistaEngine(dataclasses.replace(cfg, **bf), "cuda")
    gpu.unet.load_state_dict(cpu.unet.state_dict())
    gpu.decoder.load_state_dict(cpu.decoder.state_dict())
    inputs = requests_inputs(cfg, 64, 64, 5, torch.Generator().manual_seed(seed + 1), "cpu")
    ref_lat, ref_px, _, _ = run_request(cpu, inputs, 2)
    moved = [{k: v.cuda() for k, v in a.items()} if isinstance(a, dict)
             else a.cuda() if isinstance(a, torch.Tensor) else a for a in inputs]
    lat, px, _, _ = run_request(gpu, moved, 2)
    for name, got, ref in (("latents", lat, ref_lat), ("pixels", px, ref_px)):
        rel = ((got.cpu().float() - ref).abs().max() / ref.abs().max()).item()
        log(f"  small slice {name}: max|card - cpu| / max|cpu| = {rel:.3e} (limit {SLICE_TOL})")
        if not rel <= SLICE_TOL:
            raise SystemExit(f"small slice {name} disagrees with the CPU reference")


def _kernel_group(name):
    low = name.lower()
    for k in KERNELS:
        if f"{k}_kernel" in low:
            return f"K: {k}"
    rules = [("cuDNN layout", ("nchwtonhwc", "nhwctonchw", "converttensor")),
             ("convs (cuDNN)", ("fprop", "conv")),
             ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass")),
             ("group norm", ("group_norm", "groupnorm", "rowwisemoments")),
             ("copies", ("copy", "catarray")),
             ("softmax", ("softmax",)),
             ("upsample", ("upsample",)),
             ("reductions", ("reduce",)),
             ("elementwise", ("elementwise",))]
    for group, keys in rules:
        if any(k in low for k in keys):
            return group
    return "other"


def _device_profile(label, fn):
    """Device time by kernel group over ``fn()`` and the card's busy share
    of the host-clock wall time (one stream, so kernel times add up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, total = {}, 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or evt.key == "Command Buffer Full":
            continue
        us = evt.self_device_time_total
        total += us
        g = _kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + us
    log(f"  profile {label}: wall {wall:.3f} s, device busy {total / 1e6:.3f} s "
        f"({100 * total / 1e6 / wall:.1f}% of wall)")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:18s} {us / 1e3:10.1f} ms  {100 * us / max(total, 1):5.1f}%")
    OUT.mkdir(exist_ok=True)
    (OUT / f"profile_{label}.txt").write_text(
        f"{CARD}\n" + prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))


def profile_request(engine, cfg, gen):
    """One 576x1024 request traced in two halves: a 2-step sample and the
    decode of its latents."""
    from vista_tpu_torch.diffusion.sampler import SamplerConfig

    noise, cond, uc, cf, cm, guider = requests_inputs(cfg, 576, 1024, 25, gen, "cuda")
    out = {}
    _device_profile("sample_2_steps", lambda: out.setdefault("lat", engine.sample(
        noise, cond, uc, cf, cm, SamplerConfig(num_steps=2, guider=guider))))
    _device_profile("decode", lambda: engine.decode_first_stage(
        out["lat"].to(cfg.vae.compute_dtype)))


def slice_run(seed, profile=False):
    from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
    from vista_tpu_torch.ops import _build

    phase("slice-reference", slice_reference, seed)
    t0 = time.perf_counter()
    cfg = EngineConfig()
    engine = VistaEngine(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    random_init_(engine.unet, gen)
    random_init_(engine.decoder, gen)
    n_unet = sum(p.numel() for p in engine.unet.parameters())
    log(f"  full-width VideoUNet {n_unet / 1e9:.3f} B params + VideoVAEDecoder, bf16, "
        f"seeded random weights ({time.perf_counter() - t0:.1f} s)")
    results = []
    _build.reset_counts()
    for i, (h, w, frames, steps) in enumerate(REQUESTS):
        inputs = requests_inputs(cfg, h, w, frames, gen, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(_build.SITES)
        lat, px, t_sample, t_decode = run_request(engine, inputs, steps)
        dt = t_sample + t_decode
        peak = torch.cuda.max_memory_allocated() / 2**30
        f = cfg.vae.downsample_factor
        assert lat.shape == (frames, 4, h // f, w // f), lat.shape
        assert px.shape == (frames, 3, h, w), px.shape
        assert bool(torch.isfinite(lat).all()) and bool(torch.isfinite(px).all()), "non-finite"
        assert torch.equal(lat[0], inputs[3][0]), "frame 0 is not the cond frame"
        sites = {k: v - before.get(k, 0) for k, v in _build.SITES.items()}
        results.append(dict(request=i, height=h, width=w, frames=frames, steps=steps,
                            seconds=dt, sample_s=t_sample, decode_s=t_decode,
                            peak_gib=peak, launches=sites))
        log(f"  request {i}: {h}x{w}, {frames} frames, {steps} steps, triangle CFG 2.5: "
            f"{dt:.3f} s (sample {t_sample:.3f} s = {t_sample / steps:.3f} s/step, decode "
            f"{t_decode:.3f} s), peak {peak:.2f} GiB; pixels mean {px.mean().item():.4f} "
            f"std {px.std().item():.4f}")
        log(f"    launches by site: {json.dumps(sites, sort_keys=True)}")
        del lat, px
    launches = dict(_build.LAUNCHES)
    log(f"  launches over the requests: {json.dumps(launches, sort_keys=True)}")
    OUT.mkdir(exist_ok=True)
    (OUT / "slice.json").write_text(json.dumps(dict(card=CARD, requests=results,
                                                    launches=launches), indent=1))
    if profile:
        phase("profile", profile_request, engine, cfg, gen)
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    needed = ["attention/spatial-long", "attention/spatial-short", "attention/temporal",
              "ln_linear/qkv", "ln_linear/ff", "linear_residual/ff",
              "gn_silu_conv3/emb", "gn_silu_conv3/res"]
    missing += [k for k in needed if _build.SITES.get(k, 0) == 0]
    if missing:
        raise SystemExit(f"kernels or call sites never launched on the main path: {missing}")
    return launches


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one 576x1024 request (2 steps) with torch.profiler")
    args = ap.parse_args()

    phase("card", card_check)
    phase("build", build)
    log("kernel vs plain (fp32 on the same bf16 inputs):")
    rows = phase("kernels", kernel_checks)
    launches = phase("slice", slice_run, args.seed, args.profile)

    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        timed = mine[0]  # the first (largest) main-path shape of the kernel
        kernels.append(dict(name=name, **meta, launches=launches[name],
                            max_abs_err=max(r["max_abs_err"] for r in mine),
                            rel_err=max(r["rel_err"] for r in mine), shape=timed["shape"],
                            ms=timed["ms"], plain_ms=timed["plain_ms"]))
    log(f"card: {CARD}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
