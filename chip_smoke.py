"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py            # every phase (needs one H100)
    python3 chip_smoke.py --profile  # and traces: a request, the train steps, the arc

Phases, each timed on its own line:

1. card: the card's name and power limit (nvidia-smi); exit non-zero when
   ``torch.cuda.is_available()`` is false;
2. build: compile the kernels of ``vista_tpu_torch/csrc/`` with nvcc (one
   process per source, all started together);
3. kernels: each hand-written kernel against its plain PyTorch version (fp32
   on the same bf16 inputs) at the shapes of the main paths, every output,
   with its time, the plain version's, one PyTorch library call's where one
   computes the same function, and the least time the card could take; K1
   and attention_bwd on every route that takes a shape and at their route
   crossovers (each threshold in its plan is held to its crossover); the
   conv dW of K4's backward in fp32 against the same products in fp32;
4. slice: full-width VideoUNet + temporal VAE decoder in bf16 with seeded
   random weights, answering sampling requests through ``VistaEngine.sample``
   and ``decode_first_stage`` (triangle CFG 2.5, frame 0 pinned, 14/3
   decode), with the launch counts of every kernel;
5. rollout: a small 2-round rollout and 3-member reward with action control
   on the card in bf16 against the CPU in fp32; then, at full width
   (576x1024, 25 frames, action control, seeded random weights, non-zero
   adapters), the sample CLI's ``run`` (``--action traj``, 2 rounds of 10
   steps, triangle CFG: 47 frames, the files written and checked) and the
   reward CLI's (``--action traj``, an ensemble of 5 at 10 steps), each with
   its seconds by stage, peak memory and the launch counts of every kernel;
6. train: the phase-2 stage-1 recipe (``configs/vista_phase2_stage1.yaml``:
   320x576, 25 frames, batch 1, LoRA + action control, ``lora_only``, remat,
   dynamics loss) at full width with seeded random weights and non-zero
   adapters: a small slice of the step on the card in bf16 against the CPU
   in fp32, three optimizer steps with the launch counts of every kernel,
   with ``--profile`` a traced step (device time by kernel group), and the
   selective checkpointing modes under LoRA (as in phase1, below; one
   timed optimizer step each);
7. train_cli: the phase-2 stage-2 recipe (``configs/vista_phase2_stage2.yaml``:
   576x1024, 25 frames, batch 1, LoRA + action control, ``lora_only``, remat,
   dynamics loss, the recipe's 1000-step warm-up) through the train CLI's
   ``main``, from JPEG clips it writes in both layouts the recipe mixes
   (OpenDV folders and nuScenes annotations), with the modules' own
   initialisation: three steps with a validation and image logs, then
   ``--resume`` for a fourth; the CSV, the images, frozen tensors
   bit-identical, adapters and EMA moved, the restored state bit-identical
   to the saved one, and the launch counts;
8. phase1: the phase-1 recipe (``configs/vista_phase1.yaml``: 576x1024, 25
   frames, batch 1, no LoRA, every UNet weight trained under
   ``slow_spatial``, remat, dynamics loss, gradient accumulation 2) at full
   width with seeded random weights: two small micro-steps on the card in
   bf16 against the CPU in fp32 (the loss, and every UNet gradient against
   its own size, beside the same error of bf16 on the CPU), four
   micro-steps (two optimizer steps) with the launch counts of every kernel
   and checks of which tensors move after which call, with ``--profile``
   a traced optimizer step, and the selective-checkpointing modes (``remat_max_ds`` 2 and 1,
   ``names``, ``dots``, ``names`` with ``remat_max_ds`` 1): each one's
   micro-step from full remat's state, batch and draws bit-identical to full
   remat's (loss and every gradient), its launches as predicted from the
   config, the memory its forward keeps, its peak, and two optimizer steps
   of each but the last in turns;
9. sampling_modes (after slice): the headline request (576x1024, 25 frames,
   triangle CFG 2.5) at 5 steps on one noise, batched, sequential and
   batched with churn (``s_churn`` 1, eps from a ``torch.Generator`` on the
   card): seconds, peak memory and K1-K4 launches a step of each (sequential
   twice batched's), sequential against batched within 1.5x a small run's
   bf16-on-the-CPU error, churn finite with frame 0 pinned bit for bit; the
   small run's three forms on the card against the CPU in fp32;
10. convert (inside train_cli, on its final checkpoint): ``cli.convert
    --merge-lora`` to a ``.safetensors``, loaded by ``cli.sample --ckpt``
    (``strict=True``) for one round of 5 steps against the same round from
    the runner's modules with LoRA unmerged and the EMA in; the file's size
    and the seconds to write and load it; the file is deleted;
11. vae_train: ``VAEConfig()`` at full width on 576x1024 frames, batch 1,
    four alternating AE / discriminator steps (``StepTimer``): seconds a
    step of each kind, peak memory, which modules each step moved; a small
    step on the card in fp32 against the CPU;
12. quality: the full-width CLIP text tower on the card against the CPU,
    then ``tools/torch_quality_bench.py`` in-process: ``--calibrate`` at
    576x1024 on 2 synthetic clips (FCD rising over the noise and blur
    grades, PSNR and SSIM falling) and one harness run (1 clip, 1 round of
    5 steps);
13. parallel: the CLIs under ``torch.distributed.run`` at world size 1
    (sample in ``frames``, ``height`` and ``weights`` mode, the train CLI),
    ``sp_attention`` at the ds1 shape bit-identical to ``attention_packed``
    forward and backward, and the kernels at the local shapes of frame
    splits and row bands;
14. overfit (after phase1): two micro-steps of the arc's engine at its
    shapes on the card against fp32 on the CPU (every training kernel held
    to its plain version there); then ``tools/torch_overfit.py``'s arc at
    the kernel widths in bf16 (32x32, 5 frames): 400 optimizer steps on two
    clips, sampling from the EMA weights against the weights before step
    1, the decode, the JAX test's margins, every training kernel's launches
    and the optimizer's share of a step (with ``--profile`` three more steps
    traced).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before it. Tables too long for the end of the output go to ``chiprun_out/``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

TOL = 1e-2  # max|kernel - plain| / max|plain|, per output
OUT = Path("chiprun_out")
CARD = ""
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes per second
# exp2 per second on the special-function units of an H100 SXM
# (FlashAttention-3 paper, section 3: 3.9 TFLOP/s of special functions)
PEAK_EXP2 = 3.9e12

KERNELS = {
    "attention": dict(
        route="cuda", source="vista_tpu_torch/csrc/attention.cu with "
                             "csrc/attention_short.cuh",
        replaces="vista_tpu/ops/flash_attention.py:194 (_flash_kernel: wgmma route); "
                 "vista_tpu/ops/tiny_attention.py:95 (_tiny_kernel: wgmma route from 144 "
                 "keys, short route at 45); "
                 "vista_tpu/ops/fused_temporal_attn.py:138 (_kernel's attention core at "
                 "t = 25: short route)"),
    "ln_linear": dict(
        route="cuda", source="vista_tpu_torch/csrc/ln_linear.cu",
        replaces="vista_tpu/ops/fused_qkv.py:95 (_qkv_kernel); "
                 "vista_tpu/ops/fused_ff.py:146 (_ff_kernel, LN+proj_in+GEGLU); "
                 "vista_tpu/ops/fused_temporal_attn.py:138 (LN+q/k/v)"),
    "linear_residual": dict(
        route="cuda", source="vista_tpu_torch/csrc/linear_residual.cu with csrc/gemm_tma.cuh",
        replaces="vista_tpu/ops/fused_ff.py:146 (_ff_kernel, proj_out+residual); "
                 "vista_tpu/ops/fused_temporal_attn.py:138 (out-proj+residual)"),
    "gn_silu_conv3": dict(
        route="cuda", source="vista_tpu_torch/csrc/gn_silu_conv3.cu (gn_silu_kernel + "
                             "conv3_tma_kernel<EMB|RES>) with csrc/gemm_tma.cuh",
        replaces="vista_tpu/ops/temporal_conv.py:357 (_gn_conv3_kernel)"),
    "gn_silu": dict(
        route="cuda", source="vista_tpu_torch/csrc/gn_silu_conv3.cu (gn_silu_kernel)",
        replaces="vista_tpu/ops/temporal_conv.py:357 (_gn_conv3_kernel, its GroupNorm affine "
                 "+ SiLU of each tap)"),
    "layer_norm": dict(
        route="cuda", source="vista_tpu_torch/csrc/layer_norm.cu (layer_norm_kernel)",
        replaces="vista_tpu/ops/norms.py:140 (_ln_kernel)"),
    "ln_bwd": dict(
        route="cuda", source="vista_tpu_torch/csrc/layer_norm.cu (ln_bwd_kernel)",
        replaces="vista_tpu/ops/fused_qkv.py:224 (_qkv_bwd_kernel, its LayerNorm backward); "
                 "vista_tpu/ops/fused_ff.py:307 (_ff_bwd_kernel, its LayerNorm backward); "
                 "vista_tpu/ops/fused_ff.py:434 (_ff_bwd_wide_kernel, its LayerNorm backward); "
                 "vista_tpu/ops/norms.py:103 (layer_norm's backward, an XLA recompute: the "
                 "LoRA norm1 sites)"),
    "attention_bwd": dict(
        route="cuda", source="vista_tpu_torch/csrc/attention_bwd.cu with "
                             "csrc/attention_short.cuh",
        replaces="vista_tpu/ops/flash_attention.py:346 (_bwd_dq_kernel: wgmma route); "
                 "vista_tpu/ops/flash_attention.py:368 (_bwd_dkv_kernel: wgmma route); "
                 "vista_tpu/ops/tiny_attention.py:201 (_tiny_bwd_kernel: wgmma route from "
                 "144 keys, short route at 45 and t = 25); "
                 "vista_tpu/ops/fused_temporal_attn.py:353 (_bwd_kernel's softmax backward: "
                 "short route)"),
    "ff_bwd": dict(
        route="cuda", source="vista_tpu_torch/csrc/ff_bwd.cu (ff_bwd_dh; vk_wgrad with db1 / "
                             "db2 as 8 more columns of its product against a block of ones, "
                             "and the split fold in the launch) "
                             "with csrc/qkv_bwd.cu (vk_seg_gemm), csrc/gemm_tma.cuh and "
                             "csrc/layer_norm.cu (vk_layer_norm, vk_ln_bwd)",
        replaces="vista_tpu/ops/fused_ff.py:307 (_ff_bwd_kernel); "
                 "vista_tpu/ops/fused_ff.py:434 (_ff_bwd_wide_kernel)"),
    "ff_bwd_dh": dict(
        route="cuda", source="vista_tpu_torch/csrc/ff_bwd.cu (ff_bwd_dh_tma_kernel) with "
                             "csrc/gemm_tma.cuh",
        replaces="vista_tpu/ops/fused_ff.py:307 (_ff_bwd_kernel, dh and hg); "
                 "vista_tpu/ops/fused_ff.py:434 (_ff_bwd_wide_kernel, dh and hg)"),
    "conv3": dict(
        route="cuda", source="vista_tpu_torch/csrc/gn_silu_conv3.cu (conv3_tma_kernel<NONE>) "
                             "with csrc/gemm_tma.cuh",
        replaces="vista_tpu/ops/temporal_conv.py:155 (_conv3_kernel)"),
    "qkv_bwd": dict(
        route="cuda", source="vista_tpu_torch/csrc/qkv_bwd.cu (vk_seg_gemm) with "
                             "csrc/ff_bwd.cu (vk_wgrad, the split fold in the launch), "
                             "csrc/gemm_tma.cuh and csrc/layer_norm.cu (vk_layer_norm, "
                             "vk_ln_bwd)",
        replaces="vista_tpu/ops/fused_qkv.py:224 (_qkv_bwd_kernel); "
                 "vista_tpu/ops/fused_temporal_attn.py:353 (_bwd_kernel, LN + q/k/v backward)"),
    "linear_residual_bwd": dict(
        route="cuda", source="vista_tpu_torch/csrc/qkv_bwd.cu (vk_seg_gemm) with "
                             "csrc/ff_bwd.cu (vk_wgrad: dWo, and dbo as 8 more columns of its "
                             "product against a block of ones, the split fold in the launch) "
                             "and csrc/gemm_tma.cuh",
        replaces="vista_tpu/ops/fused_temporal_attn.py:353 (_bwd_kernel, out-projection "
                 "backward: do, dWo, dbo)"),
}
SAMPLE_KERNELS = ("attention", "ln_linear", "linear_residual", "gn_silu_conv3", "gn_silu")
TRAIN_KERNELS = ("attention", "ln_linear", "linear_residual", "gn_silu_conv3", "gn_silu",
                 "layer_norm", "ln_bwd", "attention_bwd", "ff_bwd", "ff_bwd_dh", "conv3")
PHASE1_KERNELS = TRAIN_KERNELS + ("qkv_bwd", "linear_residual_bwd")
# both routes of K1 run on every path and both of attention_bwd on each
# training path: wgmma at the spatial sites, short at the temporal ones
ATTENTION_ROUTES = ("attention:wgmma", "attention:short")
ATTENTION_BWD_ROUTES = ("attention_bwd:wgmma", "attention_bwd:short")
# every call site of the sampling kernels, each launched on every sampling path
SAMPLE_SITES = ("attention/spatial-long", "attention/spatial-short", "attention/temporal",
                "ln_linear/qkv", "ln_linear/ff", "linear_residual/ff",
                "gn_silu_conv3/emb", "gn_silu_conv3/res", "gn_silu/emb", "gn_silu/res")
# the demangled names of each group's device functions, for the profiles
# (the first group whose prefix matches takes a kernel); vk_wgrad (with the
# bias gradients and the split-K fold in its launch), seg_gemm and the LN
# backward serve ff_bwd, qkv_bwd and K3's backward alike (vk_wgrad also
# conv3's dW and db, ln_bwd the LoRA norm1 sites); each attention
# kernel's routes are apart. Every __global__ function of
# vista_tpu_torch/csrc/ belongs to one group (tests/test_torch_gemm_plan.py).
SYMBOLS = {
    "attention (wgmma)": ("vk::attention_wgmma_kernel<",),
    "attention (short, Sk <= 64)": ("vk::attention_short_kernel<",),
    "ln_linear": ("vk::ln_linear_kernel", "vk::ln_stats_kernel"),
    "linear_residual": ("vk::linear_residual_tma_kernel",),
    "gn_silu_conv3": ("vk::gn_silu_kernel", "vk::conv3_tma_kernel<1>", "vk::conv3_tma_kernel<2>"),
    "conv3": ("vk::conv3_tma_kernel<0>",),
    "layer_norm": ("vk::layer_norm_kernel",),
    "attention_bwd dK/dV (wgmma)": ("vk::attn_bwd_dkv_wgmma",),
    "attention_bwd dQ (wgmma)": ("vk::attn_bwd_dq_wgmma",),
    "attention_bwd prep (lse, D)": ("vk::attn_bwd_prep",),
    "attention_bwd (short, Sk <= 64)": ("vk::attn_bwd_short_kernel<",),
    "ff_bwd_dh": ("vk::ff_bwd_dh_tma_kernel",),
    "seg_gemm (dxn of ff_bwd, qkv_bwd; K3 da)": ("vk::seg_gemm_tma_kernel",),
    "vk_wgrad (split-K dW + db, fold in-launch)": ("vk::wgrad_tma_kernel",),
    "ln_bwd": ("vk::ln_bwd_kernel",),
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
    for line in ptxas_summary(_build.build_log):
        log("  ptxas: " + line)
    OUT.mkdir(exist_ok=True)
    (OUT / "build_log.txt").write_text(_build.build_log)
    from vista_tpu_torch.ops.norms import LN_BLOCKS_PER_SM, ln_occupancy

    blocks = ln_occupancy()
    log("  LayerNorm kernels, blocks an SM: " + ", ".join(f"{k} {v}" for k, v in blocks.items()))
    if min(blocks.values()) < LN_BLOCKS_PER_SM:
        raise SystemExit(f"a LayerNorm kernel fits fewer than the plan's {LN_BLOCKS_PER_SM} "
                         "blocks an SM")


def ptxas_summary(build_log):
    """One line per kernel from nvcc's ``-Xptxas=-v`` log: its source,
    registers, spills, and any wgmma serialisation or other performance
    warning ptxas gave it."""
    import re

    lines, source, name, spill, warns = [], "", None, "", {}
    for line in build_log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        for code, fn in re.findall(r"\((C7\d+)\)[^']*'(_Z\w+)'", line):
            warns.setdefault(fn, []).append(code)
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f", spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            label, short = name, re.match(r"_ZN2vk(\d+)", name)
            if short:
                end = short.end() + int(short.group(1))
                label = name[short.end():end] + ("<...>" if name[end:end + 1] == "I" else "")
            lines.append(f"{source}: {label}: {m.group(1)} registers{spill}"
                         + "".join(f", {w}" for w in warns.get(name, [])))
            name = None
    return lines


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


def device_ms(fn, reps=20):
    """Device time per launch of a kernel shorter than its host-side launch:
    the stream first sleeps (about 10 ms) while the host queues every
    launch, so the events time the launches back to back."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(flops, nbytes, exp2=0):
    """The least time the card could take: the bf16 tensor-core products and
    the ``exp2`` on the special-function units (each at its peak; the two
    units run at once, so the slower one bounds) against the bytes over
    HBM."""
    t_ops = max(flops / PEAK_FLOPS, exp2 / PEAK_EXP2)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


@contextlib.contextmanager
def full_fp32():
    """fp32 products and convolutions on the card in full fp32, not TF32
    (which keeps about three decimal digits): the reference that a kernel is
    held to. PyTorch's defaults are matmul.allow_tf32 False, cudnn.allow_tf32
    True; the main paths keep them."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def compare(name, shape, kernel_fn, plain_fn, plain_inputs_fn, rows, flops, nbytes,
            library_fn=None, reps=5, exp2=0, extra_bytes=0):
    """Run the kernel and its plain version in fp32 (no TF32) on the same bf16
    inputs, compare every output (each normalised by its own largest
    magnitude), and time the kernel, the plain version on the bf16 inputs
    and the library call. ``exp2``: the exp2 a softmax kernel must take,
    part of its bound (and shown beside it). ``extra_bytes``: what the
    design moves beyond each input read once and each output written once
    (an intermediate's round trip); its bound is shown in brackets and
    kept in the row, the bound itself is not changed."""
    got = kernel_fn()
    torch.cuda.synchronize()
    with full_fp32():
        ref = plain_inputs_fn()
    if isinstance(got, torch.Tensor):
        got, ref = [got], [ref]
    errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(got, ref)]
    rels = [e / max(r.float().abs().max().item(), 1e-30) for e, r in zip(errs, ref)]
    del got, ref
    torch.cuda.empty_cache()
    ms = time_ms(kernel_fn, reps)
    plain_ms = time_ms(plain_fn, max(1, reps // 2))
    library_ms = library_fn() if library_fn is not None else None
    bound_ms, bound_by = bound(flops, nbytes, exp2)
    rel = max(rels)
    ok = all(math.isfinite(r) and r <= TOL for r in rels)
    design_ms = bound(flops, nbytes + extra_bytes, exp2)[0] if extra_bytes else None
    rows.append(dict(kernel=name, shape=shape, max_abs_err=max(errs), rel_err=rel,
                     rel_err_per_output=rels, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound_ms, bound_by=bound_by, design_bound_ms=design_ms, ok=ok))
    lib = "none" if library_ms is None else f"{library_ms:8.3f} ms"
    by = f"{bound_by}; exp2 {exp2 / PEAK_EXP2 * 1e3:.3f}" if exp2 else bound_by
    design = (f" [+{extra_bytes / 1e6:.0f} MB of the design: {design_ms:.3f} ms]"
              if extra_bytes else "")
    log(f"  {name:16s} {shape:38s} rel {rel:.2e}  kernel {ms:9.3f} ms  plain "
        f"{plain_ms:9.3f} ms  library {lib}  bound {bound_ms:.3f} ms ({by}){design}  "
        f"{'ok' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return ok


def sdpa_layout(t, heads):
    b, s, hd = t.shape
    return t.view(b, s, heads, hd // heads).transpose(1, 2).contiguous()


def kernel_checks():
    from vista_tpu_torch.ops.attention import attention_forward, attention_plain
    from vista_tpu_torch.ops.fused_ff import ff_bwd, ff_bwd_plain
    from vista_tpu_torch.ops.linear import (linear_residual, linear_residual_plain,
                                            ln_linear, ln_linear_plain)
    from vista_tpu_torch.ops.temporal_conv import (_flipped_taps, conv3, conv3_plain, gn_silu,
                                                   gn_silu_conv3, gn_silu_conv3_plain,
                                                   gn_silu_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    f32 = lambda *ts: [None if t is None else t.float() for t in ts]
    rows, ok = [], True
    sdpa = F.scaled_dot_product_attention

    # K1: (batch rows, tokens, heads) at the main paths' shapes, every route
    # that takes the shape, the plan's first; the ds1 and 2880-token cases
    # use a few of the 50 frames so that the plain fp32 logits fit.
    for b, s, h, tag in [(2, 9216, 5, "ds1 576x1024"), (8, 2304, 10, "ds2 576x1024"),
                         (50, 576, 20, "ds4 576x1024"), (50, 144, 20, "mid 576x1024"),
                         (10, 2880, 5, "ds1 320x576"), (50, 720, 10, "ds2 320x576"),
                         (50, 180, 20, "ds4 320x576"), (50, 45, 20, "mid 320x576"),
                         (18432, 25, 5, "temporal ds1 576x1024"),
                         (4608, 25, 10, "temporal ds2 576x1024"),
                         (1152, 25, 20, "temporal ds4 576x1024")]:
        q, k, v = (rnd(b, s, h * 64) for _ in range(3))
        q4, k4, v4 = (sdpa_layout(t, h) for t in (q, k, v))
        for route in attention_routes(b, s, h):
            ok &= compare("attention", f"{tag} ({b},{s},{h}x64) {route}",
                          lambda: attention_forward(q, k, v, h, route=route),
                          lambda: attention_plain(q, k, v, h),
                          lambda: attention_plain(*f32(q, k, v), h), rows,
                          4 * b * h * s * s * 64, 2 * 4 * b * s * h * 64,
                          lambda: time_ms(lambda: sdpa(q4, k4, v4)), exp2=b * h * s * s)
        del q, k, v, q4, k4, v4
    # K2 and K3 at c = 320 (ds1 rows) and 1280 (ds4 rows), 576x1024.
    for m, c in [(50 * 9216, 320), (50 * 576, 1280)]:
        x = rnd(m, c)
        lw, lb = rnd(c, std=0.2, dtype=torch.float32) + 1, rnd(c, std=0.2, dtype=torch.float32)
        lwb, lbb = lw.to(bf), lb.to(bf)
        w = rnd(3 * c, c, std=c ** -0.5)
        ok &= compare("ln_linear", f"split q/k/v ({m},{c})->3x{c}",
                      lambda: ln_linear(x, lw, lb, w, None, "split", 3),
                      lambda: ln_linear_plain(x, lw, lb, w, None, "split", 3),
                      lambda: ln_linear_plain(*f32(x, lw, lb, w), None, "split", 3), rows,
                      2 * m * c * 3 * c, 2 * (m * c + 3 * c * c + 3 * m * c),
                      lambda: time_ms(lambda: F.linear(F.layer_norm(x, (c,), lwb, lbb), w)))
        w1, b1 = rnd(8 * c, c, std=c ** -0.5), rnd(8 * c, std=0.1, dtype=torch.float32)
        b1b = b1.to(bf)
        ok &= compare("ln_linear", f"geglu ({m},{c})->{4 * c}",
                      lambda: ln_linear(x, lw, lb, w1, b1, "geglu"),
                      lambda: ln_linear_plain(x, lw, lb, w1, b1, "geglu"),
                      lambda: ln_linear_plain(*f32(x, lw, lb, w1, b1), "geglu"), rows,
                      2 * m * c * 8 * c, 2 * (m * c + 8 * c * c + 4 * m * c),
                      lambda: time_ms(lambda: F.linear(F.layer_norm(x, (c,), lwb, lbb), w1, b1b)))
        del w, w1
        hg = rnd(m, 4 * c)
        w2, b2 = rnd(c, 4 * c, std=(4 * c) ** -0.5), rnd(c, std=0.1, dtype=torch.float32)
        b2b = b2.to(bf)
        ok &= compare("linear_residual", f"ff out ({m},{4 * c})->{c}",
                      lambda: linear_residual(hg, w2, b2, x),
                      lambda: linear_residual_plain(hg, w2, b2, x),
                      lambda: linear_residual_plain(*f32(hg, w2, b2, x)), rows,
                      2 * m * 4 * c * c, 2 * (4 * m * c + 4 * c * c + 2 * m * c),
                      lambda: time_ms(lambda: torch.addmm(b2b, hg, w2.t()) + x))
        del hg
        o, wo = rnd(m, c), rnd(c, c, std=c ** -0.5)
        ok &= compare("linear_residual", f"attn out ({m},{c})->{c}",
                      lambda: linear_residual(o, wo, b2, x),
                      lambda: linear_residual_plain(o, wo, b2, x),
                      lambda: linear_residual_plain(*f32(o, wo, b2, x)), rows,
                      2 * m * c * c, 2 * (3 * m * c + c * c),
                      lambda: time_ms(lambda: torch.addmm(b2b, o, wo.t()) + x))
        del x, o
    # K3 at the temporal out-projection, ds2 576x1024: (2 h w rows, 25
    # frames, 640) of the doubled batch
    x, o = rnd(4608, 25, 640), rnd(4608, 25, 640)
    wo, bo = rnd(640, 640, std=640 ** -0.5), rnd(640, std=0.1, dtype=torch.float32)
    bob = bo.to(bf)
    m, c = 4608 * 25, 640
    ok &= compare("linear_residual", f"temporal out (4608,25,{c})->{c}",
                  lambda: linear_residual(o, wo, bo, x),
                  lambda: linear_residual_plain(o, wo, bo, x),
                  lambda: linear_residual_plain(*f32(o, wo, bo, x)), rows,
                  2 * m * c * c, 2 * (3 * m * c + c * c),
                  lambda: time_ms(lambda: torch.addmm(bob, o.view(m, c), wo.t()).view(o.shape) + x))
    del x, o
    # K2 at c = 640 (ds2 rows, 576x1024), and split at ds1 on a residual
    # stream that is not zero-mean (x + 4, std 1), as the UNet's are.
    for m, c, shift in [(50 * 2304, 640, 0.0), (50 * 9216, 320, 4.0)]:
        x = (rnd(m, c, dtype=torch.float32) + shift).to(bf)
        lw, lb = rnd(c, std=0.2, dtype=torch.float32) + 1, rnd(c, std=0.2, dtype=torch.float32)
        lwb, lbb = lw.to(bf), lb.to(bf)
        w = rnd(3 * c, c, std=c ** -0.5)
        tag = f" x+{shift:g}" if shift else ""
        ok &= compare("ln_linear", f"split q/k/v ({m},{c})->3x{c}{tag}",
                      lambda: ln_linear(x, lw, lb, w, None, "split", 3),
                      lambda: ln_linear_plain(x, lw, lb, w, None, "split", 3),
                      lambda: ln_linear_plain(*f32(x, lw, lb, w), None, "split", 3), rows,
                      2 * m * c * 3 * c, 2 * (m * c + 3 * c * c + 3 * m * c),
                      lambda: time_ms(lambda: F.linear(F.layer_norm(x, (c,), lwb, lbb), w)))
        del w
        if not shift:
            w1, b1 = rnd(8 * c, c, std=c ** -0.5), rnd(8 * c, std=0.1, dtype=torch.float32)
            b1b = b1.to(bf)
            ok &= compare("ln_linear", f"geglu ({m},{c})->{4 * c}",
                          lambda: ln_linear(x, lw, lb, w1, b1, "geglu"),
                          lambda: ln_linear_plain(x, lw, lb, w1, b1, "geglu"),
                          lambda: ln_linear_plain(*f32(x, lw, lb, w1, b1), "geglu"), rows,
                          2 * m * c * 8 * c, 2 * (m * c + 8 * c * c + 4 * m * c),
                          lambda: time_ms(lambda: F.linear(F.layer_norm(x, (c,), lwb, lbb), w1,
                                                           b1b)))
            del w1
        del x
    # K4 at its four sites of the 576x1024 request and the ragged mid site
    # of 320x576 (1125 rows a clip), both epilogues, t = 25 over the two
    # clips of the doubled batch; beside each, its pre-pass alone. Library:
    # F.conv3d on the same xn, "conv only" (no one call computes GN + SiLU +
    # conv + epilogue). The K4 bound is the function's; the design's extra
    # write and read of xn are shown in brackets.
    for bt, s, c, tag in [(50, 9216, 320, "ds1"), (50, 2304, 640, "ds2"), (50, 576, 1280, "ds4"),
                          (50, 144, 1280, "mid"), (50, 45, 1280, "mid 320x576")]:
        x = rnd(bt, s, c)
        sc, sh = rnd(bt, c, std=0.5, dtype=torch.float32), rnd(bt, c, std=0.5, dtype=torch.float32)
        w, b = rnd(c, c, 3, 1, 1, std=(3 * c) ** -0.5), rnd(c, std=0.1, dtype=torch.float32)
        bb = b.to(bf)
        emb = rnd(bt, c, dtype=torch.float32)
        m = bt * s
        ok &= compare("gn_silu", f"pre-pass {tag} ({bt},{s},{c})",
                      lambda: gn_silu(x, sc, sh), lambda: gn_silu_plain(x, sc, sh),
                      lambda: gn_silu_plain(*f32(x, sc, sh)), rows, 0,
                      2 * 2 * m * c + 2 * 4 * bt * c, exp2=m * c)
        xn5 = gn_silu(x, sc, sh).view(bt // 25, 25, s, c).permute(0, 3, 1, 2)[..., None]
        conv_only = lambda: time_ms(lambda: F.conv3d(xn5, w, bb, padding=(1, 0, 0)))
        ok &= compare("gn_silu_conv3", f"emb {tag} ({bt},{s},{c})",
                      lambda: gn_silu_conv3(x, sc, sh, w, b, 25, emb=emb),
                      lambda: gn_silu_conv3_plain(x, sc, sh, w, b, 25, emb=emb),
                      lambda: gn_silu_conv3_plain(*f32(x, sc, sh, w, b), 25, emb=emb), rows,
                      6 * m * c * c, 2 * (2 * m * c + 3 * c * c), conv_only,
                      extra_bytes=2 * 2 * m * c)
        rs = torch.full((1,), 0.4, device=dev)
        ok &= compare("gn_silu_conv3", f"res {tag} ({bt},{s},{c})",
                      lambda: gn_silu_conv3(x, sc, sh, w, b, 25, residual=x, res_scale=rs),
                      lambda: gn_silu_conv3_plain(x, sc, sh, w, b, 25, residual=x,
                                                  res_scale=rs),
                      lambda: gn_silu_conv3_plain(*f32(x, sc, sh, w, b), 25,
                                                  residual=x.float(), res_scale=rs), rows,
                      6 * m * c * c, 2 * (3 * m * c + 3 * c * c), conv_only,
                      extra_bytes=2 * 2 * m * c)
        del x, xn5
        torch.cuda.empty_cache()

    # The training path's kernels at the phase-2 shapes: 320x576 -> 40x72
    # latents, 25 frames, batch 1.
    ok &= ln_checks(rnd, f32, rows)
    for b, s, h, tag in [(25, 2880, 5, "ds1"), (25, 720, 10, "ds2"), (25, 180, 20, "ds4"),
                         (25, 45, 20, "mid"), (2880, 25, 5, "temporal ds1"),
                         (720, 25, 10, "temporal ds2")]:
        ok &= attention_train_checks(rnd, f32, rows, b, s, h, f"{tag} 320x576")
    for m, c in [(72000, 320), (18000, 640), (4500, 1280)]:
        x, dy = rnd(m, c), rnd(m, c)
        lw, lb = rnd(c, std=0.1, dtype=torch.float32) + 1, rnd(c, std=0.1, dtype=torch.float32)
        w1, b1 = rnd(8 * c, c, std=c ** -0.5), rnd(8 * c, std=0.1, dtype=torch.float32)
        w2 = rnd(c, 4 * c, std=(4 * c) ** -0.5)
        ok &= compare("ff_bwd", f"({m},{c}) all 7 grads",
                      lambda: ff_bwd(x, lw, lb, w1, b1, w2, dy),
                      lambda: ff_bwd_plain(x, lw, lb, w1, b1, w2, dy),
                      lambda: ff_bwd_plain(*f32(x, lw, lb, w1, b1, w2, dy)), rows,
                      64 * m * c * c, 2 * (3 * m * c + 2 * 12 * c * c),
                      lambda: ff_composite_bwd_ms(x, lw, lb, w1, b1, w2), reps=3)
        del x, dy
    # conv3 (dx of K4's backward) at 320x576 ds1 and ds2 and at the phase-1
    # ds1 shape (576x1024)
    for bt, s, c in [(25, 2880, 320), (25, 720, 640), (25, 9216, 320)]:
        gy = rnd(bt, s, c)
        w = rnd(c, c, 3, 1, 1, std=(3 * c) ** -0.5)
        wt = _flipped_taps(w)
        g5 = gy.view(1, bt, s, c).permute(0, 3, 1, 2)[..., None]
        ok &= compare("conv3", f"dx ({bt},{s},{c})",
                      lambda: conv3(gy, wt, None, 25),
                      lambda: conv3_plain(gy, wt, None, 25),
                      lambda: conv3_plain(gy.float(), wt.float(), None, 25), rows,
                      6 * bt * s * c * c, 2 * (2 * bt * s * c + 3 * c * c),
                      lambda: time_ms(lambda: F.conv3d(g5, wt, padding=(1, 0, 0))))
        del gy, g5
    ok &= phase1_kernel_checks(rnd, f32, rows)
    ok &= primitive_checks(rnd, rows)
    fwd_crossover, crossover, agrees = route_crossovers(rnd)
    OUT.mkdir(exist_ok=True)
    (OUT / "kernel_checks.json").write_text(json.dumps(dict(
        card=CARD, rows=rows, crossover=crossover, fwd_crossover=fwd_crossover), indent=1))
    if not ok:
        raise SystemExit("a kernel disagrees with its plain version")
    if not agrees:
        raise SystemExit("a route threshold disagrees with the measured crossover")
    return rows


# the LayerNorm pair's shapes: phase 2 (320x576: ds1 in the spatial and the
# temporal layout, ds2, ds4) and phase 1 (576x1024: ds1, ds2, ds4)
LN_PHASE2 = [(72000, 320), (2880, 25, 320), (18000, 640), (4500, 1280)]
LN_PHASE1 = [(230400, 320), (57600, 640), (14400, 1280)]


def ln_checks(rnd, f32, rows):
    """layer_norm and ln_bwd against their plain versions, each row with its
    host-timed kernel and library times and the same two on the device
    alone (``device_ms``: the phase-2 rows are shorter than a launch from
    Python). Library: ``F.layer_norm``; ``native_layer_norm_backward`` on
    bf16 x and dy with the mean and rstd of ``native_layer_norm`` (it does
    not add ff_bwd's residual cotangent). ln_bwd in its three forms:
    qkv_bwd's (fp32 dxn, fp32 γ as K2's wrapper holds it, dγ/dβ) and
    ff_bwd's (fp32 dxn, the residual's cotangent, bf16 γ, dγ/dβ) at the
    phase-1 shapes; the LoRA norm1's (bf16 dy, bf16 γ, frozen) at the
    phase-2 ones."""
    from vista_tpu_torch.ops.norms import (layer_norm_kernel, layer_norm_plain, ln_backward,
                                           ln_bwd_plain)

    bf = torch.bfloat16
    ok = True

    def device_row(kernel_fn, library_call):
        row = rows[-1]
        row["device_ms"], row["library_device_ms"] = device_ms(kernel_fn), device_ms(library_call)
        log(f"  {row['kernel']:16s} {row['shape']:38s} device: kernel {row['device_ms']:.4f} ms, "
            f"library {row['library_device_ms']:.4f} ms; "
            f"{100 * row['bound_ms'] / row['device_ms']:.0f}% of the bound")

    for shape in LN_PHASE2 + LN_PHASE1:
        c = shape[-1]
        x = rnd(*shape, std=2.0)
        lw, lb = rnd(c, std=0.1) + 1, rnd(c, std=0.1)  # bf16, as the UNet's norms
        n = x.numel()
        library = lambda: F.layer_norm(x, (c,), lw, lb)
        ok &= compare("layer_norm", f"{tuple(shape)}",
                      lambda: layer_norm_kernel(x, lw, lb),
                      lambda: layer_norm_plain(x, lw, lb),
                      lambda: layer_norm_plain(*f32(x, lw, lb)), rows, 8 * n, 2 * 2 * n + 4 * c,
                      lambda: time_ms(library))
        device_row(lambda: layer_norm_kernel(x, lw, lb), library)
        del x
    for form, shapes, dxn_dtype, with_res, want in [
            ("qkv_bwd", LN_PHASE1, torch.float32, False, True),
            ("ff_bwd", LN_PHASE1, torch.float32, True, True),
            ("LoRA norm1", LN_PHASE2[:1] + LN_PHASE2[2:], bf, False, False)]:
        for shape in shapes:
            c = shape[-1]
            m = math.prod(shape[:-1])
            x, dxn = rnd(m, c, std=2.0), rnd(m, c, dtype=dxn_dtype)
            dres = rnd(m, c) if with_res else None
            lw = rnd(c, std=0.1, dtype=torch.float32 if form == "qkv_bwd" else bf) + 1
            lb = rnd(c, std=0.1, dtype=lw.dtype)

            def kernel():
                dx, dg, db = ln_backward(x, dxn, lw, dres, want_ln=want)
                return (dx, dg, db) if want else dx

            def plain(x, dxn, lw, dres):
                dx, dg, db = ln_bwd_plain(x, dxn, lw)
                dx = dx if dres is None else dx + dres.float()
                return (dx, dg, db) if want else dx

            _, mean, rstd = torch.ops.aten.native_layer_norm(x, [c], lw.to(bf), lb.to(bf), 1e-5)
            dy, lwb, lbb = dxn.to(bf), lw.to(bf), lb.to(bf)
            library = lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [c], mean, rstd, lwb, lbb, [True, want, want])
            # x, dxn, dres in, dx out; γ in and dγ, dβ out
            nbytes = (m * c * (2 + dxn.element_size() + 2 * with_res + 2)
                      + c * lw.element_size() + 8 * c * want)
            tag = (f"{form} ({m},{c}) {str(dxn_dtype)[6:]} dxn" + (" + dres" if with_res else "")
                   + (", dγ/dβ" if want else ""))
            ok &= compare("ln_bwd", tag, kernel, lambda: plain(x, dxn, lw, dres),
                          lambda: plain(*f32(x, dxn, lw, dres)), rows, 0, nbytes,
                          lambda: time_ms(library))
            device_row(kernel, library)
            del x, dxn, dres, dy
    torch.cuda.empty_cache()
    return ok


def attention_routes(b, s, h):
    """The routes of K1 that take ``s`` queries and keys (the short route
    takes at most 64), the one the plan takes first."""
    from vista_tpu_torch.ops.attention import SHORT_ROWS, attention_plan

    chosen = attention_plan(b, s, s, h, s).route
    routes = ("short", "wgmma") if s <= SHORT_ROWS else ("wgmma",)
    return (chosen,) + tuple(r for r in routes if r != chosen)


def attention_train_checks(rnd, f32, rows, b, s, h, tag):
    """The training path's attention at one shape: K1 with its LSE on every
    route that takes it, then attention_bwd on the plan's route, every
    output against the plain version; SDPA forward, and its autograd
    backward minus forward, as the yardsticks."""
    from vista_tpu_torch.ops.attention import (attention_bwd, attention_bwd_plain,
                                               attention_bwd_plan, attention_forward)

    sdpa = F.scaled_dot_product_attention
    q, k, v, do = (rnd(b, s, h * 64) for _ in range(4))
    o, lse = attention_forward(q, k, v, h, want_lse=True)
    q4, k4, v4, do4 = (sdpa_layout(t, h) for t in (q, k, v, do))
    ok = fwd_lse_checks(f"{tag} ({b},{s},{h}x64)", q, k, v, h, rows,
                        lambda: time_ms(lambda: sdpa(q4, k4, v4)))
    q4.requires_grad_(), k4.requires_grad_(), v4.requires_grad_()

    def sdpa_fwd_bwd():
        q4.grad = k4.grad = v4.grad = None
        sdpa(q4, k4, v4).backward(do4)

    def sdpa_bwd_ms():
        with torch.no_grad():
            fwd = time_ms(lambda: sdpa(q4, k4, v4))
        return time_ms(sdpa_fwd_bwd) - fwd

    route = attention_bwd_plan(b, s, s, h, s).route
    ok &= compare("attention_bwd", f"{tag} ({b},{s},{h}x64) {route}",
                  lambda: attention_bwd(q, k, v, o, lse, do, h),
                  lambda: attention_bwd_plain(q, k, v, o, lse, do, h),
                  lambda: attention_bwd_plain(*f32(q, k, v, o, lse, do), h), rows,
                  10 * b * h * s * s * 64, 2 * 8 * b * s * h * 64 + 4 * b * h * s,
                  sdpa_bwd_ms)
    del q, k, v, do, o, lse, q4, k4, v4, do4
    torch.cuda.empty_cache()
    return ok


def fwd_lse_checks(shape, q, k, v, h, rows, library_fn):
    """K1 with its LSE output (the training forward) on both routes, every
    output against the plain version; SDPA (no LSE) as the yardstick."""
    from vista_tpu_torch.ops.attention import attention_forward, attention_plain

    b, s = q.shape[:2]
    ok = True
    for route in attention_routes(b, s, h):
        ok &= compare("attention", f"fwd+lse {shape} {route}",
                      lambda: attention_forward(q, k, v, h, want_lse=True, route=route),
                      lambda: attention_plain(q, k, v, h, want_lse=True),
                      lambda: attention_plain(q.float(), k.float(), v.float(), h,
                                              want_lse=True), rows,
                      4 * b * h * s * s * 64, 2 * 4 * b * s * h * 64 + 4 * b * h * s,
                      library_fn, exp2=b * h * s * s)
    return ok


# the plan's route may be slower than the other by this factor at a site: a
# near-tie (144 keys, where K1's two routes read within 3% of each other on
# an H100) must not fail the run
CROSSOVER_SLACK = 1.2


def route_crossover(kernel, sites, plan, launcher):
    """``kernel``'s routes timed on the device alone (``device_ms``) at the
    sites next to its threshold: the measurement behind ``plan``. The short
    route takes at most 64 queries and keys, so above that the wgmma route
    is timed alone. ``launcher(b, s, h)`` makes the inputs of a site and
    returns the launch of one route. Returns the rows and whether the
    plan's route is the faster one at every site, within
    ``CROSSOVER_SLACK``."""
    from vista_tpu_torch.ops.attention import SHORT_ROWS

    out, agrees = [], True
    for b, s, h, tag in sites:
        run = launcher(b, s, h)
        routes = ("short", "wgmma") if s <= SHORT_ROWS else ("wgmma",)
        ms = {route: device_ms(lambda: run(route)) for route in routes}
        chosen = plan(b, s, s, h, s).route
        fine = ms[chosen] <= CROSSOVER_SLACK * min(ms.values())
        agrees &= fine
        times = ", ".join(f"{r} {t:.3f} ms" for r, t in ms.items())
        log(f"  {kernel} route crossover {tag} ({b},{s},{h}x64): {times}; the plan takes "
            f"{chosen}" + ("" if fine else f", more than {CROSSOVER_SLACK}x the other: DISAGREES"))
        out.append(dict(shape=f"{tag} ({b},{s},{h}x64)", chosen=chosen, agrees=fine, **ms))
        del run
    torch.cuda.empty_cache()
    return out, agrees


def route_crossovers(rnd):
    """Both attention kernels' crossovers: K1's at the sampling batch of 50
    frames (the temporal attention's rows of ds4 and ds1 576x1024 for
    t = 25), attention_bwd's at the phase-2 batch of 25 (the temporal rows
    of ds1 320x576) and at the phase-1 temporal rows of ds1 576x1024."""
    from vista_tpu_torch.ops.attention import (attention_bwd, attention_bwd_plan,
                                               attention_forward, attention_plan)

    def fwd(b, s, h):
        q, k, v = (rnd(b, s, h * 64) for _ in range(3))
        return lambda route: attention_forward(q, k, v, h, route=route)

    def bwd(b, s, h):
        q, k, v, do = (rnd(b, s, h * 64) for _ in range(4))
        o, lse = attention_forward(q, k, v, h, want_lse=True)
        return lambda route: attention_bwd(q, k, v, o, lse, do, h, route=route)

    fwd_rows, fwd_agrees = route_crossover("attention", [
        (50, 45, 20, "mid 320x576"), (50, 144, 20, "mid 576x1024"),
        (50, 180, 20, "ds4 320x576"), (50, 576, 20, "ds4 576x1024"),
        (50, 720, 10, "ds2 320x576"), (1152, 25, 20, "temporal ds4 576x1024"),
        (18432, 25, 5, "temporal ds1 576x1024")],
        attention_plan, fwd)
    bwd_rows, bwd_agrees = route_crossover("attention_bwd", [
        (25, 45, 20, "mid 320x576"), (25, 144, 20, "mid 576x1024"),
        (25, 180, 20, "ds4 320x576"), (2880, 25, 5, "temporal ds1 320x576"),
        (9216, 25, 5, "temporal ds1 576x1024")],
        attention_bwd_plan, bwd)
    return fwd_rows, bwd_rows, fwd_agrees and bwd_agrees


def composite_bwd_ms(fwd, inputs):
    """The library column of a backward row: autograd of a composition of
    cuBLAS/ATen calls (``fwd`` of ``inputs``, which require grad), backward
    minus forward, with a cotangent of ones."""
    with torch.no_grad():
        fwd_ms = time_ms(fwd)
        dy = torch.ones_like(fwd())

    def fwd_bwd():
        for t in inputs:
            t.grad = None
        fwd().backward(dy)

    total = time_ms(fwd_bwd)
    for t in inputs:
        t.grad = None
    return total - fwd_ms


def phase1_kernel_checks(rnd, f32, rows):
    """The phase-1 training path's backward kernels at its shapes: 576x1024
    -> 72x128 latents, 25 frames, batch 1, so n = 25 h w token rows."""
    from vista_tpu_torch.ops.attention import (attention_bwd, attention_bwd_plain,
                                               attention_bwd_plan, attention_bwd_prep,
                                               attention_bwd_prep_plain, attention_forward)
    from vista_tpu_torch.ops.fused_ff import ff_bwd, ff_bwd_plain
    from vista_tpu_torch.ops.linear import (linear_residual_bwd, linear_residual_bwd_plain,
                                            ln_linear_split_bwd, ln_linear_split_bwd_plain)

    bf = torch.bfloat16
    ok = True
    # K2 split's backward (#7): spatial at ds1, ds2, ds4; temporal at ds1
    # (rows, t, c).
    for shape, tag in [((230400, 320), "spatial ds1"), ((57600, 640), "spatial ds2"),
                       ((14400, 1280), "spatial ds4"), ((9216, 25, 320), "temporal ds1")]:
        c = shape[-1]
        n = math.prod(shape[:-1])
        x, g = rnd(*shape, std=2.0), rnd(3, *shape)
        lw, lb = rnd(c, std=0.1, dtype=torch.float32) + 1, rnd(c, std=0.1, dtype=torch.float32)
        w = rnd(3 * c, c, std=c ** -0.5)
        xl = x.reshape(-1, c).detach().requires_grad_()
        lwb = lw.to(bf).requires_grad_()
        lbb = lb.to(bf).requires_grad_()
        wl = w.detach().requires_grad_()
        # bf16 x, g, w in and dx, dW out; fp32 gamma, beta in and their grads out
        nbytes = 2 * (5 * n * c + 6 * c * c) + 16 * c
        ok &= compare("qkv_bwd", f"{tag} {shape}->3x{c}",
                      lambda: ln_linear_split_bwd(x, lw, lb, w, g),
                      lambda: ln_linear_split_bwd_plain(x, lw, lb, w, g),
                      lambda: ln_linear_split_bwd_plain(*f32(x, lw, lb, w, g)), rows,
                      12 * n * c * c, nbytes,
                      lambda: composite_bwd_ms(
                          lambda: F.linear(F.layer_norm(xl, (c,), lwb, lbb), wl),
                          (xl, lwb, lbb, wl)), reps=3)
        del x, g, xl, wl
    # K3's backward: attn-out at ds1, temporal-out at ds1 and ds4.
    for shape, tag in [((230400, 320), "attn-out ds1"), ((9216, 25, 320), "temporal-out ds1"),
                       ((576, 25, 1280), "temporal-out ds4")]:
        c = shape[-1]
        m = math.prod(shape[:-1])
        a, g = rnd(*shape), rnd(*shape)
        w, b = rnd(c, c, std=c ** -0.5), rnd(c, std=0.1, dtype=bf)
        al, wl, bl = (t.detach().requires_grad_() for t in (a, w, b))
        res = rnd(*shape)
        ok &= compare("linear_residual_bwd", f"{tag} {shape}",
                      lambda: linear_residual_bwd(a, w, g),
                      lambda: linear_residual_bwd_plain(a, w, g),
                      lambda: linear_residual_bwd_plain(*f32(a, w, g)), rows,
                      4 * m * c * c, 2 * (3 * m * c + 2 * c * c) + 4 * c,
                      lambda: composite_bwd_ms(lambda: F.linear(al, wl, bl) + res, (al, wl, bl)))
        del a, g, al, res
    # attention_bwd at ds1 576x1024: 2 of the 25 frames, so that the plain
    # fp32 (2, 5, 9216, 9216) score tensors fit; then its wgmma route's
    # pre-pass alone (lse log2 e and D per row, each column an output); then
    # ds2 576x1024 at its own size (25 frames, 2304 tokens, 10 heads).
    for b, s, h, tag in [(2, 9216, 5, "ds1 576x1024 (2 of 25, 9216, 5x64)"),
                         (25, 2304, 10, "ds2 576x1024 (25, 2304, 10x64)")]:
        q, k, v, do = (rnd(b, s, h * 64) for _ in range(4))
        o, lse = attention_forward(q, k, v, h, want_lse=True)
        q4, k4, v4 = (sdpa_layout(t, h).detach().requires_grad_() for t in (q, k, v))
        if b == 2:
            with torch.no_grad():
                ok &= fwd_lse_checks(tag, q, k, v, h, rows,
                                     lambda: time_ms(lambda: F.scaled_dot_product_attention(
                                         q4, k4, v4)))
        plan = attention_bwd_plan(b, s, s, h, s)
        ok &= compare("attention_bwd", f"{tag} {plan.route}",
                      lambda: attention_bwd(q, k, v, o, lse, do, h),
                      lambda: attention_bwd_plain(q, k, v, o, lse, do, h),
                      lambda: attention_bwd_plain(*f32(q, k, v, o, lse, do), h), rows,
                      10 * b * h * s * s * 64, 2 * 8 * b * s * h * 64 + 4 * b * h * s,
                      lambda: composite_bwd_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                                               (q4, k4, v4)), reps=3)
        if b == 2:
            def columns(r):
                return r[:, :, :s, 0], r[:, :, :s, 1]

            ok &= compare("attention_bwd", f"prep (lse, D) {tag}",
                          lambda: columns(attention_bwd_prep(o, lse, do, plan)),
                          lambda: columns(attention_bwd_prep_plain(o, lse, do, plan)),
                          lambda: columns(attention_bwd_prep_plain(*f32(o, lse, do), plan)), rows,
                          2 * b * s * h * 64,
                          2 * 2 * b * s * h * 64 + 4 * b * h * s + 8 * b * h * plan.s_q_pad)
        del q, k, v, do, o, lse, q4, k4, v4
        torch.cuda.empty_cache()
    # the temporal attention at ds1 and ds2 (batch 1 x h w rows, t = 25)
    for b, s, h, tag in [(9216, 25, 5, "temporal ds1"), (2304, 25, 10, "temporal ds2")]:
        ok &= attention_train_checks(rnd, f32, rows, b, s, h, f"{tag} 576x1024")
    # the feed-forward backward at ds1, every gradient
    m, c = 230400, 320
    x, dy = rnd(m, c), rnd(m, c)
    lw, lb = rnd(c, std=0.1, dtype=torch.float32) + 1, rnd(c, std=0.1, dtype=torch.float32)
    w1, b1 = rnd(8 * c, c, std=c ** -0.5), rnd(8 * c, std=0.1, dtype=torch.float32)
    w2 = rnd(c, 4 * c, std=(4 * c) ** -0.5)
    ok &= compare("ff_bwd", f"({m},{c}) all 7 grads, ds1 576x1024",
                  lambda: ff_bwd(x, lw, lb, w1, b1, w2, dy),
                  lambda: ff_bwd_plain(x, lw, lb, w1, b1, w2, dy),
                  lambda: ff_bwd_plain(*f32(x, lw, lb, w1, b1, w2, dy)), rows,
                  64 * m * c * c, 2 * (3 * m * c + 2 * 12 * c * c),
                  lambda: ff_composite_bwd_ms(x, lw, lb, w1, b1, w2), reps=3)
    del x, dy
    torch.cuda.empty_cache()
    ok &= conv3_dw_check(rnd, rows)
    return ok


DW_TOL = 1e-5  # conv3's dW in fp32 against fp32: the order of the sums differs, nothing else


def conv3_dw_check(rnd, rows):
    """K4's and conv3's dW at the phase-1 ds1 shape (25 frames, 9216 tokens,
    320 channels; 230400 tokens contracted): the port's three tap products
    summed in fp32 (``weight_grad``) against the same products in fp32 on
    the card, held to ``DW_TOL``; beside it, as the library column, a bf16
    matmul with bf16 output per tap (the port's route before), with its own
    error against the same reference."""
    from vista_tpu_torch.ops.temporal_conv import _conv3_weight_grad

    t, s, c = 25, 9216, 320
    xn, gy = rnd(t, s, c), rnd(t, s, c)
    n = t * s
    g2, a2 = gy.view(n, c), xn.view(n, c)
    spans = [(g2[s:], a2[:n - s]), (g2, a2), (g2[:n - s], a2[s:])]
    fp32 = lambda: torch.stack([g.float().t() @ a.float() for g, a in spans], -1)
    bf16_out = lambda: torch.stack([(g.t() @ a).float() for g, a in spans], -1)
    ok = compare("conv3_dw", f"({t},{s},{c}) 3 taps, fp32 sums (weight_grad)",
                 lambda: _conv3_weight_grad(xn, gy, t, (c, c, 3)), fp32, fp32, rows,
                 6 * n * c * c, 2 * 2 * n * c + 4 * 3 * c * c,
                 lambda: time_ms(bf16_out))
    with full_fp32():
        ref = fp32()
    row = rows[-1]
    row["bf16_out_rel_err"] = ((bf16_out() - ref).abs().max() / ref.abs().max()).item()
    log(f"  conv3 dW: fp32 sums rel err {row['rel_err']:.2e} ({row['ms']:.3f} ms) against "
        f"bf16 matmuls with bf16 output {row['bf16_out_rel_err']:.2e} "
        f"({row['library_ms']:.3f} ms); limit {DW_TOL:g}")
    del xn, gy, ref
    torch.cuda.empty_cache()
    return ok and row["rel_err"] <= DW_TOL


def ff_composite_bwd_ms(x, lw, lb, w1, b1, w2):
    """ff_bwd's library column: autograd of F.layer_norm -> F.linear ->
    chunk / erf GELU -> F.linear + residual in bf16 (``composite_bwd_ms``)."""
    c = x.shape[-1]
    b2 = torch.zeros(c, dtype=x.dtype, device=x.device)
    params = [t.to(x.dtype).detach().requires_grad_() for t in (x, lw, lb, w1, b1, w2, b2)]

    def fwd():
        xl, lwl, lbl, w1l, b1l, w2l, b2l = params
        a, g = F.linear(F.layer_norm(xl, (c,), lwl, lbl), w1l, b1l).chunk(2, dim=-1)
        return F.linear(a * F.gelu(g), w2l, b2l) + xl

    return composite_bwd_ms(fwd, params)


# vk_wgrad as (M; segs x N1 x N2; with the bias gradient) and vk_seg_gemm as
# (segs, M, k) -> N, at every shape the phase-1 step gives them
WGRAD_SHAPES = [(230400, 1, 320, 320, True, "one qkv segment; K3 attn-out ds1"),
                (230400, 3, 320, 320, False, "qkv ds1, all three segments"),
                (230400, 1, 2560, 320, True, "ff_bwd dW1 ds1"),
                (230400, 1, 320, 1280, True, "ff_bwd dW2 ds1"),
                (57600, 3, 640, 640, False, "qkv ds2"),
                (14400, 3, 1280, 1280, False, "qkv ds4"),
                (14400, 1, 1280, 1280, True, "K3 temporal-out ds4")]
SEG_GEMM_SHAPES = [(3, 230400, 320, 320, torch.float32, "qkv dxn ds1"),
                   (1, 230400, 2560, 320, torch.float32, "ff_bwd dxn ds1"),
                   (1, 230400, 320, 320, torch.bfloat16, "K3 da ds1"),
                   (3, 14400, 1280, 1280, torch.float32, "qkv dxn ds4")]


# ff_bwd_dh as (M, c), inner 4c: the phase-1 widths (576x1024: ds1, ds2,
# ds4 rows) and the phase-2 ones (320x576)
FF_BWD_DH_SHAPES = [(230400, 320, "ds1 576x1024"), (57600, 640, "ds2 576x1024"),
                    (14400, 1280, "ds4 576x1024"), (72000, 320, "ds1 320x576"),
                    (4500, 1280, "ds4 320x576")]


def primitive_checks(rnd, rows):
    """The two GEMMs under ff_bwd, qkv_bwd and K3's backward, each alone:
    ``weight_grad`` (vk_wgrad with its split fold, fp32 out) and ``seg_gemm``
    against their fp32 plain versions, with one cuBLAS call of the same
    product in bf16 as the yardstick (``torch.mm``, which writes bf16 where
    vk_wgrad and the fp32 seg_gemm rows write fp32; the segments laid out
    as one (M, segs * k) operand for it beforehand); at the shapes of a
    layer with a bias, ``weight_grad`` with its bias gradient as well (the
    cotangent still read once; beside ``torch.mm``, ``torch.sum`` in fp32);
    and whether two launches give the same bits (dW, db); then ff_bwd's
    first step, ``ff_bwd_dh``, alone (no one library call computes it)."""
    from vista_tpu_torch.ops.fused_ff import ff_bwd_dh, ff_bwd_dh_plain
    from vista_tpu_torch.ops.linear import (bias_grad_plain, seg_gemm, seg_gemm_plain,
                                            weight_grad, weight_grad_plain)

    ok = True
    for m, segs, n1, n2, bias, use in WGRAD_SHAPES:
        a, b = (rnd(segs, m, n1) if segs > 1 else rnd(m, n1)), rnd(m, n2)
        flat = a.permute(1, 0, 2).reshape(m, segs * n1) if segs > 1 else a
        nbytes = 2 * m * (segs * n1 + n2) + 4 * segs * n1 * n2
        ok &= compare("vk_wgrad", f"({m}; {segs}x{n1} x {n2}) {use}, fp32 (cuBLAS bf16)",
                      lambda: weight_grad(a, b), lambda: weight_grad_plain(a, b),
                      lambda: weight_grad_plain(a, b), rows, 2 * m * segs * n1 * n2, nbytes,
                      lambda: time_ms(lambda: torch.mm(flat.t(), b)))
        if bias:
            ok &= compare("vk_wgrad", f"({m}; {segs}x{n1} x {n2}) {use}, with db "
                          "(cuBLAS bf16 + torch.sum)",
                          lambda: weight_grad(a, b, want_db=True),
                          lambda: (weight_grad_plain(a, b), bias_grad_plain(a)),
                          lambda: (weight_grad_plain(a, b), bias_grad_plain(a)), rows,
                          2 * m * segs * n1 * n2, nbytes + 4 * segs * n1,
                          lambda: time_ms(lambda: (torch.mm(flat.t(), b),
                                                   torch.sum(a, 0, dtype=torch.float32))))
        outs = [weight_grad(a, b, want_db=bias) for _ in range(2)]
        outs = [o if bias else (o,) for o in outs]
        same = all(torch.equal(x, y) for x, y in zip(*outs))
        rows[-1]["same_bits_in_two_launches"] = same
        log(f"  vk_wgrad {use}: two launches give the same bits ({'dW, db' if bias else 'dW'}): "
            f"{same}")
        ok &= same
        del a, b, flat, outs
    for segs, m, k, n, dtype, use in SEG_GEMM_SHAPES:
        a, w = rnd(segs, m, k), rnd(segs * k, n, std=k ** -0.5)
        flat = a.permute(1, 0, 2).reshape(m, segs * k)
        out_bytes = 4 if dtype == torch.float32 else 2
        ok &= compare("vk_seg_gemm", f"({segs}, {m}, {k})->{n} {use}, "
                      f"{'fp32 (cuBLAS bf16)' if out_bytes == 4 else 'bf16'}",
                      lambda: seg_gemm(a, w, dtype), lambda: seg_gemm_plain(a, w),
                      lambda: seg_gemm_plain(a, w), rows,
                      2 * m * segs * k * n, 2 * (m * segs * k + segs * k * n) + out_bytes * m * n,
                      lambda: time_ms(lambda: torch.mm(flat, w)))
        del a, w, flat
    for m, c, use in FF_BWD_DH_SHAPES:
        xn, dy = rnd(m, c), rnd(m, c)
        w1, b1 = rnd(8 * c, c, std=c ** -0.5), rnd(8 * c, std=0.1, dtype=torch.float32)
        w2 = rnd(c, 4 * c, std=(4 * c) ** -0.5)
        # xn, dy, W1, W2 in; hg (M, 4c) and dH (M, 8c) out; b1 fp32
        ok &= compare("ff_bwd_dh", f"({m},{c}) {use}, hg and dH",
                      lambda: ff_bwd_dh(xn, dy, w1, b1, w2),
                      lambda: ff_bwd_dh_plain(xn, dy, w1, b1, w2),
                      lambda: ff_bwd_dh_plain(*[t.float() for t in (xn, dy, w1, b1, w2)]), rows,
                      24 * m * c * c, 2 * (2 * m * c + 12 * c * c + 12 * m * c) + 32 * c)
        del xn, dy
    torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------- phase 4

SLICE_TOL = 5e-2  # small slice, bf16 kernels on the card vs fp32 plain on the CPU
REQUESTS = [  # (height, width, frames, steps)
    (320, 576, 25, 5), (320, 576, 25, 5), (576, 1024, 25, 25)]


def random_init_(module, gen):
    """Seeded random weights, none zero: norms near 1, fan-in scaled weights,
    small biases, and random mix factors (including the parameters the
    model zero-initialises, such as the LoRA ``up`` and action adapters, so
    that every kernel's output and every adapter reaches the result)."""
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


def init_engine(engine, gen):
    for module in (engine.unet, engine.decoder, engine.encoder, engine.conditioner):
        random_init_(module, gen)


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


def small_cfg(kind="sample"):
    """Widths the kernels take (head_dim 64, c % 64 == 0), fp32. ``kind``:
    ``"sample"``; ``"rollout"``, sampling with action control;
    ``"phase2"``, LoRA + action control and the phase-2 conditioner;
    ``"phase1"``, neither, ucg dropout on the default keys, remat."""
    from vista_tpu_torch.engine.engine import EngineConfig

    base = EngineConfig().tiny()
    lora = kind == "phase2"
    action = kind in ("rollout", "phase2")
    sampling = kind in ("sample", "rollout")
    unet = dataclasses.replace(base.unet, model_channels=64, num_head_channels=64,
                               context_dim=64, adm_in_channels=48, num_frames=5,
                               dtype="float32", add_lora=lora, action_control=action,
                               remat=not sampling)
    cond = base.conditioner
    cond = dataclasses.replace(
        cond, vector_outdim=16, action_control=action,
        ucg_rate=0.0 if sampling else 0.15,
        ucg_keys=PHASE2_UCG_KEYS if lora else cond.ucg_keys,
        clip=dataclasses.replace(cond.clip, output_dim=64, dtype="float32"),
        vae=dataclasses.replace(cond.vae, ch=32, dtype="float32"))
    return dataclasses.replace(base, unet=unet, num_frames=5, conditioner=cond,
                               vae=dataclasses.replace(base.vae, ch=32, dtype="float32"))


def to_bf16(cfg):
    cond = cfg.conditioner
    return dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, dtype="bfloat16"),
        vae=dataclasses.replace(cfg.vae, dtype="bfloat16"),
        conditioner=dataclasses.replace(
            cond, clip=dataclasses.replace(cond.clip, dtype="bfloat16"),
            vae=dataclasses.replace(cond.vae, dtype="bfloat16")))


def card_twin(cpu, cfg, device="cuda"):
    """The CPU engine's weights in a bf16 engine on the card (or ``device``)."""
    from vista_tpu_torch.engine.engine import VistaEngine

    gpu = VistaEngine(to_bf16(cfg), device)
    for name in ("unet", "decoder", "encoder", "conditioner"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    return gpu


def slice_reference(seed):
    """A small slice on the card in bf16 against the same weights and inputs
    in fp32 on the CPU through the plain versions."""
    from vista_tpu_torch.engine.engine import VistaEngine

    cfg = small_cfg()
    cpu = VistaEngine(cfg, "cpu")
    init_engine(cpu, torch.Generator().manual_seed(seed))
    gpu = card_twin(cpu, cfg)
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
    for k, symbols in SYMBOLS.items():
        if any(s in name for s in symbols):
            return f"K: {k}"
    low = name.lower()
    rules = [("cuDNN layout", ("nchwtonhwc", "nhwctonchw", "converttensor")),
             ("convs (cuDNN)", ("fprop", "dgrad", "wgrad", "conv")),
             ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass")),
             ("group norm", ("group_norm", "groupnorm", "rowwisemoments")),
             ("copies", ("copy", "catarray")),
             ("softmax", ("softmax",)),
             ("fft", ("fft",)),
             ("upsample", ("upsample",)),
             ("reductions", ("reduce",)),
             ("elementwise", ("elementwise",))]
    for group, keys in rules:
        if any(k in low for k in keys):
            return group
    return "other"


def _device_profile(label, fn):
    """Device time by kernel group over ``fn()`` and the card's busy share
    of the host-clock wall time (one stream, so kernel times add up; only
    attention_bwd's dQ kernel runs beside its dK/dV kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, total, launches = {}, 0.0, 0
    averages = prof.key_averages()  # its cost grows with the events: once
    for evt in averages:
        if evt.device_type != DeviceType.CUDA or evt.key == "Command Buffer Full":
            continue
        us = evt.self_device_time_total
        total += us
        launches += evt.count
        g = _kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + us
    log(f"  profile {label}: wall {wall:.3f} s, device busy {total / 1e6:.3f} s "
        f"({100 * total / 1e6 / wall:.1f}% of wall), {launches} device launches")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:18s} {us / 1e3:10.1f} ms  {100 * us / max(total, 1):5.1f}%")
    attn = sum(us for g, us in groups.items() if g.startswith("K: attention ("))
    if attn:
        log(f"    {'K: attention, all routes':18s} {attn / 1e3:10.1f} ms")
    attn_bwd = sum(us for g, us in groups.items() if g.startswith("K: attention_bwd"))
    if attn_bwd:
        # its wgmma route's dQ kernel runs on a second stream beside dK/dV, so
        # the two may overlap by up to a wave of blocks: their sum can exceed
        # their span
        log(f"    {'K: attention_bwd, all routes':18s} {attn_bwd / 1e3:10.1f} ms")
    OUT.mkdir(exist_ok=True)
    (OUT / f"profile_{label}.txt").write_text(
        f"{CARD}\n" + averages.table(sort_by="self_cuda_time_total", row_limit=60))
    return dict(wall_s=wall, busy_s=total / 1e6, launches=launches,
                groups_ms={g: us / 1e3 for g, us in groups.items()})


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


def missing_launches(kernels, sites):
    from vista_tpu_torch.ops import _build

    return ([k for k in kernels if _build.LAUNCHES.get(k, 0) == 0]
            + [k for k in sites if _build.SITES.get(k, 0) == 0])


def slice_run(seed, profile=False):
    from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
    from vista_tpu_torch.ops import _build

    phase("slice-reference", slice_reference, seed)
    t0 = time.perf_counter()
    cfg = EngineConfig()
    engine = VistaEngine(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    init_engine(engine, gen)
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
    missing = missing_launches(SAMPLE_KERNELS + ATTENTION_ROUTES, SAMPLE_SITES)
    if profile:
        phase("profile", profile_request, engine, cfg, gen)
    if missing:
        raise SystemExit(f"kernels or call sites never launched on the sampling path: {missing}")
    del engine
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 5

ROLLOUT_ARGV = ["--action", "traj", "--n_rounds", "2", "--n_steps", "10",
                "--height", "576", "--width", "1024"]
REWARD_ARGV = ["--action", "traj", "--n_steps", "10", "--ens_size", "5"]


def rollout_inputs(engine, gen, n):
    """Context frames in [-1, 1], the conditioning scalars with a
    trajectory, and the draws of ``n`` passes, on the CPU."""
    from vista_tpu_torch.engine.rollout import draw_rollout_noise

    t = engine.cfg.num_frames
    images = torch.rand(t, 3, 64, 64, generator=gen) * 2 - 1
    batch = {"fps_id": torch.full((1,), 9.0), "motion_bucket_id": torch.full((1,), 127.0),
             "cond_aug": torch.full((1,), 0.02), "trajectory": torch.randn(1, 8, generator=gen)}
    return images, batch, draw_rollout_noise(engine, images, n, gen)


ROLLOUT_TOL = 1e-1  # the small rollout: bf16 alone reads 3.3e-2 / 5.2e-2 (see below)
ROLLOUT_BF16_RATIO = 1.5  # the card's latents and pixels against bf16-on-the-CPU's own error
REWARD_TOL = 1e-2  # |card - cpu| of the reward, absolute (bf16 alone reads 1.7e-4 relative)


def rollout_reference(seed):
    """A 2-round rollout (2 steps, triangle CFG) and a 3-member reward (2
    steps, vanilla CFG) with action control at a small size: on the card in
    bf16 against the same weights, inputs and draws on the CPU in fp32.
    Beside it, the same in bf16 on the CPU (the plain versions): bf16 alone
    reads 3.3e-2 in the latents and 5.2e-2 in the pixels of this path (the
    encoder's, CLIP's and the UNet's bf16 errors through CFG 2.5 on random
    weights; the UNet's alone 3.0e-2 / 3.9e-2), past ``SLICE_TOL``. So the
    card's latents and pixels are held to ``ROLLOUT_BF16_RATIO`` times the
    same run's bf16-on-the-CPU error and to ``ROLLOUT_TOL``, and the reward
    to ``REWARD_TOL`` absolute."""
    from vista_tpu_torch.diffusion.guidance import GuiderConfig
    from vista_tpu_torch.diffusion.sampler import SamplerConfig
    from vista_tpu_torch.engine import RolloutConfig, autoregressive_rollout, estimate_reward
    from vista_tpu_torch.engine.engine import VistaEngine

    cfg = small_cfg("rollout")
    cpu = VistaEngine(cfg, "cpu")
    init_engine(cpu, torch.Generator().manual_seed(seed))
    gpu = card_twin(cpu, cfg)
    cpu_bf16 = card_twin(cpu, cfg, "cpu")
    images, batch, draws = rollout_inputs(cpu, torch.Generator().manual_seed(seed + 1), 3)
    sampler = lambda kind: SamplerConfig(num_steps=2, guider=GuiderConfig(
        kind=kind, scale=2.5, num_frames=cfg.num_frames))
    out = {}
    for name, engine in (("cpu", cpu), ("card", gpu), ("cpu-bf16", cpu_bf16)):
        dev = engine.device
        moved = dataclasses.replace(draws, **{f.name: getattr(draws, f.name).to(dev)
                                              for f in dataclasses.fields(draws)})
        b = {k: v.to(dev) for k, v in batch.items()}
        px, lat = autoregressive_rollout(engine, images.to(dev), b, sampler("triangle"),
                                         RolloutConfig(num_rounds=2), moved)
        r = estimate_reward(engine, images.to(dev), b, sampler("vanilla"), ensemble_size=3,
                            draws=moved)
        out[name] = (lat.cpu().float(), px.cpu().float(), float(r))
    lat_ref, px_ref, r_ref = out["cpu"]
    assert lat_ref.shape == (2 * (cfg.num_frames - 3) + 3, 4, 32, 32), lat_ref.shape
    errs = {}
    for name in ("card", "cpu-bf16"):
        lat, px, r = out[name]
        errs[name] = {"latents": float((lat - lat_ref).abs().max() / lat_ref.abs().max()),
                      "pixels": float((px - px_ref).abs().max() / px_ref.abs().max()),
                      "reward": abs(r - r_ref) / r_ref, "reward_abs": abs(r - r_ref)}
        e = errs[name]
        log(f"  small rollout (2 rounds) and reward (3 members), {name} vs cpu fp32: latents "
            f"{e['latents']:.3e}, pixels {e['pixels']:.3e} (max-normalised), reward {r:.6f} "
            f"vs {r_ref:.6f} (abs {e['reward_abs']:.3e}, rel {e['reward']:.3e})")
    card, bf16 = errs["card"], errs["cpu-bf16"]
    ratios = {k: card[k] / bf16[k] for k in ("latents", "pixels")}
    errs["ratios"] = ratios
    log(f"  card / bf16-on-the-CPU: latents {ratios['latents']:.3f}, pixels "
        f"{ratios['pixels']:.3f} (limit {ROLLOUT_BF16_RATIO}, and {ROLLOUT_TOL} absolute); "
        f"reward abs {card['reward_abs']:.3e} (limit {REWARD_TOL})")
    if not (all(r <= ROLLOUT_BF16_RATIO for r in ratios.values())
            and card["latents"] <= ROLLOUT_TOL and card["pixels"] <= ROLLOUT_TOL
            and card["reward_abs"] <= REWARD_TOL):
        raise SystemExit("the small rollout or reward disagrees with the CPU reference")
    return errs


def video_frames(path):
    """The frame count of a video the port wrote: the AVI main header's, or
    imageio's count for an mp4."""
    path = str(path)
    if path.endswith(".mp4"):
        import imageio

        with imageio.get_reader(path) as reader:
            return reader.count_frames()
    with open(path, "rb") as f:
        head = f.read(56)
    assert head[:4] == b"RIFF" and head[8:12] == b"AVI " and head[24:28] == b"avih", head
    return int.from_bytes(head[48:52], "little")  # avih's dwTotalFrames


class StageTimes:
    """Host-clock seconds of each call of the named functions, synchronised
    on the card: the engine's stages (instance attributes in front of its
    methods) and the CLI module's input and file writers."""

    def __init__(self, targets):
        self.calls, self.saved = [], []
        for obj, names in targets:
            for name in names:
                self.saved.append((obj, name, vars(obj).get(name)))
                setattr(obj, name, self._timed(name, getattr(obj, name)))

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((name, time.perf_counter() - t0, out))
            return out
        return call

    def take(self):
        calls, self.calls = self.calls, []
        return calls

    def close(self):
        for obj, name, own in self.saved:
            if own is None:
                delattr(obj, name)
            else:
                setattr(obj, name, own)


ENGINE_STAGES = ("encode_first_stage", "condition_pair", "sample", "decode_first_stage")
SAMPLE_CLI_HOST = ("context", "save_video_mp4", "save_grid_png", "save_frames_png")


def rollout_run(seed):
    """The rollout and the reward at full width through the CLIs' ``run``,
    with an action-control engine of seeded random weights (adapters
    non-zero, so the trajectory reaches the output)."""
    from vista_tpu_torch.cli import reward as reward_cli
    from vista_tpu_torch.cli import sample as sample_cli
    from vista_tpu_torch.cli._common import engine_config
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.ops import _build

    small = phase("rollout-reference", rollout_reference, seed)
    save = OUT / "rollout_files"
    s_args = sample_cli.parse_args(ROLLOUT_ARGV + ["--save", str(save)])
    r_args = reward_cli.parse_args(REWARD_ARGV)
    cfg = engine_config(s_args)
    assert engine_config(r_args) == cfg
    t0 = time.perf_counter()
    engine = VistaEngine(cfg, s_args.device)
    init_engine(engine, torch.Generator(device=engine.device).manual_seed(seed + 11))
    n_unet = sum(p.numel() for p in engine.unet.parameters())
    log(f"  action-control engine: VideoUNet {n_unet / 1e9:.3f} B params, CLIP ViT-H, VAE "
        f"encoder and temporal decoder, {cfg.unet.dtype}, seeded random weights "
        f"({time.perf_counter() - t0:.1f} s)")
    times = StageTimes([(engine, ENGINE_STAGES), (sample_cli, SAMPLE_CLI_HOST)])
    result = {"card": CARD, "small": small}

    # the sample CLI: 2 rounds of 10 steps, triangle CFG, files written
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    out = sample_cli.run(s_args, engine)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches, sites = dict(_build.LAUNCHES), dict(_build.SITES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    calls = times.take()
    lat, px, t = out["latents"], out["pixels"], cfg.num_frames
    n, f = s_args.n_rounds * (t - 3) + 3, cfg.vae.downsample_factor
    h, w = s_args.height, s_args.width
    assert lat.shape == (n, 4, h // f, w // f), lat.shape
    assert px.shape == (n, 3, h, w), px.shape
    assert bool(torch.isfinite(lat).all()) and bool(torch.isfinite(px).all()), "non-finite"
    assert 0.0 <= float(px.min()) and float(px.max()) <= 1.0, "pixels outside [0, 1]"
    context = [o for name, _, o in calls if name == "encode_first_stage"][0]
    assert torch.equal(lat[0], context[0].float()), "round 1's frame 0 is not the context latent"
    files = {"video": video_frames(out["paths"]["video"]),
             "real": video_frames(out["paths"]["real"]), "frames": len(out["paths"]["frames"])}
    assert files == {"video": n, "real": t, "frames": n}, files
    written = sorted(p for p in save.rglob("*") if p.is_file())
    assert Path(out["paths"]["grid"]) in written and all(Path(p) in written for p in
                                                         out["paths"]["frames"])
    sizes = {str(p.relative_to(save)): p.stat().st_size for p in written}
    secs = lambda name: [s for k, s, _ in calls if k == name]
    rounds = [dict(sample_s=s, decode_s=d) for s, d in zip(secs("sample"),
                                                           secs("decode_first_stage"))]
    cond_s = secs("condition_pair")
    rounds[0]["condition_s"] = secs("encode_first_stage")[0] + cond_s[0]
    for i, r in enumerate(rounds[1:], 1):
        r["condition_s"] = cond_s[i]
    for r in rounds:
        r["seconds"] = r["sample_s"] + r["decode_s"] + r["condition_s"]
    engine_s = sum(s for k, s, _ in calls if k in ENGINE_STAGES)
    inputs_s = sum(secs("context"))
    files_s = sum(s for k, s, _ in calls if k.startswith("save_"))
    result["rollout"] = dict(
        argv=ROLLOUT_ARGV, seconds=total, engine_s=engine_s, inputs_s=inputs_s,
        files_s=files_s, other_host_s=total - engine_s - inputs_s - files_s,
        rounds=rounds, peak_gib=peak, frames=n, files=files, file_bytes=sizes,
        launches=sites, pixels_mean=float(px.mean()), pixels_std=float(px.std()))
    for i, r in enumerate(rounds):
        log(f"  rollout round {i + 1}: {r['seconds']:.3f} s (sample {r['sample_s']:.3f} s = "
            f"{r['sample_s'] / s_args.n_steps:.3f} s/step, decode {r['decode_s']:.3f} s, "
            f"encode + conditioning {r['condition_s']:.3f} s)")
    log(f"  rollout: {s_args.n_rounds} rounds, {n} frames at {h}x{w}: {total:.3f} s through the "
        f"CLI: {engine_s:.3f} s in the engine, on the host {inputs_s:.3f} s making the context "
        f"frames, {files_s:.3f} s writing files, {total - engine_s - inputs_s - files_s:.3f} s "
        f"else (copies); peak {peak:.2f} GiB; pixels mean {px.mean().item():.4f} std "
        f"{px.std().item():.4f}; files {json.dumps(files)}")
    log(f"    launches by site: {json.dumps(sites, sort_keys=True)}")
    missing = missing_launches(SAMPLE_KERNELS + ATTENTION_ROUTES, SAMPLE_SITES)
    if missing:
        raise SystemExit(f"kernels or call sites never launched on the rollout path: {missing}")
    shutil.rmtree(save)  # the media of random weights: over 100 MB, not worth keeping
    del out, lat, px, context, calls

    # the reward CLI: an ensemble of 5 at 10 steps, vanilla CFG
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    res = reward_cli.run(r_args, engine)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    reward_launches, r_sites = dict(_build.LAUNCHES), dict(_build.SITES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    calls = times.take()
    times.close()
    reward = res["reward"]
    assert math.isfinite(reward) and 0.0 < reward <= 1.0, reward
    members = [s for k, s, _ in calls if k == "sample"]
    assert len(members) == r_args.ens_size, len(members)
    cond = sum(s for k, s, _ in calls if k in ("encode_first_stage", "condition_pair"))
    host = total - sum(s for _, s, _ in calls)
    result["reward"] = dict(argv=REWARD_ARGV, reward=reward, seconds=total,
                            member_s=members, condition_s=cond, host_s=host, peak_gib=peak,
                            launches=r_sites)
    log(f"  reward: {reward:.6f} from {r_args.ens_size} members at {r_args.n_steps} steps: "
        f"{total:.3f} s through the CLI ({sum(members) / len(members):.3f} s a member, "
        f"encode + conditioning {cond:.3f} s, host {host:.3f} s: the context frames, copies), "
        f"peak {peak:.2f} GiB")
    log(f"    launches by site: {json.dumps(r_sites, sort_keys=True)}")
    missing = missing_launches(SAMPLE_KERNELS + ATTENTION_ROUTES, SAMPLE_SITES)
    if missing:
        raise SystemExit(f"kernels or call sites never launched on the reward path: {missing}")
    OUT.mkdir(exist_ok=True)
    (OUT / "rollout.json").write_text(json.dumps(result, indent=1))
    del engine, res
    gc.collect()
    torch.cuda.empty_cache()
    return {"rollout": launches, "reward": reward_launches}


# ---------------------------------------------------------------- phase 6

PHASE2_UCG_KEYS = ("cond_frames_without_noise", "cond_frames", "command", "trajectory",
                   "speed", "angle", "goal")
TRAIN_TOL = 5e-2  # small train slice, bf16 on the card vs fp32 on the CPU
TRAIN_STEPS = 3


CONFIGS = Path(__file__).resolve().parent / "configs"


def recipe(name):
    """The engine and the train recipe of a shipped config, through the
    port's loader."""
    from vista_tpu_torch.config import load_config
    from vista_tpu_torch.runner import ExperimentConfig

    exp = load_config(ExperimentConfig, [str(CONFIGS / name)])
    return exp.engine, exp.train


def phase2_cfg():
    """configs/vista_phase2_stage1.yaml: the engine and the train recipe."""
    return recipe("vista_phase2_stage1.yaml")


def train_batch(h, w, frames, gen, device):
    """Synthetic clip in [-1, 1] and its conditioning scalars and actions."""
    u = lambda *shape: torch.rand(*shape, generator=gen, device=device) * 2 - 1
    return {"frames": u(1, frames, 3, h, w), "fps_id": torch.full((1,), 9.0, device=device),
            "motion_bucket_id": torch.full((1,), 127.0, device=device),
            "cond_aug": torch.full((1,), 0.02, device=device),
            "command": torch.ones(1, 1, device=device), "trajectory": u(1, 8) * 10,
            "speed": u(1, 4) * 10, "angle": u(1, 4), "goal": u(1, 2) * 10}


def move_draws(draws, dev):
    move = lambda t: None if t is None else t.to(dev)
    return dataclasses.replace(
        draws, posterior=move(draws.posterior), cond_aug=move(draws.cond_aug),
        ucg_keep=None if draws.ucg_keep is None else {k: move(v) for k, v in draws.ucg_keep.items()},
        loss=dataclasses.replace(draws.loss, **{f.name: move(getattr(draws.loss, f.name))
                                                for f in dataclasses.fields(draws.loss)}))


def train_reference(seed):
    """The phase-2 step at a small size: loss and adapter gradients on the
    card in bf16 against the same weights, batch and draws on the CPU in fp32."""
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.engine.training import Trainer, draw_train

    _, train = phase2_cfg()
    train = dataclasses.replace(train, loss=dataclasses.replace(train.loss, num_frames=5))
    cfg = small_cfg("phase2")
    cpu = VistaEngine(cfg, "cpu")
    init_engine(cpu, torch.Generator().manual_seed(seed))
    gpu = card_twin(cpu, cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    batch = train_batch(64, 64, 5, gen, "cpu")
    draws = draw_train(cpu, train, batch, gen)
    out = {}
    for name, engine in (("cpu", cpu), ("card", gpu)):
        dev = engine.device
        trainer = Trainer(engine, train)
        loss, _ = trainer.loss_and_grads({k: v.to(dev) for k, v in batch.items()},
                                         move_draws(draws, dev))
        grads = trainer.grads()
        out[name] = (float(loss), torch.cat([g.flatten().cpu() for g in grads.values()]))
    (loss_ref, g_ref), (loss, g) = out["cpu"], out["card"]
    rel_loss = abs(loss - loss_ref) / abs(loss_ref)
    rel_grad = float((g - g_ref).abs().max() / g_ref.abs().max())
    log(f"  small train step: loss card {loss:.6f} cpu {loss_ref:.6f} (rel {rel_loss:.3e}); "
        f"adapter grads max|card - cpu| / max|cpu| = {rel_grad:.3e} over {g.numel()} values "
        f"(limit {TRAIN_TOL})")
    if not (rel_loss <= TRAIN_TOL and rel_grad <= TRAIN_TOL):
        raise SystemExit("the small train step disagrees with the CPU reference")


def train_run(seed, profile=False):
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.engine.training import Trainer, draw_train
    from vista_tpu_torch.ops import _build

    phase("train-reference", train_reference, seed)
    t0 = time.perf_counter()
    cfg, tcfg = phase2_cfg()
    engine = VistaEngine(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    init_engine(engine, gen)
    trainer = Trainer(engine, tcfg)
    n_train = sum(m.numel() for m in trainer.master.values())
    n_unet = sum(p.numel() for p in engine.unet.parameters())
    log(f"  phase-2 stage-1 engine: VideoUNet {n_unet / 1e9:.3f} B params "
        f"({n_train / 1e6:.1f} M train: LoRA + action adapters), CLIP ViT-H, VAE encoder; "
        f"bf16, seeded random weights, remat ({time.perf_counter() - t0:.1f} s)")
    # a host copy of every frozen tensor, so that the peak stays the step's
    frozen = {f"unet.{n}": p.detach().cpu() for n, p in engine.unet.named_parameters()
              if n not in trainer.params}
    for name in ("encoder", "conditioner"):
        frozen.update({f"{name}.{n}": p.detach().cpu()
                       for n, p in getattr(engine, name).named_parameters()})
    start = {n: m.clone() for n, m in trainer.master.items()}
    batch = train_batch(320, 576, 25, gen, "cuda")
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    for i in range(TRAIN_STEPS):
        draws = draw_train(engine, tcfg, batch, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = trainer(batch, draws)
        torch.cuda.synchronize()
        m["seconds"] = time.perf_counter() - t1
        steps.append(m)
        log(f"  step {i}: loss {m['loss']:.5f} (main {m['loss_main']:.5f}, hf "
            f"{m['loss_hf']:.5f}), grad norm {m['grad_norm']:.4e}, sigma "
            f"{m['sigma_mean']:.3f}: {m['seconds']:.3f} s")
        assert math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]), m
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(_build.LAUNCHES)
    sites = dict(_build.SITES)
    s_step = sum(m["seconds"] for m in steps[1:]) / (len(steps) - 1)
    log(f"  train: {s_step:.3f} s/step (steps 2-{TRAIN_STEPS}; step 1 {steps[0]['seconds']:.3f} "
        f"s), peak {peak:.2f} GiB; card {CARD}")
    log(f"  launches over the {TRAIN_STEPS} steps: {json.dumps(sites, sort_keys=True)}")
    missing = missing_launches(TRAIN_KERNELS + ATTENTION_ROUTES + ATTENTION_BWD_ROUTES, [
        "layer_norm/spatial-long", "layer_norm/spatial-short", "layer_norm/temporal",
        "ln_bwd/spatial-long", "ln_bwd/spatial-short", "ln_bwd/temporal", "ln_bwd/ff-bwd",
        "attention/spatial-long", "attention/spatial-short", "attention/temporal",
        "attention_bwd/spatial-long", "attention_bwd/spatial-short", "attention_bwd/temporal",
        "ln_linear/ff", "linear_residual/ff", "ff_bwd/ff", "gn_silu_conv3/emb",
        "gn_silu_conv3/res", "gn_silu/emb", "gn_silu/res", "conv3/emb-dx", "conv3/res-dx"])
    if missing:
        raise SystemExit(f"kernels or call sites never launched on the train path: {missing}")
    changed = [n for n, m in trainer.master.items() if not torch.equal(m, start[n])]
    ema_moved = [n for n, e in trainer.ema.items() if not torch.equal(e, start[n])]
    now = {f"unet.{n}": p for n, p in engine.unet.named_parameters()}
    for name in ("encoder", "conditioner"):
        now.update({f"{name}.{n}": p for n, p in getattr(engine, name).named_parameters()})
    moved_frozen = [n for n, p in frozen.items() if not torch.equal(p, now[n].cpu())]
    log(f"  adapters changed: {len(changed)} of {len(start)}; EMA moved: {len(ema_moved)}; "
        f"frozen tensors changed: {len(moved_frozen)} of {len(frozen)}")
    if len(changed) < len(start) // 2 or not ema_moved or moved_frozen:
        raise SystemExit("the optimizer step touched the wrong tensors")
    del frozen, start

    prof = _device_profile("train_step", lambda: trainer(
        batch, draw_train(engine, tcfg, batch, gen))) if profile else None
    modes = remat_modes_run(engine, trainer, tcfg, batch, gen, sites, TRAIN_STEPS, (320, 576),
                            "phase 2", tuple(REMAT_MODES), 1)
    OUT.mkdir(exist_ok=True)
    (OUT / "train.json").write_text(json.dumps(dict(
        card=CARD, steps=steps, s_per_step=s_step, peak_gib=peak, launches=sites,
        profile=prof, remat_modes={name: {k: v for k, v in m.items() if k != "launches"}
                                   for name, m in modes.items()}), indent=1))
    return {"train": launches, **{f"train_{name}": m["launches"]
                                  for name, m in modes.items() if name != "full"}}


# ---------------------------------------------------------------- phase 7

# the train CLI's run: three steps, then one more after the resume
TRAIN_CLI_CONFIG = "vista_phase2_stage2.yaml"
TRAIN_CLI_ARGS = ["run.max_steps=3", "run.log_every=1", "run.val_every=3", "run.val_batches=1",
                  "run.image_log_steps=5", "run.ckpt_every=1000000",
                  "data.samples_per_epoch=64"]
TRAIN_CLI_IMAGE_STEPS = (1, 2, 4)  # the powers of two under image_log_every (1000)
# the sampling call sites of an image log: the UNet of phase 2 has LoRA, whose
# self-attentions take layer_norm and the attention route, not ln_linear/qkv
LORA_SAMPLE_SITES = tuple(s for s in SAMPLE_SITES if s != "ln_linear/qkv") + (
    "layer_norm/spatial-long", "layer_norm/spatial-short", "layer_norm/temporal")
TRAIN_SITES = (
    "layer_norm/spatial-long", "layer_norm/spatial-short", "layer_norm/temporal",
    "ln_bwd/spatial-long", "ln_bwd/spatial-short", "ln_bwd/temporal", "ln_bwd/ff-bwd",
    "attention/spatial-long", "attention/spatial-short", "attention/temporal",
    "attention_bwd/spatial-long", "attention_bwd/spatial-short", "attention_bwd/temporal",
    "ln_linear/ff", "linear_residual/ff", "ff_bwd/ff", "gn_silu_conv3/emb",
    "gn_silu_conv3/res", "gn_silu/emb", "gn_silu/res", "conv3/emb-dx", "conv3/res-dx")


def write_clips(root, seed):
    """A small on-disk dataset in both layouts of the phase-2 recipe, made
    with PIL from the seed: 2 OpenDV-style folders of 25 zero-padded JPEG
    frames at 1280x960 (4:3, so the crop to 16:9 runs), and 25 JPEG frames
    at the nuScenes camera's 1600x900 shared by 4 annotations (trajectory,
    command, speed, angle, goal with z; the last one's goal invalid). Returns
    the overlay config that points the recipe's sources at them."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)

    def frame(w, h, path):
        base = rng.randint(0, 256, (h // 16, w // 16, 3), np.uint8)
        Image.fromarray(base).resize((w, h), Image.BILINEAR).save(path, quality=90)

    opendv, nusc = root / "opendv", root / "nuscenes"
    for v in range(2):
        (opendv / f"video{v}").mkdir(parents=True)
        for i in range(25):
            frame(1280, 960, opendv / f"video{v}" / f"{i:09d}.jpg")
    (nusc / "CAM_FRONT").mkdir(parents=True)
    rel = [f"CAM_FRONT/{i:03d}.jpg" for i in range(25)]
    for r in rel:
        frame(1600, 900, nusc / r)
    annos = [dict(frames=rel, traj=rng.randn(10).tolist(), cmd=int(i % 4),
                  speed=(5 + rng.rand(5)).tolist(), angle=(100 * rng.randn(5)).tolist(),
                  goal=[float(rng.randint(1, 1600)), float(rng.randint(1, 900))],
                  z=(1.0 if i < 3 else -1.0)) for i in range(4)]
    (root / "opendv.json").write_text(json.dumps(
        [{"folder": f"video{v}", "first_frame": 0} for v in range(2)]))
    (root / "nuscenes.json").write_text(json.dumps(annos))
    overlay = {"data": {"sources": [
        {"kind": "youtube", "prob": 1.0, "anno_file": str(root / "opendv.json"),
         "data_root": str(opendv)},
        {"kind": "nuscenes", "prob": 1.0, "anno_file": str(root / "nuscenes.json"),
         "data_root": str(nusc)}]}}
    path = root / "overlay.yaml"
    path.write_text(json.dumps(overlay))  # JSON text is YAML
    return path


# Adam's second moment past which a tensor's gradient sets its update
# (sqrt(nu) >> eps = 1e-8): the LoRA down-projections' gradients scale with
# the up-projections, which start at zero, and read about 1e-13 (nu 1e-26)
# over the first updates, so their masters do not move yet
ADAM_NU_FLOOR = 1e-12


def runner_sums(runner):
    """Bit hashes (``checksums``) of a runner's state: every frozen tensor
    (the UNet's base, the encoder, the decoder, the conditioner) and each
    group of the trainer's state, plus its two counts."""
    trainer = runner.trainer
    frozen = [t for name, module in runner._modules().items()
              for n, t in module.state_dict().items()
              if not (name == "unet" and n in trainer.params)]
    state = trainer.state_dict()
    out = {"frozen": checksums(frozen), "step": state["step"], "updates": state["updates"]}
    for group in ("master", "mu", "nu", "ema", "acc"):
        out[group] = checksums(state[group].values()) if state[group] else torch.zeros(0)
    # a gradient past Adam's eps: its update is about lr x schedule an element
    out["with_grad"] = torch.stack([n.max() > ADAM_NU_FLOOR for n in state["nu"].values()]).cpu()
    return out


def train_cli_run(seed, then=None):
    """The phase-2 stage-2 recipe (configs/vista_phase2_stage2.yaml: LoRA +
    action control at 576x1024, 25 frames, batch 1, remat, dynamics loss,
    the recipe's warm-up) through ``vista_tpu_torch.cli.train.main`` from
    JPEG clips on disk and the modules' own initialisation: three steps with
    validation and image logs, then ``--resume`` for a fourth. ``then(ckpt,
    tmp)`` runs as the phase "convert" on the final checkpoint before the
    temporary directory goes. Returns the launch counts of both."""
    import csv
    import tempfile

    from vista_tpu_torch import runner as runner_mod
    from vista_tpu_torch.cli import train as train_cli
    from vista_tpu_torch.data import native
    from vista_tpu_torch.ops import _build

    tmp = Path(tempfile.mkdtemp(prefix="vista_train_cli_"))
    Runner = runner_mod.Runner
    from vista_tpu_torch.engine.engine import VistaEngine

    # the image logs split: sampling, decodes and the files written
    times = StageTimes([(Runner, ("validate", "save_checkpoint", "resume")),
                        (VistaEngine, ("sample", "decode_first_stage")),
                        (runner_mod, ("save_video_mp4", "save_grid_png"))])
    fit, log_images = Runner.fit, Runner.log_images
    runs, image_sites, image_s, failures = [], [], [], []

    def probed_fit(self):
        runs.append({"start": runner_sums(self)})
        out = fit(self)
        runs[-1].update(end=runner_sums(self), step_times=list(self.step_times),
                        step=self.trainer.step)
        return out

    def probed_log_images(self, batch):
        before = dict(_build.SITES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            log_images(self, batch)
        except Exception as e:  # the runner prints it and trains on; the phase fails
            failures.append((self.trainer.step, repr(e)))
            raise
        torch.cuda.synchronize()
        image_sites.append({k: v - before.get(k, 0) for k, v in _build.SITES.items()})
        image_s.append(time.perf_counter() - t0)

    try:
        t0 = time.perf_counter()
        n_frames = recipe(TRAIN_CLI_CONFIG)[0].num_frames
        overlay = write_clips(tmp, seed)
        write_s = time.perf_counter() - t0
        logdir = tmp / "run"
        # the overrides first: ``--base`` takes every path after it
        overrides = [f"run.logdir={logdir}", *TRAIN_CLI_ARGS]
        base = ["--base", str(CONFIGS / TRAIN_CLI_CONFIG), str(overlay)]
        argv = overrides + base
        Runner.fit, Runner.log_images = probed_fit, probed_log_images
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        runner = train_cli.main(argv)
        first_s = time.perf_counter() - t0
        peak1 = torch.cuda.max_memory_allocated() / 2**30
        calls1 = [(k, s) for k, s, _ in times.take()]
        csv1 = (logdir / "metrics.csv").read_text()
        n_train = sum(m.numel() for m in runner.trainer.master.values())
        del runner
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = train_cli.main(overrides + ["run.max_steps=4", "--resume",
                                             str(logdir / "checkpoints" / "last")] + base)
        second_s = time.perf_counter() - t0
        peak2 = torch.cuda.max_memory_allocated() / 2**30
        calls2 = [(k, s) for k, s, _ in times.take()]
        del runner
        launches, sites = dict(_build.LAUNCHES), dict(_build.SITES)
        csv2 = (logdir / "metrics.csv").read_text()
        ckpt_bytes = (logdir / "checkpoints" / "last").stat().st_size
        images = sorted(p.name for p in (logdir / "images").iterdir())
        videos = {step: [logdir / "images" / n for n in images
                         if n.startswith(f"sample_{step:08d}.") and not n.endswith(".png")]
                  for step in TRAIN_CLI_IMAGE_STEPS}
        frames = {step: [video_frames(p) for p in v] for step, v in videos.items()}
        gc.collect()
        torch.cuda.empty_cache()
        converted = None
        if then:  # its own counts; this path's are put back for the checks below
            counts = dict(_build.LAUNCHES), dict(_build.SITES)
            converted = phase("convert", then, logdir / "checkpoints" / "last", tmp)
            _build.reset_counts()
            _build.LAUNCHES.update(counts[0])
            _build.SITES.update(counts[1])
    finally:
        times.close()
        Runner.fit, Runner.log_images = fit, log_images
        shutil.rmtree(tmp, ignore_errors=True)  # the checkpoint alone is about 5 GB
        gc.collect()
        torch.cuda.empty_cache()

    faults = []
    first, second = runs
    # the CSV: train rows 1-4, one val row at step 3, appended on resume
    rows = list(csv.DictReader(csv2.splitlines()))
    header = csv2.splitlines()[0].split(",")
    train_rows = [r for r in rows if r["loss"]]
    val_rows = [r for r in rows if r.get("val_loss")]
    losses = [float(r["loss"]) for r in train_rows] + [float(r["val_loss"]) for r in val_rows]
    train_keys = {"loss", "loss_main", "loss_hf", "sigma_mean", "steps_per_sec",
                  "grad_norm_trained"}
    if [int(r["step"]) for r in train_rows] != [1, 2, 3, 4]:
        faults.append(f"train rows at steps {[r['step'] for r in train_rows]}, not 1-4")
    if [int(r["step"]) for r in val_rows] != [3]:
        faults.append(f"val rows at steps {[r['step'] for r in val_rows]}, not 3")
    if not train_keys <= set(header) or "grad_norm" in header:
        faults.append(f"CSV header {header} lacks {sorted(train_keys - set(header))} or names "
                      "grad_norm under lora_only")
    if not all(r[k] for r in train_rows for k in train_keys):
        faults.append("a train row lacks a value")
    if "val_loss" not in header or header.index("val_loss") < max(
            header.index(k) for k in train_keys if k in header):
        faults.append(f"the val columns do not follow the train columns: {header}")
    if not csv2.startswith(csv1):
        faults.append("the resumed run rewrote the CSV instead of appending to it")
    if not all(math.isfinite(v) for v in losses):
        faults.append(f"non-finite losses: {losses}")
    # images: steps 1, 2 and 4 each wrote a sample, an input and a recon grid
    # and a 25-frame video
    for step in TRAIN_CLI_IMAGE_STEPS:
        missing = [f"{kind}_{step:08d}.png" for kind in ("sample", "input", "recon")
                   if f"{kind}_{step:08d}.png" not in images]
        if missing or frames[step] != [n_frames]:
            faults.append(f"step {step}: images missing {missing} or video frames {frames[step]}")
    if failures:
        faults.append(f"image logs failed: {failures}")
    # frozen tensors bit-identical through both runs; adapters and EMA moved
    if not torch.equal(first["end"]["frozen"], first["start"]["frozen"]) or not torch.equal(
            second["end"]["frozen"], first["start"]["frozen"]):
        faults.append("a frozen tensor changed")
    with_grad = first["end"]["with_grad"]
    moved = first["end"]["master"] != first["start"]["master"]
    ema_moved = first["end"]["ema"] != first["start"]["ema"]
    if not bool(with_grad.any()) or bool((with_grad & ~moved).any()) or bool(
            (moved & ~ema_moved).any()):
        faults.append(f"of {len(moved)} trained tensors, {int(with_grad.sum())} had a gradient "
                      f"past Adam's eps, "
                      f"{int(moved.sum())} masters and {int(ema_moved.sum())} EMAs moved")
    # the resume restored the saved state bit for bit and took one step more
    restored, saved = second["start"], first["end"]
    same = [g for g in ("master", "mu", "nu", "ema", "acc", "frozen")
            if torch.equal(restored[g], saved[g])]
    if len(same) != 6 or (restored["step"], restored["updates"]) != (3, 3):
        faults.append(f"the resumed state differs from the saved one: equal {same}, step "
                      f"{restored['step']}, updates {restored['updates']}")
    if second["step"] != 4 or len(second["step_times"]) != 1:
        faults.append(f"the resumed run ended at step {second['step']} after "
                      f"{len(second['step_times'])} steps")
    # every kernel and call site of the train path; each image log's sampling sites
    missing = missing_launches(TRAIN_KERNELS + ATTENTION_ROUTES + ATTENTION_BWD_ROUTES,
                               TRAIN_SITES)
    if missing:
        faults.append(f"kernels or call sites never launched on the train CLI's path: {missing}")
    for i, logged in enumerate(image_sites):
        missing = [k for k in LORA_SAMPLE_SITES if logged.get(k, 0) == 0]
        if missing:
            faults.append(f"image log {i} never launched {missing}")
    if len(image_sites) != len(TRAIN_CLI_IMAGE_STEPS):
        faults.append(f"{len(image_sites)} image logs, not {len(TRAIN_CLI_IMAGE_STEPS)}")

    steps = first["step_times"] + second["step_times"]
    secs = lambda calls, name: [s for k, s in calls if k == name]
    logged = {"sampling": sum(secs(calls1 + calls2, "sample")),
              "decodes": sum(secs(calls1 + calls2, "decode_first_stage")),
              "files": sum(s for k, s in calls1 + calls2
                            if k in ("save_video_mp4", "save_grid_png"))}
    logged["else"] = sum(image_s) - sum(logged.values())
    result = dict(
        card=CARD, argv=argv, trained_params=n_train,
        decoder="native" if native.available() else "PIL", write_clips_s=write_s,
        s_per_step=sum(s for _, s in steps[1:3]) / 2, step_s=[s for _, s in steps],
        data_wait_s=[w for w, _ in steps],
        validate_s=secs(calls1, "validate"), log_images_s=image_s, log_images_split_s=logged,
        save_s=secs(calls1 + calls2, "save_checkpoint"), load_s=secs(calls2, "resume"),
        checkpoint_bytes=ckpt_bytes, first_run_s=first_s, resumed_run_s=second_s,
        peak_gib=[peak1, peak2], csv=csv2, launches=sites, image_log_sites=image_sites)
    log(f"  phase-2 stage-2 through the train CLI at 576x1024 ({n_train / 1e6:.1f} M trained "
        f"params, LoRA + action, warm-up 1000): {result['s_per_step']:.3f} s/step (steps 2-3; "
        f"steps {', '.join(f'{s:.3f}' for s in result['step_s'])} s), waiting on the pipeline "
        f"{', '.join(f'{w:.3f}' for w in result['data_wait_s'])} s; JPEG decoder: "
        f"{result['decoder']}")
    log(f"  validate {', '.join(f'{s:.3f}' for s in result['validate_s'])} s; image logs "
        f"{', '.join(f'{s:.3f}' for s in result['log_images_s'])} s (over the "
        f"{len(image_s)}: {', '.join(f'{k} {v:.3f}' for k, v in logged.items())} s); checkpoint "
        f"{ckpt_bytes / 1e9:.3f} GB saved in {', '.join(f'{s:.3f}' for s in result['save_s'])}"
        f" s, loaded in {', '.join(f'{s:.3f}' for s in result['load_s'])} s; runs "
        f"{first_s:.3f} + {second_s:.3f} s (clips written in {write_s:.3f} s); peak "
        f"{peak1:.2f} / {peak2:.2f} GiB; card {CARD}")
    log(f"  losses {', '.join(f'{v:.5f}' for v in losses)}; adapters with a gradient past "
        f"Adam's eps "
        f"{int(with_grad.sum())} of {len(with_grad)}, masters moved {int(moved.sum())}, EMA "
        f"moved {int(ema_moved.sum())}; restored state equal in {same}")
    log(f"    launches by site: {json.dumps(sites, sort_keys=True)}")
    OUT.mkdir(exist_ok=True)
    (OUT / "train_cli.json").write_text(json.dumps(result, indent=1))
    if faults:
        raise SystemExit("train CLI: " + "; ".join(faults))
    return {"train_cli": launches, "convert": converted}


# ---------------------------------------------------------------- phase 8

PHASE1_MICRO_STEPS = 4  # two optimizer steps at accum_steps = 2


def phase1_cfg():
    """configs/vista_phase1.yaml: the engine and the train recipe."""
    return recipe("vista_phase1.yaml")


def phase1_batch(h, w, frames, gen, device):
    """Synthetic clip in [-1, 1] and its conditioning scalars (no actions)."""
    batch = train_batch(h, w, frames, gen, device)
    return {k: batch[k] for k in ("frames", "fps_id", "motion_bucket_id", "cond_aug")}


# Per UNet tensor, |card - cpu|_2 / max(|cpu|_2, floor). bf16 alone (the
# same step in bf16 on the CPU) reads up to 5.9e-2 on the worst tensor and
# the card up to 6.2e-2 (the temporal q/k weights and a time-mixer scalar);
# dWq and dWk swapped at one site read about 1.4 (``phase1_reference``
# checks that).
PHASE1_GRAD_TOL = 0.15
PHASE1_GRAD_FLOOR = 1e-3  # the floor, as a share of the largest tensor's |cpu|_2


def grad_errors(g, g_ref):
    """Each tensor's error against its own size: the L2 norm of the
    difference over the reference's L2 norm, with a floor of
    ``PHASE1_GRAD_FLOOR`` times the largest reference norm so that a tensor
    whose gradient all but cancels is not held to its own rounding. A
    swapped or garbage gradient reads about 1 or more."""
    norms = {n: float(t.norm()) for n, t in g_ref.items()}
    floor = PHASE1_GRAD_FLOOR * max(norms.values())
    return {n: float((g[n].float() - t).norm()) / max(norms[n], floor)
            for n, t in g_ref.items()}


def phase1_reference(seed):
    """The phase-1 step at a small size (64x64, 5 frames; the recipe's
    optimizer without its warm-up) through :func:`small_step_reference`."""
    _, train = phase1_cfg()
    train = dataclasses.replace(train, warmup_steps=0,
                                loss=dataclasses.replace(train.loss, num_frames=5))
    gen = torch.Generator().manual_seed(seed + 1)
    batch = phase1_batch(64, 64, 5, gen, "cpu")
    small_step_reference("small phase-1", small_cfg("phase1"), train, batch, gen, seed,
                         "phase1_reference.json")


def small_step_reference(label, cfg, train, batch, gen, seed, out_name):
    """Two micro-steps of ``train`` on the fp32 engine of ``cfg`` at the
    shapes of ``batch`` (on the CPU; draws from ``gen``), on the card in
    bf16 against the same weights, batch and draws on the CPU in fp32 (no
    TF32 there): the loss and every UNet gradient of each micro-step, each
    tensor against its own size (:func:`grad_errors`). The control is the
    same step in bf16 on the CPU through the plain versions: the error that
    bf16 alone makes, with no kernel in the run. Returns the kernels, routes
    and call sites the card's micro-steps launched."""
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.engine.training import Trainer, draw_train
    from vista_tpu_torch.ops import _build

    cpu = VistaEngine(cfg, "cpu")
    init_engine(cpu, torch.Generator().manual_seed(seed))
    gpu = card_twin(cpu, cfg)
    control = VistaEngine(to_bf16(cfg), "cpu")
    for name in ("unet", "decoder", "encoder", "conditioner"):
        getattr(control, name).load_state_dict(getattr(cpu, name).state_dict())
    draws = [draw_train(cpu, train, batch, gen) for _ in range(2)]
    out = {}
    for name, engine in (("cpu", cpu), ("card", gpu), ("control", control)):
        dev = engine.device
        trainer = Trainer(engine, train)
        out[name] = []
        _build.reset_counts()
        for d in draws:
            loss, _ = trainer.loss_and_grads({k: v.to(dev) for k, v in batch.items()},
                                             move_draws(d, dev))
            out[name].append((float(loss), {n: g.cpu() for n, g in trainer.grads().items()}))
            trainer.apply()
        if name == "card":
            launched = {**_build.LAUNCHES, **_build.SITES}
    ok, readings = True, []
    labels = dict(card="bf16 kernels on the card", control="bf16 plain on the CPU")
    for i, (loss_ref, g_ref) in enumerate(out["cpu"]):
        reading = dict(micro_step=i)
        for name in ("card", "control"):
            loss, g = out[name][i]
            errs = grad_errors(g, g_ref)
            worst = max(errs, key=errs.get)
            rel_loss = abs(loss - loss_ref) / abs(loss_ref)
            reading[name] = dict(rel_loss=rel_loss, worst=errs[worst], worst_tensor=worst,
                                 median=sorted(errs.values())[len(errs) // 2])
            log(f"  {label} micro-step {i}, {labels[name]} vs fp32 on the CPU: loss "
                f"rel {rel_loss:.3e}; per UNet tensor ({len(g)}), "
                f"|diff|_2 / |cpu|_2 (floor {PHASE1_GRAD_FLOOR} of the largest): worst "
                f"{errs[worst]:.3e} ({worst}), median {reading[name]['median']:.3e} "
                f"(limit {PHASE1_GRAD_TOL})")
        # the check's own test: the card's dWq and dWk swapped at the last
        # temporal self-attention must fail it
        g = out["card"][i][1]
        q = [n for n in g if n.endswith("time_stack.0.attn1.to_q.weight")][-1]
        k = q.replace("to_q", "to_k")
        swapped = grad_errors({**g, q: g[k], k: g[q]}, g_ref)
        reading["swapped"] = dict(tensor=q, q=swapped[q], k=swapped[k])
        log(f"  the same check with the card's dWq and dWk swapped ({q}): {swapped[q]:.3e} "
            f"and {swapped[k]:.3e} (must exceed {PHASE1_GRAD_TOL})")
        readings.append(reading)
        card = reading["card"]
        ok &= card["rel_loss"] <= TRAIN_TOL and card["worst"] <= PHASE1_GRAD_TOL
        ok &= min(swapped[q], swapped[k]) > PHASE1_GRAD_TOL
    OUT.mkdir(exist_ok=True)
    (OUT / out_name).write_text(json.dumps(dict(card=CARD, readings=readings,
                                                launches=launched), indent=1))
    if not ok:
        raise SystemExit(f"the {label} step disagrees with the CPU reference")
    return launched


_HASH_P = 2 ** 31 - 1  # a prime: every product below stays under 2^62


def checksums(tensors):
    """One hash of the raw bits per tensor (one host sync): the sum mod p of
    each element's bits times a weight drawn from its index (Knuth's
    multiplicative hash), so a change of any value changes it except with
    probability about 1/p = 5e-10. A plain sum of the bits cancels far more
    often: the EMA of a GroupNorm weight that moved in 1279 of its 1280
    elements summed to the same value."""
    out = []
    for t in tensors:
        word = {2: torch.int16, 4: torch.int32}[t.element_size()]
        bits = t.reshape(-1).view(word).to(torch.int64) % _HASH_P
        w = torch.arange(bits.numel(), device=t.device, dtype=torch.int64) * 2654435761 % _HASH_P
        out.append((bits * (w + 1) % _HASH_P).sum())
    return torch.stack(out).cpu()


def phase1_run(seed, profile=False):
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.engine.training import Trainer, draw_train
    from vista_tpu_torch.ops import _build

    phase("phase1-reference", phase1_reference, seed)
    torch.cuda.empty_cache()
    log(f"  device memory held before the full-width phase-1 engine: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    cfg, tcfg = phase1_cfg()
    # The recipe's 1000-step warm-up scales the first updates by 1e-6 and
    # 1e-3: too small for most fp32 masters to change, so the checks below
    # could not see the updates. The run takes the full rate from update 0;
    # the work per step is the same.
    tcfg = dataclasses.replace(tcfg, warmup_steps=0)
    engine = VistaEngine(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    init_engine(engine, gen)
    trainer = Trainer(engine, tcfg)
    names = list(trainer.master)
    n_train = sum(m.numel() for m in trainer.master.values())
    log(f"  phase-1 engine: VideoUNet {n_train / 1e9:.3f} B params, all trained "
        f"(slow_spatial), CLIP ViT-H, VAE encoder; bf16, seeded random weights, remat, "
        f"accum_steps {tcfg.accum_steps} ({time.perf_counter() - t0:.1f} s)")
    frozen = {f"{name}.{n}": p.detach().cpu() for name in ("encoder", "conditioner")
              for n, p in getattr(engine, name).named_parameters()}
    batch = phase1_batch(576, 1024, 25, gen, "cuda")
    apply_s = []
    apply = trainer.apply

    def timed_apply(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = apply(*args)
        torch.cuda.synchronize()
        apply_s.append(time.perf_counter() - t)
        return out

    trainer.apply = timed_apply
    ema_start = checksums(trainer.ema.values())
    steps, faults = [], []
    with_moment = torch.zeros(len(names), dtype=torch.bool)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    for i in range(PHASE1_MICRO_STEPS):
        applying = (i + 1) % tcfg.accum_steps == 0
        before = checksums(trainer.master.values())
        # Which tensors the ucg dropout and the one-token cross-attentions
        # leave without a gradient depends on the draws: keep the masters of
        # those whose accumulated gradient is still zero before an applying
        # call, to hold them to the weight decay alone if it stays zero.
        held = {}
        if applying:
            zero = torch.stack([a.abs().max() == 0 for a in trainer.acc.values()]).cpu()
            held = {n: trainer.master[n].clone() for n, z in zip(names, zero) if z}
        draws = draw_train(engine, tcfg, batch, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = trainer(batch, draws)
        torch.cuda.synchronize()
        m["seconds"] = time.perf_counter() - t1
        m["apply_s"] = apply_s[-1]
        steps.append(m)
        moved = checksums(trainer.master.values()) != before
        if not applying and bool(moved.any()):
            faults.append(f"micro-step {i} applies nothing, but {int(moved.sum())} tensors moved")
        if applying:
            # Adam's first moment is non-zero exactly where a gradient has been
            with_moment = torch.stack([(mu != 0).any() for mu in trainer.mu.values()]).cpu()
            still = [n for n, mv, g in zip(names, moved, with_moment) if g and not mv]
            if still:
                faults.append(f"micro-step {i}: {len(still)} trained tensors with a gradient "
                              f"did not move, e.g. {still[:3]}")
            for n, g in zip(names, with_moment):
                if g:
                    continue
                old = held.get(n)
                limit = None if old is None else (
                    tcfg.learning_rate * trainer.mults[n] * tcfg.weight_decay
                    + 2.0 ** -23) * float(old.abs().max())
                if old is None or float((trainer.master[n] - old).abs().max()) > limit:
                    faults.append(f"micro-step {i}: {n} has no gradient but moved by more "
                                  f"than its weight decay")
        log(f"  micro-step {i}{' (applies)' if applying else ''}: loss {m['loss']:.5f} (main "
            f"{m['loss_main']:.5f}, hf {m['loss_hf']:.5f}), grad norm {m['grad_norm']:.4e}, "
            f"sigma {m['sigma_mean']:.3f}: {m['seconds']:.3f} s (optimizer {m['apply_s']:.3f} "
            f"s); {int(moved.sum())} of {len(names)} tensors moved"
            + (f", {int(with_moment.sum())} with a gradient so far" if applying else ""))
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise SystemExit(f"phase 1: micro-step {i} is not finite: {m}")
        del held
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, sites = dict(_build.LAUNCHES), dict(_build.SITES)
    k = tcfg.accum_steps
    s_micro = sum(m["seconds"] for m in steps[k:]) / (len(steps) - k)
    s_opt = sum(m["seconds"] for m in steps[-k:])
    opt_share = sum(m["apply_s"] for m in steps[-k:]) / s_opt
    log(f"  phase 1 at 576x1024: {s_micro:.3f} s per micro-step and {s_opt:.3f} s per "
        f"optimizer step (the second; the first {sum(m['seconds'] for m in steps[:k]):.3f} s), "
        f"optimizer loop {100 * opt_share:.1f}% of it; peak {peak:.2f} GiB; card {CARD}")
    log(f"  launches over the {len(steps)} micro-steps: {json.dumps(sites, sort_keys=True)}")
    ema_moved = checksums(trainer.ema.values()) != ema_start
    ema_still = [n for n, mv, g in zip(names, ema_moved, with_moment) if g and not mv]
    now = {f"{name}.{n}": p for name in ("encoder", "conditioner")
           for n, p in getattr(engine, name).named_parameters()}
    moved_frozen = [n for n, p in frozen.items() if not torch.equal(p, now[n].cpu())]
    log(f"  {int(with_moment.sum())} of {len(names)} tensors had a gradient (the others: the "
        f"one-token cross-attentions' q/k and norm2); EMA moved for {int(ema_moved.sum())}; "
        f"encoder and conditioner tensors changed: {len(moved_frozen)} of {len(frozen)}")
    if ema_still:
        faults.append(f"the EMA of {len(ema_still)} trained tensors did not move")
    if moved_frozen:
        faults.append(f"frozen tensors changed: {moved_frozen[:3]}")
    missing = missing_launches(PHASE1_KERNELS + ATTENTION_ROUTES + ATTENTION_BWD_ROUTES, [
        "qkv_bwd/spatial-long", "qkv_bwd/spatial-short", "qkv_bwd/temporal",
        "ln_bwd/spatial-long-qkv-bwd", "ln_bwd/spatial-short-qkv-bwd", "ln_bwd/temporal-qkv-bwd",
        "ln_bwd/ff-bwd", "linear_residual_bwd/attn-out", "linear_residual_bwd/temporal-out",
        "ln_linear/qkv", "ln_linear/temporal-qkv", "linear_residual/attn-out",
        "linear_residual/temporal-out",
        "attention/spatial-long", "attention/spatial-short", "attention/temporal",
        "attention_bwd/spatial-long", "attention_bwd/spatial-short", "attention_bwd/temporal",
        "ln_linear/ff", "linear_residual/ff", "ff_bwd/ff", "gn_silu_conv3/emb",
        "gn_silu_conv3/res", "gn_silu/emb", "gn_silu/res", "conv3/emb-dx", "conv3/res-dx",
        "conv3/res-y"])
    if missing:
        faults.append(f"kernels or call sites never launched on the phase-1 path: {missing}")
    if faults:
        raise SystemExit("phase 1: " + "; ".join(faults))
    del frozen
    trainer.apply = apply
    prof = _device_profile("phase1_optimizer_step", lambda: [
        trainer(batch, draw_train(engine, tcfg, batch, gen)) for _ in range(k)]) \
        if profile else None
    modes = remat_modes_run(engine, trainer, tcfg, batch, gen, sites, PHASE1_MICRO_STEPS,
                            (576, 1024), "phase 1", PHASE1_TIMED_MODES, 2)
    OUT.mkdir(exist_ok=True)
    (OUT / "phase1.json").write_text(json.dumps(dict(
        card=CARD, micro_steps=steps, s_per_micro_step=s_micro, s_per_optimizer_step=s_opt,
        optimizer_share=opt_share, peak_gib=peak, launches=sites, profile=prof,
        remat_modes={name: {k: v for k, v in m.items() if k != "launches"}
                     for name, m in modes.items()}), indent=1))
    del engine, trainer
    torch.cuda.empty_cache()
    return {"phase1": launches, **{f"phase1_{name}": m["launches"]
                                   for name, m in modes.items() if name != "full"}}


# Selective checkpointing: on the phase-1 engine and on the phase-2 one
# (LoRA), each mode's micro-step from the state, batch and draws of a
# full-remat one, and optimizer steps of the timed modes. ``remat_max_ds: 1``
# stores every ds2-ds8 block (see PERF.md).
REMAT_MODES = {"full": {}, "remat_max_ds_2": dict(remat_max_ds=2),
               "names": dict(remat_policy="names"), "dots": dict(remat_policy="dots"),
               "remat_max_ds_1": dict(remat_max_ds=1),
               "names_remat_max_ds_1": dict(remat_policy="names", remat_max_ds=1)}
# phase 1 times two optimizer steps of these modes in turns; the last mode
# is compared only
PHASE1_TIMED_MODES = ("full", "remat_max_ds_2", "names", "dots", "remat_max_ds_1")
# a SpatialVideoTransformer's forward launches by site (a spatial site is
# spatial-long from 2048 keys); "names" tags: K1's (o, lse), the three
# feed-forwards and the temporal self-attention (K2 + K1 + K3)
REMAT_ATTN_SITES = {"ln_linear/qkv": (1, False), "attention/spatial": (1, True),
                    "linear_residual/attn-out": (1, False), "ln_linear/ff": (3, True),
                    "linear_residual/ff": (3, True), "ln_linear/temporal-qkv": (1, True),
                    "attention/temporal": (1, True), "linear_residual/temporal-out": (1, True)}
# with LoRA the self-attentions take the layer_norm kernel and K1 and leave
# the products to PyTorch; "names" keeps the LoRA out-projection (no
# kernel), so only the feed-forwards' K2 and K3 run once
REMAT_LORA_ATTN_SITES = {"layer_norm/spatial": (1, False), "attention/spatial": (1, False),
                         "ln_linear/ff": (3, True), "linear_residual/ff": (3, True),
                         "layer_norm/temporal": (1, False), "attention/temporal": (1, False)}
# a VideoResBlock's: K4 twice, each a pre-pass and a conv; no tag
REMAT_RES_SITES = {"gn_silu_conv3/emb": (1, False), "gn_silu_conv3/res": (1, False),
                   "gn_silu/emb": (1, False), "gn_silu/res": (1, False)}


def unet_blocks(cfg):
    """(kind, ds) of every VideoResBlock ("res") and SpatialVideoTransformer
    ("attn") in the order the UNet runs them, from the config alone: the
    JAX package's ds bookkeeping (``vista_tpu/models/unet.py``)."""
    out, ds, levels = [], 1, len(cfg.channel_mult)
    for level in range(levels):
        for _ in range(cfg.num_res_blocks):
            out += [("res", ds)] + ([("attn", ds)] if ds in cfg.attention_resolutions else [])
        ds *= 2 if level != levels - 1 else 1
    out += [("res", ds), ("attn", ds), ("res", ds)]
    for level in reversed(range(levels)):
        for i in range(cfg.num_res_blocks + 1):
            out += [("res", ds)] + ([("attn", ds)] if ds in cfg.attention_resolutions else [])
            ds //= 2 if level != 0 and i == cfg.num_res_blocks else 1
    return out


def predicted_remat_launches(cfg, full, mode, h, w):
    """One micro-step's launches under ``mode`` from full remat's ``full``
    (kernel and kernel/site counts): full remat runs each block's forward
    twice; a block deeper than ``remat_max_ds`` runs it once, and under
    ``names`` a checkpointed block's tagged sites run once. The sites are
    the LoRA path's when ``cfg.add_lora``; a spatial K1 takes the short
    route at most ``FWD_SMALL_KEYS`` keys (the mid block at 320x576)."""
    from vista_tpu_torch.models.attention import LONG_SEQ
    from vista_tpu_torch.ops.attention import FWD_SMALL_KEYS

    attn_sites = REMAT_LORA_ATTN_SITES if cfg.add_lora else REMAT_ATTN_SITES
    out = collections.Counter(full)
    for kind, ds in unet_blocks(cfg):
        deep = mode.get("remat_max_ds") is not None and ds > mode["remat_max_ds"]
        keys = ((h // 8 // ds) * (w // 8 // ds))
        for site, (n, tag) in (attn_sites if kind == "attn" else REMAT_RES_SITES).items():
            if not (deep or (tag and mode.get("remat_policy") == "names")):
                continue
            if site.endswith("/spatial"):
                site += "-long" if keys >= LONG_SEQ else "-short"
            kernel = site.split("/")[0]
            short = site.endswith("temporal") or keys <= FWD_SMALL_KEYS
            route = [f"attention:{'short' if short else 'wgmma'}"] if kernel == "attention" else []
            for key in (site, kernel, *route):
                out[key] -= n
    return {k: v for k, v in out.items() if v}


def remat_modes_run(engine, trainer, tcfg, batch, gen, main_sites, main_steps, size, label,
                    timed, rounds):
    """Each of :data:`REMAT_MODES` on a training engine (``label``: the
    path, in the log). First one micro-step (``Trainer.loss_and_grads``, no
    update) of each from the same state, batch and draws: its loss and
    every gradient must be bit-identical to full remat's, its launches must
    equal the prediction at frames of ``size`` (full remat's: ``main_sites``
    of the path's ``main_steps`` micro-steps, per micro-step); its peak
    memory is the forward and backward's, and what the UNet's forward kept
    for the backward is the memory held after it less before it. Then
    ``rounds`` optimizer steps (``accum_steps`` micro-steps each) of every
    mode in ``timed``, in turns (the modes in order, then in reverse, ...),
    timed, with the peak over them."""
    from vista_tpu_torch.engine.training import draw_train
    from vista_tpu_torch.ops import _build

    unet, base = engine.unet, engine.unet.cfg
    draws = draw_train(engine, tcfg, batch, gen)
    out, ref, faults, held = {}, None, [], []
    hooks = [unet.register_forward_pre_hook(lambda *_: held.append(torch.cuda.memory_allocated())),
             unet.register_forward_hook(lambda *_: held.append(torch.cuda.memory_allocated()))]
    try:
        for name, mode in REMAT_MODES.items():
            unet.cfg = dataclasses.replace(base, **mode)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_counts()
            held.clear()
            loss, _ = trainer.loss_and_grads(batch, draws)
            if len(held) != 2:
                raise SystemExit(f"{label} remat modes: {len(held) // 2} UNet calls a micro-step")
            kept = (held[1] - held[0]) / 2**30
            grads = {n: p.grad for n, p in trainer.params.items() if p.grad is not None}
            got = (float(loss), list(grads), checksums(list(grads.values())))
            del grads
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches = {**_build.LAUNCHES, **_build.SITES}
            ref = ref or got
            identical = got[0] == ref[0] and got[1] == ref[1] and torch.equal(got[2], ref[2])
            want = predicted_remat_launches(base, out["full"]["launches"], mode, *size) \
                if out else {**_build.LAUNCHES, **{k: v / main_steps
                                                   for k, v in main_sites.items()}}
            wrong = {k: (launches.get(k, 0), want.get(k, 0)) for k in set(launches) | set(want)
                     if launches.get(k, 0) != want.get(k, 0)}
            out[name] = dict(mode=mode, loss=got[0], identical=identical,
                             peak_gib_micro_step=peak, unet_kept_gib=kept, launches=launches,
                             micro_s=[])
            log(f"  {label} remat {name} {mode}: loss {got[0]!r} and {len(got[1])} gradients "
                f"{'bit-identical to' if identical else 'DIFFER from'} full remat's; peak "
                f"{peak:.2f} GiB, the UNet's forward kept {kept:.2f} GiB; K1 "
                f"{launches.get('attention', 0)} (wgmma {launches.get('attention:wgmma', 0)}, "
                f"short {launches.get('attention:short', 0)}), K2 "
                f"{launches.get('ln_linear', 0)}, K3 {launches.get('linear_residual', 0)}, K4 "
                f"{launches.get('gn_silu_conv3', 0)}, layer_norm "
                f"{launches.get('layer_norm', 0)} a micro-step; "
                f"{'as predicted' if not wrong else f'NOT as predicted: {wrong}'}")
            if not identical:
                faults.append(f"{name}: the loss or a gradient differs from full remat's")
            if wrong:
                faults.append(f"{name}: launches (got, predicted) {wrong}")
        for name in [m for r in range(rounds) for m in (timed if r % 2 == 0 else timed[::-1])]:
            unet.cfg = dataclasses.replace(base, **REMAT_MODES[name])
            torch.cuda.reset_peak_memory_stats()
            for _ in range(tcfg.accum_steps):
                d = draw_train(engine, tcfg, batch, gen)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                trainer(batch, d)
                torch.cuda.synchronize()
                out[name]["micro_s"].append(time.perf_counter() - t1)
            out[name]["peak_gib"] = max(out[name].get("peak_gib", 0.0),
                                        torch.cuda.max_memory_allocated() / 2**30)
    finally:
        unet.cfg = base
        for h in hooks:
            h.remove()
    k = tcfg.accum_steps
    for name in timed:
        m = out[name]
        opt = [sum(m["micro_s"][i:i + k]) for i in range(0, len(m["micro_s"]), k)]
        m.update(s_per_micro_step=sum(m["micro_s"]) / len(m["micro_s"]),
                 s_per_optimizer_step=opt)
        log(f"  {label} remat {name}: {m['s_per_micro_step']:.3f} s per micro-step, optimizer "
            f"steps {', '.join(f'{t:.3f}' for t in opt)} s, peak {m['peak_gib']:.2f} GiB")
    log(f"  card {CARD}")
    if faults:
        raise SystemExit(f"{label} remat modes: " + "; ".join(faults))
    return out


# ---------------------------------------------------------------- phase 14

def load_tool(name):
    """``tools/<name>.py`` as a module, to run in-process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # a dataclass of the module looks it up
    spec.loader.exec_module(module)
    return module


def overfit_reference(arc, seed):
    """The arc's own engine config (``tools/torch_overfit.py``'s kernel
    widths) and its batch of both clips, 32 x 32 and 5 frames, through
    :func:`small_step_reference`: every training kernel at the arc's shapes
    held to its plain version. The arc's optimizer: its warm-up scales the
    update between the two micro-steps by 1e-6, so both compare the same
    weights (at the full lr 2e-3, Adam's first step moves every weight by
    about the rate in the direction of its gradient's sign, which bf16
    alone flips where the gradient is small)."""
    cfg = arc.engine_config(False, fp32=True)
    clips = torch.from_numpy(arc.make_clips(arc.SIDE, arc.SIDE, cfg.num_frames))
    train = arc.train_config(cfg.num_frames)
    return small_step_reference("overfit arc's", cfg, train, arc.train_batch(clips),
                                torch.Generator().manual_seed(seed + 1), seed,
                                "overfit_reference.json")


def overfit_run(seed, profile=False):
    """``tools/torch_overfit.py``'s arc in-process on the card: the JAX
    test's optimizer, sampler and margins (the loss's at fixed draws) at the
    kernel widths (the phase-1 slice's UNet, ``small_cfg("phase1")``, in
    bf16 with remat) on the JAX test's 32 x 32 clips: 400 optimizer
    steps on every UNet weight (the JAX test's 250 train its tiny engine;
    see the tool), then sampling from the EMA weights and from
    the weights before step 1, and the decode. First the arc's kernels at
    its shapes against their plain versions (:func:`overfit_reference`);
    with ``profile`` last three more steps of a new trainer, traced (the
    card's busy share; the trace of 21k launches a step adds about 45 s).
    Fails on a missed margin or check, when a training kernel never
    launched, and when the arc launched a kernel, route or site that the
    reference did not hold."""
    from vista_tpu_torch.ops import _build

    gc.collect()  # the phase-1 engine and trainer, before the peak is taken
    torch.cuda.empty_cache()
    arc = load_tool("torch_overfit")
    held = phase("overfit-reference", overfit_reference, arc, seed)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    engine = arc.build_engine(False, "cuda", seed)
    n_unet = sum(p.numel() for p in engine.unet.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    out = arc.run_arc(engine, arc.KERNEL_STEPS, seed)
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    launches, sites = dict(_build.LAUNCHES), dict(_build.SITES)
    log(f"  overfit arc: VideoUNet {n_unet / 1e6:.2f} M params (model_channels 64, head dim 64, "
        f"5 frames, remat), bf16, {arc.SIDE}x{arc.SIDE}, 2 clips, {out['steps']} steps "
        f"(lr 2e-3, warm-up 5, EMA 0.9), all UNet weights trained")
    log(f"  loss median at {arc.EVAL_DRAWS} fixed draws, before step 1 "
        f"{out['eval_before_median']:.5f} -> the EMA weights after step {out['steps']} "
        f"{out['eval_after_ema_median']:.5f}: ratio {out['eval_ratio']:.4f} (limit "
        f"{arc.LOSS_RATIO}; the online weights {out['eval_after_median']:.5f}); "
        f"the JAX test's statistic, the per-step loss median of the first {arc.WINDOW} steps "
        f"{out['loss_first_median']:.5f} -> the last {arc.WINDOW} {out['loss_last_median']:.5f}: "
        f"ratio {out['loss_ratio']:.4f} (not held: it reads the sigma draws)")
    log(f"  latent MSE from the EMA weights {out['trained_mse']:.5f} "
        f"{[round(x, 5) for x in out['trained_mses']]} vs random init {out['baseline_mse']:.5f} "
        f"{[round(x, 5) for x in out['baseline_mses']]}: ratio {out['mse_ratio']:.4f} (limit "
        f"{arc.MSE_RATIO})")
    log(f"  {out['s_per_step']:.4f} s a training step (mean of steps 11-{out['steps']}; "
        f"{out['train_s']:.2f} s for all), {out['apply_s_per_step']:.4f} s of it the optimizer "
        f"update (Trainer.apply), sampling {out['sample_s']:.3f} s and decode "
        f"{out['decode_s']:.3f} s (the EMA run: 2 clips x 10 steps, triangle CFG 2.0), peak "
        f"{peak:.2f} GiB over the {before / 2**30:.2f} GiB held before; card {CARD}")
    log(f"  launches over the arc: {json.dumps(sites, sort_keys=True)}")
    missing = missing_launches(PHASE1_KERNELS + ATTENTION_ROUTES + ATTENTION_BWD_ROUTES, [])
    unheld = sorted((set(launches) | set(sites)) - set(held))
    faults = out["faults"] + ([f"kernels never launched: {missing}"] if missing else []) + (
        [f"launched in the arc but not held at its shapes: {unheld}"] if unheld else [])
    prof = None
    if profile:  # where a step's time goes: three more steps of a new trainer
        t = engine.cfg.num_frames
        clips = torch.from_numpy(arc.make_clips(arc.SIDE, arc.SIDE, t)).cuda()
        gen = torch.Generator(device="cuda").manual_seed(seed + 13)
        prof = _device_profile("overfit_steps", lambda: arc.overfit(
            engine, arc.train_config(t), clips, 3, gen))
    OUT.mkdir(exist_ok=True)
    (OUT / "overfit.json").write_text(json.dumps(dict(
        card=CARD, **out, peak_gib=peak, launches=sites, profile=prof), indent=1))
    del engine, out
    gc.collect()
    torch.cuda.empty_cache()
    if faults:
        raise SystemExit("overfit: " + "; ".join(faults))
    return launches


# ---------------------------------------------------------------- phase 9

MODES_STEPS = 5
# full width, sequential against batched CFG: two bf16 computations of one
# function, each within bf16's own error of the fp32 result; held to this
# many times the small run's bf16-on-the-CPU error (the rollout check's rule)
MODES_BF16_RATIO = 1.5
K_NAMES = {"K1": "attention", "K2": "ln_linear", "K3": "linear_residual",
           "K4": "gn_silu_conv3", "K4 pre-pass": "gn_silu"}


def rel_err(got, ref):
    return float((got.float().cpu() - ref.float().cpu()).abs().max() / ref.float().abs().max())


def modes_reference(seed):
    """A small sampling run in the three forms (batched, sequential, churn
    with the same passed eps) on the card in bf16 against the CPU in fp32,
    each within ``SLICE_TOL``; beside them bf16 on the CPU (batched) against
    fp32, bf16's own error on this path, and on the CPU in fp32 sequential
    against batched, printed (the same function; batches of 10 and 5 frames
    block the convs' and products' sums apart)."""
    from vista_tpu_torch.diffusion.sampler import SamplerConfig
    from vista_tpu_torch.engine.engine import VistaEngine

    cfg = small_cfg()
    cpu = VistaEngine(cfg, "cpu")
    init_engine(cpu, torch.Generator().manual_seed(seed))
    gpu, cpu_bf16 = card_twin(cpu, cfg), card_twin(cpu, cfg, "cpu")
    noise, cond, uc, cf, cm, guider = requests_inputs(
        cfg, 64, 64, 5, torch.Generator().manual_seed(seed + 1), "cpu")
    eps = torch.randn(2, *noise.shape, generator=torch.Generator().manual_seed(seed + 2))
    forms = {"batched": SamplerConfig(num_steps=2, guider=guider),
             "sequential": SamplerConfig(num_steps=2, guider=guider, cfg_mode="sequential"),
             "churn": SamplerConfig(num_steps=2, guider=guider, s_churn=1.0)}
    out = {}
    for name, engine in (("cpu", cpu), ("card", gpu), ("cpu-bf16", cpu_bf16)):
        dev = engine.device
        mv = lambda d: {k: v.to(dev) for k, v in d.items()}
        for form, sampler in forms.items():
            if name == "cpu-bf16" and form != "batched":
                continue
            churn = (lambda i: eps[i].to(dev)) if form == "churn" else None
            out[name, form] = engine.sample(noise.to(dev), mv(cond), mv(uc), cf.to(dev),
                                            cm.to(dev), sampler, churn_noise=churn).cpu().float()
    errs = {f"card {form}": rel_err(out["card", form], out["cpu", form]) for form in forms}
    errs["cpu-bf16 batched"] = rel_err(out["cpu-bf16", "batched"], out["cpu", "batched"])
    errs["cpu sequential vs batched"] = rel_err(out["cpu", "sequential"], out["cpu", "batched"])
    log("  small sampling modes, card bf16 vs cpu fp32 (max-normalised): " + ", ".join(
        f"{k.split(' ')[1]} {v:.3e}" for k, v in errs.items() if k.startswith("card"))
        + f" (limit {SLICE_TOL}); bf16 on the CPU {errs['cpu-bf16 batched']:.3e}; fp32 "
        f"sequential vs batched {errs['cpu sequential vs batched']:.3e}")
    if not all(errs[f"card {f}"] <= SLICE_TOL for f in forms):
        raise SystemExit("the small sampling modes disagree with the CPU reference")
    return errs


def sampling_modes_run(seed):
    """The headline request (576x1024, 25 frames, triangle CFG 2.5) at
    ``MODES_STEPS`` steps on one noise in three forms: batched CFG,
    sequential CFG, and batched with churn (``s_churn`` 1, eps drawn on the
    card from a ``torch.Generator``)."""
    from vista_tpu_torch.diffusion.sampler import SamplerConfig
    from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
    from vista_tpu_torch.ops import _build

    small = phase("sampling_modes-reference", modes_reference, seed)
    cfg = EngineConfig()
    engine = VistaEngine(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    init_engine(engine, gen)
    noise, cond, uc, cf, cm, guider = requests_inputs(cfg, 576, 1024, 25, gen, "cuda")
    forms = {"batched": SamplerConfig(num_steps=MODES_STEPS, guider=guider),
             "sequential": SamplerConfig(num_steps=MODES_STEPS, guider=guider,
                                         cfg_mode="sequential"),
             "churn": SamplerConfig(num_steps=MODES_STEPS, guider=guider, s_churn=1.0)}
    _build.reset_counts()
    results, lats, faults = {}, {}, []
    for form, sampler in forms.items():
        churn = (torch.Generator(device="cuda").manual_seed(seed + 23) if form == "churn"
                 else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        lat = engine.sample(noise, cond, uc, cf, cm, sampler, churn_noise=churn)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_step = {k: (_build.LAUNCHES.get(n, 0) - before.get(n, 0)) / MODES_STEPS
                    for k, n in K_NAMES.items()}
        results[form] = dict(seconds=seconds, s_per_step=seconds / MODES_STEPS, peak_gib=peak,
                             launches_per_step=per_step)
        lats[form] = lat
        log(f"  {form}: {seconds:.3f} s a request of {MODES_STEPS} steps "
            f"({seconds / MODES_STEPS:.3f} s/step), peak {peak:.2f} GiB; launches a step "
            + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
        if not bool(torch.isfinite(lat).all()):
            faults.append(f"{form}: non-finite latents")
        if not torch.equal(lat[0], cf[0]):
            faults.append(f"{form}: frame 0 is not the cond frame bit for bit")
    twice = {k: results["sequential"]["launches_per_step"][k]
             == 2 * results["batched"]["launches_per_step"][k] for k in K_NAMES}
    if not all(twice.values()) or not all(results["batched"]["launches_per_step"].values()):
        faults.append(f"sequential does not launch twice batched's kernels a step: {twice}")
    seq = rel_err(lats["sequential"], lats["batched"])
    churn_moved = rel_err(lats["churn"], lats["batched"])
    limit = MODES_BF16_RATIO * small["cpu-bf16 batched"]
    log(f"  sequential vs batched: {seq:.3e} max-normalised (limit {limit:.3e}: "
        f"{MODES_BF16_RATIO} x the small run's bf16-on-the-CPU error); churn vs batched "
        f"{churn_moved:.3e}; card {CARD}")
    if not seq <= limit:
        faults.append(f"sequential disagrees with batched: {seq:.3e} > {limit:.3e}")
    if not churn_moved > 1e-3:
        faults.append(f"churn did not reach the result ({churn_moved:.3e})")
    missing = missing_launches(SAMPLE_KERNELS + ATTENTION_ROUTES, SAMPLE_SITES)
    if missing:
        faults.append(f"kernels or call sites never launched on the sampling modes: {missing}")
    launches = dict(_build.LAUNCHES)
    OUT.mkdir(exist_ok=True)
    (OUT / "sampling_modes.json").write_text(json.dumps(dict(
        card=CARD, steps=MODES_STEPS, small=small, forms=results,
        sequential_vs_batched=seq, churn_vs_batched=churn_moved, launches=launches), indent=1))
    del engine, lats, lat
    torch.cuda.empty_cache()
    if faults:
        raise SystemExit("sampling modes: " + "; ".join(faults))
    return launches


# ---------------------------------------------------------------- phase 10

CONVERT_ARGV = ["--action", "traj", "--n_rounds", "1", "--n_steps", "5",
                "--height", "576", "--width", "1024"]
# the sample CLI's round from the merged file against the runner's own
# modules (LoRA unmerged, EMA in): the same function in bf16 by two routes
# (the fused LN + q/k/v against layer_norm + the products and adapters);
# each is within bf16's own error of fp32, which the small rollout reads at
# up to 5.2e-2 (ROLLOUT_TOL's note)
CONVERT_TOL = ROLLOUT_TOL


def convert_run(ckpt, tmp):
    """The ``train_cli`` checkpoint through ``cli.convert --merge-lora`` to a
    ``.safetensors``, loaded by ``cli.sample --ckpt`` (``strict=True``) into
    the sample CLI's engine (no LoRA, action control), one round of
    ``CONVERT_ARGV`` against the same round from the runner's modules with
    LoRA unmerged and their EMA shadows in, on the same draws. The merged
    file's adapters must be gone and each trained tensor it keeps (the action
    adapters) must be its EMA shadow bit for bit."""
    import numpy as np

    from vista_tpu_torch.cli import convert as convert_cli
    from vista_tpu_torch.cli import sample as sample_cli
    from vista_tpu_torch.cli._common import build_engine
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.ops import _build
    from vista_tpu_torch.utils import checkpoint as io

    out = tmp / "vista_merged.safetensors"
    t0 = time.perf_counter()
    convert_cli.main(["--input", str(ckpt), "--output", str(out), "--merge-lora",
                      "--action-control"])
    export_s = time.perf_counter() - t0
    gb = out.stat().st_size / 1e9
    state = io.load_checkpoint(str(ckpt))
    ema = state["trainer"]["ema"]
    merged = io.load_safetensors(str(out))
    faults = []
    adapters = [k for k in merged if "adapter_down" in k or "adapter_up" in k]
    kept = [n for n in ema if "adapter_action_control" in n]
    not_ema = [n for n in kept if not np.array_equal(merged[io.UNET_PREFIX + n],
                                                     ema[n].float().numpy())]
    lora = max(float((ema[n.replace("_down", "_up")] @ ema[n]).abs().max())
               for n in ema if "_adapter_down" in n)
    if adapters or not kept or not_ema:
        faults.append(f"merged file: {len(adapters)} adapter keys left, {len(kept)} action "
                      f"adapters, {len(not_ema)} of them not their EMA shadow")
    del merged

    args = sample_cli.parse_args(CONVERT_ARGV + ["--ckpt", str(out), "--save",
                                                 str(tmp / "sample_ckpt")])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    engine = build_engine(args)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lat = sample_cli.run(args, engine)["latents"]
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    missing = missing_launches(SAMPLE_KERNELS + ATTENTION_ROUTES, SAMPLE_SITES)
    if missing:
        faults.append(f"kernels or call sites never launched from the merged file: {missing}")
    del engine
    out.unlink()  # about 10 GB

    ref_cfg = recipe(TRAIN_CLI_CONFIG)[0]
    ref = VistaEngine(ref_cfg, "cuda")
    for name in ("unet", "decoder", "encoder", "conditioner"):
        getattr(ref, name).load_state_dict(state["modules"][name])
    with torch.no_grad():
        for n, shadow in ema.items():
            ref.unet.get_parameter(n).copy_(shadow)
    del state
    ref_args = sample_cli.parse_args(CONVERT_ARGV + ["--save", str(tmp / "sample_ref")])
    ref_lat = sample_cli.run(ref_args, ref)["latents"]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    err = rel_err(lat, ref_lat)
    result = dict(card=CARD, file_gb=gb, export_write_s=export_s, build_load_s=load_s,
                  round_s=round_s, merged_vs_unmerged=err, lora_max=lora,
                  action_adapters=len(kept), launches=launches)
    log(f"  convert --merge-lora: {gb:.3f} GB written in {export_s:.3f} s (load, EMA, merge, "
        f"write); sample CLI --ckpt: engine built and loaded strictly in {load_s:.3f} s, a "
        f"round of 5 steps at 576x1024 in {round_s:.3f} s (files included); merged vs the "
        f"runner's unmerged LoRA: {err:.3e} max-normalised (limit {CONVERT_TOL}); largest "
        f"|up @ down| {lora:.3e}; {len(kept)} action adapters equal their EMA; card {CARD}")
    if not err <= CONVERT_TOL:
        faults.append(f"the merged file's round disagrees with the runner's: {err:.3e}")
    OUT.mkdir(exist_ok=True)
    (OUT / "convert.json").write_text(json.dumps(result, indent=1))
    if faults:
        raise SystemExit("convert: " + "; ".join(faults))
    return launches


# ---------------------------------------------------------------- phase 11

VAE_STEPS = 4  # AE, discriminator, AE, discriminator at disc_start 0
VAE_CARD_TOL = 1e-4  # the tiny step's metrics and Adam moments, card fp32 vs CPU fp32


def vae_trainer(cfg, vae_cfg, device, seed):
    from vista_tpu_torch.engine.vae_training import VAETrainer

    torch.manual_seed(seed)
    return VAETrainer(cfg, vae_cfg, device)


def vae_reference(seed):
    """One AE and one discriminator step of a small VAE (ch 64, 32x32,
    batch 2) on the card in fp32 with TF32 off against the CPU in fp32:
    the metrics and the Adam moments within ``VAE_CARD_TOL`` (the moments
    against the module's largest), and each parameter within 1e-3 of lr where
    its gradient is past 1e-5, else within 2 lr (a first Adam step's most)."""
    from vista_tpu_torch.engine.vae_training import VAETrainConfig
    from vista_tpu_torch.models.vae import VAEConfig

    tcfg = VAETrainConfig(learning_rate=1e-4, disc_start=0, disc_channels=8, disc_layers=2)
    vcfg = VAEConfig(ch=64, ch_mult=(1, 2), num_res_blocks=1, dtype="float32")
    cpu = vae_trainer(tcfg, vcfg, "cpu", seed)
    card = vae_trainer(tcfg, vcfg, "cuda", seed)
    for a, b in ((cpu.encoder, card.encoder), (cpu.decoder, card.decoder), (cpu.disc, card.disc)):
        b.load_state_dict(a.state_dict())
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.rand(2, 3, 32, 32, generator=gen) * 2 - 1
    errs, faults = {}, []
    with full_fp32():
        for i in range(2):
            noise = torch.randn(2, 4, 16, 16, generator=gen)
            m_cpu = cpu.step(x, noise)
            m_card = card.step(x.cuda(), noise.cuda())
            for k in ("loss", "rec", "kl"):
                e = abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
                errs[f"step {i} {k}"] = e
                if not e <= VAE_CARD_TOL:
                    faults.append(f"step {i} {k}: {m_card[k]} vs {m_cpu[k]}")
            opt_c, opt_g = (cpu.ae_opt, card.ae_opt) if i == 0 else (cpu.disc_opt, card.disc_opt)
            top = max(float(mu.abs().max()) for mu in opt_c.mu)
            mom = max(float((g.cpu() - c).abs().max()) for g, c in zip(opt_g.mu, opt_c.mu)) / top
            errs[f"step {i} mu"] = mom
            bad = sum(int(((pg.detach().cpu() - pc.detach()).abs()
                           > torch.where(mu.abs() / 0.5 >= 1e-5, 1e-3 * tcfg.learning_rate,
                                         2 * tcfg.learning_rate)).sum())
                      for pg, pc, mu in zip(opt_g.params, opt_c.params, opt_c.mu))
            if not mom <= VAE_CARD_TOL or bad:
                faults.append(f"step {i}: moments {mom:.3e}, {bad} parameters off")
    log("  small VAE steps, card fp32 vs cpu fp32: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + f" (limit {VAE_CARD_TOL})")
    if faults:
        raise SystemExit("the small VAE steps disagree with the CPU: " + "; ".join(faults))
    return errs


def vae_train_run(seed):
    """``VAEConfig()`` at full width (ch 128, mult 1/2/4/4, bf16 compute by
    autocast, fp32 parameters) on 576x1024 frames, batch 1, ``disc_start``
    0: ``VAE_STEPS`` steps, AE and discriminator in turn, each timed by
    ``utils/profiling.StepTimer``; which modules each step moved."""
    from vista_tpu_torch.engine.vae_training import VAETrainConfig
    from vista_tpu_torch.models.vae import VAEConfig
    from vista_tpu_torch.utils.profiling import StepTimer

    gc.collect()  # the earlier phases' engines and trainers
    torch.cuda.empty_cache()
    small = phase("vae_train-reference", vae_reference, seed)
    tcfg = VAETrainConfig(disc_start=0)
    trainer = vae_trainer(tcfg, VAEConfig(), "cuda", seed + 31)
    n = {k: sum(p.numel() for p in getattr(trainer, k).parameters())
         for k in ("encoder", "decoder", "disc")}
    gen = torch.Generator(device="cuda").manual_seed(seed + 32)
    x = torch.rand(1, 3, 576, 1024, generator=gen, device="cuda") * 2 - 1
    timers = {0.0: StepTimer(), 1.0: StepTimer()}
    steps, faults = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # the modules, their moments, the batch
    for i in range(VAE_STEPS):
        noise = torch.randn(1, 4, 72, 128, generator=gen, device="cuda")
        before = {k: checksums(list(getattr(trainer, k).parameters()))
                  for k in ("encoder", "decoder", "disc")}
        which = 1.0 if trainer.trains_disc() else 0.0
        with timers[which].step() as out:
            m = out["result"] = trainer.step(x, noise)
        moved = {k: int((checksums(list(getattr(trainer, k).parameters())) != v).sum())
                 for k, v in before.items()}
        steps.append(dict(m, seconds=timers[which].durations[-1], moved=moved))
        log(f"  VAE step {i} ({'discriminator' if m['which'] else 'autoencoder'}): loss "
            f"{m['loss']:.5f} (rec {m['rec']:.5f}, kl {m['kl']:.2f}) in "
            f"{timers[which].durations[-1]:.3f} s; tensors moved {json.dumps(moved)}")
        if not all(math.isfinite(m[k]) for k in ("loss", "rec", "kl")):
            faults.append(f"step {i}: non-finite {m}")
        ae, disc = moved["encoder"] > 0 and moved["decoder"] > 0, moved["disc"] > 0
        frozen = moved["disc"] == 0 if m["which"] == 0.0 else not (moved["encoder"]
                                                                   or moved["decoder"])
        if m["which"] != float(i % 2) or not (ae if m["which"] == 0.0 else disc) or not frozen:
            faults.append(f"step {i} ({m['which']}) moved {moved}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    report = {("autoencoder" if k == 0.0 else "discriminator"): t.report()
              for k, t in timers.items()}
    log(f"  VAE training at 576x1024 (encoder {n['encoder'] / 1e6:.1f} M, image decoder "
        f"{n['decoder'] / 1e6:.1f} M, discriminator {n['disc'] / 1e6:.2f} M params): "
        f"autoencoder {report['autoencoder']['mean_s']:.3f} s a step, discriminator "
        f"{report['discriminator']['mean_s']:.3f} s (StepTimer means of 2; the first of each "
        f"kind carries cuDNN's algorithm search), peak {peak:.2f} GiB ({held:.2f} GiB held "
        f"before the first step); card {CARD}")
    OUT.mkdir(exist_ok=True)
    (OUT / "vae_train.json").write_text(json.dumps(dict(
        card=CARD, small=small, params=n, steps=steps, timers=report, peak_gib=peak,
        held_gib=held), indent=1))
    del trainer, x
    gc.collect()
    torch.cuda.empty_cache()
    if faults:
        raise SystemExit("VAE training: " + "; ".join(faults))


# ---------------------------------------------------------------- phase 12

TEXT_TOL = SLICE_TOL  # the full-width text tower in bf16 on the card vs fp32 on the CPU


def text_tower_check(seed):
    """The CLIP text tower at full width (ViT-L/14's: 12 layers of 768,
    vocabulary 49408) on (4, 77) random tokens: the card with its layers in
    bf16 against the CPU in fp32, hidden states and pooled output."""
    from vista_tpu_torch.models.clip import CLIPTextConfig, CLIPTextTower

    cfg = CLIPTextConfig()
    torch.manual_seed(seed)
    cpu = CLIPTextTower(cfg).eval()
    card = CLIPTextTower(cfg).cuda().eval()
    card.load_state_dict(cpu.state_dict())
    card.encoder.to(cfg.compute_dtype)
    tokens = torch.randint(0, cfg.vocab_size - 1, (4, cfg.max_length),
                           generator=torch.Generator().manual_seed(seed + 1))
    tokens[torch.arange(4), torch.tensor([5, 20, 40, 76])] = cfg.vocab_size - 1
    with torch.no_grad():
        ref = cpu(tokens)
        t0 = time.perf_counter()
        got = card(tokens.cuda())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    errs = {k: rel_err(g, r) for k, g, r in zip(("hidden", "pooled"), got, ref)}
    log(f"  CLIP text tower 12x768 on (4, 77) tokens, card bf16 vs cpu fp32: hidden "
        f"{errs['hidden']:.3e}, pooled {errs['pooled']:.3e} (limit {TEXT_TOL}); {ms:.1f} ms "
        f"(first call)")
    if not all(v <= TEXT_TOL for v in errs.values()):
        raise SystemExit("the CLIP text tower disagrees with the CPU")
    return errs


def quality_run(seed):
    """``tools/torch_quality_bench.py`` in-process on the card with the full
    ViT-H tower: ``--calibrate`` at 576x1024 on 2 synthetic clips (it exits
    non-zero unless FCD rises over the noise and blur grades while PSNR
    falls), then one harness run (1 clip, 1 round, 5 steps)."""
    from vista_tpu_torch.ops import _build

    text = phase("quality-text", text_tower_check, seed)
    bench = load_tool("torch_quality_bench")
    OUT.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    cal = bench.main(["--calibrate", "--n-clips", "2", "--out", str(OUT / "quality_cal.json")])
    cal_s = time.perf_counter() - t0
    faults = [f"{kind}: SSIM does not fall over the grades {c['ssim']}"
              for kind, c in cal["calibration"].items()
              if kind != "shuffle" and not c["ssim_monotone_decreasing"]]
    _build.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = bench.main(["--n-clips", "1", "--n_steps", "5", "--out", str(OUT / "quality.json")])
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(_build.LAUNCHES)
    missing = missing_launches(SAMPLE_KERNELS + ATTENTION_ROUTES, SAMPLE_SITES)
    if missing:
        faults.append(f"kernels or call sites never launched by the harness: {missing}")
    if run["config"]["backend"] != torch.cuda.get_device_name(0):
        faults.append(f"the harness ran on {run['config']['backend']}")
    log(f"  quality calibration at 576x1024 (2 clips x 25 frames): {cal_s:.3f} s; FCD noise "
        f"{cal['calibration']['noise']['fcd']}, blur {cal['calibration']['blur']['fcd']}, "
        f"shuffle {cal['calibration']['shuffle']['fcd']}; validated {cal['validated']}")
    log(f"  quality harness (1 clip, 1 round of 5 steps, own random weights): {run_s:.3f} s "
        f"(rollout {run['rollout_timing']['mean_s']:.3f} s), FCD "
        f"{run['frechet_clip_distance']}, PSNR {run['psnr_db']} dB, SSIM {run['ssim']}; "
        f"peak {peak:.2f} GiB; backend {run['config']['backend']}")
    (OUT / "quality_phase.json").write_text(json.dumps(dict(
        card=CARD, text=text, calibrate_s=cal_s, run_s=run_s, peak_gib=peak,
        launches=launches), indent=1))
    gc.collect()
    torch.cuda.empty_cache()
    if faults:
        raise SystemExit("quality: " + "; ".join(faults))
    return launches


# ---------------------------------------------------------------- phase 13

# the sample CLI's round: 576x1024, 25 frames, one round of 5 steps
PARALLEL_SAMPLE_ARGV = ["--n_rounds", "1", "--n_steps", "5", "--height", "576",
                        "--width", "1024"]
PARALLEL_MODES = ("frames", "height", "weights")
# the train CLI on the phase-1 recipe: 4 micro-steps (2 updates at accum 2)
# with the phase1 phase's warm-up (the full rate from update 0), the losses
# of every step in the CSV, one decoder thread (two hand the batches out in
# either order)
PARALLEL_TRAIN_OVERRIDES = ["run.max_steps=4", "run.log_every=1", "train.warmup_steps=0",
                            "data.num_threads=1", "parallel.data=1"]
# sampling: frames at one rank changes only the order of the temporal
# GroupNorm sums, height the arithmetic of every GroupNorm's statistics (and
# its convs read copies of their rows); held, as the small slice's bf16 run,
# to 5e-2 of the largest latent
PARALLEL_FRAMES_TOL = 5e-2


def parallel_train_argv(logdir):
    return ["--base", str(CONFIGS / "vista_phase1.yaml"), "--synthetic-data",
            f"run.logdir={logdir}", *PARALLEL_TRAIN_OVERRIDES]


def parallel_sample_worker(seed):
    """Under torch.distributed.run: the sample CLI's mesh (``--mesh-data 1``,
    NCCL), one engine of seeded random weights, and the CLI's ``run`` in
    ``frames``, ``height`` and ``weights`` mode and without a mesh."""
    import tempfile

    from vista_tpu_torch.cli import sample as sample_cli
    from vista_tpu_torch.cli._common import engine_config
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.ops import _build

    save = Path(tempfile.mkdtemp(prefix="vista_parallel_sample_"))
    base = PARALLEL_SAMPLE_ARGV + ["--save", str(save)]
    args = {m: sample_cli.parse_args(base + ["--mesh-data", "1", "--mesh-mode", m])
            for m in PARALLEL_MODES}
    mesh = sample_cli.sample_mesh(args["frames"])
    args["none"] = sample_cli.parse_args(base)
    for a in args.values():
        a.device = args["frames"].device
    engine = VistaEngine(engine_config(args["none"]), args["none"].device)
    init_engine(engine, torch.Generator(device=engine.device).manual_seed(seed + 11))
    runs, latents = {}, {}
    for mode in (*PARALLEL_MODES, "none"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        out = sample_cli.run(args[mode], engine, None if mode == "none" else mesh)
        torch.cuda.synchronize()
        latents[mode] = out["latents"]
        runs[mode] = dict(seconds=time.perf_counter() - t0,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          launches=dict(_build.LAUNCHES), sites=dict(_build.SITES),
                          finite=bool(torch.isfinite(out["latents"]).all()),
                          shape=list(out["latents"].shape))
    shutil.rmtree(save)
    ref = latents["none"]
    for mode in PARALLEL_MODES:
        runs[mode]["bit_identical"] = bool(torch.equal(latents[mode], ref))
        runs[mode]["max_abs_diff"] = float((latents[mode] - ref).abs().max())
    runs["latents_max"] = float(ref.abs().max())
    runs["sp_attention"] = sp_attention_check(seed)
    return runs


def sp_attention_check(seed):
    """``sp_attention`` over the one-rank group at the ds1 shape of the
    576x1024 sampling batch's spatial attention ``(2, 9216, 5x64)`` bf16,
    forward and backward, against ``attention_packed`` on the same tensors
    (a gather of one rank is the identity, so the bits must agree); its K1
    and attention_bwd launches."""
    from vista_tpu_torch.ops import _build
    from vista_tpu_torch.ops.attention import attention_packed
    from vista_tpu_torch.parallel.sp_attention import sp_attention

    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    q, k, v, do = (torch.randn(2, 9216, 320, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    runs = {}
    for name in ("attention_packed", "sp_attention"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        o = (sp_attention(*leaves, 5, 9216) if name == "sp_attention"
             else attention_packed(*leaves, 5))
        o.backward(do)
        torch.cuda.synchronize()
        runs[name] = dict(seconds=time.perf_counter() - t0, launches=dict(_build.LAUNCHES),
                          outputs=[o.detach(), *(t.grad for t in leaves)])
    ref, got = runs["attention_packed"]["outputs"], runs["sp_attention"].pop("outputs")
    runs.pop("attention_packed")
    runs["sp_attention"]["bit_identical"] = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
    return runs["sp_attention"]


def train_summary(runner, seconds, stages):
    """What a train CLI run is compared on: the losses of its steps, one
    checksum per master, its host seconds a step and of its stages, and the
    launch counts."""
    import csv

    from vista_tpu_torch.ops import _build

    with open(Path(runner.cfg.run.logdir) / "metrics.csv", newline="") as f:
        rows = [r for r in csv.DictReader(f) if r.get("loss")]
    return dict(seconds=seconds, stages=stages, losses=[float(r["loss"]) for r in rows],
                grad_norms=[float(r["grad_norm"]) for r in rows],
                step_s=[s for _, s in runner.step_times],
                masters=checksums(list(runner.trainer.master.values())).tolist(),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches=dict(_build.LAUNCHES), sites=dict(_build.SITES))


def parallel_train():
    """The train CLI's ``main`` on the phase-1 recipe (see
    ``PARALLEL_TRAIN_OVERRIDES``) without its image logs (steps 1, 2 and 4:
    45 s a run at 576x1024; the ``train_cli`` phase checks them) and without
    its checkpoints (a 35 GB file, 40-55 s, that slices nothing at one rank;
    the CPU tests hold checkpoints across meshes), in a temporary run
    directory deleted after."""
    import tempfile

    from vista_tpu_torch import runner as runner_mod
    from vista_tpu_torch.cli import train as train_cli
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.ops import _build

    tmp = Path(tempfile.mkdtemp(prefix="vista_parallel_train_"))
    logdir = tmp / "run"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    times = StageTimes([(VistaEngine, ("__init__",))])
    stubbed = {name: getattr(runner_mod.Runner, name) for name in ("log_images", "save_checkpoint")}
    runner_mod.Runner.log_images = lambda self, batch: None
    runner_mod.Runner.save_checkpoint = lambda self, tag=None: None
    t0 = time.perf_counter()
    try:
        runner = train_cli.main(parallel_train_argv(logdir))
    finally:
        for name, f in stubbed.items():
            setattr(runner_mod.Runner, name, f)
        times.close()
    torch.cuda.synchronize()
    stages = {}
    for name, s, _ in times.take():
        stages[name] = stages.get(name, 0.0) + s
    out = train_summary(runner, time.perf_counter() - t0, stages)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    return out


PARALLEL_WORKERS = {"sample": parallel_sample_worker, "train": lambda seed: parallel_train()}


def torchrun(kind, seed):
    """``chip_smoke.py --parallel-worker kind`` as one process under
    ``python -m torch.distributed.run --standalone``: the CLIs join a
    one-rank NCCL group from torchrun's environment. Returns the worker's
    table; its output lands in ``chiprun_out/parallel_<kind>.log``."""
    table = OUT / f"parallel_{kind}.json"
    table.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", str(Path(__file__).resolve()), "--parallel-worker", kind, "--seed", str(seed)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    (OUT / f"parallel_{kind}.log").write_text(proc.stdout + "\n---- stderr\n" + proc.stderr)
    if proc.returncode != 0 or not table.exists():
        raise SystemExit(f"parallel {kind}: the torchrun worker exited {proc.returncode}:\n"
                         + proc.stderr[-3000:])
    out = json.loads(table.read_text())
    out["process_s"] = time.perf_counter() - t0
    return out


# the temporal sites of the 576x1024 sampling batch (2 x 25 frames) whose
# tokens a frame-parallel split over PARALLEL_SPLIT ranks cuts unevenly
PARALLEL_SPLIT = 5
PARALLEL_SITES = (("ds1", 9216, 320, 5), ("mid", 144, 1280, 20))
# the spatial attention levels of the 576x1024 latents (rows, width,
# channels, heads) and the rank counts whose row bands height mode checks
HEIGHT_LEVELS = (("ds1", 72, 128, 320, 5), ("ds2", 36, 64, 640, 10),
                 ("ds4", 18, 32, 1280, 20), ("ds8", 9, 16, 1280, 20))
HEIGHT_SPLITS = (2, 4, 8)
HEIGHT_CHECK_FRAMES = 2  # of the 50 whose K1 output is held to the plain version


def sharded_shape_checks(seed):
    """The kernels at the local shapes of a split of the 576x1024 sampling
    batch (one card cannot run the ranks; their shapes it can), each against
    its plain version in fp32 on the same bf16 inputs, to ``TOL``:

    - ``frames`` over ``PARALLEL_SPLIT`` ranks: each rank's tokens of all 25
      frames of both CFG halves, 1844 / 1843 of 9216 at ds1, 29 / 28 of 144
      at the mid block. K4 (``emb`` and ``res``) on frame-major rows ``(50,
      s, c)``; K2 split, K1's short route and K3 on the temporal sequences
      ``(2 s, 25, c)``;
    - ``height`` over ``HEIGHT_SPLITS`` ranks: every band of latent rows
      (uneven ones included) at each spatial attention level: K1 with the
      band's queries against the whole frame's keys (all 50 frames, the
      first ``HEIGHT_CHECK_FRAMES`` held), K2 split and K4 ``emb`` on the
      band's tokens ``(50, band tokens, c)``;
    - an empty band (more ranks than rows): K1, K2, K3, K4 and the
      LayerNorm on no rows return empty results and launch nothing."""
    from vista_tpu_torch.ops import _build
    from vista_tpu_torch.ops.attention import attention_forward, attention_plain
    from vista_tpu_torch.ops.fused_qkv import fused_ln_qkv
    from vista_tpu_torch.ops.linear import (linear_residual, linear_residual_plain,
                                            ln_linear_plain)
    from vista_tpu_torch.ops.norms import layer_norm_kernel
    from vista_tpu_torch.ops.temporal_conv import gn_silu_conv3, gn_silu_conv3_plain
    from vista_tpu_torch.parallel.height import bounds
    from vista_tpu_torch.parallel.mesh import token_splits

    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    rnd = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device="cuda") * scale
    bf = lambda t: t.to(torch.bfloat16)
    rows, t = [], 25

    def k4(site, s_me, c, kinds=("emb", "res")):
        x = bf(rnd(2 * t, s_me, c))
        sc, sh = 1.0 + 0.1 * rnd(2 * t, c), 0.1 * rnd(2 * t, c)
        w, b = bf(rnd(c, c, 3, 1, 1, scale=(3 * c) ** -0.5)), 0.02 * rnd(c)
        emb, res, rs = 0.1 * rnd(2 * t, c), bf(rnd(2 * t, s_me, c)), rnd(1).abs()
        epilogues = {"emb": dict(emb=emb), "res": dict(residual=res, res_scale=rs)}
        for kind in kinds:
            kw = epilogues[kind]
            got = gn_silu_conv3(x, sc, sh, w, b, t, **kw)
            with full_fp32():
                ref = gn_silu_conv3_plain(x.float(), sc, sh, w.float(), b, t,
                                          **{k: v.float() for k, v in kw.items()})
            rows.append((f"gn_silu_conv3 {kind} {site} (50,{s_me},{c})", got, ref))

    def k2(x, ln_w, ln_b, wq, wk, wv, site, shape, count_site="temporal-qkv"):
        q, k, v = fused_ln_qkv(x, ln_w, ln_b, wq, wk, wv, 1e-5, site=count_site)
        with full_fp32():
            rq, rk, rv = ln_linear_plain(x.float(), ln_w, ln_b,
                                         torch.cat([wq, wk, wv]).float(), None, "split", 3)
        rows.append((f"ln_linear qkv {site} {shape}", torch.stack([q, k, v]),
                     torch.stack([rq, rk, rv])))
        return q, k, v

    def params(c):
        return (1.0 + 0.1 * rnd(c), 0.1 * rnd(c),
                *(bf(rnd(c, c, scale=c ** -0.5)) for _ in range(4)), 0.02 * rnd(c))

    for site, s, c, heads in PARALLEL_SITES:
        for s_me in sorted(set(token_splits(s, PARALLEL_SPLIT)), reverse=True):
            k4(site, s_me, c)
            seq = bf(rnd(2 * s_me, t, c))
            ln_w, ln_b, wq, wk, wv, wo, bo = params(c)
            shape = f"({2 * s_me},{t},{c})"
            q, k, v = k2(seq, ln_w, ln_b, wq, wk, wv, f"temporal {site}", shape)
            o = attention_forward(q, k, v, heads, site="temporal")
            out = linear_residual(o, wo, bo, seq, site="temporal-out")
            with full_fp32():
                ro = attention_plain(q.float(), k.float(), v.float(), heads)
                rout = linear_residual_plain(o.float(), wo.float(), bo, seq.float())
            rows += [(f"attention temporal {site} {shape}", o, ro),
                     (f"linear_residual temporal-out {site} {shape}", out, rout)]

    nf = HEIGHT_CHECK_FRAMES
    for level, h, w, c, heads in HEIGHT_LEVELS:
        bands = sorted({b[i + 1] - b[i] for b in (bounds(h, n) for n in HEIGHT_SPLITS)
                        for i in range(len(b) - 1)}, reverse=True)
        k = bf(rnd(2 * t, h * w, c))
        v = bf(rnd(2 * t, h * w, c))
        for r in bands:
            s_me = r * w
            site = f"height {level} {r} of {h} rows"
            k4(site, s_me, c, kinds=("emb",))
            ln_w, ln_b, wq, wk, wv, _, _ = params(c)
            q = k2(bf(rnd(2 * t, s_me, c)), ln_w, ln_b, wq, wk, wv, site, f"(50,{s_me},{c})",
                   "qkv")[0]
            o = attention_forward(q, k, v, heads, site="spatial")
            with full_fp32():
                ro = attention_plain(q[:nf].float(), k[:nf].float(), v[:nf].float(), heads)
            rows.append((f"attention {site} (50,{s_me} of {h * w},{c})", o[:nf], ro))

    before = dict(_build.LAUNCHES)
    x0 = bf(rnd(2 * t, 0, 320))
    ln_w, ln_b, wq, wk, wv, wo, bo = params(320)
    kk = bf(rnd(2 * t, 64, 320))
    empty = [fused_ln_qkv(x0, ln_w, ln_b, wq, wk, wv)[0],
             attention_forward(x0, kk, kk, 5), linear_residual(x0, wo, bo, x0),
             gn_silu_conv3(x0, ln_w.expand(2 * t, -1), ln_b.expand(2 * t, -1),
                           bf(rnd(320, 320, 3, 1, 1)), bo, t, emb=bo.expand(2 * t, -1)),
             layer_norm_kernel(x0, ln_w, ln_b)]
    torch.cuda.synchronize()
    if dict(_build.LAUNCHES) != before or any(e.shape != x0.shape for e in empty):
        raise SystemExit(f"parallel: an empty band launched a kernel or changed shape: "
                         f"{[tuple(e.shape) for e in empty]}")
    log("  an empty band (50, 0, 320): K1, K2, K3, K4 and the LayerNorm launch nothing")

    table, faults = [], []
    for name, got, ref in rows:
        rel = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
        table.append(dict(check=name, rel_err=rel))
        log(f"  {name:60s} rel {rel:.2e}  {'ok' if rel <= TOL else 'FAIL'}")
        if not (math.isfinite(rel) and rel <= TOL):
            faults.append(name)
    if faults:
        raise SystemExit(f"parallel: kernels off at the split's local shapes: {faults}")
    return table


def parallel_run(seed):
    """The CLIs under torch.distributed.run at world size 1 over NCCL: the
    sample CLI in ``frames``, ``height`` and ``weights`` mode against the
    same round without a mesh, and the train CLI on the phase-1 recipe with
    ``parallel.data=1`` against the same steps without a group (in this
    process). No multi-GPU speed exists here: one card."""
    OUT.mkdir(exist_ok=True)
    local = sharded_shape_checks(seed)
    gc.collect()  # the earlier phases' engines and trainers: the workers need the card
    torch.cuda.empty_cache()
    log(f"  device memory held by this process before the workers: "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    sample = torchrun("sample", seed)
    faults = []
    none = sample["none"]
    log(f"  sample CLI, 576x1024, 25 frames, 1 round of 5 steps, without a mesh: "
        f"{none['seconds']:.3f} s, peak {none['peak_gib']:.2f} GiB")
    for mode in PARALLEL_MODES:
        r = sample[mode]
        log(f"  sample CLI --mesh-data 1 --mesh-mode {mode} (torchrun, NCCL): "
            f"{r['seconds']:.3f} s, peak {r['peak_gib']:.2f} GiB; latents "
            + ("bit-identical to" if r["bit_identical"] else
               f"max |diff| {r['max_abs_diff']:.4e} (largest latent "
               f"{sample['latents_max']:.3f}) from")
            + " the round without a mesh")
        log(f"    launches: {json.dumps(r['launches'], sort_keys=True)}")
        if not r["finite"] or r["shape"] != none["shape"]:
            faults.append(f"{mode}: latents {r['shape']} not finite or not {none['shape']}")
        missing = [k for k in SAMPLE_KERNELS + ATTENTION_ROUTES if not r["launches"].get(k)]
        if missing:
            faults.append(f"{mode}: kernels never launched: {missing}")
    for mode in ("frames", "height"):
        if sample[mode]["max_abs_diff"] > PARALLEL_FRAMES_TOL * sample["latents_max"]:
            faults.append(f"{mode} at one rank: {sample[mode]['max_abs_diff']:.4e} from the "
                          f"round without a mesh, over {PARALLEL_FRAMES_TOL} of the largest "
                          f"latent")
    if not sample["weights"]["bit_identical"]:
        faults.append("weights mode at one rank gathers the same weights: its latents must be "
                      "bit-identical to the round without a mesh")
    sp = sample["sp_attention"]
    log(f"  sp_attention (torchrun, NCCL, world size 1) at ds1 (2, 9216, 5x64) bf16, forward "
        f"and backward: o, dq, dk, dv {sp['bit_identical']} bit-identical to attention_packed; "
        f"{sp['seconds']:.3f} s; launches {json.dumps(sp['launches'], sort_keys=True)}")
    if not all(sp["bit_identical"]):
        faults.append(f"sp_attention at one rank differs from attention_packed: "
                      f"{sp['bit_identical']} (o, dq, dk, dv)")
    if [sp["launches"].get(k, 0) for k in ("attention:wgmma", "attention_bwd:wgmma")] != [1, 1]:
        faults.append(f"sp_attention launched {sp['launches']}, not K1 and attention_bwd once")

    train = torchrun("train", seed)
    ref = parallel_train()
    phase1 = json.loads((OUT / "phase1.json").read_text()) if (OUT / "phase1.json").exists() \
        else {}
    same_losses = train["losses"] == ref["losses"]
    differ = sum(a != b for a, b in zip(train["masters"], ref["masters"]))
    for name, r in (("torchrun, NCCL, parallel.data=1", train), ("no group", ref)):
        log(f"  train CLI, phase-1 recipe, 4 micro-steps ({name}): losses "
            f"{r['losses']}, host seconds a step {[round(x, 3) for x in r['step_s']]}, "
            f"peak {r['peak_gib']:.2f} GiB; {r['seconds']:.1f} s in all: "
            + ", ".join(f"{k} {v:.1f} s" for k, v in r["stages"].items()))
    log(f"  phase1 phase (the Trainer alone): {phase1.get('s_per_micro_step', float('nan')):.3f} "
        f"s a micro-step")
    log(f"  losses {'identical' if same_losses else 'differ'}; masters: {differ} of "
        f"{len(ref['masters'])} checksums differ")
    log(f"    launches (torchrun): {json.dumps(train['launches'], sort_keys=True)}")
    if len(train["losses"]) != 4 or not all(math.isfinite(x) for x in train["losses"]):
        faults.append(f"train: losses {train['losses']}")
    # world size 1: the gradient mean divides by 1 and no state is sliced, and
    # one data thread fixes the batches, so the run must repeat the bits
    if not same_losses or differ or len(train["masters"]) != len(ref["masters"]):
        faults.append(f"train under torchrun: losses {'identical' if same_losses else 'differ'}, "
                      f"{differ} of {len(ref['masters'])} master checksums differ from the run "
                      f"without a group")
    missing = [k for k in PHASE1_KERNELS + ATTENTION_ROUTES + ATTENTION_BWD_ROUTES
               if not train["launches"].get(k)]
    if missing:
        faults.append(f"train: kernels never launched: {missing}")
    (OUT / "parallel.json").write_text(json.dumps(dict(
        card=CARD, local_shapes=local, sample=sample, train=train, train_no_group=ref,
        phase1_s_per_micro_step=phase1.get("s_per_micro_step"), masters_differ=differ,
        losses_identical=same_losses), indent=1))
    if faults:
        raise SystemExit("parallel: " + "; ".join(faults))
    return {"parallel_sp_attention": sp["launches"],
            "parallel_sample_frames": sample["frames"]["launches"],
            "parallel_sample_height": sample["height"]["launches"],
            "parallel_sample_weights": sample["weights"]["launches"],
            "parallel_train": train["launches"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace with torch.profiler one 576x1024 request (2 steps), "
                    "a phase-2 step, a phase-1 optimizer step and three steps of the "
                    "overfit arc (each trace adds up to a minute)")
    ap.add_argument("--parallel-worker", choices=sorted(PARALLEL_WORKERS),
                    help=argparse.SUPPRESS)  # the parallel phase's torchrun worker
    args = ap.parse_args()
    if args.parallel_worker:
        import torch.distributed as dist

        from vista_tpu_torch.ops import _build

        card_check()
        _build.build()  # the main process built them: loads build/'s library
        table = PARALLEL_WORKERS[args.parallel_worker](args.seed)
        OUT.mkdir(exist_ok=True)
        (OUT / f"parallel_{args.parallel_worker}.json").write_text(json.dumps(table, indent=1))
        dist.destroy_process_group()
        return

    phase("card", card_check)
    phase("build", build)
    log("kernel vs plain (fp32 on the same bf16 inputs):")
    rows = phase("kernels", kernel_checks)
    sample = phase("slice", slice_run, args.seed, args.profile)
    modes = phase("sampling_modes", sampling_modes_run, args.seed)
    rollout = phase("rollout", rollout_run, args.seed)
    train = phase("train", train_run, args.seed, args.profile)
    gc.collect()  # the phase-2 engine and trainer, before the next ones
    torch.cuda.empty_cache()
    train_cli = phase("train_cli", train_cli_run, args.seed, convert_run)
    phase1 = phase("phase1", phase1_run, args.seed, args.profile)
    overfit = phase("overfit", overfit_run, args.seed, args.profile)
    parallel = phase("parallel", parallel_run, args.seed)
    phase("vae_train", vae_train_run, args.seed)
    quality = phase("quality", quality_run, args.seed)

    kernels = []
    paths = {"sample": sample, "sampling_modes": modes, "rollout": rollout["rollout"],
             "reward": rollout["reward"], **train, "train_cli": train_cli["train_cli"],
             "convert": train_cli["convert"], **phase1, "overfit": overfit, **parallel,
             "quality": quality}
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        timed = mine[0]  # the first (largest) main-path shape of the kernel
        by_path = {p: counts.get(name, 0) for p, counts in paths.items()}
        path = ("sample" if name in SAMPLE_KERNELS else
                "train" if name in TRAIN_KERNELS else "phase1")
        routes = {key.split(":")[1]: {p: counts.get(key, 0) for p, counts in paths.items()}
                  for key in sorted(set().union(*paths.values()))
                  if key.startswith(name + ":")}
        kernels.append(dict(
            name=name, **meta, launches=by_path[path],
            launches_by_path=by_path, launches_by_route=routes or None,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            rel_err=max(r["rel_err"] for r in mine), shape=timed["shape"], ms=timed["ms"],
            plain_ms=timed["plain_ms"], bound_ms=timed["bound_ms"], bound_by=timed["bound_by"],
            library_ms=timed["library_ms"]))
    log(f"card: {CARD}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
