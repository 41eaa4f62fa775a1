"""What the CPU can check of the LayerNorm kernels (``csrc/layer_norm.cu``):
that ``ln_plan``'s persistent grid takes every row once, forward and
backward, at every LayerNorm site of the UNet's training paths and at the
card tests' shapes; that a row's lanes and their chunks cover its width
once; that the plan's ring and grid are the source's ``constexpr``s and fit
an SM; that the kernels' row-group arithmetic, emulated in numpy in fp32
block by block along the plan's walk, is ``layer_norm_plain`` and
``ln_bwd_plain``; and that the backward's in-launch fold of dγ and dβ gives
the same bits whatever order the blocks arrive in. No card, no JAX: each
case takes milliseconds."""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vista_tpu_torch.ops import norms
from vista_tpu_torch.ops.norms import MAX_C, layer_norm_plain, ln_bwd_plain, ln_plan

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "vista_tpu_torch" / "csrc"
SMEM_LIMIT = 232448  # the shared memory one block may opt into on an H100 (227 KB)
SM_SMEM = 233472  # an SM's shared memory (228 KB), 1 KB of it reserved per block
SM_THREADS = 2048

# (rows, c) of every LayerNorm site of the training paths: phase 2 at
# 320x576 (40x72 latents) and phase 1 at 576x1024 (72x128), 25 frames, batch
# 1, at ds1, ds2, ds4 and mid (h w tokens a frame, 25 frames; the temporal
# layout (h w, 25, c) has as many rows)
UNET = []
for h, w, res in [(40, 72, "320x576"), (72, 128, "576x1024")]:
    for level, c in [("ds1", 320), ("ds2", 640), ("ds4", 1280), ("mid", 1280)]:
        UNET.append((25 * h * w, c, f"{level} {res}"))
        h, w = -(-h // 2), -(-w // 2)
# (rows, c) of the card tests (tests/test_torch_cuda.py): the LayerNorm
# tests, ff_bwd's, qkv_bwd's and the LoRA self-attention's
CARD = [(7, 32), (45, 64), (301, 320), (1125, 640), (77, 1280), (20011, 320), (300, 320),
        (1250, 640), (7, 1280), (3001, 640), (28800, 320), (14400, 1280), (300, 64),
        (130, 96), (461, 64), (1000, 96), (777, 320), (300, 96), (125, 64), (129, 64),
        (1000, 128), (150, 128)]
SHAPES = [(m, c, tag) for m, c, tag in UNET] + [(m, c, "card") for m, c in CARD]


def _constants():
    """The ``constexpr int LN_...`` of csrc/layer_norm.cu, in order."""
    env = {}
    for decl in re.findall(r"constexpr int ([^;]+);", (CSRC / "layer_norm.cu").read_text()):
        for part in decl.split(","):
            key, expr = (s.strip() for s in part.split("=", 1))
            if key.startswith("LN_"):
                env[key] = eval(expr, {}, env)  # products and sums of the names above
    return env


def test_unet_sites():
    assert [m for m, _, _ in UNET] == [72000, 18000, 4500, 1125, 230400, 57600, 14400, 3600]


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("m,c,tag", SHAPES)
def test_plan_covers_every_row_once(m, c, tag, backward):
    plan = ln_plan(m, c, 132, backward)
    seen = np.zeros(m, np.int64)
    for block in range(plan.grid):
        taken = 0
        for warp in range(plan.warps):
            for first, rows in plan.walk(block, warp, m):
                assert 0 < rows <= plan.rows and first % plan.rows == 0
                seen[first:first + rows] += 1
                taken += 1
        assert taken > 0, f"block {block} takes no step"
    assert (seen == 1).all()
    assert plan.steps == -(-m // plan.rows) and plan.grid <= 2 * 132
    if tag != "card":  # the UNet's widths: C / 40 lanes a row, 5 chunks each
        assert (plan.lanes, plan.chunks) == (c // 40, 5)


@pytest.mark.parametrize("c", range(8, MAX_C + 1, 8))
def test_lanes_cover_the_row(c):
    """Lane j of a row holds chunks j, j + lanes, ... (at most LN_KMAX): the
    lanes of a row cover its c / 8 chunks once, with the fewest lanes."""
    plan = ln_plan(1, c)
    chunks = c // 8
    assert plan.lanes in (1, 2, 4, 8, 16, 32) and plan.rows * plan.lanes == 32
    held = sorted(j + plan.lanes * k for j in range(plan.lanes) for k in range(plan.chunks)
                  if j + plan.lanes * k < chunks)
    assert held == list(range(chunks))
    assert plan.chunks <= norms.LN_KMAX and (plan.lanes == 1 or
                                             -(-chunks // (plan.lanes // 2)) > norms.LN_KMAX)


def test_plan_refuses_what_the_kernels_do_not_take():
    for m, c in [(0, 320), (10, 12), (10, MAX_C + 8), (10, 0)]:
        with pytest.raises(ValueError):
            ln_plan(m, c)


def test_plan_matches_the_cuda_source():
    k = _constants()
    for name in ("LN_KMAX", "LN_CHUNK_BYTES", "LN_BLOCKS_PER_SM", "LN_FWD_WARPS",
                 "LN_FWD_STAGES", "LN_FWD_STAGE_BYTES", "LN_BWD_WARPS", "LN_BWD_STAGES",
                 "LN_BWD_STAGE_BYTES", "LN_FOLD", "LN_COUNTERS"):
        assert getattr(norms, name) == k[name], name
    assert k["LN_MAX_C"] == MAX_C == 32 * k["LN_KMAX"] * 8
    fwd, bwd = ln_plan(230400, 320, 132), ln_plan(230400, 320, 132, backward=True)
    assert fwd.smem == k["LN_FWD_SMEM"] and bwd.smem == k["LN_BWD_SMEM"]
    for plan, threads in [(fwd, 32 * k["LN_FWD_WARPS"]), (bwd, 32 * k["LN_BWD_WARPS"])]:
        # LN_BLOCKS_PER_SM blocks fit an SM: shared memory and threads
        assert plan.smem <= SMEM_LIMIT
        assert k["LN_BLOCKS_PER_SM"] * (plan.smem + 1024) <= SM_SMEM
        assert k["LN_BLOCKS_PER_SM"] * threads <= SM_THREADS
    assert k["LN_BLOCKS_PER_SM"] >= 2
    # a stage holds a step of x, fp32 dxn and dres; a warp's ring holds its
    # 2C column sums once the walk is done, and the fold of the largest grid
    # has its counters
    assert bwd.stage_bytes >= bwd.rows * 320 * (2 + 4 + 2)
    assert k["LN_BWD_STAGES"] * k["LN_BWD_STAGE_BYTES"] >= 2 * MAX_C * 4
    assert ln_plan(10 ** 7, 320, 132, True).groups + 1 <= k["LN_COUNTERS"]
    src = (CSRC / "layer_norm.cu").read_text()
    # the entries refuse a grid or a row group other than the plan's
    assert "grid > 0 && grid <= (steps + warps - 1) / warps" in src
    assert "(C / 8 + lanes - 1) / lanes > LN_KMAX" in src


# ---------------------------------------------------- numpy emulation, fp32

EPS = np.float32(1e-5)


def _lane_chunks(plan, c):
    """(lanes, chunks, 8) column index of each element a lane of a row holds,
    -1 where the chunk is past the row."""
    cols = np.full((plan.lanes, plan.chunks, 8), -1)
    for j, k in itertools.product(range(plan.lanes), range(plan.chunks)):
        ch = j + plan.lanes * k
        if ch < c // 8:
            cols[j, k] = ch * 8 + np.arange(8)
    return cols


def _lane_sum(vals):
    """Each lane's sum in the kernel's order (chunk, then element), fp32;
    vals (..., chunks, 8)."""
    s = np.zeros(vals.shape[:-2], np.float32)
    for k, e in itertools.product(range(vals.shape[-2]), range(8)):
        s = s + vals[..., k, e]
    return s


def _butterfly(v, lanes, start=1, axis=-1):
    """The __shfl_xor tree over offsets start, 2 start, ... < lanes along ``axis``."""
    idx = np.arange(v.shape[axis])
    o = start
    while o < lanes:
        v = v + np.take(v, idx ^ o, axis=axis)
        o *= 2
    return v


def _gather(a, cols):
    """a (rows, c) -> (rows, lanes, chunks, 8), zero past the row."""
    out = a[:, np.maximum(cols, 0)]
    return np.where(cols >= 0, out, np.float32(0))


def _emulate(x, dxn, gamma, beta, sms):
    """Forward and backward along the plans' walks: the row group's lane
    sums and butterflies; the backward's per-lane dγ/dβ sums over the walk,
    the warp's butterfly over its groups, the block's sum in warp order, and
    the two-level fold. Returns (y, dx, dγ, dβ)."""
    m, c = x.shape
    y = np.zeros_like(x)
    dx = np.zeros_like(x)
    for backward in (False, True):
        plan = ln_plan(m, c, sms, backward)
        cols = _lane_chunks(plan, c)
        g = _gather(gamma[None], cols)[0]
        b = _gather(beta[None], cols)[0]
        parts = []
        for block in range(plan.grid):
            red = []
            for warp in range(plan.warps):
                pg = np.zeros((32 // plan.lanes, plan.lanes, plan.chunks, 8), np.float32)
                pb = np.zeros_like(pg)
                for first, rows in plan.walk(block, warp, m):
                    xv = _gather(x[first:first + rows], cols)
                    s = _butterfly(_lane_sum(xv), plan.lanes)[..., None, None]
                    ss = _butterfly(_lane_sum(xv * xv), plan.lanes)[..., None, None]
                    mean = s / np.float32(c)
                    rstd = np.float32(1) / np.sqrt(np.maximum(ss / np.float32(c) - mean * mean,
                                                              np.float32(0)) + EPS)
                    xh = (xv - mean) * rstd
                    if not backward:
                        out = xh * g + b
                        for r in range(rows):
                            y[first + r, cols[cols >= 0]] = out[r][cols >= 0]
                        continue
                    d = _gather(dxn[first:first + rows], cols)
                    gx = d * g
                    s1 = _butterfly(_lane_sum(gx), plan.lanes)[..., None, None] / np.float32(c)
                    s2 = _butterfly(_lane_sum(gx * xh), plan.lanes)[..., None, None] / np.float32(c)
                    out = rstd * (gx - s1 - xh * s2)
                    for r in range(rows):
                        dx[first + r, cols[cols >= 0]] = out[r][cols >= 0]
                    pg[:rows] += d * xh
                    pb[:rows] += d
                if backward:  # the warp's groups, lane for lane: a butterfly over 32 lanes
                    flat = lambda p: _butterfly(p.reshape(32, -1), 32, plan.lanes, axis=0)
                    row = np.zeros(2 * c, np.float32)
                    valid = cols >= 0
                    row[cols[valid]] = flat(pg)[:plan.lanes].reshape(cols.shape)[valid]
                    row[c + cols[valid]] = flat(pb)[:plan.lanes].reshape(cols.shape)[valid]
                    red.append(row)
            if backward:
                part = np.zeros(2 * c, np.float32)
                for row in red:
                    part = part + row
                parts.append(part)
        if backward:
            folded = _fold(np.stack(parts), range(plan.grid))
    return y, dx, folded[:c], folded[c:]


def _fold(parts, arrivals):
    """The kernel's fold with blocks arriving in the order ``arrivals``:
    per group of LN_FOLD blocks an arrival counter; the last block of a
    group adds the group's rows in block order; the last group to finish
    adds the group rows in group order. Checks that the counters end at 0."""
    grid = len(parts)
    groups = -(-grid // norms.LN_FOLD)
    counters = [0] * (groups + 1)
    group_rows = np.zeros((groups, parts.shape[1]), np.float32)
    result = None
    for block in arrivals:
        g = block // norms.LN_FOLD
        b0, nb = g * norms.LN_FOLD, min(grid - g * norms.LN_FOLD, norms.LN_FOLD)
        ticket, counters[g] = counters[g], counters[g] + 1
        if ticket != nb - 1:
            continue
        acc = np.zeros(parts.shape[1], np.float32)
        for b in range(b0, b0 + nb):
            acc = acc + parts[b]
        group_rows[g] = acc
        counters[g] = 0
        ticket, counters[groups] = counters[groups], counters[groups] + 1
        if ticket != groups - 1:
            continue
        acc = np.zeros(parts.shape[1], np.float32)
        for row in group_rows:
            acc = acc + row
        result = acc
        counters[groups] = 0
    assert counters == [0] * (groups + 1) and result is not None
    return result


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("m,c,sms", [(300, 320, 2), (77, 1280, 3), (45, 64, 1), (130, 96, 2),
                                     (2000, 320, 12), (37, 40, 1)])
def test_row_groups_match_the_plain_versions(m, c, sms):
    rng = np.random.default_rng(m + c)
    x = (rng.standard_normal((m, c)) * 2 + 0.5).astype(np.float32)
    dxn = rng.standard_normal((m, c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    y, dx, dg, db = _emulate(x, dxn, gamma, beta, sms)
    tx, td, tg, tb = map(torch.from_numpy, (x, dxn, gamma, beta))
    ref_dx, ref_dg, ref_db = ln_bwd_plain(tx, td, tg)
    assert _rel(y, layer_norm_plain(tx, tg, tb).numpy()) <= 1e-5
    for got, want in [(dx, ref_dx), (dg, ref_dg), (db, ref_db)]:
        assert _rel(got, want.numpy()) <= 1e-5


@pytest.mark.parametrize("grid", [1, 5, 16, 17, 40, 264])
def test_fold_is_the_same_for_every_arrival_order(grid):
    """The sums' order depends on the grid alone: any order of arrival gives
    the bits of block order (partial rows of mixed magnitude, where another
    order of the sums would change the bits)."""
    rng = np.random.default_rng(grid)
    parts = (rng.standard_normal((grid, 64)) * 10.0 ** rng.integers(-4, 4, (grid, 64)))
    parts = parts.astype(np.float32)
    want = _fold(parts, range(grid))
    for seed in range(8):
        order = np.random.default_rng(seed).permutation(grid)
        assert _fold(parts, order).tobytes() == want.tobytes()
    assert _fold(parts, range(grid - 1, -1, -1)).tobytes() == want.tobytes()
    if grid > 2 * norms.LN_FOLD:  # and the two levels are not one sum in block order
        flat = np.zeros(64, np.float32)
        for row in parts:
            flat = flat + row
        assert flat.tobytes() != want.tobytes()
