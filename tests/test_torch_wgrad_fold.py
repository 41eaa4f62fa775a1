"""What the CPU can check of ``vk_wgrad``'s bias gradient and in-launch
split fold (``csrc/ff_bwd.cu``): ``weight_grad(..., want_db=True)`` on the
CPU path against numpy; the launch the wrapper hands the kernel; a model of
how the bias gradient rides on the products (the 72-column product's last
block of B is the ones block behind the ring, for every ring stage and
depth slice; its column-320 lanes write every row of a tile once; only
items of column tile 0 write db, once per split, segment and row tile); a
model of the fold's slices (every partial quad folded once, by one block,
in split order) for grids of 132 and 114 at every plan shape; and an
emulation of the whole launch in numpy (items, partials, column sums,
fold) against the plain fp32 product. The kernel's constants are read from
the source. No card, no JAX; seconds to run."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vista_tpu_torch.ops import _build, linear
from vista_tpu_torch.ops.linear import (GEMM_TILE, TOKEN_BOX, bias_grad_plain, weight_bias_grads,
                                        weight_grad, weight_grad_plain, wgrad_launch, wgrad_plan)

CSRC = Path(__file__).resolve().parents[1] / "vista_tpu_torch" / "csrc"
SMEM_LIMIT = 232448  # bytes of shared memory a block can opt into on an H100

# (M; segs x N1 x N2): every phase-1 shape, the phase-2 ones, ragged and tiny ones
PLAN_SHAPES = [(230400, 1, 320, 320), (230400, 3, 320, 320), (230400, 1, 2560, 320),
               (230400, 1, 320, 1280), (57600, 3, 640, 640), (14400, 3, 1280, 1280),
               (14400, 1, 1280, 1280), (72000, 1, 2560, 320), (4500, 1, 320, 1280),
               (129, 1, 96, 64), (1000, 1, 320, 320), (4097, 1, 2560, 320), (300, 1, 320, 1280),
               (20000, 1, 64, 96), (1000, 3, 96, 96), (63, 1, 64, 64), (1, 1, 64, 64)]


def _constants():
    """The ``constexpr int`` names of the skeleton and of ff_bwd.cu."""
    env = {}
    for name in ("gemm_tma.cuh", "ff_bwd.cu"):
        for decl in re.findall(r"constexpr int ([^;]+);", (CSRC / name).read_text()):
            for part in decl.split(","):
                key, expr = (s.strip() for s in part.split("=", 1))
                # products, sums and C's integer quotients of the names above
                env[key] = eval(expr.replace("/", "//"), {}, env)
    return env


def _rows(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_constants_match_the_source():
    c = _constants()
    assert c["WG_FOLD_THREADS"] == 32 * c["TG_CONSUMER_WARPS"]  # the consumer threads fold
    # the ring, the ones block (16 deep x 8 in two 8-row groups of 128-byte
    # swizzled rows) and the barriers fit the block's shared memory with the
    # 960 bytes of alignment slack the kernel checks for
    assert c["WG_ONES_BYTES"] == 16 * 128
    assert c["WG_NEED"] == c["TG_STAGES"] * c["TG_STAGE_BYTES"] + c["WG_ONES_BYTES"] + \
        16 * c["TG_STAGES"]
    assert c["WG_SMEM"] == SMEM_LIMIT and SMEM_LIMIT - c["WG_NEED"] == 960
    assert (c["TG_BM"], c["TG_BN"], c["TG_BK"]) == (*GEMM_TILE, TOKEN_BOX)


def test_ones_block_is_the_last_columns_of_every_slice():
    """The 72-column product reads columns 256..319 from box 4 of the stage
    and 320..327 at box 4 + LBO: for every ring stage and 16-deep slice the
    LBO is a positive multiple of 16 that the descriptor's 14-bit field
    holds, and lands on the ones block behind the ring; the 2 KB read there
    (16 rows of 128 bytes) stays inside the block."""
    c = _constants()
    ones = c["TG_STAGES"] * c["TG_STAGE_BYTES"]  # from the ring's base
    for stage in range(c["TG_STAGES"]):
        b_tile = stage * c["TG_STAGE_BYTES"] + c["TG_A_BYTES"]
        for kk in range(c["TG_BK"] // 16):
            box4 = b_tile + 4 * c["TG_BOX_BYTES"] + kk * 2048
            lbo = ones - box4
            assert 0 < lbo < 16 * 2 ** 14 and lbo % 16 == 0
            assert (lbo >> 4) & 0x3FFF == lbo >> 4
            assert box4 + lbo == ones and (box4 + lbo) % 1024 == 0
            # box 4's own slice: 16 rows of 128 bytes inside the stage
            assert box4 + 16 * 128 <= (stage + 1) * c["TG_STAGE_BYTES"]
    assert ones + c["WG_ONES_BYTES"] + 16 * c["TG_STAGES"] == c["WG_NEED"]


def test_column_sum_lanes_write_each_row_once():
    """wgmma's D layout: d[4 j + 2 i + e] is row 16 w + g + 8 i, column 8 j +
    2 t + e (g = lane / 4, t = lane % 4). Lanes with t = 0 hold column 320
    (j = 8, e = 0) in d[32] and d[34]; together the two warpgroups' lanes
    write every row of the 128-row tile exactly once."""
    rows = []
    for wg in range(2):
        for w in range(4):
            for lane in range(0, 32, 4):
                r = 64 * wg + 16 * w + (lane >> 2)
                for i in range(2):
                    j, e = (32 + 2 * i) // 4, 0
                    assert 8 * j + 2 * (lane & 3) + e == 64  # column 320 of the tile
                    rows.append(r + 8 * i)
    assert sorted(rows) == list(range(GEMM_TILE[0]))


@pytest.mark.parametrize("segs,m,n1,n2", [(1, 129, 96, 64), (3, 70, 32, 48), (1, 1, 8, 8)])
def test_weight_grad_with_db_cpu(segs, m, n1, n2):
    a = _rows(segs, m, n1, seed=4)
    b = _rows(m, n2, seed=5)
    want_dw = np.concatenate([x.T.astype(np.float64) @ b for x in a])
    want_db = np.concatenate([x.astype(np.float64).sum(0) for x in a])
    at = torch.from_numpy(a[0] if segs == 1 else a)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        dw, db = weight_grad(at, torch.from_numpy(b), dtype, want_db=True)
        assert dw.dtype == dtype and db.dtype == torch.float32
        assert dw.shape == (segs * n1, n2) and db.shape == (segs * n1,)
        np.testing.assert_allclose(dw.float().numpy(), want_dw, rtol=tol, atol=tol * 10)
        np.testing.assert_allclose(db.numpy(), want_db, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(bias_grad_plain(at).numpy(), want_db, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("need_dw,need_db", [(True, True), (True, False), (False, True),
                                             (False, False)])
def test_weight_bias_grads(need_dw, need_db):
    """db without dW is the same call with dW dropped; nothing asked, nothing run."""
    a, b = torch.from_numpy(_rows(50, 16, seed=6)), torch.from_numpy(_rows(50, 24, seed=7))
    dw, db = weight_bias_grads(a, b, torch.float32, need_dw, need_db)
    assert (dw is not None) == need_dw and (db is not None) == need_db
    if need_dw:
        torch.testing.assert_close(dw, weight_grad_plain(a, b))
    if need_db:
        torch.testing.assert_close(db, a.sum(0))


@pytest.mark.parametrize("m,segs,n1,n2,want_db,dtype",
                         [(230400, 1, 320, 320, True, torch.bfloat16),
                          (14400, 3, 1280, 1280, False, torch.float32),
                          (14400, 1, 1280, 1280, True, torch.float32),
                          (63, 1, 64, 64, True, torch.bfloat16)])
def test_weight_grad_launch(monkeypatch, m, segs, n1, n2, want_db, dtype):
    """On the card's path (forced here, nothing launched): the wrapper hands
    the kernel the plan's splits and grid, partials of the plan's size and
    the stream's barrier only with more than one split, and db only when
    asked."""
    calls = []
    barrier = torch.zeros(2, dtype=torch.int32)
    monkeypatch.setattr(_build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_build, "check", lambda *a, **k: None)
    monkeypatch.setattr(linear, "sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "stream_ints", lambda name, n, device: barrier)
    monkeypatch.setattr(_build, "launch", lambda *args: calls.append(args))
    real_empty, made = torch.empty, []

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    a = torch.zeros(segs, m, n1, dtype=torch.bfloat16) if segs > 1 else \
        torch.zeros(m, n1, dtype=torch.bfloat16)
    out = weight_grad(a, torch.zeros(m, n2, dtype=torch.bfloat16), dtype, want_db=want_db)
    plan = wgrad_launch(m, n1, n2, segs, 132, want_db)
    (name, _, _, part, dw, db, bar, *ints), = calls
    assert name == "vk_wgrad"
    assert ints == [m, n1, n2, segs, plan.splits, plan.rows_per_split, plan.grid,
                    int(dtype == torch.bfloat16)]
    dw_t = out[0] if want_db else out
    assert dw == dw_t.data_ptr() and dw_t.dtype == dtype and dw_t.shape == (segs * n1, n2)
    assert (db is not None) == want_db
    if want_db:
        assert db == out[1].data_ptr() and out[1].shape == (segs * n1,)
    if plan.splits == 1:
        assert part is None and bar is None
    else:
        assert bar == barrier.data_ptr()
        part_t, = [t for t in made if t.data_ptr() == part]
        assert part_t.shape == (plan.splits, plan.part_len) and part_t.dtype == torch.float32


def _decode(item, per_split, t1, t2):
    """The kernel's item -> (split, segment, first row n1, first column n2)."""
    split, r = divmod(item, per_split)
    s, r = divmod(r, t1 * t2)
    return split, s, r // t2 * GEMM_TILE[0], r % t2 * GEMM_TILE[1]


@pytest.mark.parametrize("m,segs,n1,n2", PLAN_SHAPES)
def test_db_written_by_column_tile_zero_only(m, segs, n1, n2):
    """Each (split, segment, row tile) of db is written by exactly one item,
    the one whose column tile of B is 0, whatever block takes it."""
    plan = wgrad_launch(m, n1, n2, segs, 132, True)
    t1, t2 = -(-n1 // GEMM_TILE[0]), -(-n2 // GEMM_TILE[1])
    per_split = segs * t1 * t2
    assert plan.items == plan.splits * per_split
    summed = {}
    for item in range(plan.items):
        split, s, r0, c0 = _decode(item, per_split, t1, t2)
        if c0 == 0:
            key = (split, s, r0)
            summed[key] = summed.get(key, 0) + 1
    assert sorted(summed) == [(k, s, r * GEMM_TILE[0]) for k in range(plan.splits)
                              for s in range(segs) for r in range(t1)]
    assert set(summed.values()) == {1}


def _fold_order(splits, unroll):
    """The splits in the order one thread adds them: the kernel's loop of
    ``unroll`` loads in flight, then their adds in order."""
    order = []
    for k0 in range(0, splits, unroll):
        loaded = [k0 + u for u in range(unroll) if k0 + u < splits]
        for u in range(unroll):
            if k0 + u >= splits:
                break
            order.append(loaded[u])
    return order


@pytest.mark.parametrize("m,segs,n1,n2", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
def test_fold_covers_every_output_once_in_split_order(m, segs, n1, n2, sms):
    c = _constants()
    for want_db in (False, True):
        plan = wgrad_launch(m, n1, n2, segs, sms, want_db)
        assert plan.grid == min(plan.items, sms)
        dw_len = segs * n1 * n2
        assert plan.part_len == dw_len + (segs * n1 if want_db else 0)
        assert dw_len % 4 == 0 and plan.part_len % 4 == 0  # a quad is dW's or db's
        quads = plan.part_len // 4
        per = -(-quads // plan.grid)  # the kernel's slice of a block
        threads = c["WG_FOLD_THREADS"]
        folded = np.zeros(quads, int)
        for b in range(plan.grid):
            q0, q1 = b * per, min(quads, (b + 1) * per)
            if b in (0, plan.grid - 1):  # the block's threads take its slice between them
                mine = np.concatenate([np.arange(q0 + t, q1, threads) for t in range(threads)])
                assert (np.sort(mine) == np.arange(q0, max(q0, q1))).all()
            folded[q0:q1] += 1
        assert (folded == 1).all()
        assert _fold_order(plan.splits, c["WG_FOLD"]) == list(range(plan.splits))


@pytest.mark.parametrize("m,segs,n1,n2", PLAN_SHAPES[:9])
def test_partials_fit_in_l2_at_the_training_shapes(m, segs, n1, n2):
    """On the H100's 132 SMs every phase-1 and phase-2 plan's partials fit
    in its 50 MB L2, where the fold reads them moments after they were
    written (dW1 at ds1: 13 splits of 2560 x 320 and db, 42.7 MB)."""
    plan = wgrad_launch(m, n1, n2, segs, 132, True)
    assert plan.splits * plan.part_len * 4 < 50e6


def _emulate(a, b, plan, want_db):
    """``vk_wgrad`` in numpy, fp32 throughout: each item's partial tile and,
    on column tile 0, its column sums, written into the partials, then the
    fold in split order; every partial element must be written exactly
    once."""
    segs, m, n1 = a.shape
    n2 = b.shape[1]
    bm, bn = GEMM_TILE
    t1, t2 = -(-n1 // bm), -(-n2 // bn)
    per_split = segs * t1 * t2
    dw_len = segs * n1 * n2
    part = np.full((plan.splits, plan.part_len), np.nan, np.float32)
    written = np.zeros(part.shape, int)
    for item in range(plan.items):
        split, s, r0, c0 = _decode(item, per_split, t1, t2)
        m0, m1 = split * plan.rows_per_split, min(m, (split + 1) * plan.rows_per_split)
        rows, cols = slice(r0, min(n1, r0 + bm)), slice(c0, min(n2, c0 + bn))
        part[split, :dw_len].reshape(segs, n1, n2)[s, rows, cols] = \
            a[s, m0:m1, rows].T @ b[m0:m1, cols]
        written[split, :dw_len].reshape(segs, n1, n2)[s, rows, cols] += 1
        if not (want_db and c0 == 0):
            continue
        # the column sums of the item's tokens (its 72-column product)
        lo = dw_len + s * n1 + r0
        part[split, lo:lo + rows.stop - r0] = a[s, m0:m1, rows].sum(0, dtype=np.float32)
        written[split, lo:lo + rows.stop - r0] += 1
    assert (written == 1).all()
    out = np.zeros(plan.part_len, np.float32)
    for k in _fold_order(plan.splits, _constants()["WG_FOLD"]):
        out += part[k]
    return out[:dw_len].reshape(segs * n1, n2), out[dw_len:]


@pytest.mark.parametrize("m,segs,n1,n2", [(129, 1, 96, 64), (1000, 1, 320, 320),
                                          (300, 1, 320, 1280), (4097, 1, 200, 320),
                                          (1000, 3, 96, 96), (63, 1, 64, 64),
                                          (20000, 1, 64, 96)])
@pytest.mark.parametrize("sms", [132, 7])
def test_emulated_launch_matches_the_plain_product(m, segs, n1, n2, sms):
    a, b = _rows(segs, m, n1, seed=8), _rows(m, n2, seed=9)
    plan = wgrad_launch(m, n1, n2, segs, sms, True)
    assert (plan.splits, plan.rows_per_split) == wgrad_plan(m, n1, n2, segs, sms)[1:]
    dw, db = _emulate(a, b, plan, True)
    at = torch.from_numpy(a)
    want_dw = weight_grad_plain(at, torch.from_numpy(b)).numpy()
    want_db = bias_grad_plain(at).numpy()
    assert np.abs(dw - want_dw).max() <= 1e-5 * np.abs(want_dw).max() * max(1, plan.splits)
    assert np.abs(db - want_db).max() <= 1e-5 * np.abs(a).sum(1).max()
