"""What the CPU can check of K4 ``gn_silu_conv3`` and ``conv3`` on the TMA +
``wgmma`` skeleton: that ``conv3_plan``'s persistent grid takes every output
tile once and its tiles cover every row of every clip once, at every K4 and
``conv3`` site of the UNet and at the card tests' shapes; that a tap's box
stays within s rows of its clip; that the kernel's indexing, emulated here
with TMA's zero fill, is the 3-tap conv; that the plan's tiles, ring and
shared memory are the CUDA source's ``constexpr``s and fit a block; that the
wrappers refuse what the kernels do not take and hand the entry the plan;
and that the pre-pass followed by the plain conv is K4's plain version,
with a nonzero shift at the clip edges. No card, no JAX jit: each case
takes milliseconds."""

import collections
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu_torch.ops import _build, temporal_conv
from vista_tpu_torch.ops.temporal_conv import (conv3, conv3_plain, conv3_plan, gn_silu,
                                               gn_silu_conv3, gn_silu_conv3_plain, gn_silu_plain)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "vista_tpu_torch" / "csrc"
SMEM_LIMIT = 232448  # the shared memory one block may opt into on an H100 (227 KB)

# Token rows per frame (s) and width c at each level of the UNet (ds1, ds2,
# ds4, mid) for 576x1024 (72x128 latents) and 320x576 (40x72): s = 9216,
# 2304, 576, 144 and 2880, 720, 180, 45. K4 and conv3 run at every level,
# on one clip (training) or two (the CFG-doubled sampling batch), t = 25.
SITES = []
for h, w, res in [(72, 128, "576x1024"), (40, 72, "320x576")]:
    for level, c in [("ds1", 320), ("ds2", 640), ("ds4", 1280), ("mid", 1280)]:
        for b in (1, 2):
            SITES.append((b, 25, h * w, c, c, f"{level} {res} x{b}"))
        h, w = -(-h // 2), -(-w // 2)
# (clips, t, s, cin, cout) of the card tests (tests/test_torch_cuda.py)
CARD = [(2, 5, 45, 64, 96), (2, 5, 45, 64, 64), (3, 4, 180, 320, 320), (2, 25, 45, 1280, 1280),
        (3, 5, 180, 64, 328), (1, 25, 9216, 320, 320)]


def _plan_cases():
    return ([s[:5] for s in SITES] + CARD,
            [s[5] for s in SITES] + [f"card{s}" for s in CARD])


@pytest.mark.parametrize("b,t,s,cin,cout", _plan_cases()[0], ids=_plan_cases()[1])
def test_conv3_plan_covers_every_row_once(b, t, s, cin, cout):
    plan = conv3_plan(b, t, s, cin, cout)
    taken = [tile for blk in range(plan.grid) for tile in plan.tiles(blk)]
    assert len(taken) == len(set(taken)) == plan.items
    assert plan.grid == min(plan.items, 132)
    rows = t * s
    assert plan.rows == rows and (plan.panels - 1) * 128 < rows <= plan.panels * 128
    assert plan.col_tiles == -(-cout // 320)
    for col in range(plan.col_tiles):
        seen = collections.Counter()
        for clip, r0, n0 in taken:
            if n0 == col * 320:
                seen.update((clip, r) for r in range(r0, min(r0 + 128, rows)))
        assert set(seen) == {(clip, r) for clip in range(b) for r in range(rows)}
        assert set(seen.values()) == {1}
    assert plan.stages == 3 * cin // 64 and plan.tile == (128, 320)
    assert plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("b,t,s,cin,cout", _plan_cases()[0], ids=_plan_cases()[1])
def test_tap_boxes_stay_within_s_rows_of_their_clip(b, t, s, cin, cout):
    """The A box of tap ``tap`` starts (tap - 1) s rows from the tile's first
    row, so it never starts more than s rows outside its clip's [0, t s)."""
    plan = conv3_plan(b, t, s, cin, cout)
    for r0 in range(0, plan.rows, 128):
        for stage in range(plan.stages):
            tap = stage // (cin // 64)
            start = plan.tap_row(r0, stage)
            assert start == r0 + (tap - 1) * s
            assert -s <= start < plan.rows + s


@pytest.mark.parametrize("sms", [1, 7, 114])
def test_conv3_plan_on_fewer_sms(sms):
    plan = conv3_plan(2, 25, 180, 320, 640, sms)
    assert plan.grid == min(plan.items, sms)
    taken = [tile for blk in range(plan.grid) for tile in plan.tiles(blk)]
    assert len(set(taken)) == len(taken) == plan.items == 2 * 36 * 2


@pytest.mark.parametrize("b,t,s,cin,cout", [(2, 3, 45, 64, 72), (3, 2, 70, 128, 328),
                                            (1, 1, 20, 64, 8)])
def test_emulated_kernel_is_the_conv(b, t, s, cin, cout):
    """The kernel's indexing, emulated: per tile, per 64-deep stage, an A box
    of 128 rows from ``tap_row`` in the same clip (zeros outside the clip, as
    TMA fills them) times a W box of the K-major (cout, 3 cin) weight (zeros
    past cout), then the tile cropped to the clip and the output."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b * t, s, cin)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, 3, 1, 1)) * (3 * cin) ** -0.5).astype(np.float32)
    plan = conv3_plan(b, t, s, cin, cout, sms=5)
    xc = x.reshape(b, t * s, cin).astype(np.float64)
    wk = w.reshape(cout, cin, 3).transpose(0, 2, 1).reshape(cout, 3 * cin).astype(np.float64)
    out = np.full((b, t * s, cout), np.nan)
    for blk in range(plan.grid):
        for clip, r0, n0 in plan.tiles(blk):
            acc = np.zeros((128, 320))
            for stage in range(plan.stages):
                start = plan.tap_row(r0, stage)
                k = stage * 64 % cin
                a = np.zeros((128, 64))
                for i in range(128):
                    if 0 <= start + i < plan.rows:
                        a[i] = xc[clip, start + i, k:k + 64]
                wb = np.zeros((320, 64))
                cols = wk[n0:n0 + 320, stage * 64:stage * 64 + 64]
                wb[:cols.shape[0]] = cols
                acc += a @ wb.T
            rows, ncols = min(128, plan.rows - r0), min(320, cout - n0)
            out[clip, r0:r0 + rows, n0:n0 + ncols] = acc[:rows, :ncols]
    want = conv3_plain(torch.from_numpy(x), torch.from_numpy(w), None, t)
    np.testing.assert_allclose(out.reshape(b * t, s, cout), want.numpy(), rtol=1e-5, atol=1e-5)


def _constants():
    """The ``constexpr int`` names of the skeleton and of K4's source, in order."""
    env = {}
    for name in ("gemm_tma.cuh", "gn_silu_conv3.cu"):
        for decl in re.findall(r"constexpr int ([^;]+);", (CSRC / name).read_text()):
            for part in decl.split(","):
                key, expr = (s.strip() for s in part.split("=", 1))
                env[key] = eval(expr, {}, env)  # products and sums of the names above
    return env


def test_plan_matches_the_cuda_source():
    c = _constants()
    plan = conv3_plan(2, 25, 9216, 320, 320)
    assert plan.tile == (c["TG_BM"], c["TG_BN"]) and c["TG_BK"] == 64
    assert (plan.ring, plan.stage_bytes, plan.staging_bytes, plan.smem) == (
        c["CV_STAGES"], c["TG_STAGE_BYTES"], c["CV_STG_BYTES"], c["CV_SMEM"])
    assert c["CV_SMEM"] <= SMEM_LIMIT
    src = (CSRC / "gn_silu_conv3.cu").read_text()
    # the entry refuses another grid or shared memory than the plan's, and
    # the producer's A box starts where tap_row says
    assert "grid <= 0 || grid > items || items > (1L << 30) || smem != CV_SMEM" in src
    assert "K % TG_BK || N % 8" in src
    assert "it.r0 + (tap - 1) * S, it.clip" in src


def _forced_card(monkeypatch, calls):
    """The card's path on CPU tensors: the CUDA side replaced by a recorder."""
    monkeypatch.setattr(_build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_build, "check", lambda *a, **kw: None)
    monkeypatch.setattr(temporal_conv, "sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    for counter in ("LAUNCHES", "SITES"):
        monkeypatch.setattr(_build, counter, collections.Counter())


def _k4_args(bt, s, cin, cout):
    x = torch.zeros(bt, s, cin, dtype=torch.bfloat16)
    sc, sh = torch.zeros(bt, cin), torch.zeros(bt, cin)
    w, b = torch.zeros(cout, cin, 3, 1, 1, dtype=torch.bfloat16), torch.zeros(cout)
    return x, sc, sh, w, b


@pytest.mark.parametrize("cin,cout,frames,t", [(32, 64, 10, 5), (96, 64, 10, 5), (64, 12, 10, 5),
                                               (64, 64, 10, 3), (0, 64, 10, 5)])
def test_wrappers_refuse(monkeypatch, cin, cout, frames, t):
    """cin % 64, cout % 8 and frames that are not whole clips raise before
    anything is launched, in K4 and in conv3."""
    calls = []
    _forced_card(monkeypatch, calls)
    x, sc, sh, w, b = _k4_args(frames, 45, cin, cout)
    with pytest.raises(ValueError):
        gn_silu_conv3(x, sc, sh, w, b, t, emb=torch.zeros(frames, cout))
    with pytest.raises(ValueError):
        gn_silu_conv3(x, sc, sh, w, b, t, residual=torch.zeros(frames, 45, cout),
                      res_scale=torch.ones(1))
    with pytest.raises(ValueError):
        conv3(x, w, b, t)
    assert calls == [] and not _build.LAUNCHES


@pytest.mark.parametrize("epilogue", ["emb", "res", "conv3", "conv3 no bias"])
@pytest.mark.parametrize("clips,t,s,cin,cout", [(2, 5, 45, 64, 96), (1, 25, 144, 1280, 1280)])
def test_launches_the_plan(monkeypatch, epilogue, clips, t, s, cin, cout):
    """The wrappers hand ``vk_conv3`` the plan's grid and shared memory (which
    the entry checks against its own constexprs) and the clip layout; K4
    launches the pre-pass first; each launch is counted once, at its site."""
    calls = []
    _forced_card(monkeypatch, calls)
    bt = clips * t
    x, sc, sh, w, b = _k4_args(bt, s, cin, cout)
    if epilogue == "emb":
        gn_silu_conv3(x, sc, sh, w, b, t, emb=torch.zeros(bt, cout), site="emb")
    elif epilogue == "res":
        gn_silu_conv3(x, sc, sh, w, b, t, residual=torch.zeros(bt, s, cout),
                      res_scale=torch.tensor(0.5), site="res")
    else:
        conv3(x, w, b if epilogue == "conv3" else None, t, site="res-y")
    plan = conv3_plan(clips, t, s, cin, cout)
    names = [name for name, _ in calls]
    args = calls[-1][1]
    assert names == (["vk_gn_silu", "vk_conv3"] if epilogue in ("emb", "res") else ["vk_conv3"])
    assert args[7:12] == (clips, t, s, cin, cout) and args[-2:] == (plan.grid, plan.smem)
    has = [a is not None for a in args[2:6]]  # bias, emb, residual, res_scale
    assert has == {"emb": [True, True, False, False], "res": [True, False, True, True],
                   "conv3": [True, False, False, False],
                   "conv3 no bias": [False] * 4}[epilogue]
    if epilogue in ("emb", "res"):
        assert calls[0][1][4:] == (bt, s, cin)
        assert _build.LAUNCHES == {"gn_silu": 1, "gn_silu_conv3": 1}
        assert _build.SITES == {f"gn_silu/{epilogue}": 1, f"gn_silu_conv3/{epilogue}": 1}
    else:
        assert _build.LAUNCHES == {"conv3": 1} and _build.SITES == {"conv3/res-y": 1}


def _inputs(b, t, s, cin, cout, seed):
    rng = np.random.default_rng(seed)
    bt = b * t
    x = rng.standard_normal((bt, s, cin)).astype(np.float32)
    # per-frame scale and shift, the shift well away from 0 at every frame
    sc = (rng.standard_normal((bt, cin)) * 0.5 + 1).astype(np.float32)
    sh = (rng.standard_normal((bt, cin)) * 0.3 + 1.5).astype(np.float32)
    w = (rng.standard_normal((cout, cin, 3, 1, 1)) * (3 * cin) ** -0.5).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    emb = rng.standard_normal((bt, cout)).astype(np.float32)
    res = rng.standard_normal((bt, s, cout)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, sc, sh, w, bias, emb, res)]


@pytest.mark.parametrize("epilogue", ["emb", "res"])
def test_pre_pass_then_conv_is_k4(epilogue):
    """xn = gn_silu(x) then conv3 with zero padding of xn, then the epilogue,
    equals K4's plain version; padding x instead (each edge frame's own
    affine applied to the zeros, SiLU(shift) != 0) does not."""
    b, t, s, cin, cout = 2, 4, 6, 16, 8
    x, sc, sh, w, bias, emb, res = _inputs(b, t, s, cin, cout, seed=1)
    rs = torch.tensor([0.3])
    xn = gn_silu_plain(x, sc, sh)
    y = conv3_plain(xn, w, bias, t)
    if epilogue == "emb":
        got, want = y + emb[:, None], gn_silu_conv3_plain(x, sc, sh, w, bias, t, emb=emb)
    else:
        got = res + rs * y
        want = gn_silu_conv3_plain(x, sc, sh, w, bias, t, residual=res, res_scale=rs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    # the trap: a zero frame of x before frame 0 (after frame t - 1) under
    # frame 0's (t - 1's) affine is SiLU(shift) != 0, not the padding's 0
    w3, shv = w.reshape(cout, cin, 3), sh.reshape(b, t, cin)
    lead = torch.nn.functional.silu(shv[:, 0]) @ w3[:, :, 0].t()  # (b, cout), every row
    tail = torch.nn.functional.silu(shv[:, -1]) @ w3[:, :, 2].t()
    assert max(lead.abs().max(), tail.abs().max()) > 0.1 * y.abs().max()


def test_gn_silu_plain_is_silu_of_the_affine():
    """The pre-pass's plain version against the formula in float64, with
    per-frame scale and shift."""
    x, sc, sh = _inputs(2, 3, 5, 16, 8, seed=2)[:3]
    a = x.double() * sc.double()[:, None] + sh.double()[:, None]
    np.testing.assert_allclose(gn_silu_plain(x, sc, sh).numpy(),
                               (a / (1 + torch.exp(-a))).numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(gn_silu(x, sc, sh), gn_silu_plain(x, sc, sh))  # CPU: the plain version
