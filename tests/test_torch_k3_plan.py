"""What the CPU can check of K3 ``linear_residual`` and ``ff_bwd_dh`` on the
GEMM skeleton: that each plan's persistent grid takes every output tile
exactly once and its tiles cover every output row and column, at every UNet
site and at the card tests' shapes; that the plans' tiles, ring stages and
shared-memory bytes are the CUDA sources' ``constexpr``s and fit a block;
that the wrappers refuse the shapes the kernels do not take; and the plain
version of ``ff_bwd_dh`` against numpy. No card, no JAX jit: each case takes
milliseconds."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu_torch.ops import _build, fused_ff, linear
from vista_tpu_torch.ops.fused_ff import ff_bwd_dh, ff_bwd_dh_plain, ff_bwd_dh_plan, ff_bwd_plain
from vista_tpu_torch.ops.linear import linear_residual, linear_residual_plan

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "vista_tpu_torch" / "csrc"
SMEM_LIMIT = 232448  # the shared memory one block may opt into on an H100 (227 KB)

# Token rows per frame at each transformer level of the UNet (ds1, ds2, ds4
# and the mid block, ds8) for 576x1024 (72x128 latents) and 320x576 (40x72),
# with the level's width c.
LEVELS = []
for h, w, res in [(72, 128, "576x1024"), (40, 72, "320x576")]:
    for level, c in [("ds1", 320), ("ds2", 640), ("ds4", 1280), ("mid", 1280)]:
        LEVELS.append((h * w, c, f"{level} {res}"))
        h, w = -(-h // 2), -(-w // 2)

# K3: (m, k, n) of FF-out (k = 4c) and attn-out / temporal-out (k = c),
# 50 frames when sampling (the doubled CFG batch), 25 in training
K3_SITES = [(frames * hw, k, c, f"{site} {name} x{frames}")
            for hw, c, name in LEVELS for frames in (50, 25)
            for k, site in [(4 * c, "ff-out"), (c, "attn-out")]]
K3_CARD = [(300, 256, 200), (1000, 320, 320), (777, 1280, 320), (300, 640, 640),
           (515, 2560, 640), (129, 1280, 1280), (260, 5120, 1280), (70, 96, 64), (200, 200, 8),
           (3000, 1280, 320), (28800, 5120, 1280), (4608 * 25, 640, 640)]
# ff_bwd_dh: (m, c) of the training sites (25 frames) and the card tests
FB_SITES = [(25 * hw, c, f"ff {name}") for hw, c, name in LEVELS]
FB_CARD = [(300, 64), (130, 96), (461, 64), (1000, 96), (777, 320), (300, 1280), (3000, 320),
           (72000, 320), (18000, 640), (4500, 1280)]


def _covers_once(plan, m, n):
    """Every tile taken by exactly one block, once; the tiles are the whole
    grid of row panels x column tiles and reach past the output's last row
    and column by less than a tile."""
    taken = [t for b in range(plan.grid) for t in plan.tiles(b)]
    assert len(taken) == len(set(taken)) == plan.items
    rows, cols = -(-m // plan.tile[0]), -(-n // plan.tile[1])
    assert plan.col_tiles == cols and plan.items == rows * cols
    assert set(taken) == {(r * plan.tile[0], c * plan.tile[1])
                          for r in range(rows) for c in range(cols)}
    assert (rows - 1) * plan.tile[0] < m <= rows * plan.tile[0]
    assert (cols - 1) * plan.tile[1] < n <= cols * plan.tile[1]


@pytest.mark.parametrize("m,k,n", [s[:3] for s in K3_SITES] + K3_CARD,
                         ids=[s[3] for s in K3_SITES] + [f"card{s}" for s in K3_CARD])
def test_linear_residual_plan(m, k, n):
    plan = linear_residual_plan(m, k, n)
    _covers_once(plan, m, n)
    assert plan.grid == min(plan.items, 132)
    assert plan.stages == math.ceil(k / 64)
    assert plan.tile == (128, 320) and plan.smem <= SMEM_LIMIT
    if n in (320, 640, 1280):  # no ragged column tile at a UNet width
        assert n % plan.tile[1] == 0


@pytest.mark.parametrize("m,c", [s[:2] for s in FB_SITES] + FB_CARD,
                         ids=[s[2] for s in FB_SITES] + [f"card{s}" for s in FB_CARD])
def test_ff_bwd_dh_plan(m, c):
    plan = ff_bwd_dh_plan(m, c, 4 * c)
    _covers_once(plan, m, 4 * c)
    assert plan.grid == min(plan.items, 132)
    assert plan.stages == 2 * math.ceil(c / 64)  # [a | g], then dhg
    assert plan.tile == (128, 64) and plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("sms", [1, 7, 114])
def test_plans_on_fewer_sms(sms):
    for plan, m, n in [(linear_residual_plan(1000, 640, 1280, sms), 1000, 1280),
                       (ff_bwd_dh_plan(1000, 96, 384, sms), 1000, 384)]:
        assert plan.grid == min(plan.items, sms)
        _covers_once(plan, m, n)


def _constants():
    """The ``constexpr int`` names of the skeleton, K3 and ff_bwd, in order."""
    env = {}
    for name in ("gemm_tma.cuh", "linear_residual.cu", "ff_bwd.cu"):
        for decl in re.findall(r"constexpr int ([^;]+);", (CSRC / name).read_text()):
            for part in decl.split(","):
                key, expr = (s.strip() for s in part.split("=", 1))
                env[key] = eval(expr, {}, env)  # products and sums of the names above
    return env


def test_plans_match_the_cuda_sources():
    c = _constants()
    k3 = linear_residual_plan(460800, 1280, 320)
    assert k3.tile == (c["TG_BM"], c["TG_BN"])
    assert (k3.ring, k3.stage_bytes, k3.staging_bytes, k3.smem) == (
        c["K3_STAGES"], c["TG_STAGE_BYTES"], c["K3_STG_BYTES"], c["K3_SMEM"])
    fb = ff_bwd_dh_plan(230400, 320, 1280)
    assert fb.tile == (c["TG_BM"], c["FB_NI"])
    assert (fb.ring, fb.stage_bytes, fb.staging_bytes, fb.smem) == (
        c["FB_STAGES"], c["FB_STAGE_BYTES"], c["FB_STG_BYTES"], c["FB_SMEM"])
    # the skeleton's own kernels keep their 4-stage ring
    assert c["TG_STAGES"] == 4 and c["TG_SMEM"] <= SMEM_LIMIT
    assert max(c["K3_SMEM"], c["FB_SMEM"]) <= SMEM_LIMIT


@pytest.mark.parametrize("m,k,n", [(100, 12, 64), (100, 64, 12), (0, 64, 64), (100, 0, 64)])
def test_linear_residual_refuses(monkeypatch, m, k, n):
    """On the card's path (forced here), a shape the kernel does not take
    raises before anything is launched; no rows (an empty band of
    height-parallel sampling) give an empty result, also launching
    nothing."""
    monkeypatch.setattr(_build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(linear, "sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "launch", lambda *a: pytest.fail("launched"))
    a, w = torch.zeros(m, k, dtype=torch.bfloat16), torch.zeros(n, k, dtype=torch.bfloat16)
    residual = torch.zeros(m, n, dtype=torch.bfloat16)
    if m == 0:
        assert linear_residual(a, w, torch.zeros(n), residual).shape == (0, n)
        return
    with pytest.raises(ValueError):
        linear_residual(a, w, torch.zeros(n), residual)


@pytest.mark.parametrize("m,c,n", [(100, 12, 48), (100, 64, 96), (100, 64, 0), (0, 64, 256)])
def test_ff_bwd_dh_refuses(monkeypatch, m, c, n):
    monkeypatch.setattr(_build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(fused_ff, "sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "launch", lambda *a: pytest.fail("launched"))
    xn = torch.zeros(m, c, dtype=torch.bfloat16)
    w1, w2 = torch.zeros(2 * n, c, dtype=torch.bfloat16), torch.zeros(c, n, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ff_bwd_dh(xn, xn, w1, torch.zeros(2 * n), w2)


def _rows(*shape, seed, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


def test_ff_bwd_dh_plain():
    """hg and dH against the formulas in float64 (exact erf), and dW1 =
    dH^T xn against the whole backward's plain version."""
    m, c = 37, 16
    n = 4 * c
    xn, dy = _rows(m, c, seed=0), _rows(m, c, seed=1)
    w1, b1 = _rows(2 * n, c, seed=2, std=c ** -0.5), _rows(2 * n, seed=3, std=0.1)
    w2 = _rows(c, n, seed=4, std=n ** -0.5)
    hg, dh = ff_bwd_dh(*map(torch.from_numpy, (xn, dy, w1, b1, w2)))
    h = xn.astype(np.float64) @ w1.T + b1
    a, g = h[:, :n], h[:, n:]
    cdf = 0.5 * (1 + np.vectorize(math.erf)(g / math.sqrt(2)))
    pdf = np.exp(-0.5 * g * g) / math.sqrt(2 * math.pi)
    dhg = dy.astype(np.float64) @ w2
    np.testing.assert_allclose(hg.numpy(), a * g * cdf, rtol=1e-5, atol=1e-5)
    want = np.concatenate([dhg * g * cdf, dhg * a * (cdf + g * pdf)], axis=1)
    np.testing.assert_allclose(dh.numpy(), want, rtol=1e-5, atol=1e-5)
    # with LN the identity: xn = LN(x) of gamma 1, beta 0 on rows of mean 0, variance 1
    x = (xn - xn.mean(1, keepdims=True)) / xn.std(1, keepdims=True)
    x_t = torch.from_numpy(x.astype(np.float32))
    ones, zeros = torch.ones(c), torch.zeros(c)
    grads = ff_bwd_plain(x_t, ones, zeros, *map(torch.from_numpy, (w1, b1, w2)),
                         torch.from_numpy(dy))
    xn_t = torch.nn.functional.layer_norm(x_t, (c,), ones, zeros, 1e-5)
    _, dh_x = ff_bwd_dh_plain(xn_t, torch.from_numpy(dy), *map(torch.from_numpy, (w1, b1, w2)))
    np.testing.assert_allclose(grads[3].numpy(), (dh_x.t() @ xn_t).numpy(), rtol=1e-4, atol=1e-4)
