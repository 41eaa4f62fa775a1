"""What the CPU can check of K1's forward routing (``attention_plan``) and
the attention backward's (``attention_bwd_plan``): the route of every UNet
site at both resolutions and of ragged shapes, that the forward's grid
(the one its entry is handed) covers every query row, and the backward's
dK/dV and dQ grids every key
and query row, of every (batch row, head) exactly once, that tiles are
whole 64-row boxes and shared memory fits a block, that the plans' tile,
stage and shared-memory numbers are the CUDA sources', and the wgmma
route's pre-pass in its plain form. No card, no JAX jit: each case takes
milliseconds."""

import collections
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vista_tpu_torch.ops.attention import (FWD_SMALL_KEYS, FWD_STAGES, SMALL_KEYS,
                                           attention_bwd, attention_bwd_plain,
                                           attention_bwd_plan, attention_bwd_prep,
                                           attention_bwd_prep_plain, attention_forward,
                                           attention_plain, attention_plan)

ROOT = Path(__file__).resolve().parents[1]
SMEM_LIMIT = 232448  # the shared memory one block may opt into on an H100 (227 KB)

# (b, s_q, s_k, heads, kv_len, site): every attention of the UNet at
# 576x1024 (72x128 latents) and 320x576 (40x72), batch 1 x 25 frames; the
# spatial sites attend over h w tokens with 5/10/20 heads at ds1/ds2/ds4
# and mid (ds8), the temporal ones over t = 25 frames for every h w row.
SITES = []
for h, w, res in [(72, 128, "576x1024"), (40, 72, "320x576")]:
    for level, heads in [("ds1", 5), ("ds2", 10), ("ds4", 20), ("mid", 20)]:
        n = h * w
        SITES.append((25, n, n, heads, n, f"spatial {level} {res}"))
        SITES.append((n, 25, 25, heads, 25, f"temporal {level} {res}"))
        h, w = -(-h // 2), -(-w // 2)

# ragged lengths, s_q != s_k, kv_len < s_k, the threshold on each side
RAGGED = [(3, 1000, 1000, 5, 1000), (2, 640, 700, 5, 600), (3, 100, 130, 2, 77),
          (2, 300, 300, 1, 257), (2, 2304, 2304, 10, 2304),
          (2, SMALL_KEYS + 1, SMALL_KEYS + 1, 1, SMALL_KEYS + 1),
          (2, SMALL_KEYS, SMALL_KEYS, 1, SMALL_KEYS), (40, 25, 25, 5, 25), (1, 1, 1, 1, 1),
          (2, 129, 200, 3, 1), (1, 7, 4000, 2, 3999)]


def test_sites_cover_both_resolutions():
    names = [s[-1] for s in SITES]
    assert "spatial ds1 576x1024" in names and "temporal mid 320x576" in names
    sizes = {s[-1]: s[1] for s in SITES}
    levels = ("ds1", "ds2", "ds4", "mid")
    assert [sizes[f"spatial {n} 576x1024"] for n in levels] == [9216, 2304, 576, 144]
    assert [sizes[f"spatial {n} 320x576"] for n in levels] == [2880, 720, 180, 45]


def _covered(plan, grid, block, tile, s):
    """How often each (batch row, head, row) is in a block's range of
    ``tile`` rows, over every block of ``grid``."""
    counts = np.zeros((plan.b, plan.heads, s), dtype=np.int64)
    ys = range(grid[1]) if len(grid) == 2 else [0]
    for y in ys:
        b, h, r0 = block(np.arange(grid[0]), y)
        b, h = np.broadcast_to(b, r0.shape), np.broadcast_to(h, r0.shape)
        for off in range(tile):
            rows = r0 + off
            keep = rows < s
            np.add.at(counts, (b[keep], h[keep], rows[keep]), 1)
    return counts


@pytest.mark.parametrize("b,s_q,s_k,heads,kv_len", [s[:5] for s in SITES] + RAGGED,
                         ids=[s[-1] for s in SITES] + [f"ragged{r}" for r in RAGGED])
def test_plan(b, s_q, s_k, heads, kv_len):
    plan = attention_bwd_plan(b, s_q, s_k, heads, kv_len)
    # the route: more than SMALL_KEYS keys take the wgmma kernels
    assert plan.route == ("mma" if s_k <= SMALL_KEYS else "wgmma")
    # tiles are whole 64-row boxes; shared memory fits one block
    assert plan.tile % 64 == 0
    assert all(0 < v <= SMEM_LIMIT for v in plan.smem.values())
    assert plan.threads % 128 == 0
    # every key row and every query row of every (batch row, head) once
    assert (_covered(plan, plan.dkv_grid, plan.dkv_block, plan.tile, s_k) == 1).all()
    assert (_covered(plan, plan.dq_grid, plan.dq_block, plan.tile, s_q) == 1).all()
    # the pre-pass: 8 threads per (batch row, head, padded query), 256 a block
    pairs = b * heads * plan.s_q_pad
    assert plan.prep_blocks * 32 >= pairs > (plan.prep_blocks - 1) * 32
    if plan.route == "wgmma":
        assert set(plan.smem) == {"dkv", "dq"}
        assert plan.s_q_pad % plan.tile == 0 and s_q <= plan.s_q_pad < s_q + plan.tile
    else:
        assert plan.smem == {} and plan.s_q_pad == s_q


def test_plan_refuses_bad_shapes():
    with pytest.raises(ValueError):
        attention_bwd_plan(1, 10, 10, 1, 0)
    with pytest.raises(ValueError):
        attention_bwd_plan(1, 10, 10, 1, 11)
    with pytest.raises(ValueError):
        attention_bwd_plan(1, 10, 100, 1, 100, route="flash")


def test_forced_route():
    assert attention_bwd_plan(2880, 25, 25, 5, 25, route="wgmma").route == "wgmma"
    assert attention_bwd_plan(25, 2880, 2880, 5, 2880, route="mma").route == "mma"


def _constants(source="attention_bwd.cu", prefix="WB", env=None):
    """The wgmma route's ``constexpr int <prefix>...`` of a CUDA source."""
    src = (ROOT / "vista_tpu_torch" / "csrc" / source).read_text()
    env = dict(env or {"HD": 64})
    for name, expr in re.findall(rf"constexpr int ({prefix}\w*) = ([^;]+);", src):
        env[name] = eval(expr, {}, env)  # products and sums of the names above
    return env


def test_plan_matches_the_cuda_source():
    c = _constants()
    plan = attention_bwd_plan(25, 9216, 9216, 5, 9216)
    assert plan.tile == c["WB"]
    assert plan.threads == c["WB_THREADS"]
    assert plan.smem == {"dkv": c["WB_DKV_SMEM"], "dq": c["WB_DQ_SMEM"]}
    assert c["WB"] % 64 == 0 and c["WB_THREADS"] == 384


@pytest.mark.parametrize("b,s_q,s_k,heads,kv_len", [s[:5] for s in SITES] + RAGGED,
                         ids=[s[-1] for s in SITES] + [f"ragged{r}" for r in RAGGED])
def test_fwd_plan(b, s_q, s_k, heads, kv_len):
    plan = attention_plan(b, s_q, s_k, heads, kv_len)
    # the route: more than FWD_SMALL_KEYS keys take the wgmma kernel
    assert plan.route == ("mma" if s_k <= FWD_SMALL_KEYS else "wgmma")
    assert plan.tile % 64 == 0 and plan.threads % 128 == 0
    assert 0 <= plan.smem <= SMEM_LIMIT
    assert (plan.smem == 0) == (plan.route == "mma")
    # every query row of every (batch row, head) once
    assert (_covered(plan, plan.grid, plan.block, plan.tile, s_q) == 1).all()


def test_fwd_routes_of_the_unet_sites():
    """The measured crossover on an H100 (PERF.md §6): every spatial
    self-attention from 144 keys up takes the wgmma forward; the 45-key mid
    site at 320x576 and the temporal t = 25 attention take the mma.sync one."""
    routes = {s[-1]: attention_plan(*s[:5]).route for s in SITES}
    for name, route in routes.items():
        kind, level, res = name.split()
        spatial_long = kind == "spatial" and (level, res) != ("mid", "320x576")
        assert route == ("wgmma" if spatial_long else "mma"), name
    assert sum(r == "wgmma" for r in routes.values()) == 7


def test_fwd_plan_refuses_bad_shapes():
    with pytest.raises(ValueError):
        attention_plan(1, 10, 10, 1, 0)
    with pytest.raises(ValueError):
        attention_plan(1, 10, 10, 1, 11)
    with pytest.raises(ValueError):
        attention_plan(0, 10, 10, 1, 10)
    with pytest.raises(ValueError):
        attention_plan(1, 10, 100, 1, 100, route="flash")


def test_fwd_forced_route():
    assert attention_plan(2880, 25, 25, 5, 25, route="wgmma").route == "wgmma"
    assert attention_plan(25, 2880, 2880, 5, 2880, route="mma").route == "mma"
    assert attention_plan(25, 2880, 2880, 5, 2880).route == "wgmma"


def test_fwd_plan_matches_the_cuda_source():
    c = _constants("attention.cu", "AW", {"AD": 64})
    plan = attention_plan(2, 9216, 9216, 5, 9216)
    assert plan.tile == c["AW"] and c["AW"] == 2 * 64  # two consumer warpgroups of 64 rows
    assert plan.threads == c["AW_THREADS"] == 384
    assert FWD_STAGES == c["AW_STAGES"]
    assert plan.smem == c["AW_SMEM"]
    src = (ROOT / "vista_tpu_torch" / "csrc" / "attention.cu").read_text()
    assert "constexpr int AQ = 64" in src and "__launch_bounds__(128)" in src
    mma = attention_plan(25, 25, 25, 5, 25)
    assert (mma.tile, mma.threads) == (64, 128)


@pytest.mark.parametrize("route", ["wgmma", "mma"])
@pytest.mark.parametrize("b,s_q,s_k,heads,valid_k", [(3, 100, 130, 2, 77), (2, 576, 576, 3, None)])
def test_forward_launches_the_plan(monkeypatch, route, b, s_q, s_k, heads, valid_k):
    """attention_forward hands the kernel's entry the plan's grid (and, on
    the wgmma route, its shared memory), and the entry checks them against
    the same formulas: the grid that the coverage test walks is the one
    launched. The CUDA side is replaced by a recorder, so no card is needed."""
    from vista_tpu_torch.ops import _build

    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "check", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    for counter in ("LAUNCHES", "SITES"):
        monkeypatch.setattr(_build, counter, collections.Counter())
    q = torch.zeros(b, s_q, heads * 64, dtype=torch.bfloat16)
    k, v = (torch.zeros(b, s_k, heads * 64, dtype=torch.bfloat16) for _ in range(2))
    attention_forward(q, k, v, heads, valid_k, want_lse=True, route=route)
    plan = attention_plan(b, s_q, s_k, heads, valid_k or s_k, route)
    (name, args), = calls
    if route == "mma":
        assert name == "vk_attention" and args[-2:] == plan.grid
    else:
        assert name == "vk_attention_wgmma" and args[-2:] == (plan.grid[0], plan.smem)
    assert args[5:10] == (b, s_q, s_k, heads, plan.kv_len)
    assert _build.LAUNCHES == {"attention": 1, f"attention:{route}": 1}
    src = (ROOT / "vista_tpu_torch" / "csrc" / "attention.cu").read_text()
    assert "grid_x != B * ((Sq + vk::AQ - 1) / vk::AQ) || grid_y != H" in src
    assert "(long)blocks != (long)B * H * ((Sq + AW - 1) / AW) || smem != AW_SMEM" in src


@pytest.mark.parametrize("route", ["wgmma", "mma", None])
def test_backward_forced_route(monkeypatch, route):
    """``route=`` forces attention_bwd's kernels as it does the forward's,
    and the launch is counted under the route taken (recorded, no card)."""
    from vista_tpu_torch.ops import _build

    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "check", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append(name))
    for counter in ("LAUNCHES", "SITES"):
        monkeypatch.setattr(_build, counter, collections.Counter())
    q, k, v, o, do = (torch.zeros(2, 300, 128, dtype=torch.bfloat16) for _ in range(5))
    lse = torch.zeros(2, 2, 300)
    attention_bwd(q, k, v, o, lse, do, 2, route=route)
    taken = route or "wgmma"  # 300 keys: above SMALL_KEYS
    assert calls == ["vk_attention_bwd_prep",
                     "vk_attention_bwd" if taken == "mma" else "vk_attention_bwd_wgmma"]
    assert _build.LAUNCHES == {"attention_bwd": 1, f"attention_bwd:{taken}": 1}


def test_cpu_forward_is_the_plain_one():
    """On CPU tensors the forward runs the plain version, whatever the route."""
    q, k, v = (torch.from_numpy(_rows(2, 130, 128, seed=i)) for i in range(3))
    attention_plain(q, k, v, 2, 77, want_lse=True)  # warm-up: see the backward's test
    want = attention_plain(q, k, v, 2, 77, want_lse=True)
    for route in ("wgmma", "mma", None):
        got = attention_forward(q, k, v, 2, 77, want_lse=True, route=route)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def _rows(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,s,heads", [(2, 100, 2), (1, 256, 1), (3, 25, 2)])
def test_prep_plain(b, s, heads):
    o, do = _rows(b, s, heads * 64, seed=0), _rows(b, s, heads * 64, seed=1)
    lse = _rows(b, heads, s, seed=2)
    plan = attention_bwd_plan(b, s, s, heads, s)
    got = attention_bwd_prep(torch.from_numpy(o), torch.from_numpy(lse), torch.from_numpy(do),
                             plan).numpy()
    assert got.shape == (b, heads, plan.s_q_pad, 2)
    d = (o.reshape(b, s, heads, 64).astype(np.float64)
         * do.reshape(b, s, heads, 64)).sum(-1).transpose(0, 2, 1)
    np.testing.assert_allclose(got[:, :, :s, 1], d, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[:, :, :s, 0], lse * np.log2(np.e), rtol=1e-6)
    assert np.isinf(got[:, :, s:, 0]).all() and (got[:, :, s:, 0] > 0).all()
    assert (got[:, :, s:, 1] == 0).all()
    same = attention_bwd_prep_plain(torch.from_numpy(o), torch.from_numpy(lse),
                                    torch.from_numpy(do), plan).numpy()
    np.testing.assert_array_equal(got, same)


def test_cpu_backward_is_the_plain_one():
    """On CPU tensors the wrapper runs the plain version, whatever the route."""
    q, k, v, do = (torch.from_numpy(_rows(2, 130, 128, seed=i)) for i in range(4))
    lse = torch.from_numpy(_rows(2, 2, 130, seed=5))
    # the first CPU matmul of a process now and then sums in another order
    # than the later ones (about one run in ten): warm up before comparing bits
    attention_bwd_plain(q, k, v, q, lse, do, 2, 77)
    got = attention_bwd(q, k, v, q, lse, do, 2, 77)
    want = attention_bwd_plain(q, k, v, q, lse, do, 2, 77)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
