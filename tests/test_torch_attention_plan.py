"""What the CPU can check of K1's forward routing (``attention_plan``) and
the attention backward's (``attention_bwd_plan``): the route of every UNet
site at both resolutions and of ragged shapes; on the wgmma route, that the
forward's grid (the one its entry is handed) covers every query row, and
the backward's dK/dV and dQ grids every key and query row, of every (batch
row, head) exactly once, that tiles are whole 64-row boxes and shared
memory fits a block; on the short route, that the persistent walk takes
every (sequence, head) exactly once; that the plans' tile, stage and
shared-memory numbers are the CUDA sources', and the wgmma route's pre-pass
in its plain form. No card: each plan case takes milliseconds.

The short route is emulated on the CPU: the 3-d TMA box arithmetic in numpy
(a 32-frame box at t = 25 and a 64-frame box at 45 frames read only their
own sequences, zeros after; the 16-row output boxes write each row once),
and the kernels' per-block algorithm in fp32 (the forward's whole-row
softmax; the backward's in-block D, P from the LSE, the pad-row and kv_len
rules, P and dS handed from the query-row warps to the key-row warps),
held to the plain versions and, for the backward, to ``jax.vjp`` of the
JAX ``tiny_attention_packed``, whose backward is ``_tiny_bwd_kernel`` in
interpret mode on the CPU (one JAX jit for the file)."""

import collections
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vista_tpu.ops.tiny_attention import tiny_attention_packed
from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu_torch.ops import attention as attention_module
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
    """How often each (batch row, head, row) is in a wgmma block's range of
    ``tile`` rows, over every block of ``grid``."""
    counts = np.zeros((plan.b, plan.heads, s), dtype=np.int64)
    b, h, r0 = block(np.arange(grid[0]))
    b, h = np.broadcast_to(b, r0.shape), np.broadcast_to(h, r0.shape)
    for off in range(tile):
        rows = r0 + off
        keep = rows < s
        np.add.at(counts, (b[keep], h[keep], rows[keep]), 1)
    return counts


def _walked(plan):
    """How often each (sequence, head) is in a unit that the short route's
    persistent blocks take, walking as the kernels do: block i takes units
    i, i + grid, ...; unit u is head u % heads of sequences
    (u // heads) seqs .. + seqs - 1, those past b being the box's zero fill."""
    counts = np.zeros((plan.b, plan.heads), dtype=np.int64)
    units = np.concatenate([np.asarray(plan.walk(i)) for i in range(plan.grid[0])])
    b0, h = plan.unit(units)
    for j in range(plan.seqs):
        keep = b0 + j < plan.b
        np.add.at(counts, (b0[keep] + j, h[keep]), 1)
    return counts


def _short_checks(plan, s_q, s_k):
    assert plan.route == "short" and len(plan.grid) == 1
    assert plan.frames == (32 if max(s_q, s_k) <= 32 else 64) >= max(s_q, s_k)
    assert plan.seqs * plan.frames == 64  # one 64-row box per tensor
    assert plan.threads == 160 and 0 < plan.smem <= SMEM_LIMIT
    # two blocks share an SM (228 KB, 1 KB of it reserved per block)
    assert 2 * (plan.smem + 1024) <= 233472
    assert 1 <= plan.grid[0] <= min(plan.units, 2 * 132)
    assert (_walked(plan) == 1).all()


@pytest.mark.parametrize("b,s_q,s_k,heads,kv_len", [s[:5] for s in SITES] + RAGGED,
                         ids=[s[-1] for s in SITES] + [f"ragged{r}" for r in RAGGED])
def test_plan(b, s_q, s_k, heads, kv_len):
    plan = attention_bwd_plan(b, s_q, s_k, heads, kv_len)
    # the route: more than SMALL_KEYS keys take the wgmma kernels
    assert plan.route == ("short" if s_k <= SMALL_KEYS else "wgmma")
    if plan.route == "short":
        return _short_checks(plan, s_q, s_k)
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
    assert set(plan.smem) == {"dkv", "dq"}
    assert plan.s_q_pad % plan.tile == 0 and s_q <= plan.s_q_pad < s_q + plan.tile


def test_plan_refuses_bad_shapes():
    with pytest.raises(ValueError):
        attention_bwd_plan(1, 10, 10, 1, 0)
    with pytest.raises(ValueError):
        attention_bwd_plan(1, 10, 10, 1, 11)
    with pytest.raises(ValueError):
        attention_bwd_plan(1, 10, 100, 1, 100, route="flash")


def test_forced_route():
    assert attention_bwd_plan(2880, 25, 25, 5, 25, route="wgmma").route == "wgmma"
    assert attention_bwd_plan(25, 45, 45, 20, 45, route="short").route == "short"
    # the short kernels take no more than 64 queries and keys
    with pytest.raises(ValueError):
        attention_bwd_plan(25, 2880, 2880, 5, 2880, route="short")
    with pytest.raises(ValueError):
        attention_bwd_plan(25, 65, 65, 5, 65, route="short")


def _constants(source="attention_bwd.cu", prefix="WB", env=None):
    """The wgmma route's ``constexpr int <prefix>...`` of a CUDA source."""
    src = (ROOT / "vista_tpu_torch" / "csrc" / source).read_text()
    env = dict(env or {"HD": 64})
    for name, expr in re.findall(rf"constexpr int ({prefix}\w*) = ([^;]+);", src):
        env[name] = eval(" ".join(expr.split()), {}, env)  # products and sums of the above
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
    assert plan.route == ("short" if s_k <= FWD_SMALL_KEYS else "wgmma")
    if plan.route == "short":
        return _short_checks(plan, s_q, s_k)
    assert plan.tile % 64 == 0 and plan.threads % 128 == 0
    assert 0 < plan.smem <= SMEM_LIMIT
    # every query row of every (batch row, head) once
    assert (_covered(plan, plan.grid, plan.block, plan.tile, s_q) == 1).all()


def test_fwd_routes_of_the_unet_sites():
    """The measured crossover on an H100 (PERF.md §6): every spatial
    self-attention from 144 keys up takes the wgmma forward; the 45-key mid
    site at 320x576 and the temporal t = 25 attention take the short one."""
    routes = {s[-1]: attention_plan(*s[:5]).route for s in SITES}
    for name, route in routes.items():
        kind, level, res = name.split()
        spatial_long = kind == "spatial" and (level, res) != ("mid", "320x576")
        assert route == ("wgmma" if spatial_long else "short"), name
    # the backward takes the same route at every site
    assert {s[-1]: attention_bwd_plan(*s[:5]).route for s in SITES} == routes
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
    assert attention_plan(50, 45, 45, 20, 45, route="short").route == "short"
    assert attention_plan(25, 2880, 2880, 5, 2880).route == "wgmma"
    # the short kernel takes no more than 64 queries and keys
    with pytest.raises(ValueError):
        attention_plan(25, 2880, 2880, 5, 2880, route="short")
    with pytest.raises(ValueError):
        attention_plan(25, 100, 64, 5, 64, route="short")


def test_fwd_plan_matches_the_cuda_source():
    c = _constants("attention.cu", "AW", {"AD": 64})
    plan = attention_plan(2, 9216, 9216, 5, 9216)
    assert plan.tile == c["AW"] and c["AW"] == 2 * 64  # two consumer warpgroups of 64 rows
    assert plan.threads == c["AW_THREADS"] == 384
    assert FWD_STAGES == c["AW_STAGES"]
    assert plan.smem == c["AW_SMEM"]



@pytest.mark.parametrize("b,s,heads", [(18432, 25, 5), (50, 45, 20)])
def test_short_plans_match_the_cuda_source(b, s, heads):
    """The short route's threads, ring depths and shared memory, forward and
    backward, against ``csrc/attention_short.cuh``'s constants; the box
    frames against its ``sh_frames``."""
    c = _constants("attention_short.cuh", "SH", {})
    fwd, bwd = attention_plan(b, s, s, heads, s), attention_bwd_plan(b, s, s, heads, s)
    assert fwd.threads == bwd.threads == c["SH_THREADS"] == 160
    assert fwd.stages == c["SH_FWD_STAGES"] and bwd.stages == c["SH_BWD_STAGES"]
    assert fwd.smem == c["SH_FWD_SMEM"] and bwd.smem == c["SH_BWD_SMEM"]
    assert fwd.grid == bwd.grid == (min(fwd.units, c["SH_BLOCKS_PER_SM"] * 132),)
    assert fwd.seqs * fwd.frames == c["SH_ROWS"]
    src = (ROOT / "vista_tpu_torch" / "csrc" / "attention_short.cuh").read_text()
    assert "return s > 32 ? 64 : 32;" in src and fwd.frames == (64 if s > 32 else 32)


@pytest.mark.parametrize("route,b,s_q,s_k,heads,valid_k", [
    ("wgmma", 3, 100, 130, 2, 77), ("wgmma", 2, 576, 576, 3, None),
    ("short", 3, 25, 25, 2, 20), ("short", 5, 45, 45, 3, None)])
def test_forward_launches_the_plan(monkeypatch, route, b, s_q, s_k, heads, valid_k):
    """attention_forward hands the kernel's entry the plan's block count and
    shared memory, and the entry checks them against the same formulas: the
    grid that the coverage test walks is the one launched. The CUDA side is
    replaced by a recorder, so no card is needed."""
    from vista_tpu_torch.ops import _build

    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "check", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(attention_module, "sm_count", lambda index: 132)
    for counter in ("LAUNCHES", "SITES"):
        monkeypatch.setattr(_build, counter, collections.Counter())
    q = torch.zeros(b, s_q, heads * 64, dtype=torch.bfloat16)
    k, v = (torch.zeros(b, s_k, heads * 64, dtype=torch.bfloat16) for _ in range(2))
    attention_forward(q, k, v, heads, valid_k, want_lse=True, route=route)
    plan = attention_plan(b, s_q, s_k, heads, valid_k or s_k, route)
    (name, args), = calls
    assert name == f"vk_attention_{route}" and args[-2:] == (plan.grid[0], plan.smem)
    assert args[5:10] == (b, s_q, s_k, heads, plan.kv_len)
    assert _build.LAUNCHES == {"attention": 1, f"attention:{route}": 1}
    src = (ROOT / "vista_tpu_torch" / "csrc" / "attention.cu").read_text()
    assert "(long)blocks != (long)B * H * ((Sq + AW - 1) / AW) || smem != AW_SMEM" in src
    assert "kv_len > Sk || smem != SH_FWD_SMEM ||" in src
    assert "if (blocks < 1 || blocks > units) return (int)cudaErrorInvalidValue;" in src


@pytest.mark.parametrize("route,s", [("wgmma", 300), ("short", 25), (None, 300), (None, 45),
                                     ("wgmma", 25)])
def test_backward_forced_route(monkeypatch, route, s):
    """``route=`` forces attention_bwd's kernels as it does the forward's,
    and the launch is counted under the route taken (recorded, no card):
    the wgmma route is the pre-pass and its kernels, the short route one
    launch with no pre-pass, with the plan's block count and shared memory."""
    from vista_tpu_torch.ops import _build

    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "check", lambda *a, **kw: None)
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(attention_module, "sm_count", lambda index: 132)
    for counter in ("LAUNCHES", "SITES"):
        monkeypatch.setattr(_build, counter, collections.Counter())
    q, k, v, o, do = (torch.zeros(2, s, 128, dtype=torch.bfloat16) for _ in range(5))
    lse = torch.zeros(2, 2, s)
    attention_bwd(q, k, v, o, lse, do, 2, route=route)
    taken = route or ("short" if s <= SMALL_KEYS else "wgmma")
    names = [name for name, _ in calls]
    if taken == "short":
        plan = attention_bwd_plan(2, s, s, 2, s, "short")
        assert names == ["vk_attention_bwd_short"]
        assert calls[0][1][9:14] == (2, s, s, 2, s)
        assert calls[0][1][-2:] == (plan.grid[0], plan.smem)
    else:
        assert names == ["vk_attention_bwd_prep", "vk_attention_bwd_wgmma"]
    assert _build.LAUNCHES == {"attention_bwd": 1, f"attention_bwd:{taken}": 1}
    src = (ROOT / "vista_tpu_torch" / "csrc" / "attention_bwd.cu").read_text()
    assert "kv_len > Sk || smem != SH_BWD_SMEM ||" in src
    assert "atomic" not in src.split("attn_bwd_short_kernel(")[1].split("}  // namespace vk")[0]


def test_cpu_forward_is_the_plain_one():
    """On CPU tensors the forward runs the plain version, whatever the route."""
    q, k, v = (torch.from_numpy(_rows(2, 130, 128, seed=i)) for i in range(3))
    attention_plain(q, k, v, 2, 77, want_lse=True)  # warm-up: see the backward's test
    want = attention_plain(q, k, v, 2, 77, want_lse=True)
    for route in ("wgmma", "short", None):
        got = attention_forward(q, k, v, 2, 77, want_lse=True, route=route)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def _rows(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,s,heads", [(2, 100, 2), (1, 256, 1), (3, 25, 2)])
def test_prep_plain(b, s, heads):
    o, do = _rows(b, s, heads * 64, seed=0), _rows(b, s, heads * 64, seed=1)
    lse = _rows(b, heads, s, seed=2)
    plan = attention_bwd_plan(b, s, s, heads, s, route="wgmma")
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


# ---- the short route, emulated on the CPU

LOG2E = 1.4426950408889634


def _box(t, h, b0, frames, seqs):
    """A TMA load of one 64-row box of a packed (B, S, H*64) tensor through
    the short route's 3-d map (H*64, S, B): head h, frames 0 .. frames - 1
    of sequences b0 .. b0 + seqs - 1. An element whose row coordinate is
    past S or whose sequence is past B is out of the tensor and arrives as
    0; the map's bounds are per dimension, so a box never reads another
    sequence's rows."""
    b, s, _ = t.shape
    box = np.zeros((seqs, frames, 64), t.dtype)
    n = max(0, min(seqs, b - b0))
    box[:n, :min(frames, s)] = t[b0:b0 + n, :frames, h * 64:(h + 1) * 64]
    return box.reshape(seqs * frames, 64)


def _store(dst, rows, h, r0, seq, written):
    """A TMA store of a 16-row box at (head h, row r0, sequence seq): rows
    past S and sequences past B are dropped."""
    b, s, _ = dst.shape
    if seq >= b:
        return
    n = max(0, min(16, s - r0))
    dst[seq, r0:r0 + n, h * 64:(h + 1) * 64] = rows[:n]
    written[seq, r0:r0 + n, h] += 1


def _warps(frames):
    """(first box row, sequence in the box, first frame) of each consumer
    warp's 16 rows: R0 = 16 w, j = R0 // frames, r0 = R0 % frames."""
    return [(16 * w, 16 * w // frames, 16 * w % frames) for w in range(4)]


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _short_fwd_emulated(q, k, v, heads, kv_len):
    """attention_short_kernel's algorithm in fp32: per unit of the plan's
    walk, per warp, the whole-row base-2 softmax of its 16 query rows over
    the frames of its sequence, keys at or past kv_len masked; O = P V / l;
    LSE = m ln 2 + log l."""
    b, s_q, _ = q.shape
    plan = attention_plan(b, s_q, k.shape[1], heads, kv_len, route="short")
    f, scale_log2 = plan.frames, 64 ** -0.5 * LOG2E
    out, lse = np.zeros_like(q), np.zeros((b, heads, s_q), np.float32)
    written = np.zeros((b, s_q, heads), np.int64)
    for i in range(plan.grid[0]):
        for u in plan.walk(i):
            b0, h = plan.unit(u)
            qb, kb, vb = (_box(t, h, b0, f, plan.seqs) for t in (q, k, v))
            for R0, j, r0 in _warps(f):
                keys = slice(j * f, j * f + f)
                s = qb[R0:R0 + 16] @ kb[keys].T * scale_log2
                s[:, kv_len:] = -np.inf
                m = s.max(-1, keepdims=True)
                p = np.exp2(s - m)
                l = p.sum(-1, keepdims=True)
                _store(out, p @ vb[keys] / l, h, r0, b0 + j, written)
                seq, rows = b0 + j, np.arange(r0, r0 + 16)
                keep = rows < s_q
                if seq < b:
                    lse[seq, h, rows[keep]] = (m[:, 0] * np.log(2) + np.log(l[:, 0]))[keep]
    assert (written == 1).all()  # every output row of every head once
    return out, lse


def _short_bwd_emulated(q, k, v, o, lse, do, heads, kv_len, round_bf16=False):
    """attn_bwd_short_kernel's algorithm in fp32, block by block. Per unit:
    phase A, each warp on its 16 query rows: D = rowsum(dO O) from the O and
    dO boxes, P = exp2(S scale log2 e - lse log2 e) with lse = +inf on rows
    past S_q (a pad row has P = 0) and P = 0 at keys at or past kv_len,
    dS = P (dP - D), dQ = dS K scale; P and dS into the block's shared
    arrays. Phase B, each warp on its 16 keys: dV = P^T dO, dK = dS^T Q
    scale. With ``round_bf16``, P and dS are rounded to bf16 for their
    products, as on the card."""
    b, s_q, _ = q.shape
    plan = attention_bwd_plan(b, s_q, k.shape[1], heads, kv_len, route="short")
    f, scale = plan.frames, 64 ** -0.5
    rnd = _bf16 if round_bf16 else (lambda x: x)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    wq, wk = np.zeros((b, s_q, heads), np.int64), np.zeros((b, k.shape[1], heads), np.int64)
    wv = wk.copy()
    for i in range(plan.grid[0]):
        for u in plan.walk(i):
            b0, h = plan.unit(u)
            qb, kb, vb, ob, dob = (_box(t, h, b0, f, plan.seqs) for t in (q, k, v, o, do))
            p_s, ds_s = np.zeros((64, f), np.float32), np.zeros((64, f), np.float32)
            dq_rows = np.zeros((64, 64), np.float32)
            for R0, j, r0 in _warps(f):  # phase A
                rows, keys, seq = slice(R0, R0 + 16), slice(j * f, j * f + f), b0 + j
                d = (ob[rows] * dob[rows]).sum(-1, keepdims=True)
                frames = np.arange(r0, r0 + 16)
                live = frames < s_q
                l2 = np.full((16, 1), np.inf, np.float32)
                if seq < b:
                    l2[live, 0] = lse[seq, h, frames[live]] * LOG2E
                pr = np.exp2(qb[rows] @ kb[keys].T * (scale * LOG2E) - l2)
                pr[:, kv_len:] = 0
                ds = pr * (dob[rows] @ vb[keys].T - d)
                dq_rows[rows] = rnd(ds) @ kb[keys] * scale
                p_s[rows], ds_s[rows] = rnd(pr), rnd(ds)
            for R0, j, r0 in _warps(f):  # phase B, after the block's barrier
                qs, seq = slice(j * f, j * f + f), b0 + j
                _store(dq, dq_rows[R0:R0 + 16], h, r0, seq, wq)
                _store(dv, p_s[qs, r0:r0 + 16].T @ dob[qs], h, r0, seq, wv)
                _store(dk, ds_s[qs, r0:r0 + 16].T @ qb[qs] * scale, h, r0, seq, wk)
    assert (wq == 1).all() and (wk == 1).all() and (wv == 1).all()
    return dq, dk, dv


@pytest.mark.parametrize("b,s,heads", [(5, 25, 3), (3, 45, 2), (1, 25, 1), (2, 64, 1)])
def test_short_box_reads_only_its_sequence(b, s, heads):
    """The 3-d box arithmetic: a 32-frame box at t = 25 (two sequences) and a
    64-frame box at 45 frames (one) hold each sequence's own rows, zeros
    after, and zeros for sequences past B; the warps' rows, read through
    the 128-byte swizzle as the kernels address them, are those rows. A 2-d
    map over the b s rows would have read the next sequence into the pad."""
    t = np.arange(b * s * heads * 64, dtype=np.float64).reshape(b, s, heads * 64) + 1
    plan = attention_plan(b, s, s, heads, s, route="short")
    f = plan.frames
    assert f == (32 if s <= 32 else 64)
    for u in range(plan.units):
        b0, h = plan.unit(u)
        box = _box(t, h, b0, f, plan.seqs)
        for j in range(plan.seqs):
            rows = box[j * f:(j + 1) * f]
            if b0 + j < b:
                np.testing.assert_array_equal(rows[:s], t[b0 + j, :, h * 64:(h + 1) * 64])
            assert not rows[min(s, f) if b0 + j < b else 0:].any()
        # the swizzled box as TMA writes it: chunk c of row R at
        # R * 128 + (c ^ R % 8) * 16 bytes (8 bf16 values a chunk)
        flat = np.zeros(64 * 64)
        for row in range(64):
            for c in range(8):
                at = (row * 128 + ((c ^ (row % 8)) << 4)) // 2
                flat[at:at + 8] = box[row, 8 * c:8 * c + 8]
        for R0, j, r0 in _warps(f):
            got = np.stack([np.concatenate([flat[(R * 128 + ((c ^ (R % 8)) << 4)) // 2:][:8]
                                            for c in range(8)]) for R in range(R0, R0 + 16)])
            np.testing.assert_array_equal(got, box[R0:R0 + 16])
            if b0 + j < b and r0 < s:
                n = min(16, s - r0)
                np.testing.assert_array_equal(got[:n], t[b0 + j, r0:r0 + n, h * 64:(h + 1) * 64])
    if b > 1 and s < f:
        flat_rows = t.reshape(b * s, heads * 64)
        assert flat_rows[:f][s:].any()  # a 2-d box past row s reads sequence 1


def _inputs(b, s, heads, kv_len, seed, pad_cot=None):
    q, k, v, do = (_rows(b, s, heads * 64, seed=seed + i) for i in range(4))
    if pad_cot is not None:
        do[:, pad_cot:] = 0  # no cotangent on the padded query rows
    o, lse = attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), heads, kv_len,
                             want_lse=True)
    return q, k, v, o.numpy(), lse.numpy(), do


@pytest.mark.parametrize("b,s_q,s_k,heads,kv_len", [
    (5, 25, 25, 3, 25), (5, 25, 25, 2, 20), (3, 45, 45, 2, 45), (3, 45, 45, 2, 40),
    (4, 17, 17, 1, 9), (2, 64, 64, 1, 64), (3, 20, 30, 2, 30), (1, 1, 1, 1, 1)])
def test_short_route_emulation_matches_plain(b, s_q, s_k, heads, kv_len):
    """The emulated kernels against the plain versions on the same fp32
    inputs: forward and backward to 1e-5 of each output's largest magnitude
    (the same fp32 math, summed in another order), or of 1 where that is
    larger (at one frame dq and dk are 0 up to rounding); the backward with
    P and dS rounded to bf16, as on the card, to the card's 1e-2."""
    q, k, v = (_rows(b, s, heads * 64, seed=i) for i, s in enumerate((s_q, s_k, s_k)))
    do = _rows(b, s_q, heads * 64, seed=3)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = attention_plain(tq, tk, tv, heads, kv_len, want_lse=True)
    got_o, got_lse = _short_fwd_emulated(q, k, v, heads, kv_len)
    assert _rel(got_o, o.numpy()) <= 1e-5 and _rel(got_lse, lse.numpy()) <= 1e-5
    want = [w.numpy() for w in attention_bwd_plain(tq, tk, tv, o, lse, tdo, heads, kv_len)]
    args = (q, k, v, o.numpy(), lse.numpy(), do, heads, kv_len)
    for g, w in zip(_short_bwd_emulated(*args), want):
        assert _rel(g, w, floor=1.0) <= 1e-5
    for g, w in zip(_short_bwd_emulated(*args, round_bf16=True), want):
        assert _rel(g, w, floor=1.0) <= 1e-2
    # keys at or past kv_len get no gradient
    assert not want[1][:, kv_len:].any() and not want[2][:, kv_len:].any()


def _rel(a, b, floor=1e-30):
    return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), floor))


@functools.lru_cache(maxsize=1)
def _jax_tiny_grads():
    """``jax.vjp`` of ``tiny_attention_packed`` (3 sequences, 2 heads) at 25
    and 45 frames, both in one jit; fp32 inputs and cotangents from numpy.
    Returns {frames: (inputs, (out, dq, dk, dv))}."""
    ins = {s: tuple(_rows(3, s, 128, seed=10 * s + i) for i in range(4)) for s in (25, 45)}

    def grads(*arrays):
        out = []
        for q, k, v, g in (arrays[:4], arrays[4:]):
            o, vjp = jax.vjp(lambda q, k, v: tiny_attention_packed(q, k, v, 2), q, k, v)
            out.append((o, *vjp(g)))
        return out

    res = jax.jit(grads)(*map(jnp.asarray, ins[25] + ins[45]))
    return {s: (ins[s], [np.asarray(x) for x in r]) for s, r in zip((25, 45), res)}


@pytest.mark.parametrize("s", [25, 45])
@pytest.mark.parametrize("valid_k", [False, True])
def test_short_bwd_emulation_matches_jax(s, valid_k):
    """The emulated fused backward against the JAX package's tiny attention
    VJP (``_tiny_bwd_kernel`` in interpret mode), 1e-4 of each gradient's
    largest magnitude: fp32 math summed in another order, P from the saved
    LSE where the TPU kernel renormalises from the row max. With
    ``valid_k``, the sequences are padded by 5 frames of noise that the
    valid length masks (no cotangent on the padded queries): the real rows'
    gradients are the same, the padded keys' and queries' are 0."""
    (q, k, v, g), (out, *want) = _jax_tiny_grads()[s]
    if valid_k:
        pad = lambda x, seed: np.concatenate([x, _rows(3, 5, 128, seed=seed)], axis=1)
        q, k, v, g = (pad(x, 90 + i) for i, x in enumerate((q, k, v, g)))
        g[:, s:] = 0
    o, lse = attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), 2, s, want_lse=True)
    assert _rel(o.numpy()[:, :s], out) <= 1e-4
    got = _short_bwd_emulated(q, k, v, o.numpy(), lse.numpy(), g, 2, s)
    for grad, ref in zip(got, want):
        assert _rel(grad[:, :s], ref) <= 1e-4
        assert not grad[:, s:].any()
