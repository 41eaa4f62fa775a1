"""Multi-head attention on the packed ``(B, S, heads * head_dim)`` layout.

Counterpart of ``vista_tpu/ops/attention.py``, ``ops/flash_attention.py``
and ``ops/tiny_attention.py``: one entry, :func:`attention_packed`, covers
the spatial self-attention at every length (the JAX package switches
between its flash kernel at s >= 2048 and its tiny kernel at s <= 1024) and
the temporal attention over t = 25 frames. On CUDA tensors it launches the
hand-written kernel K1 (``csrc/attention.cu``) on the route that
:func:`attention_plan` picks: more than ``FWD_SMALL_KEYS`` keys (the
spatial sites) take the TMA + ``wgmma`` flash forward, the temporal t = 25
attention and the 45-key mid site at 320x576 (at most 64 queries and keys)
the short route, a persistent TMA-fed kernel that holds whole sequences
(``csrc/attention_short.cuh``). On CPU tensors it runs
:func:`attention_plain`. The kernels take t = 25 unpadded; ``valid_k``
masks keys at or past it for callers that do pad.

Backward (training): when an input requires grad, the forward also writes
the fp32 log-sum-exp of each query row, ``(B, heads, S_q)`` (the JAX
``want_lse`` path), and the backward runs ``csrc/attention_bwd.cu``, both
routes recomputing P from the saved LSE. :func:`attention_bwd_plan` picks
the route: the spatial sites (more than 64 keys) take the TMA + ``wgmma``
kernels (ports of ``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` and the spatial
``_tiny_bwd_kernel``): a pre-pass for ``D = rowsum(dO * O)``, a dK/dV
kernel looping over query tiles and a dQ kernel looping over key tiles. The
temporal t = 25 attention and the 45-key mid site at 320x576 take the short
route: one launch that reads each of q, k, v, o, dO and the LSE once per
(sequence, head) and writes dq, dk, dv once, every sum inside one block. On
CPU tensors :func:`attention_bwd_plain` computes the same in fp32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from vista_tpu_torch.ops import _build, remat

HEAD_DIM = 64  # the only head width K1 is built for (the UNet's)
_LOG2E = 1.4426950408889634

# Both kernels' routes share their shapes. At most a threshold of queries
# and keys take the short route (csrc/attention_short.cuh): a persistent
# grid of SHORT_BLOCKS_PER_SM blocks per SM of SHORT_THREADS threads (four
# consumer warps and a producer warp), walking units of one head of
# SHORT_ROWS // frames whole sequences (a 64-row TMA box per tensor), head
# fastest; frames is 32 up to 32 queries and keys, else 64. The forward's
# ring is SHORT_FWD_STAGES (Q, K, V) stages deep, the backward's
# SHORT_BWD_STAGES (Q, K, V, O, dO). More take the wgmma kernels (blocks of
# 128 rows, two consumer warpgroups and a producer warpgroup, a ring of
# stages of 128 rows). K1's threshold is FWD_SMALL_KEYS and its wgmma ring
# FWD_STAGES deep (csrc/attention.cu); attention_bwd's SMALL_KEYS and
# WGMMA_STAGES (csrc/attention_bwd.cu). The short kernels take no more than
# 64 of either; below that the measured route crossover on an H100
# (chip_smoke.py route_crossovers) holds each threshold.
FWD_SMALL_KEYS = 64
FWD_STAGES = 4
SMALL_KEYS = 64
SHORT_ROWS, SHORT_THREADS, SHORT_BLOCKS_PER_SM = 64, 160, 2
SHORT_FWD_STAGES, SHORT_BWD_STAGES = 4, 2
WGMMA_TILE, WGMMA_STAGES, WGMMA_THREADS = 128, 3, 384
_BOX = WGMMA_TILE * HEAD_DIM * 2  # one 128 x 64 bf16 tile, bytes
_SHORT_BOX = SHORT_ROWS * HEAD_DIM * 2  # one 64-row box, bytes
_BARRIERS = 8 * (1 + 2 * WGMMA_STAGES)
H100_SMS = 132


@functools.lru_cache(maxsize=8)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode(heads, tile, tiles, i):
    """(batch row, head, first row) of wgmma block ``i`` of a flat grid over
    ``tiles`` row tiles per (batch row, head), the tile fastest, then the
    head."""
    bh = i // tiles
    return bh // heads, bh % heads, i % tiles * tile


@dataclasses.dataclass(frozen=True)
class ShortPlan:
    """The short route's launch, forward or backward: ``grid[0]`` persistent
    blocks of ``threads`` walk the ``units``, each one head of ``seqs``
    whole sequences of ``frames`` rows (one TMA box per tensor), the head
    fastest; block ``i`` takes units ``i, i + grid[0], ...``. ``stages``
    is the ring's depth and ``smem`` the dynamic shared memory in bytes."""

    route: str
    b: int
    s_q: int
    s_k: int
    heads: int
    kv_len: int
    frames: int
    seqs: int
    threads: int
    stages: int
    grid: tuple
    smem: int

    @property
    def units(self) -> int:
        return -(-self.b // self.seqs) * self.heads

    def unit(self, u):
        """(first sequence, head) of unit ``u``, as the kernel decodes it."""
        return u // self.heads * self.seqs, u % self.heads

    def walk(self, i: int) -> range:
        """The units that block ``i`` takes, in order."""
        return range(i, self.units, self.grid[0])


def _short_plan(shape, stages, smem, sms):
    b, s_q, s_k, heads, _ = shape
    if max(s_q, s_k) > SHORT_ROWS:
        raise ValueError(f"the short route takes at most {SHORT_ROWS} queries and keys: "
                         f"got {s_q} and {s_k}")
    frames = 32 if max(s_q, s_k) <= 32 else 64
    seqs = SHORT_ROWS // frames
    units = -(-b // seqs) * heads
    return ShortPlan("short", *shape, frames, seqs, SHORT_THREADS, stages,
                     (min(units, SHORT_BLOCKS_PER_SM * sms),), smem)


def _short_route(s_q, s_k, threshold):
    return s_k <= threshold and s_q <= SHORT_ROWS


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """What :func:`attention_forward` launches on the wgmma route for one
    shape: the row tile of a block (queries per block and keys per step),
    its threads, the flat grid and the dynamic shared memory in bytes."""

    route: str
    b: int
    s_q: int
    s_k: int
    heads: int
    kv_len: int
    tile: int
    threads: int
    grid: tuple
    smem: int

    def block(self, i: int):
        """(batch row, head, first query) of block ``i``, as the kernel
        decodes it."""
        return _decode(self.heads, self.tile, -(-self.s_q // self.tile), i)


@functools.lru_cache(maxsize=256)
def attention_plan(b: int, s_q: int, s_k: int, heads: int, kv_len: int,
                   route: Optional[str] = None, sms: int = H100_SMS):
    """The route and launch that K1's forward takes at one shape (the
    kernels' entries only check them), computed here so that the CPU tests
    check them; cached, since a model repeats a few shapes. ``route`` forces
    a route (for measuring the crossover); by default at most
    ``FWD_SMALL_KEYS`` keys (and at most 64 queries) take the short route
    (a :class:`ShortPlan` for ``sms`` SMs), more the wgmma kernel (a
    :class:`FwdPlan`)."""
    if min(b, s_q, s_k, heads) < 1 or not 1 <= kv_len <= s_k:
        raise ValueError(f"attention_plan: bad shape {(b, s_q, s_k, heads, kv_len)}")
    route = route or ("short" if _short_route(s_q, s_k, FWD_SMALL_KEYS) else "wgmma")
    shape = (b, s_q, s_k, heads, kv_len)
    if route == "short":
        # 1024 for the swizzle alignment, the ring of Q, K, V boxes, a
        # 16-row staging box per consumer warp, the barriers
        smem = (1024 + SHORT_FWD_STAGES * 3 * _SHORT_BOX + 4 * 16 * 128
                + 16 * SHORT_FWD_STAGES)
        return _short_plan(shape, SHORT_FWD_STAGES, smem, sms)
    if route != "wgmma":
        raise ValueError(f"attention_plan: unknown route {route!r}")
    t = WGMMA_TILE
    # 1024 for the swizzle alignment, the Q tile, the ring of K and V, the
    # barriers (Q's, full and empty per stage)
    smem = 1024 + _BOX + FWD_STAGES * 2 * _BOX + 8 * (1 + 2 * FWD_STAGES)
    return FwdPlan(route, *shape, t, WGMMA_THREADS, (b * heads * -(-s_q // t),), smem)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """What :func:`attention_bwd` launches on the wgmma route for one shape:
    first the pre-pass, 8 threads per (batch row, head, query) in
    ``prep_blocks`` blocks of 256, writing the fp32 (lse log2 e, D) pairs
    ``(b, heads, s_q_pad, 2)``; then the dK/dV and dQ kernels, flat grids of
    ``threads`` threads, with ``smem`` their dynamic shared memory in
    bytes."""

    route: str
    b: int
    s_q: int
    s_k: int
    heads: int
    kv_len: int
    tile: int
    threads: int
    s_q_pad: int
    dkv_grid: tuple
    dq_grid: tuple
    smem: dict

    @property
    def prep_blocks(self) -> int:
        return -(-self.b * self.heads * self.s_q_pad * 8 // 256)

    def dkv_block(self, i: int):
        """(batch row, head, first key) of dK/dV block ``i``, as the kernel
        decodes it."""
        return _decode(self.heads, self.tile, -(-self.s_k // self.tile), i)

    def dq_block(self, i: int):
        """(batch row, head, first query) of dQ block ``i``."""
        return _decode(self.heads, self.tile, -(-self.s_q // self.tile), i)


@functools.lru_cache(maxsize=256)
def attention_bwd_plan(b: int, s_q: int, s_k: int, heads: int, kv_len: int,
                       route: Optional[str] = None, sms: int = H100_SMS):
    """The route and launch of :func:`attention_bwd` at one shape, computed
    here so that the CPU tests check them. ``route`` forces a route (for
    measuring the crossover); by default at most ``SMALL_KEYS`` keys (and at
    most 64 queries) take the short route (a :class:`ShortPlan` for ``sms``
    SMs: one launch, no pre-pass), more the wgmma kernels (a
    :class:`BwdPlan`)."""
    if min(b, s_q, s_k, heads) < 1 or not 1 <= kv_len <= s_k:
        raise ValueError(f"attention_bwd_plan: bad shape {(b, s_q, s_k, heads, kv_len)}")
    route = route or ("short" if _short_route(s_q, s_k, SMALL_KEYS) else "wgmma")
    shape = (b, s_q, s_k, heads, kv_len)
    if route == "short":
        # 1024 for the swizzle alignment, the ring of Q, K, V, O, dO boxes,
        # P and dS (bf16, 64 rows of 64 + 8 values each), the barriers
        smem = (1024 + SHORT_BWD_STAGES * 5 * _SHORT_BOX + 2 * SHORT_ROWS * 72 * 2
                + 16 * SHORT_BWD_STAGES)
        return _short_plan(shape, SHORT_BWD_STAGES, smem, sms)
    if route != "wgmma":
        raise ValueError(f"attention_bwd_plan: unknown route {route!r}")
    t = WGMMA_TILE
    pad = -(-s_q // t) * t
    # 1024 for the swizzle alignment, the two kept tiles, the ring (a dK/dV
    # stage also holds 128 (lse, D) pairs), the barriers
    smem = dict(dkv=1024 + 2 * _BOX + WGMMA_STAGES * (2 * _BOX + 8 * t) + _BARRIERS,
                dq=1024 + 2 * _BOX + WGMMA_STAGES * 2 * _BOX + _BARRIERS)
    return BwdPlan(route, *shape, t, WGMMA_THREADS, pad, (b * heads * -(-s_k // t),),
                   (b * heads * (pad // t),), smem)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, hd = t.shape
    return t.float().reshape(b, s, heads, hd // heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _logits(q, k, heads, valid_k):
    d = q.shape[-1] // heads
    logits = torch.matmul(_heads(q, heads), _heads(k, heads).transpose(-1, -2)) * (d ** -0.5)
    if valid_k is not None and valid_k < k.shape[1]:
        logits[..., valid_k:] = -math.inf
    return logits


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, valid_k: Optional[int] = None,
                    want_lse: bool = False):
    """softmax(q k^T / sqrt(d)) v per head, in fp32; returns q's dtype (and
    the fp32 log-sum-exp ``(B, heads, S_q)`` with ``want_lse``)."""
    logits = _logits(q, k, heads, valid_k)
    out = _merge(torch.matmul(torch.softmax(logits, dim=-1), _heads(v, heads))).to(q.dtype)
    if want_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def attention_bwd_plain(q, k, v, o, lse, do, heads: int,
                        valid_k: Optional[int] = None):
    """dq, dk, dv of :func:`attention_plain` from the saved output and LSE,
    explicit fp32 formulas: ``P = exp(S - lse)``, ``dV = P^T dO``,
    ``dP = dO V^T``, ``dS = P (dP - rowsum(dO O))``, ``dQ = dS K / sqrt(d)``,
    ``dK = dS^T Q / sqrt(d)``."""
    scale = (q.shape[-1] // heads) ** -0.5
    p = torch.exp(_logits(q, k, heads, valid_k) - lse.float()[..., None])
    doh, oh = _heads(do, heads), _heads(o, heads)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dp = torch.matmul(doh, _heads(v, heads).transpose(-1, -2))
    ds = p * (dp - (doh * oh).sum(-1, keepdim=True))
    dq = torch.matmul(ds, _heads(k, heads)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q, heads)) * scale
    return _merge(dq).to(q.dtype), _merge(dk).to(k.dtype), _merge(dv).to(v.dtype)


def _kv_len(s_k, valid_k):
    kv_len = s_k if valid_k is None else min(int(valid_k), s_k)
    if kv_len < 1:
        raise ValueError("attention needs at least one valid key")
    return kv_len


def _check_qkv(q, k, v, heads):
    b, s_q, hd = q.shape
    s_k = k.shape[1]
    if hd != heads * HEAD_DIM:
        raise ValueError(f"K1 needs head_dim {HEAD_DIM}: got {hd} / {heads} heads")
    _build.check(q, "q", torch.bfloat16)
    _build.check(k, "k", torch.bfloat16, (b, s_k, hd))
    _build.check(v, "v", torch.bfloat16, (b, s_k, hd))


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int, valid_k: Optional[int] = None,
                      site: str = "spatial", want_lse: bool = False,
                      route: Optional[str] = None):
    """K1 on CUDA tensors (with the LSE output when ``want_lse``), on the
    route of :func:`attention_plan` (``route`` forces one, for measurements
    and the card tests; forcing the short route on more than 64 queries or
    keys raises); the plain version on CPU tensors. Not differentiable: see
    :func:`attention_packed`."""
    if _build.on_cpu(q, k, v):
        return attention_plain(q, k, v, heads, valid_k, want_lse)
    _check_qkv(q, k, v, heads)
    b, s_q, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, heads, s_q, dtype=torch.float32, device=q.device) if want_lse else None
    if b * s_q == 0:  # no queries (an empty band of height-parallel sampling): nothing to launch
        return (out, lse) if want_lse else out
    plan = attention_plan(b, s_q, k.shape[1], heads, _kv_len(k.shape[1], valid_k), route,
                          sm_count(q.device.index or 0))
    _build.launch("vk_attention_short" if plan.route == "short" else "vk_attention_wgmma",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.ptr(lse),
                  b, s_q, plan.s_k, heads, plan.kv_len, (HEAD_DIM ** -0.5) * _LOG2E,
                  plan.grid[0], plan.smem)
    _build.count("attention", site, plan.route)
    return (out, lse) if want_lse else out


def attention_bwd_prep(o, lse, do, plan: BwdPlan):
    """The wgmma route's pre-pass alone: ``(lse log2 e, rowsum(dO * O))``
    per query row and head, fp32 ``(b, heads, plan.s_q_pad, 2)``, pad rows
    ``(+inf, 0)``."""
    if _build.on_cpu(o, lse, do):
        return attention_bwd_prep_plain(o, lse, do, plan)
    rows = torch.empty(plan.b, plan.heads, plan.s_q_pad, 2, dtype=torch.float32,
                       device=o.device)
    _build.launch("vk_attention_bwd_prep", o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  rows.data_ptr(), plan.b, plan.s_q, plan.s_q_pad, plan.heads)
    return rows


def attention_bwd_prep_plain(o, lse, do, plan: BwdPlan):
    """:func:`attention_bwd_prep` in fp32."""
    s = plan.s_q
    rows = torch.zeros(plan.b, plan.heads, plan.s_q_pad, 2, dtype=torch.float32,
                       device=o.device)
    rows[..., 0] = math.inf
    rows[:, :, :s, 0] = lse.float() * _LOG2E
    rows[:, :, :s, 1] = (_heads(do, plan.heads) * _heads(o, plan.heads)).sum(-1)
    return rows


def attention_bwd(q, k, v, o, lse, do, heads: int, valid_k: Optional[int] = None,
                  site: str = "spatial", route: Optional[str] = None):
    """dq, dk, dv: ``csrc/attention_bwd.cu`` on CUDA tensors, the plain
    version on CPU tensors. The route is :func:`attention_bwd_plan`'s
    (``route`` forces one, for measurements and the card tests; forcing the
    short route on more than 64 queries or keys raises): up to
    ``SMALL_KEYS`` keys (the temporal t = 25 attention, the 45-key mid site
    at 320x576) the short route's single launch, more keys the pre-pass and
    the wgmma kernels (PERF.md §6, "route crossover")."""
    if _build.on_cpu(q, k, v, do):
        return attention_bwd_plain(q, k, v, o, lse, do, heads, valid_k)
    _check_qkv(q, k, v, heads)
    b, s_q, hd = q.shape
    _build.check(o, "o", torch.bfloat16, (b, s_q, hd))
    _build.check(do, "do", torch.bfloat16, (b, s_q, hd))
    _build.check(lse, "lse", torch.float32, (b, heads, s_q))
    plan = attention_bwd_plan(b, s_q, k.shape[1], heads, _kv_len(k.shape[1], valid_k), route,
                              sm_count(q.device.index or 0))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if plan.route == "short":
        _build.launch("vk_attention_bwd_short", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), b, s_q, plan.s_k, heads, plan.kv_len,
                      HEAD_DIM ** -0.5, plan.grid[0], plan.smem)
    else:
        rows = attention_bwd_prep(o, lse, do, plan)
        _build.launch("vk_attention_bwd_wgmma", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      do.data_ptr(), rows.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), b, s_q, plan.s_k, heads, plan.kv_len, plan.s_q_pad,
                      HEAD_DIM ** -0.5)
    _build.count("attention_bwd", site, plan.route)
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, valid_k, site, tag):
        out, lse = remat.reuse(tag, lambda: attention_forward(q, k, v, heads, valid_k, site,
                                                              want_lse=True))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (heads, valid_k, site)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, valid_k: Optional[int] = None,
                     site: str = "spatial", tag: Optional[str] = None) -> torch.Tensor:
    """Non-causal attention; ``site`` names the caller in the launch counts.
    Differentiable when an input requires grad; ``tag``: a remat ``"names"``
    site, whose recompute takes ``(o, lse)`` from the forward
    (:func:`~vista_tpu_torch.ops.remat.reuse`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, heads, valid_k, site, tag)
    return attention_forward(q, k, v, heads, valid_k, site)
