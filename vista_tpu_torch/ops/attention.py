"""Multi-head attention on the packed ``(B, S, heads * head_dim)`` layout.

Counterpart of ``vista_tpu/ops/attention.py``, ``ops/flash_attention.py``
and ``ops/tiny_attention.py``: one entry, :func:`attention_packed`, covers
the spatial self-attention at every length (the JAX package switches
between its flash kernel at s >= 2048 and its tiny kernel at s <= 1024) and
the temporal attention over t = 25 frames. On CUDA tensors it launches the
hand-written kernel K1 (``csrc/attention.cu``) on the route that
:func:`attention_plan` picks: more than ``FWD_SMALL_KEYS`` keys (the
spatial sites) take the TMA + ``wgmma`` flash forward, the temporal t = 25
attention (and any site at or under the threshold) the ``mma.sync`` kernel.
On CPU tensors it runs :func:`attention_plain`. The kernels take t = 25
unpadded; ``valid_k`` masks keys at or past it for callers that do pad.

Backward (training): when an input requires grad, the forward also writes
the fp32 log-sum-exp of each query row, ``(B, heads, S_q)`` (the JAX
``want_lse`` path), and the backward runs ``csrc/attention_bwd.cu``: a
pre-pass for ``D = rowsum(dO * O)``, a dK/dV kernel looping over query
tiles and a dQ kernel looping over key tiles, both recomputing P from the
saved LSE. :func:`attention_bwd_plan` picks the route: the spatial sites
(more than 64 keys) take the TMA + ``wgmma`` kernels (ports of
``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` and the spatial ``_tiny_bwd_kernel``);
the temporal t = 25 attention and the 45-key mid site at 320x576 keep the
``mma.sync`` kernels, which beat the library call there. On CPU tensors
:func:`attention_bwd_plain` computes the same in fp32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from vista_tpu_torch.ops import _build

HEAD_DIM = 64  # the only head width K1 is built for (the UNet's)
_LOG2E = 1.4426950408889634

# Both kernels' routes share their shapes: at most a threshold of keys take
# the mma.sync kernels (64-row tiles, 128 threads, static shared memory);
# more take the wgmma kernels (blocks of 128 rows, two consumer warpgroups
# and a producer warpgroup, a ring of stages of 128 rows). K1's threshold is
# FWD_SMALL_KEYS and its ring FWD_STAGES deep (csrc/attention.cu);
# attention_bwd's SMALL_KEYS and WGMMA_STAGES (csrc/attention_bwd.cu). Both
# thresholds are measured crossovers on an H100 (chip_smoke.py
# route_crossovers): the mma.sync kernels win at t = 25
# and at the 45-key mid site of 320x576, the wgmma ones from 144 keys up.
FWD_SMALL_KEYS = 64
FWD_STAGES = 4
SMALL_KEYS = 64
MMA_TILE, MMA_THREADS = 64, 128
WGMMA_TILE, WGMMA_STAGES, WGMMA_THREADS = 128, 3, 384
_BOX = WGMMA_TILE * HEAD_DIM * 2  # one 128 x 64 bf16 tile, bytes
_BARRIERS = 8 * (1 + 2 * WGMMA_STAGES)


def _decode(route, heads, tile, tiles, i, y):
    """(batch row, head, first row) of block ``i`` of a grid over ``tiles``
    row tiles per (batch row, head): ``(b tiles, heads)`` on the mma
    route, flat with the tile fastest, then the head, on the wgmma one."""
    if route == "mma":
        return i // tiles, y, i % tiles * tile
    bh = i // tiles
    return bh // heads, bh % heads, i % tiles * tile


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """What :func:`attention_forward` launches for one shape: ``route``
    (``"wgmma"`` or ``"mma"``), the row tile of a block (queries per block
    and keys per step), its threads, the grid (``(x, y)`` on the mma route,
    flat on the wgmma one) and the dynamic shared memory in bytes (0 on the
    mma route, whose shared memory is static)."""

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

    def block(self, i: int, y: int = 0):
        """(batch row, head, first query) of block ``i``, as the kernel
        decodes it."""
        return _decode(self.route, self.heads, self.tile, -(-self.s_q // self.tile), i, y)


@functools.lru_cache(maxsize=256)
def attention_plan(b: int, s_q: int, s_k: int, heads: int, kv_len: int,
                   route: Optional[str] = None) -> FwdPlan:
    """The route, tile, grid and shared memory that K1's forward launches at
    one shape (the kernels' entries only check them), computed here so that
    the CPU tests check them; cached, since a model repeats a few shapes.
    ``route`` forces a route (for measuring the crossover); by default more
    than ``FWD_SMALL_KEYS`` keys take the wgmma kernel."""
    if min(b, s_q, s_k, heads) < 1 or not 1 <= kv_len <= s_k:
        raise ValueError(f"attention_plan: bad shape {(b, s_q, s_k, heads, kv_len)}")
    route = route or ("mma" if s_k <= FWD_SMALL_KEYS else "wgmma")
    shape = (b, s_q, s_k, heads, kv_len)
    if route == "mma":
        return FwdPlan(route, *shape, MMA_TILE, MMA_THREADS, (b * -(-s_q // MMA_TILE), heads), 0)
    if route != "wgmma":
        raise ValueError(f"attention_plan: unknown route {route!r}")
    t = WGMMA_TILE
    # 1024 for the swizzle alignment, the Q tile, the ring of K and V, the
    # barriers (Q's, full and empty per stage)
    smem = 1024 + _BOX + FWD_STAGES * 2 * _BOX + 8 * (1 + 2 * FWD_STAGES)
    return FwdPlan(route, *shape, t, WGMMA_THREADS, (b * heads * -(-s_q // t),), smem)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """What :func:`attention_bwd` launches for one shape. ``route`` is
    ``"wgmma"`` or ``"mma"``. Both start with the pre-pass, 8 threads per
    (batch row, head, query) in ``prep_blocks`` blocks of 256, writing the
    fp32 (lse log2 e, D) pairs ``(b, heads, s_q_pad, 2)``; the grids are the
    kernels' block counts (``(x, y)`` for the mma route, flat for the wgmma
    one) and ``smem`` their dynamic shared memory in bytes (``{}`` for the
    mma route, whose shared memory is static)."""

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

    def dkv_block(self, i: int, y: int = 0):
        """(batch row, head, first key) of dK/dV block ``i`` (``y`` the
        grid's second index on the mma route), as the kernel decodes it."""
        return self._decode(i, y, -(-self.s_k // self.tile))

    def dq_block(self, i: int, y: int = 0):
        """(batch row, head, first query) of dQ block ``i``."""
        return self._decode(i, y, -(-self.s_q // self.tile))

    def _decode(self, i, y, tiles):
        return _decode(self.route, self.heads, self.tile, tiles, i, y)


def attention_bwd_plan(b: int, s_q: int, s_k: int, heads: int, kv_len: int,
                       route: Optional[str] = None) -> BwdPlan:
    """The route, tiles, grids and shared memory of :func:`attention_bwd` at
    one shape, computed here so that the CPU tests check them. ``route``
    forces a route (for measuring the crossover); by default more than
    ``SMALL_KEYS`` keys take the wgmma kernels."""
    if min(b, s_q, s_k, heads) < 1 or not 1 <= kv_len <= s_k:
        raise ValueError(f"attention_bwd_plan: bad shape {(b, s_q, s_k, heads, kv_len)}")
    route = route or ("mma" if s_k <= SMALL_KEYS else "wgmma")
    shape = (b, s_q, s_k, heads, kv_len)
    if route == "mma":
        t = MMA_TILE
        return BwdPlan(route, *shape, t, MMA_THREADS, s_q, (b * -(-s_k // t), heads),
                       (b * -(-s_q // t), heads), {})
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
    and the card tests); the plain version on CPU tensors. Not
    differentiable: see :func:`attention_packed`."""
    if _build.on_cpu(q, k, v):
        return attention_plain(q, k, v, heads, valid_k, want_lse)
    _check_qkv(q, k, v, heads)
    b, s_q, _ = q.shape
    plan = attention_plan(b, s_q, k.shape[1], heads, _kv_len(k.shape[1], valid_k), route)
    out = torch.empty_like(q)
    lse = torch.empty(b, heads, s_q, dtype=torch.float32, device=q.device) if want_lse else None
    # the mma route's grid is (x, y), the wgmma route's its block count and
    # its dynamic shared memory
    launch = plan.grid if plan.route == "mma" else (plan.grid[0], plan.smem)
    _build.launch("vk_attention" if plan.route == "mma" else "vk_attention_wgmma",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.ptr(lse),
                  b, s_q, plan.s_k, heads, plan.kv_len, (HEAD_DIM ** -0.5) * _LOG2E, *launch)
    _build.count("attention", site, plan.route)
    return (out, lse) if want_lse else out


def attention_bwd_prep(o, lse, do, plan: BwdPlan):
    """The pre-pass alone: ``(lse log2 e, rowsum(dO * O))`` per query row and
    head, fp32 ``(b, heads, plan.s_q_pad, 2)``, pad rows ``(+inf, 0)``."""
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
    (``route`` forces one, for measurements and the card tests): up to
    ``SMALL_KEYS`` keys (the temporal t = 25 attention, the 45-key mid site
    at 320x576) the mma.sync kernels, more keys the wgmma kernels; the
    mma.sync ones are the faster below that line on an H100 (PERF.md §6,
    "route crossover")."""
    if _build.on_cpu(q, k, v, do):
        return attention_bwd_plain(q, k, v, o, lse, do, heads, valid_k)
    _check_qkv(q, k, v, heads)
    b, s_q, hd = q.shape
    _build.check(o, "o", torch.bfloat16, (b, s_q, hd))
    _build.check(do, "do", torch.bfloat16, (b, s_q, hd))
    _build.check(lse, "lse", torch.float32, (b, heads, s_q))
    plan = attention_bwd_plan(b, s_q, k.shape[1], heads, _kv_len(k.shape[1], valid_k), route)
    rows = attention_bwd_prep(o, lse, do, plan)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    entry = "vk_attention_bwd" if plan.route == "mma" else "vk_attention_bwd_wgmma"
    _build.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  rows.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), plan.b,
                  plan.s_q, plan.s_k, plan.heads, plan.kv_len, plan.s_q_pad, HEAD_DIM ** -0.5)
    _build.count("attention_bwd", site, plan.route)
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, valid_k, site):
        out, lse = attention_forward(q, k, v, heads, valid_k, site, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (heads, valid_k, site)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, valid_k: Optional[int] = None,
                     site: str = "spatial") -> torch.Tensor:
    """Non-causal attention; ``site`` names the caller in the launch counts.
    Differentiable when an input requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, heads, valid_k, site)
    return attention_forward(q, k, v, heads, valid_k, site)
