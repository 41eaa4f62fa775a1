"""Sequence parallelism over latent rows: the ``height`` mode of sharded
sampling.

Under :func:`height_parallel` each rank of ``group`` holds one band of the
latent rows of every frame, at every level of the UNet. A level of ``rows``
rows is cut by one rule, :func:`bounds`: rank ``r`` holds rows
``[floor(r rows / n), floor((r + 1) rows / n))``, so the encoder's and the
decoder's bands of a level agree and their skips concatenate band by band.
Uneven levels are cut unevenly (9 rows over 2 ranks: 4 and 5), and a band
may be empty (9 rows over 12 ranks leave three ranks none). A level is named
by its width: the UNet halves both sides at each level, so a band of width
``w`` belongs to the level of ``height * w / width`` rows.

Only the stages that read across rows communicate:

- every spatial conv (:func:`band_conv`) fetches the rows it reads from the
  bands that hold them (:func:`fetch_rows`, one all-to-all), zeros past the
  image; stride-2 and upsampling convs fetch by row index, since floor-cut
  bands of two levels do not nest;
- every GroupNorm sums its statistics over the bands in fp32
  (:func:`band_group_norm`: the mean first, then the centred second moment);
  the temporal stages' ``gn_affine`` takes the group as a token split;
- every spatial self-attention keeps its queries and all-gathers K and V in
  row-major token order (:func:`gather_bands`);
- the result's rows are gathered at the end (:func:`gather_bands` on dim 2).

The temporal stages are token-local, so a band runs them as they are. The
same code runs at one rank: its exchanges move nothing, its all-reduces and
gathers have one part. Sampling only: nothing here has a backward.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from vista_tpu_torch.parallel.frames import frame_group
from vista_tpu_torch.parallel.mesh import _all_gather


@dataclasses.dataclass(frozen=True)
class _Bands:
    group: object
    height: int  # the latent's rows and columns at the UNet's input
    width: int


_BANDS = contextvars.ContextVar("height_parallel_bands", default=None)


@contextlib.contextmanager
def height_parallel(group, height: int, width: int):
    """For the span of the block the UNet runs on this rank's band of the
    rows of a ``height`` x ``width`` latent, over ``group``. Does not nest,
    with itself or with ``frame_parallel``."""
    if _BANDS.get() is not None or frame_group() is not None:
        raise RuntimeError("height_parallel does not nest with itself or frame_parallel")
    token = _BANDS.set(_Bands(group, height, width))
    try:
        yield
    finally:
        _BANDS.reset(token)


def height_group():
    """The group of the active :func:`height_parallel`, or None."""
    bands = _BANDS.get()
    return None if bands is None else bands.group


def _active() -> _Bands:
    bands = _BANDS.get()
    if bands is None:
        raise RuntimeError("outside height_parallel")
    return bands


def bounds(rows: int, n: int) -> List[int]:
    """The first row of each of ``n`` bands of ``rows`` rows, and ``rows``:
    band ``r`` is ``[b[r], b[r + 1])``."""
    return [r * rows // n for r in range(n + 1)]


def band_sizes(rows: int) -> List[int]:
    """The rows of each rank's band of a level of ``rows`` rows, in rank
    order."""
    b = bounds(rows, dist.get_world_size(_active().group))
    return [z - a for a, z in zip(b, b[1:])]


def level_rows(width: int) -> int:
    """The rows of the active latent's level whose width is ``width``."""
    bands = _active()
    rows, rest = divmod(bands.height * width, bands.width)
    if rest:
        raise ValueError(f"width {width} is not a level of a {bands.height}x{bands.width} latent")
    return rows


def band(rows: int) -> Tuple[int, int]:
    """This rank's band ``(start, stop)`` of a level of ``rows`` rows."""
    group = _active().group
    b = bounds(rows, dist.get_world_size(group))
    r = dist.get_rank(group)
    return b[r], b[r + 1]


def fetch_rows(x: torch.Tensor, rows: int,
               need: Callable[[int], Tuple[int, int]]) -> torch.Tensor:
    """Rows ``[lo, hi) = need(rank)`` of a level of ``rows`` rows, from
    ``x``, this rank's band ``(f, c, band rows, w)``: zeros outside ``[0,
    rows)``, the rest from the bands that hold them (one all-to-all; each
    rank's own rows stay local). Every rank computes every rank's ``need``.
    Returns ``(f, c, hi - lo, w)`` held channels-last."""
    group = _active().group
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b = bounds(rows, n)
    xv = x.permute(0, 2, 3, 1)  # (f, h, w, c): free for a channels-last x
    f, _, w, c = xv.shape

    def held(i, j):
        """The rows of rank i's band that rank j needs."""
        lo, hi = need(j)
        a = max(lo, b[i])
        return a, max(a, min(hi, b[i + 1]))

    sends = [(0, 0) if j == r else held(r, j) for j in range(n)]
    recvs = [(0, 0) if i == r else held(i, r) for i in range(n)]
    unit = f * w * c
    send = x.new_empty(sum(z - a for a, z in sends) * unit)
    off = 0
    for a, z in sends:
        part = xv[:, a - b[r]:z - b[r]]
        send[off:off + part.numel()].view(part.shape).copy_(part)
        off += part.numel()
    recv = x.new_empty(sum(z - a for a, z in recvs) * unit)
    dist.all_to_all_single(recv, send, output_split_sizes=[(z - a) * unit for a, z in recvs],
                           input_split_sizes=[(z - a) * unit for a, z in sends], group=group)
    lo, hi = need(r)
    pieces = [xv.new_zeros(f, max(min(hi, 0) - lo, 0), w, c)]
    off = 0
    for i, (a, z) in enumerate(recvs):
        if i == r:
            a, z = held(r, r)
            pieces.append(xv[:, a - b[r]:z - b[r]])
        else:
            pieces.append(recv[off:off + (z - a) * unit].view(f, z - a, w, c))
            off += (z - a) * unit
    pieces.append(xv.new_zeros(f, max(hi - max(lo, rows), 0), w, c))
    return torch.cat(pieces, dim=1).permute(0, 3, 1, 2)


def band_conv(conv: nn.Conv2d, x: torch.Tensor, upsample: bool = False) -> torch.Tensor:
    """``conv`` (3x3 with padding 1 at stride 1 or 2, or 1x1) on this rank's
    band ``x`` of a level, after a 2x nearest upsample when ``upsample``;
    returns this rank's band of the output level, held channels-last.
    Output row o of a 3x3 conv reads input rows o - 1 .. o + 1 (2o - 1 ..
    2o + 1 at stride 2; rows floor((o - 1) / 2) .. floor((o + 1) / 2) after
    the upsample), fetched with :func:`fetch_rows`; the width keeps the
    conv's own padding."""
    k, stride, pad = conv.kernel_size[0], conv.stride[0], conv.padding
    if (k, pad[0], stride) not in ((3, 1, 1), (3, 1, 2), (1, 0, 1)) or (upsample and stride != 1):
        raise ValueError(f"band_conv takes a 3x3 conv with padding 1 at stride 1 or 2 or a 1x1 "
                         f"conv, got kernel {k}, stride {stride}, padding {pad}")
    f, _, _, w = x.shape
    rows = level_rows(w)
    scale = 2 if upsample else 1
    rows_out, w_out = -(-rows * scale // stride), -(-w * scale // stride)
    b = bounds(rows_out, dist.get_world_size(_active().group))
    s, e = band(rows_out)

    def need(j):
        s_j, e_j = b[j], b[j + 1]
        if s_j == e_j:
            return s_j, s_j
        if upsample:
            return (s_j - 1) // 2, e_j // 2 + 1
        return stride * s_j - 1, stride * (e_j - 1) + 2

    if e == s:  # an empty band: it still sends the rows that others need
        if k == 3:
            fetch_rows(x, rows, need)
        return x.new_empty(f, conv.out_channels, 0, w_out).contiguous(
            memory_format=torch.channels_last)
    if k == 1:
        return F.conv2d(x, conv.weight, conv.bias)
    xin = fetch_rows(x, rows, need)
    if upsample:
        first = 2 * need(dist.get_rank(_active().group))[0]
        xin = F.interpolate(xin, scale_factor=2.0, mode="nearest")
        xin = xin[:, :, s - 1 - first:e + 1 - first]
    return F.conv2d(xin, conv.weight, conv.bias, stride, (0, pad[1]))


def band_group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``F.group_norm`` of the whole level from this rank's band ``x`` ``(f,
    c, band rows, w)``: per (frame, group) fp32 sums over the band,
    all-reduced over the bands, the mean first, then the sum of squares
    about it (no cancellation of E[x^2] - E[x]^2). x's dtype and memory
    format out."""
    group = _active().group
    f, c, h, w = x.shape
    cg = c // num_groups
    xf = x.float().permute(0, 2, 3, 1).reshape(f, h * w, num_groups, cg)
    sums = torch.cat([xf.sum(dim=(1, 3)).reshape(-1), xf.new_full((1,), float(h * w * cg))])
    dist.all_reduce(sums, group=group)
    count = sums[-1]
    mean = (sums[:-1] / count).view(f, 1, num_groups, 1)
    d = xf - mean
    sq = (d * d).sum(dim=(1, 3))
    dist.all_reduce(sq, group=group)
    rstd = torch.rsqrt(sq / count + eps).view(f, 1, num_groups, 1)
    y = (d * rstd).reshape(f, h, w, c) * weight.float() + bias.float()
    return y.permute(0, 3, 1, 2).to(x.dtype)


def gather_bands(x: torch.Tensor, dim: int, sizes: List[int]) -> torch.Tensor:
    """The whole of ``dim`` from every rank's part of it, ``sizes[r]`` long
    for rank ``r``, concatenated in rank order: each part is padded to the
    longest for the all-gather and cut back after."""
    longest = max(sizes)
    shape = list(x.shape)
    shape[dim] = longest
    padded = x.new_empty(shape)
    padded.narrow(dim, 0, x.shape[dim]).copy_(x)
    parts = _all_gather(padded, _active().group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim)


def gather_keys(k: torch.Tensor, v: torch.Tensor, width: int):
    """The whole frame's keys and values from this rank's band's ``(b,
    band tokens, d)``, in row-major token order, each contiguous."""
    sizes = [r * width for r in band_sizes(level_rows(width))]
    kv = gather_bands(torch.stack([k, v]), 2, sizes)
    return kv[0], kv[1]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole latents ``(f, c, height, width)`` from this rank's band."""
    return gather_bands(x, 2, band_sizes(_active().height))


def band_of(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """This rank's band of the rows (dim 2) of a whole ``(f, c, height,
    width)`` input, contiguous; None for None."""
    if x is None:
        return None
    s, e = band(_active().height)
    return x[:, :, s:e].contiguous()
