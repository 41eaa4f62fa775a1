"""The process group, the ``data`` x ``fsdp`` mesh, the sharding rule and
the collectives the port issues (counterpart of ``vista_tpu/parallel/mesh.py``).

One process per card, as torchrun starts them: :func:`init_distributed`
joins the group from torchrun's environment (NCCL on the card, gloo on the
CPU) and :func:`make_mesh` lays the ranks out as the JAX mesh lays out its
devices, ``(data, fsdp)`` row-major:

- ``data``: each rank takes its rows of the global batch (or its frames of
  a video when sampling); gradients are averaged over the axis;
- ``fsdp``: the optimizer state is held in slices along each tensor's
  largest divisible dim (:func:`fsdp_shard_dim`), the rule of
  ``fsdp_param_specs``.

Without a process group a mesh is one rank and holds no groups: callers
then run their one-card code. With one, every collective is issued, at
world size 1 too.

Collectives (each a plain function on a group): :func:`grad_mean_`
(bucketed fp32 all-reduce), :func:`all_gather_dim`, :func:`gather_frames`,
:func:`frames_to_tokens` / :func:`tokens_to_frames` (the all-to-all of the
temporal stages, uneven token splits through ``all_to_all_single``'s split
sizes). The GroupNorm statistics of the temporal stages are all-reduced
where they are computed (``ops/temporal_conv.gn_affine``).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "fsdp")
BUCKET_ELEMS = 1 << 25  # fp32 elements of one gradient bucket (128 MB)


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL with this rank's
    card current for ``device="cuda"``, gloo for ``"cpu"``. Returns the
    rank's device. A group that is already up is kept."""
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", rank))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(cuda) found no card; pass device='cpu' for gloo")
        torch.cuda.set_device(local)
        dev, backend = torch.device("cuda", local), "nccl"
    elif device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            rank=rank, world_size=world)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend}")
    return dev


class Mesh:
    """``shape``: the size of each axis of ``AXES``; ``device_mesh``: the
    ``DeviceMesh`` over the process group, None without one (one rank)."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group(self, axis: str):
        """The process group of this rank along ``axis`` (None without one)."""
        return self.device_mesh.get_group(axis) if self.distributed else None

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis) if self.distributed else 0

    @property
    def is_first(self) -> bool:
        """Rank 0 of the world: the rank that writes files."""
        return not self.distributed or dist.get_rank() == 0


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """A ``(data, fsdp)`` mesh over the process group's ranks (one rank
    without a group). ``axis_sizes`` defaults to ``{"data": ranks}``; a
    missing axis is 1 and a single ``-1`` is inferred, with ``make_mesh``'s
    errors (ranks in place of devices)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    sizes = dict(axis_sizes) if axis_sizes is not None else {"data": n}
    unknown_axes = set(sizes) - set(AXES)
    if unknown_axes:
        raise ValueError(f"mesh axes are {AXES}, got {sorted(unknown_axes)}")
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError("at most one -1 axis")
    known = math.prod(v for v in sizes.values() if v != -1)
    if unknown:
        if n % known:
            raise ValueError(f"{n} ranks not divisible by {known}")
        sizes[unknown[0]] = n // known
    total = math.prod(sizes.values())
    if total != n:
        raise ValueError(f"mesh {sizes} needs {total} ranks, have {n}")
    shape = {a: sizes.get(a, 1) for a in AXES}
    if not dist.is_initialized():
        return Mesh(shape)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(shape, init_device_mesh(device_type, tuple(shape.values()),
                                        mesh_dim_names=AXES))


def fsdp_shard_dim(shape: Sequence[int], n: int, min_size: int = 2**16) -> Optional[int]:
    """The dim a tensor of ``shape`` is sliced along over ``n`` ranks: the
    largest dim that ``n`` divides (the later one on a tie), or None
    (replicated) under ``min_size`` elements or where no dim divides."""
    if math.prod(shape) < min_size:
        return None
    candidates = [(d, i) for i, d in enumerate(shape) if d % n == 0]
    return max(candidates)[1] if candidates else None


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (of one shape), in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def shard(t: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim``: a contiguous copy that
    shares no storage with ``t`` (the whole tensor, copied, for ``dim``
    None)."""
    if dim is not None:
        t = t.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)]
    return t.clone(memory_format=torch.contiguous_format)


def all_gather_dim(part: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    """The whole tensor from every rank's slice along ``dim`` (``dim`` None:
    the part is whole already and comes back as it is)."""
    if dim is None:
        return part
    parts = _all_gather(part, group)
    return torch.cat(parts, dim) if len(parts) > 1 else parts[0]


def grad_mean_(grads: List[torch.Tensor], group) -> None:
    """In place: each tensor becomes its mean over ``group``. The sums run
    in fp32 buckets of at most ``BUCKET_ELEMS`` elements, one all-reduce a
    bucket; every rank passes the same tensors in the same order."""
    n = dist.get_world_size(group)
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        flat = torch.cat([g.reshape(-1).float() for g in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    for g in grads:
        if bucket and size + g.numel() > BUCKET_ELEMS:
            flush()
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel()
    if bucket:
        flush()


def token_splits(s: int, n: int) -> List[int]:
    """The tokens of each rank when ``s`` tokens are split over ``n``: the
    first ``s % n`` ranks take one more (9216 over 5: 1844, 1843 x 4)."""
    base, extra = divmod(s, n)
    return [base + (i < extra) for i in range(n)]


def frames_to_tokens(x: torch.Tensor, b: int, group, seq_major: bool) -> torch.Tensor:
    """Frame-sharded ``(b * t_local, s, c)`` rows -> token-sharded rows of
    all ``t = n * t_local`` frames, contiguous: ``(b * s_local, t, c)``
    (``seq_major``, the temporal attention's sequences) or ``(b * t,
    s_local, c)`` (frame-major, K4's layout). Every rank holds the same
    ``t_local`` frames of each of the ``b`` videos; rank ``i`` receives the
    ``i``-th run of :func:`token_splits`."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    bt, s, c = x.shape
    tl = bt // b
    sizes = token_splits(s, n)
    xv = x.view(b, tl, s, c)
    send = x.new_empty(x.numel())
    off = 0
    for part in xv.split(sizes, dim=2):
        send[off:off + part.numel()].view(part.shape).copy_(part)
        off += part.numel()
    mine = sizes[r]
    recv = x.new_empty(n * b * tl * mine * c)
    dist.all_to_all_single(recv, send, output_split_sizes=[b * tl * mine * c] * n,
                           input_split_sizes=[b * tl * sz * c for sz in sizes], group=group)
    y = recv.view(n, b, tl, mine, c)
    if seq_major:
        return y.permute(1, 3, 0, 2, 4).reshape(b * mine, n * tl, c)
    return y.permute(1, 0, 2, 3, 4).reshape(b * n * tl, mine, c)


def tokens_to_frames(y: torch.Tensor, b: int, s: int, group, seq_major: bool) -> torch.Tensor:
    """The inverse of :func:`frames_to_tokens`: token-sharded rows of all
    frames (in either layout) -> this rank's frames of all ``s`` tokens,
    ``(b * t_local, s, c)`` contiguous."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    sizes = token_splits(s, n)
    mine = sizes[r]
    c = y.shape[-1]
    if seq_major:
        t = y.shape[1]
        yv = y.view(b, mine, n, t // n, c).permute(2, 0, 3, 1, 4)
    else:
        t = y.shape[0] // b
        yv = y.view(b, n, t // n, mine, c).permute(1, 0, 2, 3, 4)
    tl = t // n
    send = yv.contiguous().view(-1)  # (n, b, tl, mine, c): rank j's frames first
    recv = y.new_empty(b * tl * s * c)
    dist.all_to_all_single(recv, send, output_split_sizes=[b * tl * sz * c for sz in sizes],
                           input_split_sizes=[b * tl * mine * c] * n, group=group)
    parts = [p.view(b, tl, sz, c) for p, sz in zip(recv.split([b * tl * sz * c for sz in sizes]),
                                                    sizes)]
    return torch.cat(parts, dim=2).view(b * tl, s, c)


def gather_frames(x: torch.Tensor, b: int, group) -> torch.Tensor:
    """This rank's frames of ``b`` videos, ``(b * t_local, ...)`` -> all
    frames ``(b * t, ...)``, the ranks' runs in rank order within each video."""
    rest = x.shape[1:]
    parts = [p.view(b, -1, *rest) for p in _all_gather(x, group)]
    return torch.cat(parts, dim=1).view(-1, *rest)
