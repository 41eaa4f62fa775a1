"""Sequence-parallel attention over a process group (counterpart of
``vista_tpu/parallel/sp_attention.py``).

Each rank holds an even share of the sequence: ``s / n`` queries, keys and
values in the packed layout ``(b, s / n, heads * d)``, rank ``r`` the
``r``-th block. The keys and values are all-gathered over the group in rank
order; every rank then runs the one-card attention (``attention_packed``:
K1 on the card, the plain version on CPU tensors) for its queries against
the whole sequence. Exact: the rank's rows of whole-sequence attention.

Differentiable: the gather's backward sums each rank's dK and dV (from K1's
backward) over the group in fp32 and keeps this rank's block, the
reduce-scatter that is the all-gather's transpose. Nothing in the
VideoUNet calls it, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vista_tpu_torch.ops.attention import attention_packed
from vista_tpu_torch.parallel.mesh import _all_gather


class _GatherSequence(torch.autograd.Function):
    """K and V ``(b, s / n, hd)`` -> ``(b, s, hd)`` each, the ranks' blocks
    in rank order; backward: each cotangent summed over the group, this
    rank's block."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        return tuple(torch.cat(_all_gather(t, group), 1) for t in (k, v))

    @staticmethod
    def backward(ctx, dk, dv):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        out = []
        for d in (dk, dv):
            total = d.float()
            dist.all_reduce(total, group=ctx.group)
            out.append(total.chunk(n, 1)[r].to(d.dtype))
        return (*out, None)


def sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, seq_len: int,
                 group=None) -> torch.Tensor:
    """This rank's rows of attention over the whole sequence of ``seq_len``
    tokens: ``q``, ``k``, ``v`` ``(b, seq_len / n, heads * d)`` are its
    blocks of it (``group`` None: the default group). Raises unless the
    group's ``n`` ranks divide ``seq_len`` and this rank holds its share, a
    check on this rank's shapes alone, as the JAX function's is on the
    global array's."""
    group = dist.group.WORLD if group is None else group
    n = dist.get_world_size(group)
    if seq_len % n:
        raise ValueError(f"sp_attention: a sequence of {seq_len} tokens does not split evenly "
                         f"over {n} ranks")
    if not (q.shape[1] == k.shape[1] == v.shape[1] == seq_len // n):
        raise ValueError(f"sp_attention: q, k and v hold {q.shape[1]}, {k.shape[1]} and "
                         f"{v.shape[1]} tokens on this rank; each must hold {seq_len // n}, its "
                         f"share of {seq_len} over {n} ranks")
    k_all, v_all = _GatherSequence.apply(k, v, group)
    return attention_packed(q, k_all, v_all, heads)
