"""Weight-sharded inference: ZeRO-style sampling for weights larger than a
card (the ``weights`` mode of ``VistaEngine.sample_sharded``).

Inside :func:`sharded_weights` every parameter that :func:`fsdp_shard_dim`
shards holds only this rank's slice. A forward pre-hook on each block
all-gathers the block's slices into whole tensors just before the block
runs, and a forward hook drops them again just after, so that one block's
whole weights live at a time. Activations are whole on every rank, and
every rank computes the same thing. On exit the whole weights come back.
No gradient flows through the gathers: sampling only.

This is the port's own pair of hooks, not FSDP2's ``fully_shard``: FSDP2
shards every parameter on dim 0, the JAX rule picks each tensor's largest
divisible dim and leaves small ones whole.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List

import torch
import torch.distributed as dist
import torch.nn as nn

from vista_tpu_torch.parallel.mesh import all_gather_dim, fsdp_shard_dim, shard


@contextlib.contextmanager
def sharded_weights(blocks: Iterable[nn.Module], group, min_size: int = 2**16):
    """Shard the parameters of ``blocks`` over ``group`` for the span of the
    block (see the module's docstring). ``blocks`` are the units gathered
    one at a time; each parameter belongs to one of them."""
    n = dist.get_world_size(group)
    blocks = list(blocks)
    owned: List[Dict[nn.Parameter, int]] = []
    for block in blocks:
        dims = {p: fsdp_shard_dim(p.shape, n, min_size) for p in block.parameters()}
        owned.append({p: d for p, d in dims.items() if d is not None})
    slices = {p: shard(p.data, dim, group) for mine in owned for p, dim in mine.items()}

    def gather(mine):
        def hook(module, args):
            with torch.no_grad():
                for p, dim in mine.items():
                    p.data = all_gather_dim(slices[p], dim, group)
        return hook

    def drop(mine):
        def hook(module, args, output):
            for p in mine:
                p.data = slices[p]
        return hook

    handles = []
    try:
        for p, part in slices.items():
            p.data = part
        for block, mine in zip(blocks, owned):
            if mine:
                handles.append(block.register_forward_pre_hook(gather(mine)))
                handles.append(block.register_forward_hook(drop(mine)))
        yield
    finally:
        for h in handles:
            h.remove()
        with torch.no_grad():
            for mine in owned:
                for p, dim in mine.items():
                    p.data = all_gather_dim(slices[p], dim, group)
