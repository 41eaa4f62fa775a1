"""Selective activation checkpointing: the ``remat_policy`` of the UNet's
checkpointed blocks (counterpart of the policies that
``vista_tpu/models/unet.py`` hands to ``nn.remat``).

A checkpointed block runs under ``torch.utils.checkpoint`` (non-reentrant):
its forward keeps only its inputs, and the backward runs the forward again
to get back the tensors that the block's autograd nodes saved. The policy
says what that recompute may take from the forward instead:

- ``None``: nothing; the whole block runs again.
- ``"names"``: the outputs of the sites tagged ``attn1_out``,
  ``attn2_out``, ``ff_out`` and ``temporal_attn_out`` (the
  ``checkpoint_name`` tags of ``vista_tpu/models/attention.py``). The
  kernels launch through ``ctypes``, out of the dispatcher's sight, so a
  dispatch-level policy cannot save their outputs; this store works one
  level up: the forward appends each site's output, the recompute takes
  them back in the same order. A site is one of two kinds:

  - a kernel's autograd Function (:func:`reuse`: K1's ``(o, lse)``, the
    feed-forward's output): the recompute still applies the Function, so
    its node saves the same tensors in the same order as the checkpoint
    expects, but the forward hands back the stored output instead of
    launching. Only that output stays on the card; the Function's inputs
    are recomputed.
  - a composition (:func:`tagged`: the cross-attention term, the temporal
    self-attention, a LoRA out-projection): its nodes keep what they save,
    as outside a checkpoint, and the recompute skips it and takes its
    output.
- ``"dots"``: the outputs of products without batch dimensions
  (``aten.mm`` / ``aten.addmm``, as JAX's
  ``dots_with_no_batch_dims_saveable``), through PyTorch's selective
  checkpoint dispatch mode; every hand-written kernel runs again, as under
  ``None``.
"""

from __future__ import annotations

import collections
import functools
import threading
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = (None, "names", "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

_state = threading.local()  # a backward's recompute runs in the autograd engine's thread


class _Store:
    """One side of a checkpointed call under ``"names"``: the forward's
    (``replay`` false) appends the sites' outputs, the recompute's takes
    them."""

    def __init__(self, outs: collections.deque, replay: bool):
        self.outs, self.replay = outs, replay

    def __enter__(self):
        self.prev = getattr(_state, "store", None)
        _state.store = self

    def __exit__(self, *exc):
        _state.store = self.prev

    def take(self):
        if not self.outs:
            raise RuntimeError("a block checkpointed under remat_policy='names' was "
                               "recomputed twice: run its backward once")
        return self.outs.popleft()


def _names_contexts():
    outs = collections.deque()
    return _Store(outs, replay=False), _Store(outs, replay=True)


def _active(tag: Optional[str]) -> Optional[_Store]:
    return getattr(_state, "store", None) if tag is not None else None


def reuse(tag: Optional[str], run: Callable):
    """``run()`` (a tensor or a tuple of tensors) inside a kernel's autograd
    Function forward; at a tagged site under ``"names"``, the recompute gets
    the forward's result back without running it."""
    store = _active(tag)
    if store is None:
        return run()
    if store.replay:
        return store.take()
    out = run()
    store.outs.append(tuple(t.detach() for t in out) if isinstance(out, tuple)
                      else out.detach())
    return out


def tagged(tag: Optional[str], run: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``run()``, a composition of differentiable ops; at a tagged site under
    ``"names"`` its nodes keep their saved tensors (detached, so that an op
    saving its own output makes no reference cycle) and the recompute takes
    its output without running it."""
    store = _active(tag)
    if store is None:
        return run()
    if store.replay:
        return store.take()
    with torch.autograd.graph.saved_tensors_hooks(torch.Tensor.detach, lambda t: t):
        out = run()
    store.outs.append(out.detach().requires_grad_(out.requires_grad))
    return out


def _dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def check_policy(policy: Optional[str]) -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}")


def checkpointed(fn: Callable, *args, policy: Optional[str] = None):
    """``fn(*args)`` under non-reentrant ``torch.utils.checkpoint`` with the
    remat ``policy``."""
    check_policy(policy)
    if policy is None:
        return checkpoint(fn, *args, use_reentrant=False)
    context_fn = (_names_contexts if policy == "names"
                  else functools.partial(create_selective_checkpoint_contexts, _dots))
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)
