"""Frame parallelism of the UNet's temporal stages.

Under :func:`frame_parallel` each rank of ``group`` holds the same
contiguous run of ``t / n`` frames of every video (rank ``i`` the ``i``-th
run). The spatial blocks, the cross-attention and the time embeddings are
frame-local and run as they are. The temporal stages read the context:

- ``TemporalTransformerBlock`` moves its rows to token-sharded sequences of
  all ``t`` frames before the temporal attention (an all-to-all) and back
  after it;
- ``TemporalResBlock`` does the same around both K4 convs, whose 3-tap
  halo needs every frame, and sums its GroupNorm statistics over the
  ranks' tokens in fp32;
- ``SpatialVideoTransformer`` embeds each frame at its index in the video.

Without the context the modules run their one-card code.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch.distributed as dist

_GROUP = contextvars.ContextVar("frame_parallel_group", default=None)


@contextlib.contextmanager
def frame_parallel(group):
    """For the span of the block the temporal stages run frame-parallel
    over ``group``. Does not nest, with itself or with ``height_parallel``."""
    from vista_tpu_torch.parallel.height import height_group  # height imports this module

    if _GROUP.get() is not None or height_group() is not None:
        raise RuntimeError("frame_parallel does not nest with itself or height_parallel")
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def frame_group():
    """The group of the active :func:`frame_parallel`, or None."""
    return _GROUP.get()


def frame_offset(local_frames: int) -> Optional[int]:
    """The index in the video of this rank's first frame, or None without
    the context."""
    group = _GROUP.get()
    return None if group is None else dist.get_rank(group) * local_frames
