"""EMA of parameters (counterpart of ``vista_tpu/engine/ema.py``): shadow
values updated with the warm-up decay ``min(decay, (1 + n) / (10 + n))``,
where ``n`` counts optimizer steps after this one. Held for the leaves that
train only: a frozen leaf's shadow is the leaf itself."""

from __future__ import annotations

from typing import Dict

import torch


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               num_updates: int, decay: float = 0.9999) -> None:
    """In place: ``e <- e - (1 - d) (e - p)`` for every shadowed name."""
    d = min(decay, (1.0 + num_updates) / (10.0 + num_updates))
    for name, e in ema.items():
        e.sub_((1.0 - d) * (e - params[name]))
