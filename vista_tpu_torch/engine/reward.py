"""Ensemble-variance reward (counterpart of ``vista_tpu/engine/reward.py``).

An ensemble of sampling passes from the same context and action
conditioning; the reward is ``exp(-var.mean())`` of the latents across the
ensemble (unbiased variance, in fp32): higher means the model is more sure
of the future under that action. No decode is needed.

The members run one after the other, as the JAX package's ``lax.map`` does,
each from its own initial noise in ``draws.noise``.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

import torch

from vista_tpu_torch.diffusion.sampler import SamplerConfig
from vista_tpu_torch.engine.engine import UC_ZERO_KEYS, VistaEngine
from vista_tpu_torch.engine.rollout import RolloutDraws, first_round_batch, frame_mask


@torch.no_grad()
def estimate_reward(engine: VistaEngine, images: torch.Tensor,
                    batch: Dict[str, torch.Tensor], sampler: SamplerConfig,
                    ensemble_size: int = 5, initial_cond_indices: Tuple[int, ...] = (0,),
                    force_uc_zero: FrozenSet[str] = UC_ZERO_KEYS, *,
                    draws: RolloutDraws) -> torch.Tensor:
    """Scalar confidence reward for the context ``images`` ``(T, 3, H, W)``
    in [-1, 1] and the actions in ``batch``; ``draws.noise`` holds at least
    ``ensemble_size`` initial noises."""
    if draws.noise.shape[0] < ensemble_size:
        raise ValueError(f"an ensemble of {ensemble_size} needs as many noises, "
                         f"got {draws.noise.shape[0]}")
    z = engine.encode_first_stage(images, draws.posterior).float()
    c, uc = engine.condition_pair(first_round_batch(batch, images, draws.cond_aug),
                                  force_uc_zero)
    mask = frame_mask(initial_cond_indices, engine.cfg.num_frames, z.device)
    members = []
    for i in range(ensemble_size):
        s = engine.sample(draws.noise[i], c, uc, z, mask, sampler)
        s[0] = z[0]
        members.append(s.float())
    variance = torch.var(torch.stack(members), dim=0, correction=1)
    return torch.exp(-variance.mean())
