"""LR multiplier schedules, functions of the optimizer step count
(counterpart of ``vista_tpu/engine/lr_schedule.py``): ``lambda_linear``, the
shipped configs' (linear warm-up, then linear from f_max to f_min over the
cycle), and ``warmup_cosine`` (linear warm-up, then a cosine from f_max to
f_min by ``max_decay_steps``)."""

from __future__ import annotations

import math


def lambda_linear(warm_up_steps: int = 1000, f_start: float = 1e-6, f_min: float = 1.0,
                  f_max: float = 1.0, cycle_length: float = 1e13):
    def schedule(step: int) -> float:
        if step < warm_up_steps:
            return f_start + (f_max - f_start) * step / max(warm_up_steps, 1)
        return f_min + (f_max - f_min) * (cycle_length - step) / cycle_length

    return schedule


def warmup_cosine(warm_up_steps: int, f_start: float, f_min: float, f_max: float,
                  max_decay_steps: float):
    def schedule(step: int) -> float:
        if step < warm_up_steps:
            return f_start + (f_max - f_start) * step / max(warm_up_steps, 1)
        t = min(max((step - warm_up_steps) / (max_decay_steps - warm_up_steps), 0.0), 1.0)
        return f_min + 0.5 * (f_max - f_min) * (1.0 + math.cos(t * math.pi))

    return schedule
