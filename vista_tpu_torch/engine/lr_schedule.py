"""The LR multiplier schedule of the shipped configs (counterpart of
``vista_tpu/engine/lr_schedule.py``, ``lambda_linear``): linear warm-up, then
linear from f_max to f_min over the cycle; a function of the optimizer step
count."""

from __future__ import annotations


def lambda_linear(warm_up_steps: int = 1000, f_start: float = 1e-6, f_min: float = 1.0,
                  f_max: float = 1.0, cycle_length: float = 1e13):
    def schedule(step: int) -> float:
        if step < warm_up_steps:
            return f_start + (f_max - f_start) * step / max(warm_up_steps, 1)
        return f_min + (f_max - f_min) * (cycle_length - step) / cycle_length

    return schedule

