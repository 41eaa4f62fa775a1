"""The training recipe's optimizer in plain fp32 PyTorch, from its
definition (optax's chain as Vista's JAX training composes it): the micro-
steps' gradients averaged over ``accum_steps``, then a clip of the global
norm, Adam with bias correction, decoupled weight decay, a multiplier per
parameter group (``slow_spatial``: the temporal parameters at 1, the rest
at ``slow_spatial_factor``) and ``-lr`` times the linear warm-up; the EMA
after every micro-step with decay ``min(ema_decay, (1 + n) / (10 + n))``.
"""

from __future__ import annotations

from typing import Dict

import torch

TEMPORAL = ("time_stack", "cond_time_stack_embed")


def lr_mult(name: str, policy: str, slow: float) -> float:
    if policy == "full":
        return 1.0
    if policy == "slow_spatial":
        return 1.0 if any(t in name for t in TEMPORAL) else slow
    raise ValueError(f"unknown policy {policy!r}")


def warmup(step: int, warm_up_steps: int, f_start: float = 1e-6) -> float:
    if step < warm_up_steps:
        return f_start + (1.0 - f_start) * step / max(warm_up_steps, 1)
    return 1.0


class Optimizer:
    """Holds fp32 parameters, Adam's moments, the EMA and the running mean
    of the micro-steps' gradients; ``micro_step(grads)`` takes one
    micro-step's gradients by name."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict):
        self.cfg = cfg
        self.params = params
        self.mults = {n: lr_mult(n, cfg["policy"], cfg["slow_spatial_factor"]) for n in params}
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.ema = {n: p.detach().clone() for n, p in params.items()}
        self.acc = {n: torch.zeros_like(p) for n, p in params.items()}
        self.micro = 0
        self.updates = 0

    @torch.no_grad()
    def micro_step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One micro-step; a gradient of None (a leaf the loss does not
        reach, as a one-token cross-attention's queries and keys) is zero."""
        cfg = self.cfg
        self.micro += 1
        k = (self.micro - 1) % cfg["accum_steps"] + 1
        for n, a in self.acc.items():
            g = grads[n] if grads[n] is not None else torch.zeros_like(a)
            a.add_((g - a) / k)
        if k == cfg["accum_steps"]:
            self._update()
            for a in self.acc.values():
                a.zero_()
        d = min(cfg["ema_decay"], (1.0 + self.micro) / (10.0 + self.micro))
        for n, e in self.ema.items():
            e.sub_((1.0 - d) * (e - self.params[n]))

    def _update(self) -> None:
        cfg = self.cfg
        norm = float(torch.sqrt(sum(torch.sum(a.double() ** 2) for a in self.acc.values())))
        clip = 1.0 if norm < cfg["grad_clip"] else cfg["grad_clip"] / norm
        count = self.updates + 1
        rate = -cfg["learning_rate"] * warmup(self.updates, cfg["warmup_steps"])
        b1, b2 = cfg["beta1"], cfg["beta2"]
        for n, p in self.params.items():
            g = self.acc[n] * clip
            self.mu[n].mul_(b1).add_(g, alpha=1.0 - b1)
            self.nu[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            u = (self.mu[n] / (1.0 - b1 ** count)) / (
                torch.sqrt(self.nu[n] / (1.0 - b2 ** count)) + cfg["eps"])
            p.add_((u + cfg["weight_decay"] * p) * self.mults[n] * rate)
        self.updates = count
