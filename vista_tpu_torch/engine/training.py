"""One training step (counterpart of ``vista_tpu/engine/training.py``,
``make_train_step``, and its optimizer).

- The UNet trains; the VAE encoder and the conditioner (CLIP tower,
  ``quant_conv``) are frozen and run without gradients.
- Parameter-group policies by name: ``full``, ``slow_spatial`` (temporal
  parameters at the full rate, the rest at ``slow_spatial_factor``) and
  ``lora_only`` (the LoRA and action adapters only). A parameter whose
  multiplier is 0 is frozen: it records no gradient and has no optimizer
  state.
- The optimizer follows optax's chain in the JAX package: global-norm clip
  (over the leaves that train), Adam, decoupled weight decay, the per-group
  multiplier, then ``-lr * schedule(step)`` (``lambda_linear``).
- Leaves that train keep fp32 masters, the module holds their copies in
  the compute dtype (the JAX package keeps fp32 parameters and computes in
  bf16); the EMA shadows the masters.

- Gradient accumulation (``accum_steps = k > 1``) follows ``optax.MultiSteps``
  around that chain, as the JAX package composes them: each call is one
  micro-step whose gradients join a running mean in one fp32 buffer per
  trained tensor (``acc += (g - acc) / n``); the chain runs on the mean on
  every k-th call only. Adam's bias correction and the schedule count the
  applied updates (:attr:`Trainer.updates`); ``Trainer.step`` and the EMA
  count micro-steps, so on a call that applies nothing the EMA still moves
  toward the unchanged parameters.

Every random draw of a step (:class:`TrainDraws`) is an argument:
:func:`draw_train` makes one from a ``torch.Generator``, and the tests hand
in the JAX package's draws. The reported ``grad_norm`` is the micro-batch's
own, over the leaves that train (the JAX package's metric also counts the
frozen leaves' grads, which the port never computes).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

from vista_tpu_torch.diffusion.loss import LossConfig, LossDraws, diffusion_loss, draw_loss
from vista_tpu_torch.engine.ema import ema_update
from vista_tpu_torch.engine.lr_schedule import lambda_linear
from vista_tpu_torch.models.conditioner import draw_ucg_keep


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-2
    grad_clip: float = 0.3
    warmup_steps: int = 1000
    accum_steps: int = 1
    policy: str = "full"  # "full" | "slow_spatial" | "lora_only"
    slow_spatial_factor: float = 0.1
    ema_decay: float = 0.9999
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)


# the reference's temporal group, by the upstream names: the VideoResBlock
# and SpatialVideoTransformer ``time_stack`` modules and the
# conditional-frame time embedding
_TEMPORAL_TOKENS = ("time_stack", "cond_time_stack_embed")


def lr_mult(name: str, policy: str, slow_factor: float = 0.1) -> float:
    """The LR multiplier of the UNet parameter ``name`` under ``policy``."""
    if policy == "full":
        return 1.0
    if policy == "slow_spatial":
        return 1.0 if any(t in name for t in _TEMPORAL_TOKENS) else slow_factor
    if policy == "lora_only":
        return 1.0 if "adapter" in name else 0.0
    raise ValueError(f"unknown policy {policy!r}")


@dataclasses.dataclass
class TrainDraws:
    """posterior ``(b*t, z, h, w)`` and cond_aug ``(b, 3, H, W)`` standard
    normals; ucg_keep: keep masks ``(b,)`` per embedder (None: no dropout);
    the loss's draws."""

    posterior: torch.Tensor
    cond_aug: torch.Tensor
    ucg_keep: Optional[Dict[str, torch.Tensor]]
    loss: LossDraws


def draw_train(engine, cfg: TrainConfig, batch: Mapping[str, torch.Tensor],
               gen: torch.Generator) -> TrainDraws:
    b, t, _, h, w = batch["frames"].shape
    dev = batch["frames"].device
    f = engine.cfg.vae.downsample_factor
    z = engine.cfg.vae.z_channels
    ccfg = engine.cfg.conditioner
    return TrainDraws(
        posterior=torch.randn(b * t, z, h // f, w // f, generator=gen, device=dev),
        cond_aug=torch.randn(b, 3, h, w, generator=gen, device=dev),
        ucg_keep=draw_ucg_keep(ccfg, b, gen, dev) if ccfg.ucg_rate > 0 else None,
        loss=draw_loss(cfg.loss, (b * t, z, h // f, w // f), gen, dev))


class Trainer:
    """``trainer(batch, draws) -> metrics``: one micro-step of the UNet's
    optimizer (one optimizer step when ``accum_steps`` is 1).

    batch: ``frames`` ``(b, t, 3, H, W)`` pixels in [-1, 1]; ``fps_id``,
    ``motion_bucket_id``, ``cond_aug`` ``(b,)``; the optional action keys.
    """

    def __init__(self, engine, cfg: TrainConfig):
        if cfg.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {cfg.accum_steps}")
        self.engine, self.cfg = engine, cfg
        self.schedule = lambda_linear(warm_up_steps=cfg.warmup_steps)
        params = dict(engine.unet.named_parameters())
        self.mults = {n: lr_mult(n, cfg.policy, cfg.slow_spatial_factor) for n in params}
        for n, p in params.items():
            p.requires_grad_(self.mults[n] > 0.0)
        self.params = {n: p for n, p in params.items() if self.mults[n] > 0.0}
        self.master = {n: p.detach().float().clone() for n, p in self.params.items()}
        self.mu = {n: torch.zeros_like(m) for n, m in self.master.items()}
        self.nu = {n: torch.zeros_like(m) for n, m in self.master.items()}
        self.ema = {n: m.clone() for n, m in self.master.items()}
        # the running mean of the micro-steps' gradients (accumulation only)
        self.acc = {n: torch.zeros_like(m) for n, m in self.master.items()} \
            if cfg.accum_steps > 1 else None
        self.step = 0     # micro-steps: the EMA's count
        self.updates = 0  # applied optimizer updates: Adam's and the schedule's count

    def loss_and_grads(self, batch: Mapping[str, torch.Tensor], draws: TrainDraws):
        """Forward and backward; the gradients land on every UNet parameter
        that requires grad. Returns the loss and its metrics."""
        engine = self.engine
        frames = batch["frames"]
        b, t = frames.shape[:2]
        latents = engine.encode_first_stage(frames.reshape(b * t, *frames.shape[2:]),
                                            draws.posterior)
        first = frames[:, 0]
        cond_batch = {k: v for k, v in batch.items() if k != "frames"}
        cond_batch["cond_frames_without_noise"] = first
        cond_batch["cond_frames"] = first + batch["cond_aug"].reshape(-1, 1, 1, 1) * draws.cond_aug
        cond = engine.conditions(cond_batch, ucg_keep=draws.ucg_keep)
        for p in engine.unet.parameters():
            p.grad = None
        loss, aux = diffusion_loss(engine.denoise_fn(t), latents, cond, self.cfg.loss,
                                   draws.loss)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def _grad(self, name: str) -> torch.Tensor:
        """The fp32 gradient of a trained tensor from its ``.grad`` (zero
        where the step did not reach it, as the k projection of a one-token
        cross-attention)."""
        g = self.params[name].grad
        return g.float() if g is not None else torch.zeros_like(self.master[name])

    def grads(self) -> Dict[str, torch.Tensor]:
        """fp32 copies of the current gradients of the leaves that train, for
        inspection (a step casts them one tensor at a time)."""
        return {n: self._grad(n) for n in self.params}

    @staticmethod
    def _global_norm(tensors) -> float:
        return float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors])))  # one sync

    @torch.no_grad()
    def apply(self) -> float:
        """One micro-step from the ``.grad`` of each leaf that trains, cast to
        fp32 tensor by tensor and then dropped. Returns the micro-batch's
        gradient norm."""
        cfg = self.cfg
        norm = self._global_norm([p.grad for p in self.params.values() if p.grad is not None])
        self.step += 1
        if self.acc is not None:
            n_acc = (self.step - 1) % cfg.accum_steps + 1
            for n, acc in self.acc.items():
                acc.add_((self._grad(n) - acc) / n_acc)
                self.params[n].grad = None
            if n_acc == cfg.accum_steps:
                self._update(lambda n: self.acc[n], self._global_norm(self.acc.values()))
                for acc in self.acc.values():
                    acc.zero_()
        else:
            self._update(self._grad, norm)
            for p in self.params.values():
                p.grad = None
        ema_update(self.ema, self.master, self.step, cfg.ema_decay)
        return norm

    def _update(self, grad, norm: float) -> None:
        """The inner chain: clip -> Adam -> decay -> multiplier -> schedule."""
        cfg = self.cfg
        clip = 1.0 if norm < cfg.grad_clip else cfg.grad_clip / norm
        count = self.updates + 1
        rate = -cfg.learning_rate * self.schedule(self.updates)
        for n, master in self.master.items():
            g = grad(n) * clip
            self.mu[n].mul_(cfg.beta1).add_(g, alpha=1.0 - cfg.beta1)
            self.nu[n].mul_(cfg.beta2).addcmul_(g, g, value=1.0 - cfg.beta2)
            u = (self.mu[n] / (1.0 - cfg.beta1 ** count)) / (
                torch.sqrt(self.nu[n] / (1.0 - cfg.beta2 ** count)) + cfg.eps)
            u = (u + cfg.weight_decay * master) * self.mults[n]
            master.add_(u * rate)
            self.params[n].copy_(master)
        self.updates = count

    def __call__(self, batch: Mapping[str, torch.Tensor], draws: TrainDraws) -> Dict[str, float]:
        loss, aux = self.loss_and_grads(batch, draws)
        norm = self.apply()
        return {"loss": float(loss), "grad_norm": norm,
                **{k: float(v) for k, v in aux.items()}}
