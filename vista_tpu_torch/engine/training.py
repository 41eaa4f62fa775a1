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

Over a mesh (``parallel/mesh.py``; the JAX TrainState sharded over
``data`` x ``fsdp``): after the backward each trained gradient becomes its
mean over the ``data`` group (bucketed fp32 all-reduces, issued after the
backward, not overlapped with it); ``master``, ``mu``, ``nu``, ``ema`` and
``acc`` hold this rank's slice of each tensor that ``fsdp_shard_dim``
shards (the whole of the others); the update runs on the slices, which are
then all-gathered into the module's copy, whole on every rank. The
gradient norm sums its squares in fp64, the slices' sums added over the
``fsdp`` group, so its fp32 value does not depend on the mesh. Without a
process group the trainer is one rank.

:func:`eval_loss` is the loss alone (counterpart of ``make_eval_step``):
no ucg dropout, no gradient, under whatever weights the modules hold;
:meth:`Trainer.ema_weights` puts the EMA shadows in for its span.
:meth:`Trainer.state_dict` holds everything a resume needs: the masters,
Adam's moments, the EMA, the accumulation buffer and both counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from vista_tpu_torch.diffusion.loss import LossConfig, LossDraws, diffusion_loss, draw_loss
from vista_tpu_torch.engine.ema import ema_update
from vista_tpu_torch.engine.lr_schedule import lambda_linear
from vista_tpu_torch.models.conditioner import draw_ucg_keep
from vista_tpu_torch.parallel.mesh import (Mesh, all_gather_dim, fsdp_shard_dim, grad_mean_,
                                           shard)


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
               gen: torch.Generator, dropout: bool = True,
               shard_of: Tuple[int, int] = (0, 1)) -> TrainDraws:
    """The draws of one step from ``gen``; ``dropout=False`` (evaluation)
    draws no ucg masks. ``shard_of = (i, n)`` (data parallelism): ``batch``
    is the ``i``-th of ``n`` equal row blocks of the global batch; the
    global batch's draws are made and the block's rows kept."""
    i, n = shard_of
    lb, t, _, h, w = batch["frames"].shape
    b = lb * n
    dev = batch["frames"].device
    f = engine.cfg.vae.downsample_factor
    z = engine.cfg.vae.z_channels
    ccfg = engine.cfg.conditioner
    draws = TrainDraws(
        posterior=torch.randn(b * t, z, h // f, w // f, generator=gen, device=dev),
        cond_aug=torch.randn(b, 3, h, w, generator=gen, device=dev),
        ucg_keep=draw_ucg_keep(ccfg, b, gen, dev) if dropout and ccfg.ucg_rate > 0 else None,
        loss=draw_loss(cfg.loss, (b * t, z, h // f, w // f), gen, dev))
    return draws if n == 1 else shard_draws(draws, i, n)


def shard_draws(draws: TrainDraws, i: int, n: int) -> TrainDraws:
    """The draws of the ``i``-th of ``n`` equal row blocks of a batch: its
    videos' rows of the per-video draws, its frames' rows of the per-frame
    ones."""
    videos = draws.cond_aug.shape[0]
    per = lambda x: None if x is None else x.chunk(n)[i]
    if videos % n:
        raise ValueError(f"{videos} videos do not split into {n} blocks")
    return TrainDraws(
        posterior=per(draws.posterior), cond_aug=per(draws.cond_aug),
        ucg_keep=None if draws.ucg_keep is None else {
            k: per(v) for k, v in draws.ucg_keep.items()},
        loss=LossDraws(sigma_normal=per(draws.loss.sigma_normal), choice=per(draws.loss.choice),
                       noise=per(draws.loss.noise), offset=per(draws.loss.offset)))


def _loss(engine, cfg: TrainConfig, batch: Mapping[str, torch.Tensor], draws: TrainDraws):
    """The training loss and its metrics: the frozen first stage and
    conditioner, then the UNet's diffusion loss."""
    frames = batch["frames"]
    b, t = frames.shape[:2]
    latents = engine.encode_first_stage(frames.reshape(b * t, *frames.shape[2:]),
                                        draws.posterior)
    first = frames[:, 0]
    cond_batch = {k: v for k, v in batch.items() if k != "frames"}
    cond_batch["cond_frames_without_noise"] = first
    cond_batch["cond_frames"] = first + batch["cond_aug"].reshape(-1, 1, 1, 1) * draws.cond_aug
    cond = engine.conditions(cond_batch, ucg_keep=draws.ucg_keep)
    return diffusion_loss(engine.denoise_fn(t), latents, cond, cfg.loss, draws.loss)


@torch.no_grad()
def eval_loss(engine, cfg: TrainConfig, batch: Mapping[str, torch.Tensor],
              draws: TrainDraws):
    """The training loss under the weights the modules hold, without ucg
    dropout and without a gradient: ``(loss, metrics)``. ``draws.ucg_keep``
    must be None."""
    if draws.ucg_keep is not None:
        raise ValueError("the eval loss takes no ucg dropout: pass ucg_keep=None")
    return _loss(engine, cfg, batch, draws)


class Trainer:
    """``trainer(batch, draws) -> metrics``: one micro-step of the UNet's
    optimizer (one optimizer step when ``accum_steps`` is 1).

    batch: ``frames`` ``(b, t, 3, H, W)`` pixels in [-1, 1]; ``fps_id``,
    ``motion_bucket_id``, ``cond_aug`` ``(b,)``; the optional action keys.
    Over a ``mesh`` with a process group: this rank's rows of the global
    batch, the optimizer state sliced over ``fsdp`` (tensors under
    ``fsdp_min_size`` elements whole).
    """

    def __init__(self, engine, cfg: TrainConfig, mesh: Optional[Mesh] = None,
                 fsdp_min_size: int = 2**16):
        if cfg.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {cfg.accum_steps}")
        self.engine, self.cfg = engine, cfg
        self.schedule = lambda_linear(warm_up_steps=cfg.warmup_steps)
        params = dict(engine.unet.named_parameters())
        self.mults = {n: lr_mult(n, cfg.policy, cfg.slow_spatial_factor) for n in params}
        for n, p in params.items():
            p.requires_grad_(self.mults[n] > 0.0)
        self.params = {n: p for n, p in params.items() if self.mults[n] > 0.0}
        # the mesh's groups; without a process group none, and no slices
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        self.shard_dims: Dict[str, Optional[int]] = {n: None for n in self.params}
        if self.mesh is None:
            self.master = {n: p.detach().float().clone() for n, p in self.params.items()}
        else:
            self._data, self._fsdp = self.mesh.group("data"), self.mesh.group("fsdp")
            self.shard_dims = {n: fsdp_shard_dim(p.shape, self.mesh.size("fsdp"), fsdp_min_size)
                               for n, p in self.params.items()}
            self.master = {n: shard(p.detach().float(), self.shard_dims[n], self._fsdp)
                           for n, p in self.params.items()}
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
        for p in self.engine.unet.parameters():
            p.grad = None
        loss, aux = _loss(self.engine, self.cfg, batch, draws)
        loss.backward()
        if self.mesh is not None:  # the data-parallel mean, after the backward
            for p in self.params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grad_mean_([p.grad for p in self.params.values()], self._data)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def _grad(self, name: str) -> torch.Tensor:
        """The fp32 gradient of a trained tensor from its ``.grad`` (zero
        where the step did not reach it, as the k projection of a one-token
        cross-attention)."""
        g = self.params[name].grad
        return g.float() if g is not None else torch.zeros_like(self.master[name])

    def _local_grad(self, name: str) -> torch.Tensor:
        """This rank's slice of :meth:`_grad` (the whole without slices)."""
        g, dim = self._grad(name), self.shard_dims[name]
        if dim is None:
            return g
        return g.chunk(self.mesh.size("fsdp"), dim)[self.mesh.coord("fsdp")]

    def _whole(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The whole tensor of a trained leaf from this rank's slice."""
        if self.mesh is None:
            return part
        return all_gather_dim(part, self.shard_dims[name], self._fsdp)

    def grads(self) -> Dict[str, torch.Tensor]:
        """fp32 copies of the current gradients of the leaves that train, for
        inspection (a step casts them one tensor at a time)."""
        return {n: self._grad(n) for n in self.params}

    @staticmethod
    def _squares(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
        """The sum of the tensors' squares, added up in fp64."""
        sums = [torch.sum(torch.square(t.float()), dtype=torch.float64) for t in tensors]
        return torch.stack(sums).sum() if sums else torch.zeros((), dtype=torch.float64)

    def _global_norm(self, tensors: Mapping[str, torch.Tensor], sliced: bool = False) -> float:
        """The global norm of ``tensors`` by name, its squares summed in fp64
        and rounded to fp32 once, so that the order of the sums does not
        reach its bits. ``sliced``: the tensors are this rank's slices; the
        sliced ones' sums are added over the ``fsdp`` group, a whole tensor
        counts once."""
        if not sliced or self.mesh is None:
            total = self._squares(tensors.values())
        else:
            total = self._squares(t for n, t in tensors.items() if self.shard_dims[n] is not None)
            dist.all_reduce(total, group=self._fsdp)
            total = total + self._squares(
                t for n, t in tensors.items() if self.shard_dims[n] is None)
        return float(torch.sqrt(total).float())  # one sync

    @torch.no_grad()
    def apply(self) -> float:
        """One micro-step from the ``.grad`` of each leaf that trains, cast to
        fp32 tensor by tensor and then dropped. Returns the micro-batch's
        gradient norm."""
        cfg = self.cfg
        norm = self._global_norm({n: p.grad for n, p in self.params.items()
                                  if p.grad is not None})
        self.step += 1
        if self.acc is not None:
            n_acc = (self.step - 1) % cfg.accum_steps + 1
            for n, acc in self.acc.items():
                acc.add_((self._local_grad(n) - acc) / n_acc)
                self.params[n].grad = None
            if n_acc == cfg.accum_steps:
                self._update(lambda n: self.acc[n], self._global_norm(self.acc, sliced=True))
                for acc in self.acc.values():
                    acc.zero_()
        else:
            self._update(self._local_grad, norm)
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
            self.params[n].copy_(self._whole(n, master))
        self.updates = count

    @contextlib.contextmanager
    def ema_weights(self):
        """For the span of the block the module's trained parameters hold
        their EMA shadows (cast to the compute dtype); on exit they are
        restored from the fp32 masters, bit for bit. Frozen leaves are their
        own shadows and stay as they are."""
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(self._whole(n, self.ema[n]))
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in self.params.items():
                    p.copy_(self._whole(n, self.master[n]))

    def _groups(self):
        return (("master", self.master), ("mu", self.mu), ("nu", self.nu), ("ema", self.ema),
                ("acc", self.acc if self.acc is not None else {}))

    def state_dict(self) -> Dict:
        """The optimizer's whole state: fp32 ``master``, ``mu``, ``nu``,
        ``ema`` and ``acc`` (empty without accumulation) by parameter name,
        ``step`` and ``updates``, the same tensors whatever the mesh. One
        rank: references, not copies. Over a mesh, a collective: each sliced
        tensor is gathered in turn, and rank 0 keeps it on the host and
        references to the whole ones; the other ranks keep nothing (their
        groups come back empty)."""
        out = {"step": self.step, "updates": self.updates}
        first = self.mesh is None or self.mesh.is_first
        for group, mine in self._groups():
            out[group] = {}
            for n, t in mine.items():
                whole = t if self.mesh is None else self._whole(n, t)
                if first:
                    out[group][n] = whole if whole is t else whole.cpu()
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        """Copy a :meth:`state_dict` in (same names and shapes, whatever mesh
        wrote it; any device; this rank keeps its slices) and set the
        module's trained parameters from the masters."""
        for group, mine in self._groups():
            theirs = state[group]
            if set(theirs) != set(mine):
                raise KeyError(f"trainer state {group!r}: the names differ from this "
                               f"trainer's ({len(theirs)} against {len(mine)})")
            for n, t in mine.items():
                t.copy_(theirs[n] if self.mesh is None
                        else shard(theirs[n], self.shard_dims[n], self._fsdp))
        self.step, self.updates = int(state["step"]), int(state["updates"])
        for n, p in self.params.items():
            p.copy_(state["master"][n])

    def __call__(self, batch: Mapping[str, torch.Tensor], draws: TrainDraws) -> Dict[str, float]:
        """One micro-step; the loss and its metrics are the global batch's
        (averaged over the ``data`` group)."""
        loss, aux = self.loss_and_grads(batch, draws)
        norm = self.apply()
        metrics = {"loss": loss, **aux}
        if self.mesh is not None:
            metrics = self.data_mean(metrics)
        return {"loss": float(metrics.pop("loss")), "grad_norm": norm,
                **{k: float(v) for k, v in metrics.items()}}

    def data_mean(self, values: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Scalars by name -> their means over the ``data`` group (fp32; as
        they are without a mesh)."""
        if self.mesh is None:
            return dict(values)
        flat = torch.stack([torch.as_tensor(v, dtype=torch.float32).to(self.engine.device)
                            for v in values.values()])
        dist.all_reduce(flat, group=self._data)
        flat /= self.mesh.size("data")
        return dict(zip(values, flat))
