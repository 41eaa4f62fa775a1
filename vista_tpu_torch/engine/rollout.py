"""Long-horizon autoregressive rollout (counterpart of
``vista_tpu/engine/rollout.py``).

Round 1 predicts ``T`` frames from the pinned context frames; every later
round re-conditions on the last 3 latents (moved to slots 0-2 under the mask
``[1,1,1,0,...]``) and appends ``T - 3`` frames. The CLIP image of round
``n + 1`` is frame ``-3`` of round ``n``'s decode; the ``concat`` condition
is the raw latent of that frame (``skip_encode``: no pixel round trip).
Every round decodes at the fixed ``T``-frame shape and drops its context
frames.

The random draws come in as tensors (:class:`RolloutDraws`), so tests can
pass the JAX package's; :func:`draw_rollout_noise` draws them from an
explicit ``torch.Generator``. Frames are NCHW.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, FrozenSet, Iterable, Optional, Tuple

import torch

from vista_tpu_torch.diffusion.sampler import SamplerConfig
from vista_tpu_torch.engine.engine import UC_ZERO_KEYS, VistaEngine
from vista_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    num_rounds: int = 1
    n_context_frames: int = 3  # frames re-pinned between rounds
    initial_cond_indices: Tuple[int, ...] = (0,)
    force_uc_zero: FrozenSet[str] = UC_ZERO_KEYS


@dataclasses.dataclass(frozen=True)
class RolloutDraws:
    """``posterior``: the encoder posterior's standard-normal noise, of the
    latents' shape ``(T, z, h, w)``; ``cond_aug``: the noise ``cond_aug``
    scales onto the first context frame, ``(1, 3, H, W)``; ``noise``: one
    initial noise per round (or per reward member), ``(n, T, z, h, w)``."""

    posterior: torch.Tensor
    cond_aug: torch.Tensor
    noise: torch.Tensor


def draw_rollout_noise(engine: VistaEngine, images: torch.Tensor, n: int,
                       gen: torch.Generator) -> RolloutDraws:
    """Standard-normal draws for ``n`` sampling passes over ``images``
    ``(T, 3, H, W)``, in the order the JAX package splits its key (encoder,
    cond_aug, then the passes), on the generator's device."""
    f, zc = engine.cfg.vae.downsample_factor, engine.cfg.vae.z_channels
    t, _, h, w = images.shape
    latent = (t, zc, h // f, w // f)
    draw = lambda *shape: torch.randn(*shape, generator=gen, device=gen.device)
    return RolloutDraws(posterior=draw(*latent), cond_aug=draw(1, *images.shape[1:]),
                        noise=draw(n, *latent))


def frame_mask(indices: Iterable[int], num_frames: int, device) -> torch.Tensor:
    m = torch.zeros(num_frames, device=device)
    m[list(indices)] = 1.0
    return m


def first_round_batch(batch: Dict[str, torch.Tensor], images: torch.Tensor,
                      cond_aug_noise: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The conditioning batch of a pass from the context frames: CLIP sees
    the first frame, the encoder the same frame plus ``cond_aug`` noise."""
    out = dict(batch)
    out["cond_frames_without_noise"] = images[:1]
    cond_aug = batch["cond_aug"] if "cond_aug" in batch else images.new_zeros(1)
    out["cond_frames"] = images[:1] + cond_aug[0] * cond_aug_noise.to(images.dtype)
    return out


@torch.no_grad()
def autoregressive_rollout(engine: VistaEngine, images: torch.Tensor,
                           batch: Dict[str, torch.Tensor], sampler: SamplerConfig,
                           rollout: RolloutConfig, draws: RolloutDraws,
                           decode_output: bool = True, mesh: Optional[Mesh] = None,
                           mesh_mode: str = "frames"
                           ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Run ``rollout.num_rounds`` rounds of prediction.

    images: ``(T, 3, H, W)`` context pixels in [-1, 1] on the engine's device;
    batch: conditioning scalars and actions (``cond_frames_without_noise`` and
    ``cond_frames`` are set per round). Returns ``(pixels or None, latents)``:
    latents ``(num_rounds * (T - 3) + 3, z, h, w)`` in fp32, pixels the same
    frames in [0, 1]. With ``mesh`` the denoise rounds run sharded over its
    ``data`` axis (:meth:`VistaEngine.sample_sharded` in ``mesh_mode``:
    ``frames``, ``height`` or ``weights``);
    encode, conditioning and decode run whole on every rank.
    """
    run_round = engine.sample if mesh is None else functools.partial(
        engine.sample_sharded, mesh=mesh, mode=mesh_mode)
    cfg = engine.cfg
    t, nc = cfg.num_frames, rollout.n_context_frames
    if draws.noise.shape[0] < rollout.num_rounds:
        raise ValueError(f"{rollout.num_rounds} rounds need as many noises, "
                         f"got {draws.noise.shape[0]}")
    z = engine.encode_first_stage(images, draws.posterior).float()

    c, uc = engine.condition_pair(first_round_batch(batch, images, draws.cond_aug),
                                  rollout.force_uc_zero)
    mask = frame_mask(rollout.initial_cond_indices, t, z.device)
    sample = run_round(draws.noise[0], c, uc, z, mask, sampler)
    sample[0] = z[0]

    # every round decodes t latents: rounds 2+ carry the previous round's nc
    # context latents through the temporal decoder and drop their frames
    latents = [sample]
    decoded = engine.decode_first_stage(sample) if decode_output else None
    pixels = [decoded]

    pred_mask = frame_mask(range(nc), t, z.device)
    for n in range(1, rollout.num_rounds):
        # the next CLIP image: frame -nc of this round's decode (without one,
        # of a decode of the tail)
        if not decode_output:
            decoded = engine.decode_first_stage(sample[-cfg.decode_chunk:])
        clip_frame = decoded[-nc]
        batch_n = dict(batch)
        batch_n["cond_frames_without_noise"] = clip_frame[None]
        # the concat condition is the unscaled latent (the encoder's output)
        batch_n["cond_frames"] = sample[-nc][None] / cfg.vae.scale_factor
        c, uc = engine.condition_pair(batch_n, rollout.force_uc_zero, skip_encode=True)

        filled = torch.zeros_like(sample)
        filled[:nc] = sample[-nc:]
        sample = run_round(draws.noise[n], c, uc, filled, pred_mask, sampler)
        latents.append(sample[nc:])
        if decode_output:
            decoded = engine.decode_first_stage(sample)
            pixels.append(decoded[nc:])

    latents = torch.cat(latents)
    if not decode_output:
        return None, latents
    return torch.clamp((torch.cat(pixels) + 1.0) / 2.0, 0.0, 1.0), latents
