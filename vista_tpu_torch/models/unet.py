"""The Vista spatiotemporal VideoUNet (counterpart of ``vista_tpu/models/unet.py``).

Layout: ``(b*t, c, h, w)`` frame-major, held channels-last so that the
attention and temporal-conv kernels see ``(b*t, h*w, c)`` rows as free
views. Module and parameter names follow the upstream torch checkpoint
(``input_blocks.{i}.{j}``, ``middle_block``, ``output_blocks``, ``out``,
``time_embed``, ``cond_time_stack_embed``, ``label_emb.0``), the names that
``vista_tpu/utils/torch_import.py:unet_key_map`` maps.

The two time-embedding MLPs are blended per frame by the conditional-frame
mask, so the pinned context frames get their own embedding.

``add_lora`` / ``action_control`` add the rank-16 LoRA adapters and the
action K/V adapters of every attention (``models/attention.py``); the
cross-attention context is then ``context_dim + 19 * 128`` wide. ``remat``
wraps the top-level blocks (VideoResBlock, SpatialVideoTransformer) in
``torch.utils.checkpoint`` when gradients are recorded: the backward
recomputes each block's forward instead of storing its activations, as the
JAX package's ``nn.remat`` does. ``remat_max_ds`` limits that to the blocks
at downsample factors up to it (the deeper ones store their activations),
and ``remat_policy`` says what the recompute takes from the forward
(``ops/remat.py``). Neither changes the parameters' names.

Under ``height_parallel`` (``parallel/height.py``, sampling) ``x`` is this
rank's band of latent rows and the result its band of the output: every
layer runs on bands of its level, cut by one rule at every level, so the
decoder's skips concatenate band by band.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from vista_tpu_torch.models.attention import SpatialVideoTransformer
from vista_tpu_torch.models.blocks import Downsample, Upsample, VideoResBlock
from vista_tpu_torch.models.layers import Conv2d, GroupNorm32, timestep_embedding, timestep_mlp
from vista_tpu_torch.ops.remat import check_policy, checkpointed


@dataclasses.dataclass(frozen=True)
class VideoUNetConfig:
    """The JAX config's fields and defaults, without its TPU-only
    ``attn_backend``."""

    in_channels: int = 8
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    transformer_depth: int = 1
    num_head_channels: int = 64
    context_dim: int = 1024
    adm_in_channels: int = 768
    video_kernel: Tuple[int, int, int] = (3, 1, 1)
    merge_strategy: str = "learned_with_images"
    merge_factor: float = 0.5
    add_lora: bool = False
    action_control: bool = False
    num_frames: int = 25
    dtype: str = "bfloat16"
    remat: bool = False  # checkpoint each top-level block (training)
    # Selective checkpointing, no effect unless remat: only the blocks at a
    # downsample factor ds <= remat_max_ds are checkpointed (None: all), the
    # deeper ones store their activations.
    remat_max_ds: Optional[int] = None
    # In the checkpointed blocks: None recomputes the whole block; "names"
    # keeps the outputs tagged attn1_out, attn2_out, ff_out and
    # temporal_attn_out (models/attention.py) and recomputes the rest;
    # "dots" keeps the products without batch dimensions (ops/remat.py).
    remat_policy: Optional[str] = None

    def __post_init__(self):
        check_policy(self.remat_policy)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def tiny(self) -> "VideoUNetConfig":
        return dataclasses.replace(
            self, model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(1, 2), num_head_channels=16, context_dim=32,
            adm_in_channels=24, num_frames=4,
        )


class VideoUNet(nn.Module):
    """Call ``unet(x, t, context, y, cond_mask, num_frames)``:

    x ``(b*t, in_channels, h, w)``; t ``(b*t,)`` noise conditioning;
    context ``(b or b*t, 1, context_dim [+ 2432 with action_control])``; y ``(b or b*t, adm_in_channels)``;
    cond_mask ``(b*t,)`` 0/1 or None. Returns fp32 ``(b*t, out_channels, h, w)``.
    """

    def __init__(self, cfg: VideoUNetConfig):
        super().__init__()
        if tuple(cfg.video_kernel) != (3, 1, 1):
            raise NotImplementedError("only the (3, 1, 1) temporal kernel is ported")
        self.cfg = cfg
        ch0 = cfg.model_channels
        emb_ch = ch0 * 4
        self.time_embed = timestep_mlp(ch0, emb_ch)
        self.cond_time_stack_embed = timestep_mlp(ch0, emb_ch)
        self.label_emb = nn.Sequential(timestep_mlp(cfg.adm_in_channels, emb_ch))

        def res(cin, cout):
            return VideoResBlock(cin, emb_ch, cout, cfg.merge_factor, cfg.merge_strategy)

        def attn(ch):
            return SpatialVideoTransformer(
                ch, ch // cfg.num_head_channels, cfg.num_head_channels,
                cfg.transformer_depth, cfg.context_dim, cfg.merge_factor,
                cfg.merge_strategy, add_lora=cfg.add_lora,
                action_control=cfg.action_control)

        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([Conv2d(cfg.in_channels, ch0, 3, padding=1)])])
        ch, ds, skip_chs = ch0, 1, [ch0]
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, mult * ch0)]
                ch = mult * ch0
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                skip_chs.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                ds *= 2
                skip_chs.append(ch)

        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + skip_chs.pop(), mult * ch0)]
                ch = mult * ch0
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                if level != 0 and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 Conv2d(ch0, cfg.out_channels, 3, padding=1))

    def blocks(self):
        """The units that weight-sharded sampling gathers one at a time: the
        three embedding MLPs, every layer of the input, middle and output
        blocks, and the output head. Each parameter is in one of them."""
        yield from (self.time_embed, self.cond_time_stack_embed, self.label_emb)
        for layers in (*self.input_blocks, self.middle_block, *self.output_blocks):
            yield from layers
        yield self.out

    def _run(self, layers, h, emb, context, num_frames, ds):
        """One entry of the block lists, whose blocks run at downsample
        factor ``ds``."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled() and (
            cfg.remat_max_ds is None or ds <= cfg.remat_max_ds)
        for layer in layers:
            if isinstance(layer, (VideoResBlock, SpatialVideoTransformer)):
                extra = emb if isinstance(layer, VideoResBlock) else context
                if remat:
                    h = checkpointed(layer, h, extra, num_frames, policy=cfg.remat_policy)
                else:
                    h = layer(h, extra, num_frames)
            else:
                h = layer(h)
        return h

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None,
                cond_mask: Optional[torch.Tensor] = None,
                num_frames: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        dtype = cfg.compute_dtype
        nf = num_frames or cfg.num_frames
        bt = x.shape[0]
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)

        t_emb = timestep_embedding(t, cfg.model_channels).to(dtype)
        emb = self.time_embed(t_emb)
        if cond_mask is not None:
            m = cond_mask.to(dtype)[:, None]
            emb = self.cond_time_stack_embed(t_emb) * m + emb * (1.0 - m)
        if context is not None:
            if context.shape[0] != bt:
                context = context.repeat_interleave(nf, dim=0)
            context = context.to(dtype)
        if y is not None:
            if y.shape[0] != bt:
                y = y.repeat_interleave(nf, dim=0)
            emb = emb + self.label_emb(y.to(dtype))

        h, hs, ds = x, [], 1
        for layers in self.input_blocks:
            h = self._run(layers, h, emb, context, nf, ds)
            ds *= 2 if isinstance(layers[-1], Downsample) else 1
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context, nf, ds)
        for layers in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1).contiguous(memory_format=torch.channels_last)
            h = self._run(layers, h, emb, context, nf, ds)  # an Upsample runs last
            ds //= 2 if isinstance(layers[-1], Upsample) else 1
        return self.out(h).float()
