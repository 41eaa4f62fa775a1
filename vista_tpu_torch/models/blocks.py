"""UNet residual blocks and resampling layers (counterpart of
``vista_tpu/models/blocks.py``).

Images are ``(b*t, c, h, w)`` tensors held channels-last, so the
``(b*t, h*w, c)`` rows that the temporal kernels take are free views. The
VideoResBlock's temporal branch runs on kernel K4 twice: GN + SiLU + 3-tap
frame conv + emb, then GN + SiLU + conv with the residual and the
AlphaBlender collapsed into ``x + (1 - a) * h``.

Under ``height_parallel`` (``parallel/height.py``) every block takes this
rank's band of latent rows: the spatial convs read the neighbour bands'
rows, the GroupNorms sum over the bands, and the temporal branch, whose
convs are token-local, only sums its K4 statistics over them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from vista_tpu_torch.models.layers import AlphaBlender, Conv2d, GroupNorm32, from_rows, to_rows
from vista_tpu_torch.ops.temporal_conv import (fused_gn_silu_conv3_emb,
                                               fused_gn_silu_conv3_res, gn_affine)
from vista_tpu_torch.parallel.frames import frame_group
from vista_tpu_torch.parallel.height import band_conv, height_group
from vista_tpu_torch.parallel.mesh import frames_to_tokens, gather_frames, tokens_to_frames


class ResBlock(nn.Module):
    """GN-SiLU-conv, + time embedding, GN-SiLU-conv, skip (upstream keys
    ``in_layers.{0,2}``, ``emb_layers.1``, ``out_layers.{0,3}``,
    ``skip_connection``)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int):
        super().__init__()
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(),
            Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(0.0),
            Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = (Conv2d(channels, out_channels, 1)
                                if channels != out_channels else nn.Identity())

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class TemporalResBlock(nn.Module):
    """The VideoResBlock's ``time_stack``: two 3-tap frame convs on K4."""

    def __init__(self, channels: int, emb_channels: int):
        super().__init__()
        conv = lambda: nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(), conv())
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, channels))
        self.out_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(),
                                        nn.Dropout(0.0), conv())

    def forward(self, x: torch.Tensor, emb: torch.Tensor, num_frames: int,
                res_scale: torch.Tensor) -> torch.Tensor:
        """``x + res_scale * h`` where h is the temporal residual branch.
        Under :func:`~vista_tpu_torch.parallel.frames.frame_parallel` the
        branch runs on this rank's tokens of all frames (an all-to-all in
        and out), its GroupNorm statistics summed over the group."""
        _, _, hh, ww = x.shape
        xs = to_rows(x).contiguous()
        e = self.emb_layers(emb).float()
        group = frame_group()
        if group is not None:
            b = xs.shape[0] // num_frames
            xs = frames_to_tokens(xs, b, group, seq_major=False)
            e = gather_frames(e, b, group)
            num_frames *= dist.get_world_size(group)
        stats = group if group is not None else height_group()  # the ranks holding the tokens
        n1, c1 = self.in_layers[0], self.in_layers[2]
        sc, sh = gn_affine(xs, n1.weight, n1.bias, num_frames, n1.eps, stats)
        h = fused_gn_silu_conv3_emb(xs, sc, sh, c1.weight, c1.bias.float(), e,
                                    num_frames)
        n2, c2 = self.out_layers[0], self.out_layers[3]
        sc, sh = gn_affine(h, n2.weight, n2.bias, num_frames, n2.eps, stats)
        out = fused_gn_silu_conv3_res(h, sc, sh, c2.weight, c2.bias.float(), xs,
                                      res_scale, num_frames)
        if group is not None:
            out = tokens_to_frames(out, b, hh * ww, group, seq_major=False)
        return from_rows(out, hh, ww)


class VideoResBlock(ResBlock):
    """Spatial ResBlock + temporal ResBlock; the learned blend
    ``a*x + (1-a)*(x + h)`` is folded into the temporal block as
    ``x + (1-a)*h``."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 merge_factor: float = 0.5, merge_strategy: str = "learned_with_images"):
        super().__init__(channels, emb_channels, out_channels)
        self.time_stack = TemporalResBlock(out_channels, emb_channels)
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, num_frames: int) -> torch.Tensor:
        x = super().forward(x, emb)
        return self.time_stack(x, emb, num_frames, 1.0 - self.time_mixer.alpha())


class Upsample(nn.Module):
    """2x nearest upsample + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if height_group() is not None:
            return band_conv(self.conv, x, upsample=True)
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Downsample(nn.Module):
    """3x3 stride-2 conv with (1, 1) padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)
