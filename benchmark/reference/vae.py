"""The first stage of Vista (the SVD temporal VAE: the image encoder and the
video decoder with frame convs and learned temporal blends) in plain fp32
PyTorch: a frozen copy of the system's model code with its dtype casts and
layout choices taken out, every product through the reference's
primitives. ``cfg`` is the configuration file's ``vae`` entry."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.nn import Conv2d, Conv3d, GroupNorm32, attention


def _video(x: torch.Tensor, num_frames: int) -> torch.Tensor:
    """``(b*t, c, h, w)`` -> ``(b, c, t, h, w)`` view."""
    bt, c, h, w = x.shape
    return x.reshape(bt // num_frames, num_frames, c, h, w).transpose(1, 2)


def _frames(x: torch.Tensor) -> torch.Tensor:
    """``(b, c, t, h, w)`` -> ``(b*t, c, h, w)``."""
    b, c, t, h, w = x.shape
    return x.transpose(1, 2).reshape(b * t, c, h, w)


def _frame_conv(channels: int) -> nn.Conv3d:
    return Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))


class VAEResnetBlock(nn.Module):
    """GN(eps 1e-6) - SiLU - conv - GN - SiLU - conv, 1x1-conv shortcut."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.nin_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class _TimeStack(nn.Module):
    """GN - SiLU - frame conv - GN - SiLU - frame conv over a whole video
    (upstream ResBlock with ``skip_t_emb``: keys ``in_layers.{0,2}``,
    ``out_layers.{0,3}``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(),
                                       _frame_conv(channels))
        self.out_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(),
                                        nn.Dropout(0.0), _frame_conv(channels))

    def forward(self, x5: torch.Tensor) -> torch.Tensor:
        return self.out_layers(self.in_layers(x5))


class VideoResnetBlock(VAEResnetBlock):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch)
        self.time_stack = _TimeStack(out_ch)
        self.mix_factor = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        x_v = _video(super().forward(x), num_frames)
        x_t = x_v + self.time_stack(x_v)
        alpha = torch.sigmoid(self.mix_factor)
        return _frames(alpha * x_t + (1.0 - alpha) * x_v)


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over the spatial tokens, per frame."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (Conv2d(channels, channels, 1)
                                                 for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x)
        rows = lambda t: t.permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = rows(self.q(y)), rows(self.k(y)), rows(self.v(y))
        out = attention(q, k, v, 1).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + self.proj_out(out)


def make_attn(attn_type: str, channels: int) -> nn.Module:
    """The mid-block attention of ``attn_type`` (``"vanilla"`` and
    ``"vanilla-xformers"`` are one block)."""
    if attn_type in ("vanilla", "vanilla-xformers"):
        return VAEAttnBlock(channels)
    raise ValueError(f"attn_type `{attn_type}` unknown")


class VAEDownsample(nn.Module):
    """Stride-2 3x3 conv with (right, bottom) padding of one."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class AE3DConv(Conv2d):
    """The output conv: a 2-D conv, then a 3-D ``time_mix_conv`` over frames."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 3, padding=1)
        self.time_mix_conv = _frame_conv(out_ch)

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        h = super().forward(x)
        return _frames(self.time_mix_conv(_video(h, num_frames)))


class _Level(nn.Module):
    pass


class VideoVAEDecoder(nn.Module):
    """``decoder(z, num_frames)``: z ``(b*t, z, h, w)`` -> pixels."""

    def __init__(self, cfg: dict):
        super().__init__()
        if tuple(cfg["video_kernel"]) != (3, 1, 1):
            raise NotImplementedError("only the (3, 1, 1) temporal kernel is supported")
        block_in = cfg["ch"] * cfg["ch_mult"][-1]
        self.conv_in = Conv2d(cfg["z_channels"], block_in, 3, padding=1)
        self.mid = _Level()
        self.mid.block_1 = VideoResnetBlock(block_in, block_in)
        self.mid.attn_1 = make_attn(cfg["attn_type"], block_in)
        self.mid.block_2 = VideoResnetBlock(block_in, block_in)
        levels = []
        in_ch = block_in
        for level in reversed(range(len(cfg["ch_mult"]))):
            out_ch = cfg["ch"] * cfg["ch_mult"][level]
            up = _Level()
            up.block = nn.ModuleList()
            for _ in range(cfg["num_res_blocks"] + 1):
                up.block.append(VideoResnetBlock(in_ch, out_ch))
                in_ch = out_ch
            if level != 0:
                up.upsample = VAEUpsample(in_ch)
            levels.insert(0, up)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(in_ch, eps=1e-6)
        self.conv_out = AE3DConv(in_ch, cfg["out_channels"])

    def forward(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid.block_1(h, num_frames)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h, num_frames)
        for level in reversed(range(len(self.up))):
            for block in self.up[level].block:
                h = block(h, num_frames)
            if level != 0:
                h = self.up[level].upsample(h)
        h = F.silu(self.norm_out(h))
        return self.conv_out(h, num_frames)


class VAEEncoder(nn.Module):
    """``encoder(x)``: pixels ``(n, 3, H, W)`` -> moments ``(n, 2z, h, w)``
    (upstream keys ``conv_in``, ``down.{l}.block.{i}``, ``down.{l}.downsample``,
    ``mid.{block_1,attn_1,block_2}``, ``norm_out``, ``conv_out``)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.conv_in = Conv2d(cfg["in_channels"], cfg["ch"], 3, padding=1)
        levels, in_ch = [], cfg["ch"]
        for level, mult in enumerate(cfg["ch_mult"]):
            down = _Level()
            down.block = nn.ModuleList()
            for _ in range(cfg["num_res_blocks"]):
                down.block.append(VAEResnetBlock(in_ch, cfg["ch"] * mult))
                in_ch = cfg["ch"] * mult
            if level != len(cfg["ch_mult"]) - 1:
                down.downsample = VAEDownsample(in_ch)
            levels.append(down)
        self.down = nn.ModuleList(levels)
        self.mid = _Level()
        self.mid.block_1 = VAEResnetBlock(in_ch, in_ch)
        self.mid.attn_1 = make_attn(cfg["attn_type"], in_ch)
        self.mid.block_2 = VAEResnetBlock(in_ch, in_ch)
        self.norm_out = GroupNorm32(in_ch, eps=1e-6)
        out_ch = 2 * cfg["z_channels"] if cfg["double_z"] else cfg["z_channels"]
        self.conv_out = Conv2d(in_ch, out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


def gaussian_split(moments: torch.Tensor):
    """``(n, 2z, h, w)`` -> mean, log-variance clipped to [-30, 20]."""
    mean, logvar = moments.chunk(2, dim=1)
    return mean, logvar.clamp(-30.0, 20.0)


def gaussian_sample(moments: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """A posterior sample with the standard-normal ``noise`` of mean's shape."""
    mean, logvar = gaussian_split(moments)
    return mean + torch.exp(0.5 * logvar) * noise


def gaussian_mode(moments: torch.Tensor) -> torch.Tensor:
    return gaussian_split(moments)[0]
