"""The spatiotemporal VideoUNet of Vista (Stable Video Diffusion's UNet with
Vista's action-control adapters) in plain fp32 PyTorch, written from the
upstream equations.

Parameter names are the upstream keys, the ones the system under test
uses, so one seeded state dict fills both. Images are ``(b*t, c, h, w)``;
the temporal layers view them as ``(b, c, t, h, w)`` videos.

The cross-attention's context is one token per video (the CLIP image
embedding with the action features behind it). Softmax over one key is
exactly 1, so its output is ``to_out(v)`` at every query; ``to_q``,
``to_k`` and ``norm2`` reach nothing, as upstream with a one-token context.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from benchmark.reference.nn import (Conv2d, Conv3d, GroupNorm32, Linear, attention, mlp,
                                    timestep_embedding)

ACTION_CONTEXT_DIM = 128 * 19  # five action modalities of 128-d sinusoidal embeddings


def _video(x, t):
    bt, c, h, w = x.shape
    return x.reshape(bt // t, t, c, h, w).transpose(1, 2)


def _frames(x):
    b, c, t, h, w = x.shape
    return x.transpose(1, 2).reshape(b * t, c, h, w)


def _rows(x):
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, c)


class AlphaBlender(nn.Module):
    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.tensor([0.5]))

    def alpha(self):
        return torch.sigmoid(self.mix_factor)


class ResBlock(nn.Module):
    def __init__(self, cin: int, emb: int, cout: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(cin), nn.SiLU(), Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb, cout))
        self.out_layers = nn.Sequential(GroupNorm32(cout), nn.SiLU(), nn.Dropout(0.0),
                                        Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = Conv2d(cin, cout, 1) if cin != cout else nn.Identity()

    def forward(self, x, emb):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class TemporalResBlock(nn.Module):
    """GN - SiLU - 3-tap frame conv (+ the time embedding), GN - SiLU - conv."""

    def __init__(self, c: int, emb: int):
        super().__init__()
        conv = lambda: Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0))
        self.in_layers = nn.Sequential(GroupNorm32(c), nn.SiLU(), conv())
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb, c))
        self.out_layers = nn.Sequential(GroupNorm32(c), nn.SiLU(), nn.Dropout(0.0), conv())

    def forward(self, x5, emb, t):
        e = self.emb_layers(emb)
        e = e.reshape(-1, t, e.shape[1]).transpose(1, 2)[..., None, None]
        return self.out_layers(self.in_layers(x5) + e)


class VideoResBlock(ResBlock):
    """``x = ResBlock(x)``, then ``a x + (1 - a) (x + temporal(x))``."""

    def __init__(self, cin: int, emb: int, cout: int):
        super().__init__(cin, emb, cout)
        self.time_stack = TemporalResBlock(cout, emb)
        self.time_mixer = AlphaBlender()

    def forward(self, x, emb, t):
        x = super().forward(x, emb)
        x5 = _video(x, t)
        a = self.time_mixer.alpha()
        return _frames(a * x5 + (1.0 - a) * (x5 + self.time_stack(x5, emb, t)))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None,
                 action_control: bool = False):
        super().__init__()
        inner = heads * dim_head
        ctx = context_dim or dim
        self.heads, self.context_dim, self.action_control = heads, context_dim, action_control
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(ctx, inner, bias=False)
        self.to_v = Linear(ctx, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), nn.Dropout(0.0))
        if action_control:
            self.k_adapter_action_control = Linear(ACTION_CONTEXT_DIM, inner, bias=False)
            self.v_adapter_action_control = Linear(ACTION_CONTEXT_DIM, inner, bias=False)

    def self_attention(self, xn):
        return self.to_out(attention(self.to_q(xn), self.to_k(xn), self.to_v(xn), self.heads))

    def one_token(self, context):
        """``(rows, 1, c)``: the output at every query of a one-token context."""
        ctx = context
        if self.action_control:
            ctx, action = context[..., :self.context_dim], context[..., self.context_dim:]
        v = self.to_v(ctx)
        if self.action_control:
            v = v + self.v_adapter_action_control(action)
        return self.to_out(v)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0), Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim, action_control):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, action_control)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))

    def forward(self, x, context):
        x = x + self.attn1.self_attention(self.norm1(x))
        x = x + self.attn2.one_token(context)
        return x + self.ff(self.norm3(x))


class TemporalTransformerBlock(nn.Module):
    """Attention over the frames at every location, with ``ff_in``."""

    def __init__(self, dim, heads, dim_head, context_dim, action_control):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, action_control)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))
        self.ff = FeedForward(dim)

    def forward(self, x, t, time_context):
        bt, s, c = x.shape
        b = bt // t
        x = x.reshape(b, t, s, c).transpose(1, 2).reshape(b * s, t, c)
        x = x + self.ff_in(self.norm_in(x))
        x = x + self.attn1.self_attention(self.norm1(x))
        x = (x.reshape(b, s, t, c) + self.attn2.one_token(time_context)[:, None]).reshape(b * s, t, c)
        x = x + self.ff(self.norm3(x))
        return x.reshape(b, s, t, c).transpose(1, 2).reshape(bt, s, c)


class SpatialVideoTransformer(nn.Module):
    def __init__(self, ch, heads, dim_head, context_dim, action_control):
        super().__init__()
        inner = heads * dim_head
        self.channels = ch
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.proj_in = Linear(ch, inner)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(inner, heads, dim_head, context_dim, action_control)])
        self.time_stack = nn.ModuleList(
            [TemporalTransformerBlock(inner, heads, dim_head, context_dim, action_control)])
        self.time_pos_embed = nn.Sequential(Linear(ch, ch * 4), nn.SiLU(), Linear(ch * 4, inner))
        self.time_mixer = AlphaBlender()
        self.proj_out = Linear(inner, ch)

    def forward(self, x, context, t):
        bt, c, h, w = x.shape
        time_context = context.reshape(bt // t, t, *context.shape[1:])[:, 0]
        xs = self.proj_in(_rows(self.norm(x)))
        frame = torch.arange(t, device=x.device).repeat(bt // t)
        pos = self.time_pos_embed(timestep_embedding(frame, self.channels))[:, None]
        a = self.time_mixer.alpha()
        for block, time_block in zip(self.transformer_blocks, self.time_stack):
            xs = block(xs, context)
            xs = a * xs + (1.0 - a) * time_block(xs + pos, t, time_context)
        out = self.proj_out(xs).reshape(bt, h, w, c).permute(0, 3, 1, 2)
        return out + x


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VideoUNet(nn.Module):
    """``unet(x, t, context, y, cond_mask, num_frames)`` -> ``(b*t, out, h, w)``.

    ``cfg``: the configuration file's ``unet`` entry. With ``checkpoint``
    every residual and transformer block is recomputed in the backward
    (the activations of a full-width step would not fit in fp32)."""

    def __init__(self, cfg: dict, checkpoint: bool = False):
        super().__init__()
        self.cfg, self.checkpoint = cfg, checkpoint
        ch0, mults = cfg["model_channels"], cfg["channel_mult"]
        emb = ch0 * 4
        dh = cfg["num_head_channels"]
        self.time_embed = mlp(ch0, emb)
        self.cond_time_stack_embed = mlp(ch0, emb)
        self.label_emb = nn.Sequential(mlp(cfg["adm_in_channels"], emb))
        res = lambda cin, cout: VideoResBlock(cin, emb, cout)
        attn = lambda ch: SpatialVideoTransformer(ch, ch // dh, dh, cfg["context_dim"],
                                                  cfg["action_control"])
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(cfg["in_channels"], ch0, 3,
                                                                 padding=1)])])
        ch, ds, skips = ch0, 1, [ch0]
        for level, mult in enumerate(mults):
            for _ in range(cfg["num_res_blocks"]):
                layers = [res(ch, mult * ch0)]
                ch = mult * ch0
                if ds in cfg["attention_resolutions"]:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                skips.append(ch)
            if level != len(mults) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                ds *= 2
                skips.append(ch)
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(mults))):
            for i in range(cfg["num_res_blocks"] + 1):
                layers = [res(ch + skips.pop(), mult * ch0)]
                ch = mult * ch0
                if ds in cfg["attention_resolutions"]:
                    layers.append(attn(ch))
                if level != 0 and i == cfg["num_res_blocks"]:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 Conv2d(ch0, cfg["out_channels"], 3, padding=1))

    def _run(self, layers, h, emb, context, t):
        for layer in layers:
            if isinstance(layer, (VideoResBlock, SpatialVideoTransformer)):
                extra = emb if isinstance(layer, VideoResBlock) else context
                if self.checkpoint and torch.is_grad_enabled():
                    h = torch.utils.checkpoint.checkpoint(layer, h, extra, t, use_reentrant=False)
                else:
                    h = layer(h, extra, t)
            else:
                h = layer(h)
        return h

    def forward(self, x, timesteps, context, y, cond_mask, num_frames):
        bt, t = x.shape[0], num_frames
        t_emb = timestep_embedding(timesteps, self.cfg["model_channels"])
        emb = self.time_embed(t_emb)
        if cond_mask is not None:
            m = cond_mask.float()[:, None]
            emb = self.cond_time_stack_embed(t_emb) * m + emb * (1.0 - m)
        if context.shape[0] != bt:
            context = context.repeat_interleave(t, dim=0)
        if y.shape[0] != bt:
            y = y.repeat_interleave(t, dim=0)
        emb = emb + self.label_emb(y)
        h, hs = x, []
        for layers in self.input_blocks:
            h = self._run(layers, h, emb, context, t)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context, t)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=1), emb, context, t)
        return self.out(h)
