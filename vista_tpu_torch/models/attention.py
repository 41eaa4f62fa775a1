"""Transformer blocks of the spatiotemporal UNet (counterpart of
``vista_tpu/models/attention.py``).

Token activations are ``(batch, tokens, c)`` rows, the layout of the ops.
Parameter names are the upstream torch keys (``attn1.to_q``, ``ff.net.0.proj``,
``time_stack.0.norm_in`` ...), so exported JAX weights and the released
checkpoint load with ``strict=True``.

- Self-attention: ``x + to_out(attn(to_qkv(LN(x))))`` as K2 (LN + q/k/v), K1
  (attention) and K3 (out-projection + bias + residual).
- Feed-forward: ``x + FF(LN(x))`` as K2 with the GEGLU epilogue, then K3.
- Cross-attention: Vista's context is one token per video, and softmax over
  one key is 1, so the output is ``to_out(to_v(ctx))`` for every query; it
  is computed once per context row and broadcast, and ``norm2`` (whose
  output nothing would read) is skipped. Contexts of several tokens are not
  ported.
- Temporal block: rows ``(b*s, t, c)``, one per spatial location, t = 25
  frames unpadded.
- Under ``height_parallel`` (``parallel/height.py``) a frame's tokens are
  this rank's band of its rows: the spatial self-attention gathers K and V
  over the bands, the rest is token-local.

With LoRA (``add_lora``, rank-16 ``up(down(x)) * scale`` adapters beside
q/k/v/out, ``up`` zero-initialised) the self-attentions leave K2 as the JAX
package does (``pre_ln_self_attention`` and ``_TemporalCore``): the
layer_norm kernel, q/k/v products plus their adapters (plain matmuls, XLA
in JAX), K1, then ``to_out`` plus its adapter plus the residual. With
action control the cross-attention context carries 19 * 128 action
features past ``context_dim``, added to v through ``v_adapter_action``
(zero-initialised); the k adapters are dead in the one-token fast path but
exist, as in the checkpoint.

Every path is differentiable. Without LoRA (the phase-1 recipe) the
self-attentions train through the kernels' own backward passes: K2 split's
(the port of ``_qkv_bwd_kernel``), K1's (``csrc/attention_bwd.cu``) and
K3's (``ops/linear.py``); the spatial out-projection, which the JAX package
leaves to XLA, runs on K3 forward and backward too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from vista_tpu_torch.models.layers import (AlphaBlender, GroupNorm32, from_rows,
                                           timestep_embedding, to_rows)
from vista_tpu_torch.ops.attention import attention_packed
from vista_tpu_torch.ops.fused_ff import fused_geglu_ff
from vista_tpu_torch.ops.fused_qkv import fused_ln_qkv
from vista_tpu_torch.ops.fused_temporal_attn import fused_temporal_self_attn
from vista_tpu_torch.ops.linear import linear_residual
from vista_tpu_torch.ops.norms import layer_norm
from vista_tpu_torch.parallel.frames import frame_group, frame_offset
from vista_tpu_torch.parallel.height import gather_keys, height_group, level_rows
from vista_tpu_torch.parallel.mesh import frames_to_tokens, tokens_to_frames

LONG_SEQ = 2048  # launch-count label only: "spatial-long" at s >= this
ACTION_CONTEXT_DIM = 128 * 19  # five action modalities of 128-d sinusoidal embeds


LORA_RANK, LORA_SCALE = 16, 1.0  # the JAX CrossAttention defaults, the shipped ones


def _add_lora(owner: nn.Module, name: str, in_dim: int, out_dim: int) -> None:
    """The adapter ``up(down(x)) * LORA_SCALE`` as the two Linears the
    checkpoint names ``{name}_down`` (normal, std 1 / rank) and ``{name}_up``
    (zero) on the owning attention."""
    down = nn.Linear(in_dim, LORA_RANK, bias=False)
    up = nn.Linear(LORA_RANK, out_dim, bias=False)
    with torch.no_grad():
        nn.init.normal_(down.weight, std=1.0 / LORA_RANK)
        nn.init.zeros_(up.weight)
    setattr(owner, f"{name}_down", down)
    setattr(owner, f"{name}_up", up)


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, add_lora: bool = False,
                 action_control: bool = False):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads = heads
        self.add_lora = add_lora
        self.action_control = action_control
        self.context_dim = context_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))
        if add_lora:
            for name, i, o in (("q_adapter", query_dim, inner), ("k_adapter", ctx_dim, inner),
                               ("v_adapter", ctx_dim, inner), ("out_adapter", inner, query_dim)):
                _add_lora(self, name, i, o)
        if action_control:
            self.k_adapter_action_control = nn.Linear(ACTION_CONTEXT_DIM, inner, bias=False)
            self.v_adapter_action_control = nn.Linear(ACTION_CONTEXT_DIM, inner, bias=False)
            with torch.no_grad():
                nn.init.zeros_(self.k_adapter_action_control.weight)
                nn.init.zeros_(self.v_adapter_action_control.weight)

    def _lora(self, name: str, x: torch.Tensor) -> torch.Tensor:
        up = getattr(self, f"{name}_up")
        return up(getattr(self, f"{name}_down")(x)) * LORA_SCALE

    def _proj(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, f"to_{name}")(x)
        return y + self._lora(f"{name}_adapter", x) if self.add_lora else y

    def self_attention(self, x: torch.Tensor, norm: nn.LayerNorm,
                       site: Optional[str] = None,
                       width: Optional[int] = None) -> torch.Tensor:
        """``x + to_out(attn(to_qkv(norm(x))))`` on ``(n, s, c)``. ``width``:
        the spatial blocks' frame width in tokens; under ``height_parallel``
        x is this rank's band of a frame's rows, and K and V are gathered
        over the bands (the queries stay local)."""
        gather = width is not None and height_group() is not None
        keys = level_rows(width) * width if gather else x.shape[1]
        site = site or ("spatial-long" if keys >= LONG_SEQ else "spatial-short")
        if self.add_lora:
            xn = layer_norm(x, norm.weight, norm.bias, norm.eps, site=site)
            q, k, v = (self._proj(p, xn) for p in ("q", "k", "v"))
        else:
            q, k, v = fused_ln_qkv(x, norm.weight, norm.bias, self.to_q.weight,
                                   self.to_k.weight, self.to_v.weight, norm.eps, bwd_site=site)
        if gather:
            k, v = gather_keys(k, v, width)
        o = attention_packed(q, k, v, self.heads, site=site)
        if self.add_lora:
            return x + self.to_out(o) + self._lora("out_adapter", o)
        out = self.to_out[0]
        return linear_residual(o, out.weight, out.bias.float(), x, site="attn-out")

    def cross(self, context: torch.Tensor) -> torch.Tensor:
        """The cross-attention term for a one-token context: softmax over one
        key is 1, so every query gets ``to_out(v(ctx))``. Returns
        ``(context rows, 1, c)``, to be broadcast by the caller."""
        if context is None or context.shape[1] != 1:
            raise NotImplementedError("only one-token contexts (Vista's) are ported")
        ctx = context
        if self.action_control:
            ctx, ctx_action = context[..., :self.context_dim], context[..., self.context_dim:]
        v = self._proj("v", ctx)
        if self.action_control:
            v = v + self.v_adapter_action_control(ctx_action)
        y = self.to_out(v)
        return y + self._lora("out_adapter", v) if self.add_lora else y


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward, upstream keys ``net.0.proj`` and ``net.2``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                 nn.Linear(dim * mult, dim))

    def residual(self, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        """``x + FF(norm(x))``."""
        p_in, p_out = self.net[0].proj, self.net[2]
        return fused_geglu_ff(x, norm.weight, norm.bias, p_in.weight, p_in.bias,
                              p_out.weight, p_out.bias, norm.eps)


class TransformerBlock(nn.Module):
    """Spatial block: pre-LN self-attn -> cross-attn(context) -> GEGLU FF."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int],
                 add_lora: bool = False, action_control: bool = False):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head, add_lora=add_lora)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, add_lora=add_lora,
                                    action_control=action_control)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
                width: Optional[int] = None) -> torch.Tensor:
        """x ``(n, s, c)``, s tokens of frames ``width`` tokens wide."""
        x = self.attn1.self_attention(x, self.norm1, width=width)
        x = x + self.attn2.cross(context)
        return self.ff.residual(x, self.norm3)


class TemporalTransformerBlock(nn.Module):
    """Attention over the frame axis (upstream VideoTransformerBlock with
    ``ff_in`` and the spatial context): ``(b*t, s, c)`` is viewed as
    ``(b*s, t, c)`` so that every location attends over its frames."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int],
                 add_lora: bool = False, action_control: bool = False):
        super().__init__()
        self.heads = heads
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.attn1 = CrossAttention(dim, heads, dim_head, add_lora=add_lora)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, add_lora=add_lora,
                                    action_control=action_control)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, num_frames: int,
                time_context: Optional[torch.Tensor]) -> torch.Tensor:
        """Under :func:`~vista_tpu_torch.parallel.frames.frame_parallel` the
        rank's frames become its tokens' sequences of all frames (an
        all-to-all) and come back after the block."""
        bt, s, c = x.shape
        b = bt // num_frames
        group = frame_group()
        if group is None:
            x = x.reshape(b, num_frames, s, c).transpose(1, 2).reshape(b * s, num_frames, c)
            x = self._sequences(x, b, num_frames, time_context)
            return x.reshape(b, s, num_frames, c).transpose(1, 2).reshape(bt, s, c)
        x = frames_to_tokens(x, b, group, seq_major=True)
        x = self._sequences(x, b, num_frames * dist.get_world_size(group), time_context)
        return tokens_to_frames(x, b, s, group, seq_major=True)

    def _sequences(self, x: torch.Tensor, b: int, num_frames: int,
                   time_context: Optional[torch.Tensor]) -> torch.Tensor:
        """The block on ``(b * s, t, c)`` sequences, one per location."""
        s, c = x.shape[0] // b, x.shape[2]
        x = self.ff_in.residual(x, self.norm_in)
        a = self.attn1
        if a.add_lora:
            x = a.self_attention(x, self.norm1, site="temporal")
        else:
            x = fused_temporal_self_attn(
                x, self.norm1.weight, self.norm1.bias, a.to_q.weight, a.to_k.weight,
                a.to_v.weight, a.to_out[0].weight, a.to_out[0].bias, self.heads,
                self.norm1.eps)
        y = self.attn2.cross(time_context).reshape(b, 1, 1, c)  # per video
        x = (x.reshape(b, s, num_frames, c) + y).reshape(b * s, num_frames, c)
        return self.ff.residual(x, self.norm3)


class SpatialVideoTransformer(nn.Module):
    """Spatial + temporal transformer pair merged by a learned AlphaBlender;
    ``(b*t, c, h, w)`` in and out. The temporal cross-attention context is the
    first frame's context of each video."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, merge_factor: float = 0.5,
                 merge_strategy: str = "learned_with_images",
                 max_time_embed_period: int = 10000, add_lora: bool = False,
                 action_control: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.channels = channels
        self.max_time_embed_period = max_time_embed_period
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        adapters = dict(add_lora=add_lora, action_control=action_control)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(inner, heads, dim_head, context_dim, **adapters)
            for _ in range(depth))
        self.time_stack = nn.ModuleList(
            TemporalTransformerBlock(inner, heads, dim_head, context_dim, **adapters)
            for _ in range(depth))
        self.time_pos_embed = nn.Sequential(
            nn.Linear(channels, channels * 4), nn.SiLU(), nn.Linear(channels * 4, inner))
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy)
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor],
                num_frames: int) -> torch.Tensor:
        bt, c, h, w = x.shape
        time_context = None
        if context is not None:
            time_context = context.reshape(bt // num_frames, num_frames,
                                           *context.shape[1:])[:, 0]
        xs = self.proj_in(to_rows(self.norm(x)))
        first = frame_offset(num_frames) or 0  # frame parallelism: this rank's first frame
        frame_idx = torch.arange(first, first + num_frames, device=x.device).repeat(
            bt // num_frames)
        t_emb = timestep_embedding(frame_idx, self.channels, self.max_time_embed_period)
        pos = self.time_pos_embed(t_emb.to(xs.dtype))[:, None]
        for block, time_block in zip(self.transformer_blocks, self.time_stack):
            xs = block(xs, context, w)
            x_mix = time_block(xs + pos, num_frames, time_context)
            xs = self.time_mixer(xs, x_mix)
        return from_rows(self.proj_out(xs), h, w) + x
