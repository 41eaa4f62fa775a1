"""Operations, exp2 and bytes of the work, counted from shapes.

Two counts, both from a configuration file's sizes and never from a run:

- **Model FLOPs** of a request or an optimizer step: the products of the
  matrix multiplications, convolutions and attention of the CLIP tower, the
  VAE encoder, the UNet and the video decoder, two FLOPs a multiply-add.
  Training counts the UNet's forward and backward as three forwards and the
  frozen first stage and conditioner once. Recomputation and whatever else
  an implementation adds are not counted, so the count is the same whatever
  implements the step.
- **Kernel launches** of one UNet forward (and the backward launches of the
  kernels whose every launch is counted here), each with its call site as
  the system names it, its products, its exp2 on the special-function
  units and its bytes: each input read once and each output written once,
  in bf16, the scale and shift of a GroupNorm in fp32. A launch's bound is
  the least time the card could take (:func:`bound`).

The peaks are an H100 SXM's, NVIDIA's data sheet, dense, without sparsity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

PEAK_FLOPS = 989e12   # bf16 tensor-core operations per second
PEAK_BYTES = 3.35e12  # HBM3 bytes per second
# exp2 per second on the special-function units (FlashAttention-3, section 3)
PEAK_EXP2 = 3.9e12
LONG_KEYS = 2048      # the system's site name: "spatial-long" from this many keys
BF16 = 2


def bound(flops: float, nbytes: float, exp2: float = 0.0) -> float:
    """Seconds: the larger of the products, the exp2 and the bytes at peak."""
    return max(flops / PEAK_FLOPS, exp2 / PEAK_EXP2, nbytes / PEAK_BYTES)


@dataclass(frozen=True)
class Launch:
    kernel: str   # the system's launch-count name
    site: str     # its call site
    flops: float
    nbytes: float
    exp2: float = 0.0

    @property
    def seconds(self) -> float:
        return bound(self.flops, self.nbytes, self.exp2)


# ------------------------------------------------------------ per kernel

def attention(b: int, s: int, c: int, site: str) -> Launch:
    """K1 on ``b`` sequences of ``s`` tokens, ``c = heads * 64``: QKᵀ and PV,
    one exp2 a score; q, k, v read, o written."""
    return Launch("attention", site, 4 * b * s * s * c, 4 * BF16 * b * s * c, b * (c // 64) * s * s)


def attention_bwd(b: int, s: int, c: int, site: str) -> Launch:
    """attention_bwd: five products (S again, dV, dP, dQ, dK), one exp2 a
    score; q, k, v, o, dO read, dq, dk, dv written."""
    return Launch("attention_bwd", site, 10 * b * s * s * c, 8 * BF16 * b * s * c,
                  b * (c // 64) * s * s)


def ln_qkv(m: int, c: int, site: str) -> Launch:
    """K2 split: LayerNorm then the q, k, v products of ``m`` rows."""
    return Launch("ln_linear", site, 2 * m * c * 3 * c, BF16 * (m * c + 3 * c * c + 3 * m * c))


def ln_geglu(m: int, c: int) -> Launch:
    """K2 GEGLU: LayerNorm, the (c, 8c) product and the gate, 4c out."""
    return Launch("ln_linear", "ff", 2 * m * c * 8 * c, BF16 * (m * c + 8 * c * c + 4 * m * c))


def ff_out(m: int, c: int) -> Launch:
    """K3 at the feed-forward's output: (4c, c) product, bias, residual."""
    return Launch("linear_residual", "ff", 2 * m * 4 * c * c,
                  BF16 * (4 * m * c + 4 * c * c + 2 * m * c))


def proj_out(m: int, c: int, site: str) -> Launch:
    """K3 at an attention's out-projection: (c, c) product, bias, residual."""
    return Launch("linear_residual", site, 2 * m * c * c, BF16 * (3 * m * c + c * c))


def gn_silu(bt: int, s: int, c: int, site: str) -> Launch:
    """K4's pre-pass: SiLU(x scale + shift) per (frame, channel)."""
    m = bt * s
    return Launch("gn_silu", site, 0, BF16 * 2 * m * c + 2 * 4 * bt * c, m * c)


def conv3(bt: int, s: int, c: int, site: str, kernel: str = "gn_silu_conv3") -> Launch:
    """A 3-tap frame conv, (c, c) per tap: K4's conv (``emb``: x in, y out;
    ``res``: x and the residual in) or ``conv3`` in the backward."""
    m = bt * s
    reads = 3 if site == "res" else 2
    return Launch(kernel, site, 6 * m * c * c, BF16 * (reads * m * c + 3 * c * c))


# ------------------------------------------------------------ the UNet

def _levels(u: dict, h: int, w: int):
    """``(ds, channels, tokens)`` of the blocks in call order: ``("res", cin,
    cout, ds)``, ``("attn", c, ds)``, ``("down", c, ds)``, ``("up", c, ds)``."""
    ch0, mults = u["model_channels"], u["channel_mult"]
    blocks, ch, ds, skips = [("conv_in", u["in_channels"], ch0, 1)], ch0, 1, [ch0]
    for level, mult in enumerate(mults):
        for _ in range(u["num_res_blocks"]):
            blocks.append(("res", ch, mult * ch0, ds))
            ch = mult * ch0
            if ds in u["attention_resolutions"]:
                blocks.append(("attn", ch, ch, ds))
            skips.append(ch)
        if level != len(mults) - 1:
            blocks.append(("down", ch, ch, ds))
            ds *= 2
            skips.append(ch)
    blocks += [("res", ch, ch, ds), ("attn", ch, ch, ds), ("res", ch, ch, ds)]
    for level, mult in reversed(list(enumerate(mults))):
        for i in range(u["num_res_blocks"] + 1):
            blocks.append(("res", ch + skips.pop(), mult * ch0, ds))
            ch = mult * ch0
            if ds in u["attention_resolutions"]:
                blocks.append(("attn", ch, ch, ds))
            if level != 0 and i == u["num_res_blocks"]:
                blocks.append(("up", ch, ch, ds))
                ds //= 2
    blocks.append(("conv_out", ch0, u["out_channels"], 1))
    return [(kind, cin, cout, ds, (h // ds) * (w // ds)) for kind, cin, cout, ds in blocks]


def unet_launches(u: dict, videos: int, t: int, h: int, w: int) -> List[Launch]:
    """The kernel launches of one UNet forward on ``videos`` videos of ``t``
    frames of ``h x w`` latents."""
    n = videos * t
    out = []
    for kind, _, c, _, s in _levels(u, h, w):
        m = n * s
        if kind == "res":
            out += [gn_silu(n, s, c, "emb"), conv3(n, s, c, "emb"),
                    gn_silu(n, s, c, "res"), conv3(n, s, c, "res")]
        elif kind == "attn":
            site = "spatial-long" if s >= LONG_KEYS else "spatial-short"
            out += [ln_qkv(m, c, "qkv"), attention(n, s, c, site), proj_out(m, c, "attn-out"),
                    ln_geglu(m, c), ff_out(m, c),
                    ln_geglu(m, c), ff_out(m, c),  # the temporal block's ff_in
                    ln_qkv(m, c, "temporal-qkv"), attention(videos * s, t, c, "temporal"),
                    proj_out(m, c, "temporal-out"),
                    ln_geglu(m, c), ff_out(m, c)]
    return out


def unet_backward_launches(u: dict, videos: int, t: int, h: int, w: int) -> List[Launch]:
    """The launches of one UNet backward of the kernels counted whole here:
    attention_bwd at every attention and ``conv3`` (dx of both of K4's
    convs and the residual branch's output again)."""
    n = videos * t
    out = []
    for kind, _, c, _, s in _levels(u, h, w):
        if kind == "res":
            out += [conv3(n, s, c, site, "conv3") for site in ("emb-dx", "res-dx", "res-y")]
        elif kind == "attn":
            site = "spatial-long" if s >= LONG_KEYS else "spatial-short"
            out += [attention_bwd(n, s, c, site), attention_bwd(videos * s, t, c, "temporal")]
    return out


def unet_flops(u: dict, videos: int, t: int, h: int, w: int) -> float:
    """Model FLOPs of one UNet forward (one-token context)."""
    n = videos * t
    ch0 = u["model_channels"]
    emb = 4 * ch0
    ctx = u["context_dim"] + (128 * 19 if u["action_control"] else 0)
    f = 2 * n * (2 * (ch0 * emb + emb * emb) + u["adm_in_channels"] * emb + emb * emb)
    for kind, cin, c, _, s in _levels(u, h, w):
        if kind == "conv_in" or kind == "conv_out":
            f += 2 * n * s * cin * c * 9
        elif kind == "res":
            f += 2 * n * s * 9 * (cin * c + c * c) + 2 * n * 2 * emb * c
            f += 2 * n * s * c * (cin if cin != c else 0)
            f += 2 * n * s * 2 * 3 * c * c  # two 3-tap frame convs
        elif kind == "attn":
            cross = 2 * (ctx * c + c * c)  # v (and the action adapter) and out, per context row
            f += 2 * n * s * 2 * c * c + 2 * n * (c * 4 * c + 4 * c * c)  # proj in/out, pos
            f += 2 * n * s * 4 * c * c + 4 * n * s * s * c + n * cross  # spatial attention
            f += 3 * 2 * n * s * 12 * c * c  # three feed-forwards
            f += 2 * n * s * 4 * c * c + 4 * n * s * t * c + videos * cross  # temporal attention
        elif kind == "down":
            f += 2 * n * (s // 4) * 9 * c * c
        elif kind == "up":
            f += 2 * n * (4 * s) * 9 * c * c
    return f


# ------------------------------------------------------------ first stage

def clip_flops(c: dict, images: int) -> float:
    g = c["image_size"] // c["patch_size"]
    s, w = g * g + 1, c["width"]
    f = 2 * g * g * 3 * c["patch_size"] ** 2 * w + 2 * w * c["output_dim"]
    f += c["layers"] * (2 * s * w * 3 * w + 4 * s * s * w + 2 * s * w * w + 2 * 2 * s * w * 4 * w)
    return images * f


def _res(cin, cout, pixels):
    return 2 * pixels * 9 * (cin * cout + cout * cout) + (2 * pixels * cin * cout if cin != cout else 0)


def encoder_flops(v: dict, frames: int, hh: int, ww: int) -> float:
    ch, mults = v["ch"], v["ch_mult"]
    px = hh * ww
    f = 2 * px * 9 * v["in_channels"] * ch
    cin = ch
    for level, mult in enumerate(mults):
        for _ in range(v["num_res_blocks"]):
            f += _res(cin, ch * mult, px)
            cin = ch * mult
        if level != len(mults) - 1:
            px //= 4
            f += 2 * px * 9 * cin * cin
    f += 2 * _res(cin, cin, px) + 2 * px * 4 * cin * cin + 4 * px * px * cin  # mid, attention
    zc = 2 * v["z_channels"] if v["double_z"] else v["z_channels"]
    return frames * (f + 2 * px * 9 * cin * zc)


def decoder_flops(v: dict, frames: int, h: int, w: int) -> float:
    """The video decoder on one window of ``frames`` latents of ``h x w``."""
    ch, mults = v["ch"], v["ch_mult"]
    px = h * w
    cin = ch * mults[-1]
    vres = lambda a, b, p: _res(a, b, p) + 2 * p * 2 * 3 * b * b  # + two 3-tap frame convs
    f = 2 * px * 9 * v["z_channels"] * cin
    f += 2 * vres(cin, cin, px) + 2 * px * 4 * cin * cin + 4 * px * px * cin
    for level in reversed(range(len(mults))):
        cout = ch * mults[level]
        for _ in range(v["num_res_blocks"] + 1):
            f += vres(cin, cout, px)
            cin = cout
        if level != 0:
            px *= 4
            f += 2 * px * 9 * cin * cin
    out = v["out_channels"]
    return frames * (f + 2 * px * 9 * cin * out + 2 * px * 3 * out * out)


def decode_windows(n: int, chunk: int, overlap: int) -> List[int]:
    """The window sizes the engine decodes ``n`` latents in."""
    if n <= chunk:
        return [n]
    step = chunk - overlap
    return [overlap + len(range(start, min(start + step, n))) for start in range(overlap, n, step)]


def downsample(cfg: dict) -> int:
    """Pixels a latent spans along each side."""
    return 2 ** (len(cfg["engine"]["vae"]["ch_mult"]) - 1)


def conditioner_flops(cfg: dict, h: int, w: int, encode: bool) -> float:
    """One call of the conditioner on one video's first frame."""
    e = cfg["engine"]
    f = clip_flops(e["conditioner"]["clip"], 1)
    if encode:
        v = e["vae"]
        zc = 2 * v["z_channels"]
        d = downsample(cfg)
        f += encoder_flops(v, 1, h, w) + 2 * (h // d) * (w // d) * zc * zc
    return f


def request_flops(cfg: dict, traffic: dict) -> float:
    """Model FLOPs of one rollout request."""
    e = cfg["engine"]
    t, hh, ww = e["num_frames"], cfg["height"], cfg["width"]
    h, w = hh // downsample(cfg), ww // downsample(cfg)
    f = encoder_flops(e["vae"], t, hh, ww)
    for r in range(traffic["rounds"]):
        f += 2 * conditioner_flops(cfg, hh, ww, encode=r == 0)
        f += traffic["steps"] * unet_flops(e["unet"], 2, t, h, w)
        f += sum(decoder_flops(e["vae"], n, h, w)
                 for n in decode_windows(t, e["decode_chunk"], e["decode_overlap"]))
    return f


def train_step_flops(cfg: dict) -> float:
    """Model FLOPs of one optimizer step."""
    e, tr = cfg["engine"], cfg["train"]
    t, hh, ww = e["num_frames"], cfg["height"], cfg["width"]
    b = tr["batch_size"]
    micro = (encoder_flops(e["vae"], b * t, hh, ww) + b * conditioner_flops(cfg, hh, ww, True)
             + 3 * unet_flops(e["unet"], b, t, hh // downsample(cfg), ww // downsample(cfg)))
    return tr["accum_steps"] * micro
