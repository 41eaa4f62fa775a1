"""The counts of ``benchmark/counts.py`` against PyTorch's FLOP counter on
the system's plain path, and the per-launch counts against the expressions
of ``chip_smoke.py``'s kernel table."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, weights
from benchmark.tests import tiny

TOL = 0.01


def flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.fixture(scope="module")
def engine():
    from vista_tpu_torch.engine.engine import VistaEngine

    from benchmark import harness

    cfg = tiny.config(tiny.SAMPLE)
    eng = VistaEngine(harness.engine_config(cfg), "cpu")
    weights.fill_(harness.components(eng), 0)
    return cfg, eng


def frame_conv_padding(u, videos, t, h, w):
    """What the system's plain 3-tap frame conv does not compute: the taps
    that would read the zero padding before a video's first frame and after
    its last, two of the 3 t taps of each of a residual block's two convs."""
    out = 0
    for kind, _, c, _, s in counts._levels(u, h, w):
        if kind == "res":
            out += 2 * (2 * videos * s * c * c * 2)
    return out


def test_unet_flops_match_the_flop_counter(engine):
    cfg, eng = engine
    u, t = cfg["engine"]["unet"], cfg["engine"]["num_frames"]
    videos, h, w = 2, 16, 16
    n = videos * t
    x = torch.randn(n, u["in_channels"], h, w)
    ctx = torch.randn(videos, 1, u["context_dim"] + 128 * 19)
    y = torch.randn(videos, u["adm_in_channels"])
    with torch.no_grad():
        got = flops(lambda: eng.unet(x, torch.rand(n), ctx, y, torch.zeros(n), t))
    want = counts.unet_flops(u, videos, t, h, w)
    # the named difference: the plain conv skips the padding taps
    assert abs(got + frame_conv_padding(u, videos, t, h, w) - want) <= TOL * want


def test_unet_flops_match_the_reference_exactly():
    from benchmark.reference.unet import VideoUNet

    cfg = tiny.config(tiny.SAMPLE)
    u, t = cfg["engine"]["unet"], cfg["engine"]["num_frames"]
    net = VideoUNet(u)
    videos, h, w = 1, 8, 16
    n = videos * t
    with torch.no_grad():
        got = flops(lambda: net(torch.randn(n, u["in_channels"], h, w), torch.rand(n),
                                torch.randn(videos, 1, u["context_dim"] + 128 * 19),
                                torch.randn(videos, u["adm_in_channels"]), None, t))
    assert abs(got - counts.unet_flops(u, videos, t, h, w)) <= TOL * got


def test_first_stage_flops_match_the_flop_counter(engine):
    cfg, eng = engine
    e = cfg["engine"]
    with torch.no_grad():
        got = flops(lambda: eng.conditioner.clip_tower(torch.randn(3, 3, 28, 28)))
        assert abs(got - counts.clip_flops(e["conditioner"]["clip"], 3)) <= TOL * got
        got = flops(lambda: eng.encoder(torch.randn(2, 3, 32, 32)))
        assert abs(got - counts.encoder_flops(e["vae"], 2, 32, 32)) <= TOL * got
        got = flops(lambda: eng.decoder(torch.randn(3, 4, 16, 16), 3))
        assert abs(got - counts.decoder_flops(e["vae"], 3, 16, 16)) <= TOL * got


def test_decode_windows_follow_the_engine():
    assert counts.decode_windows(25, 14, 3) == [14, 14]
    assert counts.decode_windows(14, 14, 3) == [14]
    assert counts.decode_windows(4, 3, 1) == [3, 2]


# chip_smoke.py kernel_checks: (FLOPs, bytes, exp2) expressions at its shapes
def test_launch_counts_match_the_kernel_table():
    b, s, h = 2, 9216, 5
    a = counts.attention(b, s, h * 64, "spatial-long")
    assert (a.flops, a.nbytes, a.exp2) == (4 * b * h * s * s * 64, 2 * 4 * b * s * h * 64,
                                           b * h * s * s)
    m, c = 50 * 9216, 320
    assert (counts.ln_qkv(m, c, "qkv").flops, counts.ln_qkv(m, c, "qkv").nbytes) == (
        2 * m * c * 3 * c, 2 * (m * c + 3 * c * c + 3 * m * c))
    assert (counts.ln_geglu(m, c).flops, counts.ln_geglu(m, c).nbytes) == (
        2 * m * c * 8 * c, 2 * (m * c + 8 * c * c + 4 * m * c))
    assert (counts.ff_out(m, c).flops, counts.ff_out(m, c).nbytes) == (
        2 * m * 4 * c * c, 2 * (4 * m * c + 4 * c * c + 2 * m * c))
    assert (counts.proj_out(m, c, "attn-out").flops, counts.proj_out(m, c, "attn-out").nbytes) == (
        2 * m * c * c, 2 * (3 * m * c + c * c))
    bt, s, c = 50, 9216, 320
    m = bt * s
    g = counts.gn_silu(bt, s, c, "emb")
    assert (g.flops, g.nbytes, g.exp2) == (0, 2 * 2 * m * c + 2 * 4 * bt * c, m * c)
    assert (counts.conv3(bt, s, c, "emb").flops, counts.conv3(bt, s, c, "emb").nbytes) == (
        6 * m * c * c, 2 * (2 * m * c + 3 * c * c))
    assert counts.conv3(bt, s, c, "res").nbytes == 2 * (3 * m * c + 3 * c * c)
    d = counts.conv3(25, 9216, 320, "emb-dx", "conv3")
    assert (d.flops, d.nbytes) == (6 * 25 * 9216 * 320 * 320, 2 * (2 * 25 * 9216 * 320 + 3 * 320 ** 2))
    # chip_smoke.bound: the larger of the products, the exp2 and the bytes
    assert a.seconds == max(a.flops / 989e12, a.exp2 / 3.9e12, a.nbytes / 3.35e12)


def test_launches_per_forward_at_the_full_configuration():
    from benchmark import harness

    _, cfg, _, _ = harness.cell_files(harness.load_spec(), tiny.SAMPLE)
    per = counts.unet_launches(cfg["engine"]["unet"], 2, 25, 72, 128)
    by_kernel = {}
    for launch in per:
        by_kernel[launch.kernel] = by_kernel.get(launch.kernel, 0) + 1
    assert by_kernel == {"attention": 32, "ln_linear": 80, "linear_residual": 80,
                         "gn_silu": 44, "gn_silu_conv3": 44}
    bwd = counts.unet_backward_launches(cfg["engine"]["unet"], 1, 25, 72, 128)
    assert sum(l.kernel == "attention_bwd" for l in bwd) == 32
    assert sum(l.kernel == "conv3" for l in bwd) == 66
    sites = {(l.kernel, l.site) for l in per}
    assert ("attention", "spatial-long") in sites and ("attention", "spatial-short") in sites
