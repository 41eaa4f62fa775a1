"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small shapes with ragged edges (rows, columns and sequence
lengths that are not tile multiples, s_q != s_k, a valid-key length).

Needs an NVIDIA card and ``nvcc``: marked ``cuda`` and skipped without a
card. On the card: ``python3 -m pytest tests/test_torch_cuda.py -q``.
Bound: max|kernel - plain| <= 1e-2 * max|plain|, the plain version in fp32
on the same bf16 inputs (bf16 operands and outputs, fp32 accumulation), with
TF32 off for its products and convolutions.
"""

import pytest
import torch

from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu_torch.ops import _build
from vista_tpu_torch.ops.attention import (SMALL_KEYS, attention_bwd, attention_bwd_plain,
                                           attention_forward, attention_packed,
                                           attention_plain)
from vista_tpu_torch.ops.fused_ff import ff_bwd, ff_bwd_dh, ff_bwd_dh_plain, ff_bwd_plain
from vista_tpu_torch.ops.fused_temporal_attn import (fused_temporal_self_attn,
                                                     fused_temporal_self_attn_bwd_plain)
from vista_tpu_torch.ops.linear import (bias_grad_plain, linear_residual, linear_residual_bwd,
                                        linear_residual_bwd_plain, linear_residual_plain,
                                        ln_linear, ln_linear_plain, ln_linear_split_bwd,
                                        ln_linear_split_bwd_plain, seg_gemm, seg_gemm_plain,
                                        weight_bias_grads, weight_grad, weight_grad_plain,
                                        wgrad_plan)
from vista_tpu_torch.ops import norms
from vista_tpu_torch.ops.norms import (layer_norm_kernel, layer_norm_plain, ln_backward,
                                       ln_bwd_plain, ln_plan)
from vista_tpu_torch.ops.temporal_conv import (_conv3_weight_grad, conv3, conv3_plain, conv3_vjp,
                                               fused_gn_silu_conv3_emb, fused_gn_silu_conv3_res,
                                               gn_silu, gn_silu_conv3, gn_silu_conv3_plain,
                                               gn_silu_plain)

pytestmark = pytest.mark.cuda
TOL = 1e-2


@pytest.fixture
def rnd():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield draw
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _f32(*ts):
    return [None if t is None else t.float() for t in ts]


def _check(got, ref):
    got = got if isinstance(got, torch.Tensor) else torch.stack(list(got))
    ref = ref if isinstance(ref, torch.Tensor) else torch.stack(list(ref))
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err <= TOL, float(err)


@pytest.mark.parametrize("b,s_q,s_k,heads,valid_k", [
    (3, 100, 130, 2, None), (3, 100, 130, 2, 77), (40, 25, 25, 5, None),
    (2, 1000, 1000, 1, 999), (70000, 25, 25, 1, None)])
def test_attention(rnd, b, s_q, s_k, heads, valid_k):
    q, k, v = rnd(b, s_q, heads * 64), rnd(b, s_k, heads * 64), rnd(b, s_k, heads * 64)
    _check(attention_packed(q, k, v, heads, valid_k),
           attention_plain(*_f32(q, k, v), heads, valid_k))


@pytest.mark.parametrize("m,c,splits", [(300, 96, 3), (129, 64, 1), (1000, 320, 3),
                                         (1000, 1280, 3), (1000, 96, 3)])
def test_ln_linear_split(rnd, m, c, splits):
    x, w = rnd(m, c), rnd(splits * c, c, std=c ** -0.5)
    lw, lb = 1 + rnd(c, std=0.1, dtype=torch.float32), rnd(c, std=0.1, dtype=torch.float32)
    _check(ln_linear(x, lw, lb, w, None, "split", splits),
           ln_linear_plain(*_f32(x, lw, lb, w), None, "split", splits))


@pytest.mark.parametrize("m,c", [(300, 64), (1000, 320)])
def test_ln_linear_geglu(rnd, m, c):
    x, w1 = rnd(m, c), rnd(8 * c, c, std=c ** -0.5)
    lw, lb = 1 + rnd(c, std=0.1, dtype=torch.float32), rnd(c, std=0.1, dtype=torch.float32)
    b1 = rnd(8 * c, std=0.1, dtype=torch.float32)
    _check(ln_linear(x, lw, lb, w1, b1, "geglu"),
           ln_linear_plain(*_f32(x, lw, lb, w1, b1), "geglu"))


@pytest.mark.parametrize("epilogue", ["split", "geglu"])
def test_ln_linear_shifted_mean(rnd, epilogue):
    """Rows of mean 4 and std 1, as a residual stream is: the kernel's
    E[x^2] - mean^2 statistic in fp32 holds there."""
    m, c = 1000, 320
    x = (rnd(m, c, dtype=torch.float32) + 4.0).to(torch.bfloat16)
    lw, lb = 1 + rnd(c, std=0.1, dtype=torch.float32), rnd(c, std=0.1, dtype=torch.float32)
    n_w = 3 * c if epilogue == "split" else 8 * c
    w, b = rnd(n_w, c, std=c ** -0.5), rnd(n_w, std=0.1, dtype=torch.float32)
    _check(ln_linear(x, lw, lb, w, b, epilogue, 3),
           ln_linear_plain(*_f32(x, lw, lb, w, b), epilogue, 3))


def test_linear_residual(rnd):
    m, k, n = 300, 256, 200
    a, w, res = rnd(m, k), rnd(n, k, std=k ** -0.5), rnd(m, n)
    b = rnd(n, std=0.1, dtype=torch.float32)
    _check(linear_residual(a, w, b, res), linear_residual_plain(*_f32(a, w, b, res)))


# (m, k, n): ragged m at every UNet width n = c with k = c (attn-out,
# temporal-out) and k = 4c (FF-out), and small widths with a ragged k
@pytest.mark.parametrize("m,k,n", [(1000, 320, 320), (777, 1280, 320), (300, 640, 640),
                                   (515, 2560, 640), (129, 1280, 1280), (260, 5120, 1280),
                                   (70, 96, 64), (200, 200, 8)])
def test_linear_residual_shapes(rnd, m, k, n):
    a, w, res = rnd(m, k), rnd(n, k, std=k ** -0.5), rnd(m, n)
    b = rnd(n, std=0.1, dtype=torch.float32)
    _check(linear_residual(a, w, b, res), linear_residual_plain(*_f32(a, w, b, res)))


def test_linear_residual_is_deterministic(rnd):
    """No split-K: two launches give the same bits."""
    a, w, res = rnd(3000, 1280), rnd(320, 1280, std=1280 ** -0.5), rnd(3000, 320)
    b = rnd(320, std=0.1, dtype=torch.float32)
    assert torch.equal(linear_residual(a, w, b, res), linear_residual(a, w, b, res))


SPATIAL_SHAPES = [(3, 100, 100, 2, None), (2, 1000, 1000, 5, None), (1, 2880, 2880, 1, None),
                  (3, 100, 130, 2, None), (3, 100, 130, 2, 77), (2, 300, 300, 20, None),
                  (2, 129, 200, 3, 1)]
# the short route: t = 25 at 5, 10 and 20 heads, 45 frames, a valid key
# length, s_q != s_k, 1, 17, 33 and 64 frames, and 1, 7 and 18432 sequences
# (an odd count leaves half of the last 32-frame box empty)
SHORT_SHAPES = [(1, 25, 25, 5, None), (7, 25, 25, 10, None), (18432, 25, 25, 5, None),
                (7, 25, 25, 20, 20), (50, 45, 45, 20, None), (7, 45, 45, 20, 40),
                (3, 20, 30, 2, None), (9, 17, 17, 2, 9), (3, 33, 33, 1, None),
                (2, 64, 64, 3, 64), (5, 1, 1, 2, None)]


@pytest.mark.parametrize("route,b,s_q,s_k,heads,valid_k",
                         [("wgmma", *s) for s in SPATIAL_SHAPES]
                         + [("short", *s) for s in SHORT_SHAPES[:4]])
def test_attention_routes(rnd, route, b, s_q, s_k, heads, valid_k):
    """Each of K1's routes, forced, at ragged lengths, s_q != s_k, a valid
    key length, 1 and 20 heads: the output and the LSE."""
    q, k, v = rnd(b, s_q, heads * 64), rnd(b, s_k, heads * 64), rnd(b, s_k, heads * 64)
    _build.reset_counts()
    o, lse = attention_forward(q, k, v, heads, valid_k, want_lse=True, route=route)
    assert _build.LAUNCHES[f"attention:{route}"] == 1
    ref_o, ref_lse = attention_plain(*_f32(q, k, v), heads, valid_k, want_lse=True)
    _check(o, ref_o)
    _check(lse, ref_lse)
    _check(attention_forward(q, k, v, heads, valid_k, route=route), ref_o)


@pytest.mark.parametrize("route,b,s", [("wgmma", 2, 1000), ("short", 2000, 25)])
def test_attention_is_deterministic(rnd, route, b, s):
    """No atomics: two launches give the same bits, with and without LSE."""
    q, k, v = (rnd(b, s, 5 * 64) for _ in range(3))
    first = attention_forward(q, k, v, 5, want_lse=True, route=route)
    second = attention_forward(q, k, v, 5, want_lse=True, route=route)
    for t, u in zip(first, second):
        assert torch.equal(t, u)
    assert torch.equal(first[0], attention_forward(q, k, v, 5, route=route))


@pytest.mark.parametrize("b,s,heads,route", [(2, 576, 5, "wgmma"), (30, 25, 5, "short")])
def test_attention_packed_forward_route(rnd, b, s, heads, route):
    """attention_packed under autograd takes the wgmma forward at a spatial
    length and the short one at t = 25, and the backward on that
    forward's LSE holds its plain version."""
    q, k, v, gy = (rnd(b, s, heads * 64) for _ in range(4))
    args = [t.requires_grad_() for t in (q, k, v)]
    _build.reset_counts()
    out = attention_packed(*args, heads)
    assert _build.LAUNCHES[f"attention:{route}"] == 1 and _build.LAUNCHES["attention"] == 1
    got = torch.autograd.grad(out, args, gy)
    o, lse = attention_plain(*_f32(q, k, v), heads, want_lse=True)
    _check(out, o)
    ref = attention_bwd_plain(*_f32(q, k, v), o, lse, gy.float(), heads)
    for g, r in zip(got, ref):
        _check(g, r)


def _close_abs(got, ref):
    """Like _check, against the plain version's largest magnitude or 1e-3 if
    that is smaller: with one key, dq and dk are 0 up to bf16 rounding."""
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max() / max(ref.float().abs().max().item(), 1e-3)
    assert err <= TOL, float(err)


@pytest.mark.parametrize("b,s_q,s_k,heads,valid_k", SHORT_SHAPES)
def test_attention_short_route(rnd, b, s_q, s_k, heads, valid_k):
    """The short route, forward without and with LSE and the fused
    backward, against their plain versions; the backward is one launch of
    its own kernel."""
    q, k, v = rnd(b, s_q, heads * 64), rnd(b, s_k, heads * 64), rnd(b, s_k, heads * 64)
    do = rnd(b, s_q, heads * 64)
    _build.reset_counts()
    o = attention_forward(q, k, v, heads, valid_k)
    o2, lse = attention_forward(q, k, v, heads, valid_k, want_lse=True)
    ref_o, ref_lse = attention_plain(*_f32(q, k, v), heads, valid_k, want_lse=True)
    _check(o, ref_o)
    assert torch.equal(o, o2)
    _check(lse, ref_lse)
    got = attention_bwd(q, k, v, o2, lse, do, heads, valid_k)
    assert _build.LAUNCHES == {"attention": 2, "attention:short": 2, "attention_bwd": 1,
                               "attention_bwd:short": 1}
    ref = attention_bwd_plain(*_f32(q, k, v, o2, lse, do), heads, valid_k)
    for g, r in zip(got, ref):
        _close_abs(g, r)
    if valid_k is not None and valid_k < s_k:
        # keys at or past the valid length get no gradient
        assert not got[1][:, valid_k:].any() and not got[2][:, valid_k:].any()


@pytest.mark.parametrize("s_q,s_k", [(65, 65), (25, 100), (100, 25)])
def test_short_route_refuses_long_sequences(rnd, s_q, s_k):
    """Forced onto more than 64 queries or keys, the short route raises
    before any launch."""
    q, k, v = rnd(2, s_q, 128), rnd(2, s_k, 128), rnd(2, s_k, 128)
    o, lse = attention_forward(q, k, v, 2, want_lse=True, route="wgmma")
    _build.reset_counts()
    with pytest.raises(ValueError):
        attention_forward(q, k, v, 2, route="short")
    with pytest.raises(ValueError):
        attention_bwd(q, k, v, o, lse, q, 2, route="short")
    assert not _build.LAUNCHES


@pytest.mark.parametrize("shape", [(300, 320), (50, 25, 640), (7, 1280)])
def test_layer_norm(rnd, shape):
    c = shape[-1]
    x = rnd(*shape, std=2.0)
    lw, lb = 1 + rnd(c, std=0.1, dtype=torch.float32), rnd(c, std=0.1, dtype=torch.float32)
    _check(layer_norm_kernel(x, lw, lb), layer_norm_plain(*_f32(x, lw, lb)))


# (rows, c): every width the row plan takes a different group size at (c =
# 32 and 64: 1 and 2 lanes a row; the UNet's 320, 640, 1280: 8, 16, 32),
# row counts that are not a multiple of a warp step or of the grid, and one
# large enough for the persistent grid to walk several steps a warp
LN_SHAPES = [(7, 32), (45, 64), (301, 320), (1125, 640), (77, 1280), (20011, 320)]


@pytest.mark.parametrize("m,c", LN_SHAPES)
def test_layer_norm_widths(rnd, m, c):
    """Every width and ragged row count, γ/β in bf16 and in fp32: the kernel
    reads bf16 γ/β as the same fp32 values that ``.float()`` gives, so the
    two outputs are identical."""
    x = (rnd(m, c, dtype=torch.float32) * 2 + 0.5).to(torch.bfloat16)
    lwb, lbb = 1 + rnd(c, std=0.1), rnd(c, std=0.1)
    got_bf16 = layer_norm_kernel(x, lwb, lbb)
    got_f32 = layer_norm_kernel(x, lwb.float(), lbb.float())
    torch.cuda.synchronize()
    assert torch.equal(got_bf16, got_f32)
    _check(got_f32, layer_norm_plain(*_f32(x, lwb, lbb)))


@pytest.mark.parametrize("m,c", LN_SHAPES)
@pytest.mark.parametrize("dxn_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("want_ln", [True, False])
def test_ln_backward(rnd, m, c, dxn_dtype, with_res, want_ln):
    x = rnd(m, c, std=2.0)
    dxn = rnd(m, c, dtype=dxn_dtype)
    dres = rnd(m, c) if with_res else None
    lw = 1 + rnd(c, std=0.1, dtype=torch.float32)
    _build.reset_counts()
    dx, dg, db = ln_backward(x, dxn, lw, dres, 1e-5, want_ln)
    assert _build.LAUNCHES["ln_bwd"] == 1
    ref_dx, ref_dg, ref_db = ln_bwd_plain(*_f32(x, dxn, lw))
    if with_res:
        ref_dx = ref_dx + dres.float()
    _check(dx, ref_dx)
    if want_ln:
        assert dg.dtype == db.dtype == torch.float32
        _check(dg, ref_dg)
        _check(db, ref_db)
    else:
        assert dg is None and db is None


def test_ln_backward_bf16_gamma(rnd):
    """bf16 γ gives the bits of the same γ in fp32."""
    m, c = 3001, 640
    x, dxn = rnd(m, c, std=2.0), rnd(m, c)
    lwb = 1 + rnd(c, std=0.1)
    got = ln_backward(x, dxn, lwb)
    ref = ln_backward(x, dxn, lwb.float())
    torch.cuda.synchronize()
    for t, u in zip(got, ref):
        assert torch.equal(t, u)


@pytest.mark.parametrize("m,c", [(230400 // 8, 320), (14400, 1280)])
def test_ln_backward_is_deterministic(rnd, m, c):
    """dγ and dβ from the in-launch fold (more than one group of blocks
    here) and dx: two launches give the same bits."""
    assert ln_plan(m, c, norms.sm_count(0), backward=True).groups > 1
    x, dxn, dres = rnd(m, c, std=2.0), rnd(m, c, dtype=torch.float32), rnd(m, c)
    lw = 1 + rnd(c, std=0.1, dtype=torch.float32)
    first, second = (ln_backward(x, dxn, lw, dres) for _ in range(2))
    torch.cuda.synchronize()
    for t, u in zip(first, second):
        assert torch.equal(t, u)


def test_ln_kernels_fit_the_plans_blocks_an_sm(rnd):
    """Every instance of both LayerNorm kernels gets LN_BLOCKS_PER_SM (2)
    blocks an SM at its registers and shared memory."""
    blocks = norms.ln_occupancy()
    assert len(blocks) == 10 and min(blocks.values()) >= norms.LN_BLOCKS_PER_SM, blocks


def test_lora_self_attention_backward_takes_the_kernels(rnd, monkeypatch):
    """Under LoRA the norm1 backward runs ``ln_bwd_kernel`` on the card: the
    plain versions raise on CUDA tensors here, and the gradient of x agrees
    with the same module in fp32 on the CPU (bound 5e-2: a bf16 chain of
    LayerNorm, four products and a softmax against fp32)."""
    import copy

    from vista_tpu_torch.models.attention import CrossAttention

    def cpu_only(fn):
        def wrapped(x, *args, **kwargs):
            if x.is_cuda:
                raise AssertionError(f"{fn.__name__} ran on a CUDA tensor")
            return fn(x, *args, **kwargs)
        return wrapped

    torch.manual_seed(0)
    c, heads = 128, 2
    attn = CrossAttention(c, heads, 64, add_lora=True)
    norm = torch.nn.LayerNorm(c)
    with torch.no_grad():
        for p in (*attn.parameters(), *norm.parameters()):
            p.add_(0.05 * torch.randn_like(p))
    norm.requires_grad_(False)  # LoRA freezes the norms
    x_cpu = torch.randn(3, 50, c)
    cpu_attn, cpu_norm = copy.deepcopy(attn), copy.deepcopy(norm)
    x_ref = x_cpu.clone().requires_grad_()
    cpu_attn.self_attention(x_ref, cpu_norm).sum().backward()

    attn, norm = attn.cuda().to(torch.bfloat16), norm.cuda().to(torch.bfloat16)
    monkeypatch.setattr(norms, "layer_norm_plain", cpu_only(norms.layer_norm_plain))
    monkeypatch.setattr(norms, "ln_bwd_plain", cpu_only(norms.ln_bwd_plain))
    x = x_cpu.cuda().to(torch.bfloat16).requires_grad_()
    _build.reset_counts()
    attn.self_attention(x, norm).float().sum().backward()
    assert _build.SITES["layer_norm/spatial-short"] == 1
    assert _build.SITES["ln_bwd/spatial-short"] == 1
    assert norm.weight.grad is None
    torch.cuda.synchronize()
    err = (x.grad.float().cpu() - x_ref.grad).abs().max() / x_ref.grad.abs().max()
    assert err <= 5e-2, float(err)


@pytest.mark.parametrize("b,s_q,s_k,heads,valid_k", [
    (3, 100, 130, 2, None), (3, 100, 130, 2, 77), (40, 25, 25, 5, None), (2, 300, 300, 1, 257),
    (3, 1000, 1000, 5, None), (2, 2304, 2304, 10, None), (2, 640, 700, 5, 600),
    (2, SMALL_KEYS, SMALL_KEYS, 1, None), (2, SMALL_KEYS + 1, SMALL_KEYS + 1, 1, None)])
def test_attention_bwd(rnd, b, s_q, s_k, heads, valid_k):
    """Both routes: more than SMALL_KEYS keys take the wgmma kernels."""
    q, k, v = rnd(b, s_q, heads * 64), rnd(b, s_k, heads * 64), rnd(b, s_k, heads * 64)
    do = rnd(b, s_q, heads * 64)
    o, lse = attention_forward(q, k, v, heads, valid_k, want_lse=True)
    ref_o, ref_lse = attention_plain(*_f32(q, k, v), heads, valid_k, want_lse=True)
    _check(o, ref_o)
    _check(lse, ref_lse)
    _build.reset_counts()
    got = attention_bwd(q, k, v, o, lse, do, heads, valid_k)
    route = "short" if s_k <= SMALL_KEYS else "wgmma"
    assert _build.LAUNCHES[f"attention_bwd:{route}"] == 1
    ref = attention_bwd_plain(*_f32(q, k, v, o, lse, do), heads, valid_k)
    for g, r in zip(got, ref):
        _check(g, r)


@pytest.mark.parametrize("route,b,s_q,s_k,heads,valid_k", [
    ("wgmma", 3, 100, 130, 2, 77), ("wgmma", 40, 25, 25, 5, None),
    ("short", 40, 25, 25, 5, None), ("short", 7, 45, 45, 20, 40)])
def test_attention_bwd_forced_route(rnd, route, b, s_q, s_k, heads, valid_k):
    """``route=`` forces either backward route at a spatial and a temporal
    shape, each within the tolerance of the plain version."""
    q, k, v = rnd(b, s_q, heads * 64), rnd(b, s_k, heads * 64), rnd(b, s_k, heads * 64)
    do = rnd(b, s_q, heads * 64)
    o, lse = attention_forward(q, k, v, heads, valid_k, want_lse=True)
    _build.reset_counts()
    got = attention_bwd(q, k, v, o, lse, do, heads, valid_k, route=route)
    assert _build.LAUNCHES[f"attention_bwd:{route}"] == 1
    ref = attention_bwd_plain(*_f32(q, k, v, o, lse, do), heads, valid_k)
    for g, r in zip(got, ref):
        _check(g, r)


@pytest.mark.parametrize("b,s,heads", [(2, 1000, 5), (40, 25, 5), (2880, 25, 5), (7, 45, 20)])
def test_attention_bwd_is_deterministic(rnd, b, s, heads):
    """No atomics in the sums: two launches give the same bits (the short
    route's single launch at t = 25 and 45 frames too)."""
    q, k, v, do = (rnd(b, s, heads * 64) for _ in range(4))
    o, lse = attention_forward(q, k, v, heads, want_lse=True)
    first = attention_bwd(q, k, v, o, lse, do, heads)
    second = attention_bwd(q, k, v, o, lse, do, heads)
    for t, u in zip(first, second):
        assert torch.equal(t, u)


@pytest.mark.parametrize("b,s,heads,route", [(2, 576, 5, "wgmma"), (30, 25, 5, "short")])
def test_attention_packed_backward_route(rnd, b, s, heads, route):
    """A backward through attention_packed under autograd (the engine's
    thread) takes the wgmma kernels at a spatial length and the short
    route's single kernel at t = 25."""
    q, k, v, gy = (rnd(b, s, heads * 64) for _ in range(4))
    args = [t.requires_grad_() for t in (q, k, v)]
    _build.reset_counts()
    out = attention_packed(*args, heads)
    got = torch.autograd.grad(out, args, gy)
    assert _build.LAUNCHES[f"attention_bwd:{route}"] == 1
    assert _build.LAUNCHES["attention_bwd"] == 1
    o, lse = attention_plain(*_f32(q, k, v), heads, want_lse=True)
    ref = attention_bwd_plain(*_f32(q, k, v), o, lse, gy.float(), heads)
    for g, r in zip(got, ref):
        _check(g, r)


@pytest.mark.parametrize("m,c", [(300, 64), (130, 96)])
def test_ff_bwd(rnd, m, c):
    x, dy = rnd(m, c), rnd(m, c)
    lw, lb = 1 + rnd(c, std=0.1, dtype=torch.float32), rnd(c, std=0.1, dtype=torch.float32)
    w1, b1 = rnd(8 * c, c, std=c ** -0.5), rnd(8 * c, std=0.1, dtype=torch.float32)
    w2 = rnd(c, 4 * c, std=(4 * c) ** -0.5)
    got = ff_bwd(x, lw, lb, w1, b1, w2, dy)
    ref = ff_bwd_plain(*_f32(x, lw, lb, w1, b1, w2, dy))
    for g, r in zip(got, ref):
        _check(g, r)


@pytest.mark.parametrize("m,c", [(461, 64), (1000, 96), (777, 320)])
def test_ff_bwd_ragged(rnd, m, c):
    x, dy = rnd(m, c), rnd(m, c)
    lw, lb = 1 + rnd(c, std=0.1, dtype=torch.float32), rnd(c, std=0.1, dtype=torch.float32)
    w1, b1 = rnd(8 * c, c, std=c ** -0.5), rnd(8 * c, std=0.1, dtype=torch.float32)
    w2 = rnd(c, 4 * c, std=(4 * c) ** -0.5)
    got = ff_bwd(x, lw, lb, w1, b1, w2, dy)
    ref = ff_bwd_plain(*_f32(x, lw, lb, w1, b1, w2, dy))
    for g, r in zip(got, ref):
        _check(g, r)


@pytest.mark.parametrize("m,c", [(130, 96), (777, 320), (300, 1280)])
def test_ff_bwd_dh(rnd, m, c):
    xn, dy = rnd(m, c), rnd(m, c)
    w1, b1 = rnd(8 * c, c, std=c ** -0.5), rnd(8 * c, std=0.1, dtype=torch.float32)
    w2 = rnd(c, 4 * c, std=(4 * c) ** -0.5)
    for g, r in zip(ff_bwd_dh(xn, dy, w1, b1, w2), ff_bwd_dh_plain(*_f32(xn, dy, w1, b1, w2))):
        _check(g, r)


def test_ff_bwd_dh_is_deterministic(rnd):
    m, c = 3000, 320
    xn, dy = rnd(m, c), rnd(m, c)
    w1, b1 = rnd(8 * c, c, std=c ** -0.5), rnd(8 * c, std=0.1, dtype=torch.float32)
    w2 = rnd(c, 4 * c, std=(4 * c) ** -0.5)
    first, second = (ff_bwd_dh(xn, dy, w1, b1, w2) for _ in range(2))
    for t, u in zip(first, second):
        assert torch.equal(t, u)


# (clips, t, s, cin, cout): ragged s (45, 180: the last 128-row tile of a
# clip is partial), two and three clips back to back, cin 64, 320 and 1280,
# a ragged column tile (328)
K4_SHAPES = [(2, 5, 45, 64, 96), (2, 5, 45, 64, 64), (3, 4, 180, 320, 320),
             (2, 25, 45, 1280, 1280), (3, 5, 180, 64, 328)]


def _k4_inputs(rnd, clips, t, s, cin, cout):
    """Per-frame scale and shift, the shift well away from 0 (a zero-filled
    edge row must stay 0 after the affine + SiLU, not become SiLU(shift))."""
    bt = clips * t
    x = rnd(bt, s, cin)
    sc = rnd(bt, cin, std=0.5, dtype=torch.float32) + 1
    sh = rnd(bt, cin, std=0.3, dtype=torch.float32) + 1.5
    w = rnd(cout, cin, 3, 1, 1, std=(3 * cin) ** -0.5)
    b = rnd(cout, std=0.1, dtype=torch.float32)
    return x, sc, sh, w, b


@pytest.mark.parametrize("epilogue", ["emb", "res"])
@pytest.mark.parametrize("clips,t,s,cin,cout", K4_SHAPES)
def test_gn_silu_conv3(rnd, clips, t, s, cin, cout, epilogue):
    x, sc, sh, w, b = _k4_inputs(rnd, clips, t, s, cin, cout)
    bt = clips * t
    kw = dict(emb=rnd(bt, cout, dtype=torch.float32)) if epilogue == "emb" else dict(
        residual=rnd(bt, s, cout), res_scale=torch.full((1,), 0.3, device="cuda"))
    ref_kw = {k: v.float() for k, v in kw.items()}
    before = _build.LAUNCHES["gn_silu_conv3"]
    _check(gn_silu_conv3(x, sc, sh, w, b, t, **kw),
           gn_silu_conv3_plain(*_f32(x, sc, sh, w, b), t, **ref_kw))
    assert _build.LAUNCHES["gn_silu_conv3"] == before + 1


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("clips,t,s,cin,cout", K4_SHAPES)
def test_conv3(rnd, clips, t, s, cin, cout, with_bias):
    x = rnd(clips * t, s, cin)
    w = rnd(cout, cin, 3, 1, 1, std=(3 * cin) ** -0.5)
    b = rnd(cout, std=0.1, dtype=torch.float32) if with_bias else None
    _check(conv3(x, w, b, t), conv3_plain(*_f32(x, w, b), t))


@pytest.mark.parametrize("clips,t,s,c", [(2, 5, 45, 64), (2, 25, 180, 1280)])
def test_gn_silu(rnd, clips, t, s, c):
    """The pre-pass alone: one bf16 rounding of SiLU(x * scale + shift)."""
    x, sc, sh, _, _ = _k4_inputs(rnd, clips, t, s, c, 8)
    _check(gn_silu(x, sc, sh), gn_silu_plain(*_f32(x, sc, sh)))


def test_gn_silu_conv3_is_deterministic(rnd):
    """No split-K: two launches give the same bits, in K4 and in conv3."""
    x, sc, sh, w, b = _k4_inputs(rnd, 2, 25, 180, 320, 320)
    emb = rnd(50, 320, dtype=torch.float32)
    assert torch.equal(gn_silu_conv3(x, sc, sh, w, b, 25, emb=emb),
                       gn_silu_conv3(x, sc, sh, w, b, 25, emb=emb))
    assert torch.equal(conv3(x, w, b, 25), conv3(x, w, b, 25))


@pytest.mark.parametrize("cin,cout,t", [(32, 64, 5), (64, 12, 5), (64, 64, 3)])
def test_gn_silu_conv3_refuses_before_launching(rnd, cin, cout, t):
    x, sc, sh, w, b = _k4_inputs(rnd, 2, 5, 45, cin, cout)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        gn_silu_conv3(x, sc, sh, w, b, t, emb=rnd(10, cout, dtype=torch.float32))
    with pytest.raises(ValueError):
        conv3(x, w, b, t)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("epilogue", ["emb", "res"])
def test_gn_silu_conv3_grads(rnd, epilogue):
    """K4 under autograd (its backward: conv3 for dx and, for ``res``, y;
    the fp32 dW) against the same autograd on the CPU in fp32, where every
    step is the plain version."""
    clips, t, s, c = 2, 5, 45, 64
    x, sc, sh, w, b = _k4_inputs(rnd, clips, t, s, c, c)
    bt = clips * t
    extra = [rnd(bt, c, dtype=torch.float32)] if epilogue == "emb" else [
        rnd(bt, s, c), torch.full((1,), 0.3, device="cuda")]
    fn = fused_gn_silu_conv3_emb if epilogue == "emb" else fused_gn_silu_conv3_res
    gy = rnd(bt, s, c)
    card = [a.detach().requires_grad_() for a in (x, sc, sh, w, b, *extra)]
    got = torch.autograd.grad(fn(*card, t), card, gy)
    cpu = [a.detach().float().cpu().requires_grad_() for a in (x, sc, sh, w, b, *extra)]
    ref = torch.autograd.grad(fn(*cpu, t), cpu, gy.float().cpu())
    for g, r in zip(got, ref):
        _check(g.cpu(), r)


def test_conv3_weight_grad_precision(rnd):
    """K4's and conv3's dW at the phase-1 ds1 shape (25 frames, 9216 tokens,
    320 channels: 230400 tokens contracted) against the same product summed
    in fp32 on the card, beside a bf16 matmul with bf16 output (the route
    it replaced). The fp32 sums differ from the reference in order only."""
    t, s, c = 25, 9216, 320
    xn, gy = rnd(t, s, c), rnd(t, s, c)
    got = _conv3_weight_grad(xn, gy, t, (c, c, 3, 1, 1)).reshape(c, c, 3)
    xf, gf = xn.float(), gy.float()
    spans = [(gf[1:], xf[:-1]), (gf, xf), (gf[:-1], xf[1:])]
    ref = torch.stack([g.reshape(-1, c).t() @ a.reshape(-1, c) for g, a in spans], -1)
    bf16 = torch.stack([(g.reshape(-1, c).t().bfloat16() @ a.reshape(-1, c).bfloat16()).float()
                        for g, a in spans], -1)
    scale = ref.abs().max()
    err, bf16_err = ((got - ref).abs().max() / scale).item(), ((bf16 - ref).abs().max() / scale).item()
    assert got.dtype == torch.float32
    assert err <= 1e-5 and err < bf16_err, (err, bf16_err)


@pytest.mark.parametrize("shape,splits", [((300, 96), 3), ((5, 25, 64), 3), ((129, 64), 1)])
def test_ln_linear_split_bwd(rnd, shape, splits):
    c = shape[-1]
    x, g = rnd(*shape, std=2.0), rnd(splits, *shape)
    w = rnd(splits * c, c, std=c ** -0.5)
    lw, lb = 1 + rnd(c, std=0.1, dtype=torch.float32), rnd(c, std=0.1, dtype=torch.float32)
    got = ln_linear_split_bwd(x, lw, lb, w, g)
    ref = ln_linear_split_bwd_plain(*_f32(x, lw, lb, w, g))
    for t, r in zip(got, ref):
        _check(t, r)


@pytest.mark.parametrize("m,k,n", [(300, 96, 64), (129, 64, 320)])
def test_linear_residual_bwd(rnd, m, k, n):
    a, w, g = rnd(m, k), rnd(n, k, std=k ** -0.5), rnd(m, n)
    for t, r in zip(linear_residual_bwd(a, w, g), linear_residual_bwd_plain(*_f32(a, w, g))):
        _check(t, r)


@pytest.mark.parametrize("m,n1,n2", [(129, 96, 64), (1000, 320, 320), (4097, 2560, 320),
                                      (300, 320, 1280), (20000, 64, 96)])
def test_weight_grad(rnd, m, n1, n2):
    """Ragged token, row and column edges; (20000, 64, 96) spans several
    splits with a ragged last one."""
    if m == 20000:
        _, splits, per = wgrad_plan(m, n1, n2)
        assert splits > 2 and m % per
    a, b = rnd(m, n1), rnd(m, n2)
    _check(weight_grad(a, b), weight_grad_plain(a, b))
    _check(weight_grad(a, b, dtype=torch.bfloat16), weight_grad_plain(a, b))


@pytest.mark.parametrize("seg", [96, 320])
def test_weight_grad_segments(rnd, seg):
    """One launch for the q/k/v segments: (3, M, seg) -> (3 seg, N2)."""
    m = 1000
    a, b = rnd(3, m, seg), rnd(m, seg)
    got = weight_grad(a, b)
    assert got.shape == (3 * seg, seg)
    _check(got, weight_grad_plain(a, b))


@pytest.mark.parametrize("segs,m,n1,n2", [(1, 129, 96, 64), (1, 4097, 200, 320),
                                          (1, 300, 320, 1280), (3, 1000, 96, 96),
                                          (1, 20000, 64, 96), (1, 63, 64, 64),
                                          (3, 14400, 1280, 1280)])
def test_weight_grad_with_db(rnd, segs, m, n1, n2):
    """dW and db from one launch: ragged M (not a multiple of 64), N1 not a
    multiple of 128, segments, several splits with a ragged last one, and
    one split (63 tokens; qkv at ds4), where the epilogue writes dW and the
    side warps db without partials. dW is the same with and without db."""
    a, b = (rnd(segs, m, n1) if segs > 1 else rnd(m, n1)), rnd(m, n2)
    splits = wgrad_plan(m, n1, n2, segs)[1]
    if (m, n1) in ((63, 64), (14400, 1280)):
        assert splits == 1
    for dtype in (torch.float32, torch.bfloat16):
        dw, db = weight_grad(a, b, dtype, want_db=True)
        assert dw.dtype == dtype and db.dtype == torch.float32 and db.shape == (segs * n1,)
        _check(dw, weight_grad_plain(a, b))
        _check(db, bias_grad_plain(a))
        assert torch.equal(dw, weight_grad(a, b, dtype))


def test_bias_grad_without_weight_grad(rnd):
    """db alone is the same launch with dW dropped: the same bits; and the
    callers that take it so (K3's backward, conv3's VJP) agree with plain."""
    a, b = rnd(4097, 320), rnd(4097, 320)
    dw, db = weight_grad(a, b, want_db=True)
    none, alone = weight_bias_grads(a, b, torch.float32, False, True)
    assert none is None and torch.equal(alone, db)
    w, g = rnd(320, 320, std=320 ** -0.5), rnd(4097, 320)
    _, _, db3 = linear_residual_bwd(a, w, g, needs=(False, False, True))
    _check(db3, linear_residual_bwd_plain(*_f32(a, w, g))[2])
    x, gy = rnd(10, 96, 64), rnd(10, 96, 64)
    wc = rnd(64, 64, 3, 1, 1, std=192 ** -0.5)
    dx, dwc, dbc = conv3_vjp(x, wc, gy, 5, needs=(False, False, True))
    assert dx is None and dwc is None
    _check(dbc, gy.float().sum((0, 1)))
    _, dwc_full, dbc_full = conv3_vjp(x, wc, gy, 5)
    assert torch.equal(dbc, dbc_full)
    _check(dwc_full, _conv3_weight_grad(x.float().cpu(), gy.float().cpu(), 5, wc.shape).cuda())


@pytest.mark.parametrize("segs,m,k,n,dtype", [(3, 1000, 96, 96, torch.float32),
                                              (1, 129, 2560, 320, torch.float32),
                                              (1, 300, 320, 320, torch.bfloat16)])
def test_seg_gemm(rnd, segs, m, k, n, dtype):
    a, w = rnd(segs, m, k), rnd(segs * k, n, std=k ** -0.5)
    got = seg_gemm(a, w, dtype)
    assert got.dtype == dtype and got.shape == (m, n)
    _check(got, seg_gemm_plain(a, w))


def test_split_k_is_deterministic(rnd):
    """The split-K sums add fixed partials in a fixed order: two calls give
    the same bits."""
    a, b = rnd(20000, 320), rnd(20000, 320)
    assert torch.equal(weight_grad(a, b), weight_grad(a, b))
    for first, second in zip(*(weight_grad(a, b, torch.bfloat16, want_db=True)
                               for _ in range(2))):
        assert torch.equal(first, second)
    x, g = rnd(20000, 320, std=2.0), rnd(3, 20000, 320)
    w = rnd(960, 320, std=320 ** -0.5)
    lw, lb = 1 + rnd(320, std=0.1, dtype=torch.float32), rnd(320, std=0.1, dtype=torch.float32)
    first, second = (ln_linear_split_bwd(x, lw, lb, w, g) for _ in range(2))
    for t, u in zip(first, second):
        assert torch.equal(t, u)


def test_temporal_self_attn_grads(rnd):
    """The whole chain (K2 split, K1, K3 and their backward kernels) under
    autograd against the plain VJP of the TPU kernel's math."""
    rows, t, heads = 40, 25, 2
    c = heads * 64
    x, gy = rnd(rows, t, c), rnd(rows, t, c)
    lw, lb = 1 + rnd(c, std=0.1, dtype=torch.float32), rnd(c, std=0.1, dtype=torch.float32)
    ws = [rnd(c, c, std=c ** -0.5) for _ in range(4)]
    bo = rnd(c, std=0.1, dtype=torch.float32)
    args = [a.requires_grad_() for a in (x, lw, lb, *ws, bo)]
    out = fused_temporal_self_attn(*args, heads)
    got = torch.autograd.grad(out, args, gy)
    ref = fused_temporal_self_attn_bwd_plain(*_f32(*(a.detach() for a in args)), heads,
                                             gy.float())
    for g, r in zip(got, ref):
        _check(g, r)


def test_cuda_tensors_never_take_the_plain_path(rnd):
    q = rnd(1, 10, 64).float()
    with pytest.raises(TypeError):
        attention_packed(q, q, q, 1)
