"""What the CPU can check of the split-K GEMMs under the backward kernels
(``vk_wgrad``, ``vk_seg_gemm``): the split plan that the wrapper hands the
kernel, the plain fp32 versions that the CPU path runs, and that every
``__global__`` function of ``vista_tpu_torch/csrc/`` falls in a profile
group of ``chip_smoke.SYMBOLS``. No card, no JAX jit: each case takes
milliseconds."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vista_tpu_torch.ops.linear import (GEMM_TILE, TOKEN_BOX, seg_gemm, seg_gemm_plain,
                                        weight_grad, weight_grad_plain, wgrad_plan)

ROOT = Path(__file__).resolve().parents[1]

# (M; segs x N1 x N2): every phase-1 shape, the card tests' ragged ones,
# M below one token box and M = 1
PLAN_SHAPES = [(230400, 1, 320, 320), (230400, 3, 320, 320), (230400, 1, 2560, 320),
               (230400, 1, 320, 1280), (57600, 3, 640, 640), (14400, 3, 1280, 1280),
               (14400, 1, 1280, 1280), (72000, 1, 2560, 320), (4500, 1, 320, 1280),
               (129, 1, 96, 64), (1000, 1, 320, 320), (4097, 1, 2560, 320), (300, 1, 320, 1280),
               (20000, 1, 64, 96), (1000, 3, 96, 96), (63, 1, 64, 64), (1, 1, 64, 64)]


@pytest.mark.parametrize("m,segs,n1,n2", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
def test_wgrad_plan_covers_every_token_once(m, segs, n1, n2, sms):
    tile_n, splits, per = wgrad_plan(m, n1, n2, segs, sms)
    # splits of `per` tokens, the last ending at m: every row exactly once
    starts = [s * per for s in range(splits)]
    ends = [min(m, s + per) for s in starts]
    assert all(e > s for s, e in zip(starts, ends))
    assert ends[-1] == m and starts[0] == 0
    assert all(e == s for e, s in zip(ends[:-1], starts[1:]))
    # every split but the last is whole boxes: a box never reaches the next
    assert per % TOKEN_BOX == 0
    # the kernel's column tile: whole 64-wide boxes, at most one wgmma
    # n256 + n64 pair, covering n2 in ceil(n2 / tile_n) tiles
    assert tile_n == GEMM_TILE[1] and tile_n % 64 == 0 and tile_n <= 320
    tiles = -(-n2 // tile_n)
    assert (tiles - 1) * tile_n < n2 <= tiles * tile_n
    if n2 % 320 == 0:
        assert n2 % tile_n == 0


def test_wgrad_plan_fills_the_card_at_ds1():
    """One qkv segment at ds1 (3 row tiles of 128) fills 132 SMs in one round."""
    _, splits, _ = wgrad_plan(230400, 320, 320, 1, 132)
    assert 3 * splits == 132


def _rows(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("segs,m,n1,n2", [(1, 129, 96, 64), (3, 70, 32, 48)])
def test_weight_grad_cpu(segs, m, n1, n2):
    a = _rows(segs, m, n1, seed=0)
    b = _rows(m, n2, seed=1)
    want = np.concatenate([x.T.astype(np.float64) @ b for x in a])
    at = torch.from_numpy(a[0] if segs == 1 else a)
    got = weight_grad(at, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(weight_grad_plain(at, torch.from_numpy(b)).numpy(), want,
                               rtol=1e-5, atol=1e-4)
    assert weight_grad(at, torch.from_numpy(b), dtype=torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("segs,m,k,n", [(3, 50, 32, 40), (1, 17, 96, 8)])
def test_seg_gemm_cpu(segs, m, k, n):
    a, w = _rows(segs, m, k, seed=2), _rows(segs * k, n, seed=3)
    want = sum(a[s].astype(np.float64) @ w[s * k:(s + 1) * k] for s in range(segs))
    got = seg_gemm(torch.from_numpy(a), torch.from_numpy(w), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(seg_gemm_plain(torch.from_numpy(a), torch.from_numpy(w)).numpy(),
                               want, rtol=1e-5, atol=1e-4)


def _symbols():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return [s for group in module.SYMBOLS.values() for s in group]


def test_every_cuda_kernel_has_a_profile_group():
    """A renamed or new kernel cannot drop out of the profiles unnoticed."""
    names = set()
    for src in sorted((ROOT / "vista_tpu_torch" / "csrc").glob("*.cu")):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                src.read_text()))
    assert {"wgrad_tma_kernel", "seg_gemm_tma_kernel", "ln_linear_kernel"} <= names
    symbols = _symbols()
    for name in sorted(names):
        full = f"vk::{name}"
        assert any(s.startswith(full) or full.startswith(s) for s in symbols), name
