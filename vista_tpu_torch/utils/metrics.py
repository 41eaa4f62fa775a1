"""Video quality metrics (counterpart of ``vista_tpu/utils/metrics.py``, the
port's own copy): the Fréchet distance between Gaussian fits of two feature
sets, PSNR, SSIM and the graded corruptions that calibrate them, in float64.
``psnr`` and ``ssim`` take numpy arrays or torch tensors (then computed
where the tensors lie: a clip on the card stays there); the rest is numpy.

``tools/torch_quality_bench.py`` feeds ``frechet_feature_distance``
per-frame CLIP ViT-H features (the Fréchet CLIP distance, an offline proxy
for FVD, whose I3D features plug into the same function).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def feature_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(n, d)`` features -> mean ``(d,)`` and covariance ``(d, d)``."""
    feats = np.asarray(feats, np.float64)
    return feats.mean(axis=0), np.atleast_2d(np.cov(feats, rowvar=False))


def sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """The square root of a symmetric PSD matrix by its eigendecomposition
    (negative eigenvalues from rounding clipped to 0)."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    return (vecs * np.sqrt(np.clip(vals, 0.0, None))) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """``|mu1 - mu2|^2 + tr(S1 + S2 - 2 (S1^1/2 S2 S1^1/2)^1/2)``: the
    symmetric form of the trace term, whose every intermediate is PSD."""
    diff = np.asarray(mu1, np.float64) - np.asarray(mu2, np.float64)
    s1, s2 = np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64)
    root1 = sqrtm_psd(s1)
    cross = sqrtm_psd(root1 @ s2 @ root1)
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * np.trace(cross))


def frechet_feature_distance(real_feats: np.ndarray, gen_feats: np.ndarray) -> float:
    """The Fréchet distance between two feature sets (rows are samples)."""
    return frechet_distance(*feature_stats(real_feats), *feature_stats(gen_feats))


def psnr(a, b, data_range: float = 2.0) -> float:
    """Peak signal-to-noise ratio in dB (the default range is [-1, 1]'s)."""
    if isinstance(a, torch.Tensor):
        mse = float(((a.double() - b.double()) ** 2).mean())
    else:
        mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0.0 else float(10.0 * np.log10(data_range ** 2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _filter2d(img, k: np.ndarray):
    """Separable 'valid' filtering of ``(..., h, w, c)`` over its two
    spatial axes, one shifted product a tap (numpy or torch)."""
    n = len(k)
    h, w = img.shape[-3] - n + 1, img.shape[-2] - n + 1
    out = sum(float(k[j]) * img[..., j:j + h, :, :] for j in range(n))
    return sum(float(k[j]) * out[..., j:j + w, :] for j in range(n))


def ssim(a, b, data_range: float = 2.0) -> float:
    """Mean SSIM of ``(h, w, c)`` frames (Wang et al.'s constants, an 11x11
    Gaussian window of sigma 1.5); ``(t, h, w, c)`` clips average their
    frames."""
    if isinstance(a, torch.Tensor):
        a, b = a.double(), b.double()
    else:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    k = _gaussian_kernel()
    mu_a, mu_b = _filter2d(a, k), _filter2d(b, k)
    var_a = _filter2d(a * a, k) - mu_a ** 2
    var_b = _filter2d(b * b, k) - mu_b ** 2
    cov = _filter2d(a * b, k) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    per_frame = (num / den).reshape(-1, int(np.prod(num.shape[-3:]))).mean(-1)
    return float(per_frame.mean())


def corrupt_clip(clip: np.ndarray, kind: str, strength: float,
                 rng: np.random.RandomState) -> np.ndarray:
    """A graded corruption of a ``(t, h, w, c)`` clip in [-1, 1], strength in
    [0, 1]: ``"noise"`` (additive Gaussian of sigma ``strength``, clipped),
    ``"blur"`` (a box of width 1 + 2 round(4 strength), edge-padded) or
    ``"shuffle"`` (a cyclic shift of a ``strength`` share of the frames,
    each chosen frame displaced)."""
    if kind == "noise":
        out = clip + strength * rng.randn(*clip.shape).astype(clip.dtype)
        return np.clip(out, -1.0, 1.0)
    if kind == "blur":
        k = 1 + 2 * int(round(strength * 4))
        if k == 1:
            return clip.copy()
        pad = k // 2
        padded = np.pad(clip, ((0, 0), (pad, pad), (pad, pad), (0, 0)), "edge")
        csum = np.pad(np.cumsum(np.cumsum(padded, axis=1), axis=2),
                      ((0, 0), (1, 0), (1, 0), (0, 0)))
        h, w = clip.shape[1], clip.shape[2]
        out = (csum[:, k:k + h, k:k + w] - csum[:, :h, k:k + w]
               - csum[:, k:k + h, :w] + csum[:, :h, :w]) / (k * k)
        return out.astype(clip.dtype)
    if kind == "shuffle":
        t = clip.shape[0]
        n = max(2, int(round(strength * t))) if strength > 0 else 0
        out = clip.copy()
        if n:
            idx = np.sort(rng.choice(t, size=n, replace=False))
            out[idx] = out[np.roll(idx, 1)]
        return out
    raise ValueError(kind)
