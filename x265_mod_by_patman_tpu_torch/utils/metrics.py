"""Quality metrics: PSNR and SSIM.

Analog of the reference's per-frame metric accumulation
(encoder/framefilter.cpp processPostRow:657 computes PSNR/SSIM on
finished recon rows; ssim via pixel.cpp ssim_4x4x2_core/ssim_end_4).
Whole-frame vectorized numpy here — metrics run on the host next to
entropy, off the device critical path.
"""
from __future__ import annotations

import math

import numpy as np


def psnr(ref: np.ndarray, rec: np.ndarray, bit_depth: int = 8) -> float:
    peak = (1 << bit_depth) - 1
    mse = np.mean((ref.astype(np.float64) - rec.astype(np.float64)) ** 2)
    if mse <= 0:
        return 99.99
    return 10.0 * math.log10(peak * peak / mse)


def global_psnr(mses, npix, bit_depth: int = 8) -> float:
    """x265's global PSNR: PSNR of the pooled MSE, not the mean of
    per-frame PSNRs (encoder.cpp printSummary analog)."""
    peak = (1 << bit_depth) - 1
    m = float(np.sum(mses)) / max(npix, 1)
    if m <= 0:
        return 99.99
    return 10.0 * math.log10(peak * peak / m)


def frame_mse(ref: np.ndarray, rec: np.ndarray) -> float:
    d = ref.astype(np.float64) - rec.astype(np.float64)
    return float(np.sum(d * d))


def ssim(ref: np.ndarray, rec: np.ndarray, bit_depth: int = 8) -> float:
    """Mean SSIM over 8x8 windows with stride 4 (the x264-heritage
    scheme the reference uses: ssim_4x4x2_core accumulates 4x4 sums,
    ssim_end combines 2x2 neighborhoods -> effective 8x8 window)."""
    L = (1 << bit_depth) - 1
    c1 = (0.01 * L) ** 2
    c2 = (0.03 * L) ** 2
    a = ref.astype(np.float64)
    b = rec.astype(np.float64)
    h, w = a.shape
    # 4x4 block sums
    h4, w4 = h // 4, w // 4
    if h4 < 2 or w4 < 2:
        return 1.0
    a = a[:h4 * 4, :w4 * 4].reshape(h4, 4, w4, 4)
    b = b[:h4 * 4, :w4 * 4].reshape(h4, 4, w4, 4)
    s1 = a.sum(axis=(1, 3))
    s2 = b.sum(axis=(1, 3))
    ss = (a * a).sum(axis=(1, 3)) + (b * b).sum(axis=(1, 3))
    s12 = (a * b).sum(axis=(1, 3))
    # combine 2x2 of 4x4 blocks -> 8x8 windows at stride 4
    def w2(x):
        return x[:-1, :-1] + x[:-1, 1:] + x[1:, :-1] + x[1:, 1:]
    n = 64.0
    m1, m2, sqs, cvs = w2(s1), w2(s2), w2(ss), w2(s12)
    var = sqs * n - (m1 * m1 + m2 * m2)
    cov = cvs * n - m1 * m2
    num = (2.0 * m1 * m2 + n * n * c1) * (2.0 * cov + n * n * c2)
    den = (m1 * m1 + m2 * m2 + n * n * c1) * (var + n * n * c2)
    return float(np.mean(num / den))
