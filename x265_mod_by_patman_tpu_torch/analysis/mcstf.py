"""Motion-compensated spatio-temporal pre-filter (MCSTF), port of
x265_mod_by_patman_tpu/analysis/mcstf.py on a torch device.

Analog of the reference's HM-style temporal filter
(common/temporalfilter.cpp: motionEstimationLuma + bilateralFilter,
applied at frameencoder.cpp:666): periodically-strong source frames are
denoised by blending motion-aligned neighbor SOURCES (+-2 frames) with
per-block error-adaptive weights before any encoding happens.

Only the alignment runs on the device: one integer full search of every
16x16 block of the frame (K1, `ops.me.full_search_batch`, at lambda 0)
and two clamped 16x16 window gathers (K2, `ops.cuda.gather`), the
aligned reference blocks and the source blocks.  The strength schedule,
the chroma MC and the blend are host numpy, copied unchanged.

Strength schedule matches the reference's GOP-based defaults:
every 16th frame 1.5, every other 8th frame 0.95, others unfiltered.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.cuda.gather import window_gather
from ..ops.me import full_search_batch

N = 16                     # filter block size (luma)
SEARCH = 12

I32 = torch.int32


def filter_strength(disp_idx: int) -> float:
    if disp_idx % 16 == 0:
        return 1.5
    if disp_idx % 8 == 0:
        return 0.95
    return 0.0


def _align_and_error(cur: torch.Tensor, ref: torch.Tensor, nby: int,
                     nbx: int):
    """Integer-pel 16x16 alignment of ref onto cur ((nby*N, nbx*N) int32
    planes on one device): returns the aligned plane (nby*N, nbx*N)
    int32, the per-block mean squared error (nby, nbx) float32 and the
    fullpel MVs fx, fy (nby, nbx) int32."""
    dev = cur.device
    bys, bxs = torch.meshgrid(torch.arange(nby, device=dev),
                              torch.arange(nbx, device=dev), indexing="ij")
    x0 = (bxs.reshape(-1) * N).to(I32)
    y0 = (bys.reshape(-1) * N).to(I32)
    z = torch.zeros_like(x0)
    mvx, mvy, _ = full_search_batch(ref, cur, x0, y0, z, z, 0, N, SEARCH)
    fx, fy = mvx >> 2, mvy >> 2
    # both gathers clamp per coordinate at the edge of the cut plane
    blocks = window_gather(ref, (y0 + fy).contiguous(),
                           (x0 + fx).contiguous(), N)
    org = window_gather(cur, y0, x0, N)
    err = _block_sse(blocks - org) / float(N * N)
    aligned = blocks.reshape(nby, nbx, N, N).permute(0, 2, 1, 3) \
        .reshape(nby * N, nbx * N)
    return aligned, err.reshape(nby, nbx), fx.reshape(nby, nbx), \
        fy.reshape(nby, nbx)


def _block_sse(d: torch.Tensor) -> torch.Tensor:
    """(B,) float32 sums of squares of the (B, N, N) int32 differences,
    as the reference's float32 mean sums them: in row-major order, one
    rounding per addition.  While every block's exact sum is below 2^24
    (always at 8 bits: 256 * 255^2) no addition rounds and the exact
    int64 sum is that value; deeper samples can go above it, and then
    the float32 additions run in the reference's order."""
    sq = (d.to(torch.int64) ** 2).reshape(d.shape[0], -1)
    exact = sq.sum(1)
    if d.shape[0] == 0 or int(exact.max()) < (1 << 24):
        return exact.to(torch.float32)
    sq = sq.to(torch.float32)
    acc = sq[:, 0].clone()
    for k in range(1, sq.shape[1]):
        acc = acc + sq[:, k]
    return acc


def _mc_chroma(ref_c, fx, fy):
    """Gather chroma blocks with halved luma MVs (8x8 blocks)."""
    h, w = ref_c.shape
    nby, nbx = fx.shape
    n = N // 2
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    gy = np.clip(bys[..., None, None] * n + (fy[..., None, None] >> 1)
                 + np.arange(n)[None, None, :, None], 0, h - 1)
    gx = np.clip(bxs[..., None, None] * n + (fx[..., None, None] >> 1)
                 + np.arange(n)[None, None, None, :], 0, w - 1)
    return ref_c[gy, gx].transpose(0, 2, 1, 3).reshape(h, w)


def _plane(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def mcstf_filter(frames: Sequence[Tuple], center: int, strength: float,
                 qp: int = 32, bit_depth: int = 8, device="cuda"):
    """Filter frames[center] using the other frames as aligned neighbors,
    aligning on `device`.  frames: (y, u, v) tuples (uint planes,
    CTU-padded or raw with /16 luma dims).  Returns new (y, u, v)."""
    if strength <= 0 or len(frames) < 2:
        return frames[center]
    cy, cu, cv = frames[center]
    h, w = cy.shape[0] & ~15, cy.shape[1] & ~15
    nby, nbx = h // N, w // N
    cur = _plane(cy[:h, :w], device)
    maxv = (1 << bit_depth) - 1

    # HM bilateral sigma: scales with the quantizer step and strength
    sigma_sq = (2.0 ** ((qp - 12) / 3.0)) * 9.0
    num_y = cy[:h, :w].astype(np.float64).copy()
    den_y = np.ones((h, w))
    num_u = cu[:h // 2, :w // 2].astype(np.float64).copy()
    num_v = cv[:h // 2, :w // 2].astype(np.float64).copy()
    den_c = np.ones((h // 2, w // 2))

    for i, (ry, ru, rv) in enumerate(frames):
        if i == center:
            continue
        aligned, err, fx, fy = _align_and_error(
            cur, _plane(ry[:h, :w], device), nby, nbx)
        aligned = aligned.cpu().numpy().astype(np.float64)
        err = err.cpu().numpy().astype(np.float64)
        fx = fx.cpu().numpy()
        fy = fy.cpu().numpy()
        dist = abs(i - center)
        # reference bilateralFilter weight: base strength falls with
        # temporal distance, gated by block alignment error
        wb = strength * 0.4 / dist * np.exp(-err / (2.0 * sigma_sq))
        wb = np.where(err > 2.0 * sigma_sq, 0.0, wb)    # misaligned/cut
        wpix = np.repeat(np.repeat(wb, N, axis=0), N, axis=1)
        num_y += wpix * aligned
        den_y += wpix
        wc = np.repeat(np.repeat(wb, N // 2, 0), N // 2, 1)
        num_u += wc * _mc_chroma(ru[:h // 2, :w // 2].astype(np.float64),
                                 fx, fy)
        num_v += wc * _mc_chroma(rv[:h // 2, :w // 2].astype(np.float64),
                                 fx, fy)
        den_c += wc

    dt = cy.dtype
    oy = cy.copy()
    oy[:h, :w] = np.clip(np.rint(num_y / den_y), 0, maxv).astype(dt)
    ou = cu.copy()
    ou[:h // 2, :w // 2] = np.clip(np.rint(num_u / den_c), 0,
                                   maxv).astype(dt)
    ov = cv.copy()
    ov[:h // 2, :w // 2] = np.clip(np.rint(num_v / den_c), 0,
                                   maxv).astype(dt)
    return (oy, ou, ov)
