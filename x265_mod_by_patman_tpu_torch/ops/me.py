"""Motion estimation: batched integer full search + subpel refinement
(port of x265_mod_by_patman_tpu/ops/me.py).

The integer full search is K1 (`ops.cuda.full_search`): on the card one
fused kernel reads the window and the source straight from the planes
and returns each block's best MV and cost; on the CPU its plain chain
(window gather, SAD grid, lambda * mv_bits, first-minimum argmin) runs,
as the reference's full_search_batch_pallas composes it.  The
reference's lane chunking and Pallas switches are TPU-only and have no
counterpart.  mv_bits_np (the numpy golden ops/sea.py's golden calls) is
copied unchanged."""
from __future__ import annotations

import numpy as np
import torch

from .cost import satd_batch
from .cuda.full_search import full_search, mv_bits  # noqa: F401
from .cuda.gather import window_gather
from .interp import LUMA_TAPS, _mc_core

I32 = torch.int32


def mv_bits_np(dx, dy):
    bx = 2 * np.ceil(np.log2(np.abs(dx).astype(np.float64) + 1.0)) + 1
    by = 2 * np.ceil(np.log2(np.abs(dy).astype(np.float64) + 1.0)) + 1
    return (bx + by).astype(np.int64)


def _org_blocks(orig, x0, y0, n: int):
    """(B, n, n) int32 source blocks at (x0, y0), edge-clamped (K2)."""
    return window_gather(orig.to(I32).contiguous(), y0.to(I32).contiguous(),
                         x0.to(I32).contiguous(), n)


def full_search_batch(ref, orig, x0, y0, pred_mv_x, pred_mv_y,
                      lambda_x256, n: int, search_range: int = 16,
                      center_x=None, center_y=None):
    """Integer full search for (B,) blocks at (x0, y0) over a +-r window,
    optionally around (B,) FULLPEL window centres (HME seeds; the MVs
    include the shift).  Returns (mv_x, mv_y, cost) int32 (B,), MVs in
    QPEL units; cost = SAD + (lambda_x256 * bits) >> 8, first minimum in
    (dy, dx) row-major order."""
    c = lambda a: None if a is None else a.to(I32).contiguous()
    return full_search(c(ref), c(orig), c(x0), c(y0), c(pred_mv_x),
                       c(pred_mv_y), lambda_x256, n, search_range,
                       c(center_x), c(center_y))


def half_res(a):
    """2x2 box average with rounding: the planes of the HME tiers."""
    return ((a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]
             + 2) >> 2).contiguous()


def hme_upsample(v, gh: int, gw: int, nby: int, nbx: int):
    """(gh * gw,) seeds of a half-resolution block grid -> the (nby *
    nbx,) grid: each seed covers a 2x2 group, cropped or edge-extended
    at the grid's end."""
    iy = torch.clamp(torch.arange(nby, device=v.device) // 2, max=gh - 1)
    ix = torch.clamp(torch.arange(nbx, device=v.device) // 2, max=gw - 1)
    return v.reshape(gh, gw)[iy[:, None], ix[None, :]].reshape(-1)


_OFFS8 = [(0, 0), (0, -2), (0, 2), (-2, 0), (2, 0),
          (-2, -2), (2, -2), (-2, 2), (2, 2)]
_OFFS4 = [(0, 0), (0, -1), (0, 1), (-1, 0), (1, 0),
          (-1, -1), (1, -1), (-1, 1), (1, 1)]


def subpel_refine_batch(ref, orig, x0, y0, mv_x, mv_y, pred_mv_x,
                        pred_mv_y, lambda_x256, n: int,
                        bit_depth: int = 8, subme: int = 2, org=None):
    """Half- then quarter-pel refinement with SATD (see the reference).
    One superset window per block (K2) covers every candidate.  `org`:
    the (B, n, n) source blocks, when the caller already holds them."""
    nt = LUMA_TAPS
    half = nt // 2 - 1
    if org is None:
        org = _org_blocks(orig, x0, y0, n)
    sz = n + nt + 1
    base_int_x = mv_x >> 2
    base_int_y = mv_y >> 2
    win9 = window_gather(ref.contiguous(),
                         (y0 + base_int_y - half - 1).to(I32).contiguous(),
                         (x0 + base_int_x - half - 1).to(I32).contiguous(),
                         sz)
    we = n + nt - 1

    def cost_at(mx, my):
        rx = (mx >> 2) - base_int_x + 1
        ry = (my >> 2) - base_int_y + 1
        rows = torch.where((ry == 0)[:, None, None], win9[:, 0:we, :],
                           torch.where((ry == 1)[:, None, None],
                                       win9[:, 1:we + 1, :],
                                       win9[:, 2:we + 2, :]))
        wc = torch.where((rx == 0)[:, None, None], rows[:, :, 0:we],
                         torch.where((rx == 1)[:, None, None],
                                     rows[:, :, 1:we + 1],
                                     rows[:, :, 2:we + 2]))
        pred = _mc_core(wc, mx & 3, my & 3, n, nt, 0, bit_depth)
        satd = satd_batch(org, pred)
        bits = mv_bits(mx - pred_mv_x, my - pred_mv_y)
        return satd + ((lambda_x256 * bits) >> 8)

    def refine(mx, my, offs):
        best = torch.full(mx.shape, -1, dtype=I32, device=mx.device)
        bx, by = mx, my
        for (ox, oy) in offs:
            cx = mx + ox
            cy = my + oy
            c = cost_at(cx, cy)
            upd = (best < 0) | (c < best)
            best = torch.where(upd, c, best)
            bx = torch.where(upd, cx, bx)
            by = torch.where(upd, cy, by)
        return bx, by, best

    if subme <= 0:
        return mv_x, mv_y, cost_at(mv_x, mv_y)
    mx, my, cost = refine(mv_x, mv_y, _OFFS8)
    if subme >= 2:
        mx, my, cost = refine(mx, my, _OFFS4)
    return mx, my, cost
