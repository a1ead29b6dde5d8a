"""Z-scan addressing and neighbor-sample availability (spec 6.4.1).

Analog of x265's CUGeom/z-order geometry tables (source/common/cudata.h:81
calcCTUGeoms, g_zscanToRaster) — here computed as vectorized numpy maps so
availability masks for whole frames of blocks are built in one shot and
cached per (frame size, block size).
"""
from __future__ import annotations

import functools

import numpy as np


def morton(y: np.ndarray, x: np.ndarray, bits: int) -> np.ndarray:
    """Interleave y/x bit-planes (y major) -> z-order index within a CTU."""
    out = np.zeros_like(x)
    for b in range(bits):
        out |= ((x >> b) & 1) << (2 * b)
        out |= ((y >> b) & 1) << (2 * b + 1)
    return out


def zscan_index(x: np.ndarray, y: np.ndarray, log2_ctu: int,
                pic_width_in_ctus: int) -> np.ndarray:
    """Frame-wide z-scan index of the 4x4 minblock containing luma sample
    (x, y): CTU raster index * minblocks-per-CTU + in-CTU Morton index."""
    x = np.asarray(x)
    y = np.asarray(y)
    ctu = (y >> log2_ctu) * pic_width_in_ctus + (x >> log2_ctu)
    bits = log2_ctu - 2
    lx = (x >> 2) & ((1 << bits) - 1)
    ly = (y >> 2) & ((1 << bits) - 1)
    return ctu * (1 << (2 * bits)) + morton(ly, lx, bits)


def zscan_scalar(x: int, y: int, log2_ctu: int,
                 pic_width_in_ctus: int) -> int:
    """Pure-int scalar zscan_index (hot in merge/AMVP derivation)."""
    ctu = (y >> log2_ctu) * pic_width_in_ctus + (x >> log2_ctu)
    bits = log2_ctu - 2
    mask = (1 << bits) - 1
    lx = (x >> 2) & mask
    ly = (y >> 2) & mask
    m = 0
    for b in range(bits):
        m |= ((lx >> b) & 1) << (2 * b)
        m |= ((ly >> b) & 1) << (2 * b + 1)
    return ctu * (1 << (2 * bits)) + m


def s_vector_coords(x0: int, y0: int, n: int):
    """Sample coordinates of the S reference vector (length 4N+1) for a
    block with top-left (x0, y0):  S[0..2N-1] left column bottom-up,
    S[2N] corner, S[2N+1..4N] top row."""
    ks = np.arange(4 * n + 1)
    xs = np.where(ks <= 2 * n, x0 - 1, x0 + (ks - (2 * n + 1)))
    ys = np.where(ks < 2 * n, y0 + 2 * n - 1 - ks,
                  np.where(ks == 2 * n, y0 - 1, y0 - 1))
    return xs, ys


@functools.lru_cache(maxsize=None)
def frame_avail_masks(width: int, height: int, block: int, log2_ctu: int,
                      comp_shift: int = 0, slice_tops: tuple = (),
                      comp_shift_y: int = None):
    """Availability masks of the S vector for every block of a frame.

    width/height: LUMA picture dimensions; block: block size in THIS
    component's samples; comp_shift: 1 for 4:2:0 chroma (coords scale x2 to
    luma for the z-scan test); comp_shift_y: vertical shift when it
    differs (4:2:2 chroma: x shift 1, y shift 0); slice_tops: LUMA rows
    where slices start — samples in an earlier slice are unavailable for
    prediction (spec 6.4.1 same-slice condition).

    Returns (blocks_y, blocks_x, 4*block+1) bool array.
    """
    sx = comp_shift
    sy = comp_shift if comp_shift_y is None else comp_shift_y
    cw = width >> sx
    ch = height >> sy
    bx = cw // block
    by = ch // block
    w_ctus = -(-width // (1 << log2_ctu))
    n = block
    masks = np.zeros((by, bx, 4 * n + 1), dtype=bool)
    for j in range(by):
        for i in range(bx):
            x0, y0 = i * n, j * n
            xs, ys = s_vector_coords(x0, y0, n)
            inside = (xs >= 0) & (ys >= 0) & (xs < cw) & (ys < ch)
            # z-scan comparison in luma coordinates
            lx = np.clip(xs, 0, cw - 1) << sx
            ly = np.clip(ys, 0, ch - 1) << sy
            z = zscan_index(lx, ly, log2_ctu, w_ctus)
            z0 = zscan_index(np.array(x0 << sx),
                             np.array(y0 << sy), log2_ctu, w_ctus)
            avail = inside & (z < z0)
            if slice_tops:
                tops = np.asarray(slice_tops)
                top = tops[np.searchsorted(tops, y0 << sy,
                                           "right") - 1]
                avail &= ly >= top
            masks[j, i] = avail
    return masks


@functools.lru_cache(maxsize=None)
def ctu_wavefront_order(n_ctu_x: int, n_ctu_y: int):
    """CTU coordinates grouped by wavefront diagonal d = cx + 2*cy
    (the WPP dependency schedule, reference doc/reST/threading.rst:40-60).

    Returns list of (cx_array, cy_array) per wave.
    """
    waves = []
    n_waves = n_ctu_x + 2 * (n_ctu_y - 1)
    for d in range(n_waves):
        cys = np.arange(n_ctu_y)
        cxs = d - 2 * cys
        sel = (cxs >= 0) & (cxs < n_ctu_x)
        if sel.any():
            waves.append((cxs[sel].astype(np.int32),
                          cys[sel].astype(np.int32)))
    return waves
