"""Subpel interpolation for motion compensation (port of the batched half
of x265_mod_by_patman_tpu/ops/interp.py): 8-tap luma / 4-tap chroma,
two-stage 14-bit intermediates, exact integer rounding.

Every window read goes through K2 (`ops.cuda.gather.window_gather`),
which clamps each coordinate to the plane (HEVC edge extension).
The numpy goldens at the end of the module (the validation decoder's)
are copied unchanged from the reference."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants.hevc_tables import CHROMA_FILTER, LUMA_FILTER
from .cuda.gather import window_gather

LUMA_TAPS = 8
CHROMA_TAPS = 4
I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _taps(c_idx: int, device) -> torch.Tensor:
    t = (LUMA_FILTER if c_idx == 0 else CHROMA_FILTER).astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(t)).to(device)


def _gather_windows(ref, x0, y0, n: int, nt: int):
    """(B,) block origins -> (B, n+nt-1, n+nt-1) clamped windows."""
    half = nt // 2 - 1
    return window_gather(ref.contiguous(), (y0 - half).to(I32).contiguous(),
                         (x0 - half).to(I32).contiguous(), n + nt - 1)


def _filt_h(w_, t_, nt: int):
    out_len = w_.shape[2] - nt + 1
    acc = None
    for i in range(nt):
        term = t_[:, i, None, None] * w_[:, :, i:i + out_len]
        acc = term if acc is None else acc + term
    return acc


def _filt_v(w_, t_, nt: int):
    out_len = w_.shape[1] - nt + 1
    acc = None
    for i in range(nt):
        term = t_[:, i, None, None] * w_[:, i:i + out_len, :]
        acc = term if acc is None else acc + term
    return acc


def _mc_core(win, fx, fy, n: int, nt: int, c_idx: int, bit_depth: int):
    """Exact pixel-output MC on pre-gathered windows."""
    half = nt // 2 - 1
    shift1 = bit_depth - 8
    maxv = (1 << bit_depth) - 1
    taps = _taps(c_idx, win.device)
    tx = taps[fx.long()]
    ty = taps[fy.long()]
    center = win[:, half:half + n, half:half + n]
    off2 = 1 << (13 - bit_depth)
    sh2 = 14 - bit_depth
    h_acc = _filt_h(win[:, half:half + n, :], tx, nt)
    h_only = torch.clip(((h_acc >> shift1) + off2) >> sh2, 0, maxv)
    v_acc = _filt_v(win[:, :, half:half + n], ty, nt)
    v_only = torch.clip(((v_acc >> shift1) + off2) >> sh2, 0, maxv)
    tmp = _filt_h(win, tx, nt) >> shift1
    hv = torch.clip(((_filt_v(tmp, ty, nt) >> 6) + off2) >> sh2, 0, maxv)
    fx_nz = (fx != 0)[:, None, None]
    fy_nz = (fy != 0)[:, None, None]
    return torch.where(fx_nz & fy_nz, hv,
                       torch.where(fx_nz, h_only,
                                   torch.where(fy_nz, v_only, center)))


def mc_batch(ref, x0, y0, mv_x, mv_y, n: int, c_idx: int = 0,
             bit_depth: int = 8):
    """(B,) origins + (B,) MVs (quarter-pel luma / eighth-pel chroma) ->
    (B, n, n) predictions."""
    nt = LUMA_TAPS if c_idx == 0 else CHROMA_TAPS
    fb = 2 if c_idx == 0 else 3
    fx = mv_x & ((1 << fb) - 1)
    fy = mv_y & ((1 << fb) - 1)
    win = _gather_windows(ref, x0 + (mv_x >> fb), y0 + (mv_y >> fb), n, nt)
    return _mc_core(win, fx, fy, n, nt, c_idx, bit_depth)


def mc_batch_14(ref, x0, y0, mv_x, mv_y, n: int, c_idx: int = 0,
                bit_depth: int = 8):
    """MC keeping the 14-bit intermediate (spec predSamplesLX)."""
    nt = LUMA_TAPS if c_idx == 0 else CHROMA_TAPS
    fb = 2 if c_idx == 0 else 3
    half = nt // 2 - 1
    shift1 = bit_depth - 8
    fx = mv_x & ((1 << fb) - 1)
    fy = mv_y & ((1 << fb) - 1)
    win = _gather_windows(ref, x0 + (mv_x >> fb), y0 + (mv_y >> fb), n, nt)
    taps = _taps(c_idx, win.device)
    tx = taps[fx.long()]
    ty = taps[fy.long()]
    center = win[:, half:half + n, half:half + n] << (14 - bit_depth)
    h_only = _filt_h(win[:, half:half + n, :], tx, nt) >> shift1
    v_only = _filt_v(win[:, :, half:half + n], ty, nt) >> shift1
    tmp = _filt_h(win, tx, nt) >> shift1
    hv = _filt_v(tmp, ty, nt) >> 6
    fx_nz = (fx != 0)[:, None, None]
    fy_nz = (fy != 0)[:, None, None]
    return torch.where(fx_nz & fy_nz, hv,
                       torch.where(fx_nz, h_only,
                                   torch.where(fy_nz, v_only, center)))


def bi_combine(p0_14, p1_14, bit_depth: int = 8):
    """Default bi-prediction combine of two 14-bit predictions."""
    sh = 15 - bit_depth
    off = 1 << (sh - 1)
    return torch.clip((p0_14 + p1_14 + off) >> sh, 0, (1 << bit_depth) - 1)


def wp_apply_batch(pred14, w, o, denom: int, bit_depth: int = 8):
    """Weighted downshift of mc_batch_14 output (explicit uni weights)."""
    shift1 = 14 - bit_depth
    log2wd = denom + shift1
    rnd = 1 << (log2wd - 1)
    maxv = (1 << bit_depth) - 1
    v = (pred14.to(I32) * w + rnd) >> log2wd
    return torch.clip(v + o, 0, maxv).to(I32)


def wp_bi_combine(p0_14, p1_14, w0, o0, w1, o1, denom: int,
                  bit_depth: int = 8):
    """Weighted bi-prediction combine of two 14-bit predictions (explicit
    weights, spec 8.5.4.3.2)."""
    log2wd = denom + 14 - bit_depth
    maxv = (1 << bit_depth) - 1
    acc = (p0_14.to(I32) * w0 + p1_14.to(I32) * w1
           + ((o0 + o1 + 1) << log2wd))
    return torch.clip(acc >> (log2wd + 1), 0, maxv).to(I32)


# ---------------------------------------------------------------------------
# Golden scalar (numpy) functions of the validation decoder
# (decoder/decoder.py), copied unchanged from the reference module
# ---------------------------------------------------------------------------

def _filt1d_ref(win: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    """Correlate along axis with the given taps (valid mode), int64."""
    t = len(taps)
    out_len = win.shape[axis] - t + 1
    sl = [slice(None)] * win.ndim
    acc = np.zeros([out_len if a == axis else s
                    for a, s in enumerate(win.shape)], dtype=np.int64)
    for i in range(t):
        sl[axis] = slice(i, i + out_len)
        acc += int(taps[i]) * win[tuple(sl)].astype(np.int64)
    return acc


def mc_block_ref(ref: np.ndarray, x: int, y: int, mv_x: int, mv_y: int,
                 w: int, h: int, c_idx: int = 0,
                 bit_depth: int = 8) -> np.ndarray:
    """Golden MC of one block: ref plane, block origin (x, y), MV in
    quarter-pel luma units (eighth-pel chroma units for c_idx>0).

    Out-of-bounds reads use edge clamping (the reference pads planes;
    clamping is equivalent for border extension, picyuv.cpp padding).
    """
    taps_tbl = LUMA_FILTER if c_idx == 0 else CHROMA_FILTER
    nt = LUMA_TAPS if c_idx == 0 else CHROMA_TAPS
    frac_bits = 2 if c_idx == 0 else 3
    fx = mv_x & ((1 << frac_bits) - 1)
    fy = mv_y & ((1 << frac_bits) - 1)
    ix = x + (mv_x >> frac_bits)
    iy = y + (mv_y >> frac_bits)
    half = nt // 2 - 1
    ph, pw = ref.shape
    shift1 = bit_depth - 8
    maxv = (1 << bit_depth) - 1

    ys = np.clip(np.arange(iy - half, iy + h + nt - 1 - half), 0, ph - 1)
    xs = np.clip(np.arange(ix - half, ix + w + nt - 1 - half), 0, pw - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int64)   # (h+nt-1, w+nt-1)

    # final stage per spec 8.5.4.3 (default weighted pred): the 14-bit
    # intermediate is truncated to 14-bit FIRST, then rounded to B bits
    off2 = 1 << (13 - bit_depth)
    sh2 = 14 - bit_depth
    if fx == 0 and fy == 0:
        return win[half:half + h, half:half + w].astype(np.int32)
    if fy == 0:
        acc = _filt1d_ref(win[half:half + h, :], taps_tbl[fx], axis=1)
        return np.clip(((acc >> shift1) + off2) >> sh2,
                       0, maxv).astype(np.int32)
    if fx == 0:
        acc = _filt1d_ref(win[:, half:half + w], taps_tbl[fy], axis=0)
        return np.clip(((acc >> shift1) + off2) >> sh2,
                       0, maxv).astype(np.int32)
    tmp = _filt1d_ref(win, taps_tbl[fx], axis=1) >> shift1
    acc = _filt1d_ref(tmp, taps_tbl[fy], axis=0)
    return np.clip(((acc >> 6) + off2) >> sh2, 0, maxv).astype(np.int32)


def mc_block_ref_14(ref: np.ndarray, x: int, y: int, mv_x: int, mv_y: int,
                    w: int, h: int, c_idx: int = 0,
                    bit_depth: int = 8) -> np.ndarray:
    """Golden 14-bit MC (decoder bi path)."""
    taps_tbl = LUMA_FILTER if c_idx == 0 else CHROMA_FILTER
    nt = LUMA_TAPS if c_idx == 0 else CHROMA_TAPS
    frac_bits = 2 if c_idx == 0 else 3
    fx = mv_x & ((1 << frac_bits) - 1)
    fy = mv_y & ((1 << frac_bits) - 1)
    ix = x + (mv_x >> frac_bits)
    iy = y + (mv_y >> frac_bits)
    half = nt // 2 - 1
    ph, pw = ref.shape
    shift1 = bit_depth - 8
    ys = np.clip(np.arange(iy - half, iy + h + nt - 1 - half), 0, ph - 1)
    xs = np.clip(np.arange(ix - half, ix + w + nt - 1 - half), 0, pw - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int64)
    if fx == 0 and fy == 0:
        return (win[half:half + h, half:half + w]
                << (14 - bit_depth)).astype(np.int32)
    if fy == 0:
        acc = _filt1d_ref(win[half:half + h, :], taps_tbl[fx], axis=1)
        return (acc >> shift1).astype(np.int32)
    if fx == 0:
        acc = _filt1d_ref(win[:, half:half + w], taps_tbl[fy], axis=0)
        return (acc >> shift1).astype(np.int32)
    tmp = _filt1d_ref(win, taps_tbl[fx], axis=1) >> shift1
    return (_filt1d_ref(tmp, taps_tbl[fy], axis=0) >> 6).astype(np.int32)


def bi_combine_ref(p0_14: np.ndarray, p1_14: np.ndarray,
                   bit_depth: int = 8) -> np.ndarray:
    sh = 15 - bit_depth
    off = 1 << (sh - 1)
    return np.clip((p0_14.astype(np.int64) + p1_14 + off) >> sh, 0,
                   (1 << bit_depth) - 1).astype(np.int32)


def wp_apply_ref(pred14, w: int, o: int, denom: int, bit_depth: int = 8):
    """Golden: weight a 14-bit uni prediction down to pixels."""
    import numpy as np
    shift1 = 14 - bit_depth
    log2wd = denom + shift1
    rnd = 1 << (log2wd - 1)
    maxv = (1 << bit_depth) - 1
    return np.clip(((pred14.astype(np.int64) * w + rnd) >> log2wd) + o,
                   0, maxv).astype(np.int32)


def wp_bi_combine_ref(p0_14, p1_14, w0: int, o0: int, w1: int, o1: int,
                      denom: int, bit_depth: int = 8):
    """Golden weighted bidir combine (spec 8.5.4.3.2 explicit bi arm):
    ((p0*w0 + p1*w1 + ((o0+o1+1) << log2Wd)) >> (log2Wd + 1))."""
    import numpy as np
    log2wd = denom + 14 - bit_depth
    maxv = (1 << bit_depth) - 1
    acc = (p0_14.astype(np.int64) * w0 + p1_14.astype(np.int64) * w1 +
           ((o0 + o1 + 1) << log2wd))
    return np.clip(acc >> (log2wd + 1), 0, maxv).astype(np.int32)
