"""Subpel interpolation for motion compensation (port of the batched half
of x265_mod_by_patman_tpu/ops/interp.py): 8-tap luma / 4-tap chroma,
two-stage 14-bit intermediates, exact integer rounding.

Every window read goes through K2 (`ops.cuda.gather.window_gather`),
which clamps each coordinate to the plane (HEVC edge extension)."""
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
