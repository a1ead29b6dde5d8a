"""Batched intra prediction (port of the batched half of
x265_mod_by_patman_tpu/ops/intra.py): reference substitution/filtering,
all-35-modes prediction and one-selected-mode prediction.  The numpy
goldens at the end of the module (the validation decoder's) are copied
unchanged from the reference."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants.hevc_tables import (
    INTRA_INV_ANGLE, INTRA_PRED_ANGLE, intra_filter_flag)

I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _angular_tables(log2_size: int):
    """Per-mode gather/weight tables (copied from the reference):
    gather_idx (33, 3N+2), pix_idx (33, N), pix_fact (33, N),
    is_vertical (33,)."""
    n = 1 << log2_size
    gather = np.zeros((33, 3 * n + 2), dtype=np.int32)
    pix_idx = np.zeros((33, n), dtype=np.int32)
    pix_fact = np.zeros((33, n), dtype=np.int32)
    vert = np.zeros(33, dtype=bool)
    for m33 in range(33):
        mode = m33 + 2
        angle = int(INTRA_PRED_ANGLE[m33])
        vertical = mode >= 18
        vert[m33] = vertical
        if vertical:
            def base_ix(x):
                return 2 * n + 1 + min(x, 2 * n - 1)

            def side_ix(y):
                return 2 * n - 1 - min(y, 2 * n - 1)
        else:
            def base_ix(x):
                return 2 * n - 1 - min(x, 2 * n - 1)

            def side_ix(y):
                return 2 * n + 1 + min(y, 2 * n - 1)
        g = np.zeros(3 * n + 2, dtype=np.int32)
        g[n] = 2 * n
        for x in range(2 * n):
            g[n + 1 + x] = base_ix(x)
        g[3 * n + 1] = base_ix(2 * n - 1)
        if angle < 0:
            inv = int(INTRA_INV_ANGLE[mode - 11])
            low = (n * angle) >> 5
            for x in range(-1, low - 1, -1):
                g[n + x] = side_ix(((x * inv + 128) >> 8) - 1)
        gather[m33] = g
        for k in range(n):
            pos = (k + 1) * angle
            pix_idx[m33, k] = pos >> 5
            pix_fact[m33, k] = pos & 31
    return gather, pix_idx, pix_fact, vert


@functools.lru_cache(maxsize=None)
def _tables_dev(log2_size: int, device, c_idx_filter: bool):
    gather, pix_idx, pix_fact, vert = _angular_tables(log2_size)
    n = 1 << log2_size
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    filt35 = np.array([intra_filter_flag(m, log2_size) and c_idx_filter
                       for m in range(35)])
    # angular sample positions per (mode, k, x): j0 = n+1+idx+x, j1 = j0+1
    k_idx = pix_idx[:, :, None] + np.arange(n)[None, None, :]
    j0 = np.clip(n + 1 + k_idx, 0, 3 * n + 1)
    j1 = np.clip(j0 + 1, 0, 3 * n + 1)
    return {"gather": t(gather.astype(np.int64)),
            "fact": t(pix_fact), "vert": t(vert),
            "j0": t(j0.astype(np.int64)), "j1": t(j1.astype(np.int64)),
            "filt35": t(filt35)}


@functools.lru_cache(maxsize=None)
def _ref_offsets(n: int, device):
    """(dx, dy) offsets of the 4n+1 S-vector samples (bottom-left column
    up, corner, top row) and arange(n), on `device`."""
    ks = np.arange(4 * n + 1)
    k_x = np.where(ks <= 2 * n, -1, ks - (2 * n + 1))
    k_y = np.where(ks < 2 * n, 2 * n - 1 - ks, -1)
    return (torch.from_numpy(k_x).to(device), torch.from_numpy(k_y).to(device),
            torch.arange(n, device=device))


def gather_ref_samples(plane, x0, y0, n: int):
    """(B, 4n+1) raw S-vector samples around (B,) n x n blocks at pixel
    coords (x0, y0), coordinates clamped to the plane."""
    hp, wp = plane.shape
    k_x, k_y, _ = _ref_offsets(n, plane.device)
    xs = torch.clip(x0[:, None] + k_x[None], 0, wp - 1)
    ys = torch.clip(y0[:, None] + k_y[None], 0, hp - 1)
    return plane[ys, xs]


def block_index(x0, y0, n: int, h: int, w: int):
    """Clamped (gy, gx) index grids of (B,) n x n blocks."""
    ar = _ref_offsets(n, x0.device)[2]
    gy = torch.clip(y0[:, None, None] + ar[None, :, None], 0, h - 1)
    gx = torch.clip(x0[:, None, None] + ar[None, None, :], 0, w - 1)
    return gy, gx


def _planar_dc(su, sf, log2_size: int, c_idx: int, use_f: bool,
               bit_depth: int):
    n = 1 << log2_size
    dev = su.device
    left_u = su[:, :2 * n].flip(1)
    top_u = su[:, 2 * n + 1:]
    s_pl = sf if (use_f and intra_filter_flag(0, log2_size)) else su
    left_p = s_pl[:, :2 * n].flip(1)
    top_p = s_pl[:, 2 * n + 1:]
    x = torch.arange(n, device=dev, dtype=I32)[None, None, :]
    y = torch.arange(n, device=dev, dtype=I32)[None, :, None]
    planar = ((n - 1 - x) * left_p[:, :n][:, :, None]
              + (x + 1) * top_p[:, n][:, None, None]
              + (n - 1 - y) * top_p[:, :n][:, None, :]
              + (y + 1) * left_p[:, n][:, None, None]
              + n) >> (log2_size + 1)
    dc = (top_u[:, :n].sum(1, dtype=I32) + left_u[:, :n].sum(1, dtype=I32)
          + n) >> (log2_size + 1)
    dcp = dc[:, None, None].expand(dc.shape[0], n, n).clone()
    if c_idx == 0 and n < 32:
        dcp[:, 0, :] = (top_u[:, :n] + 3 * dc[:, None] + 2) >> 2
        dcp[:, 1:, 0] = (left_u[:, 1:n] + 3 * dc[:, None] + 2) >> 2
        dcp[:, 0, 0] = (left_u[:, 0] + 2 * dc + top_u[:, 0] + 2) >> 2
    return planar, dcp


def _edge_rows(su, n: int, maxval: int):
    left_u = su[:, :2 * n].flip(1)
    corner_u = su[:, 2 * n]
    top_u = su[:, 2 * n + 1:]
    col0 = torch.clip(top_u[:, :1] + ((left_u[:, :n] - corner_u[:, None])
                                      >> 1), 0, maxval)
    row0 = torch.clip(left_u[:, :1] + ((top_u[:, :n] - corner_u[:, None])
                                       >> 1), 0, maxval)
    return col0, row0


def intra_pred_all_batch(s_unfilt, s_filt, log2_size: int, c_idx: int = 0,
                         bit_depth: int = 8):
    """All 35 modes: (B, 4N+1) x2 -> (B, 35, N, N) int32."""
    n = 1 << log2_size
    maxval = (1 << bit_depth) - 1
    su = s_unfilt.to(I32)
    sf = s_filt.to(I32)
    b = su.shape[0]
    tb = _tables_dev(log2_size, su.device, c_idx == 0)
    filt33 = tb["filt35"][2:]
    s_sel = torch.where(filt33[None, :, None], sf[:, None, :],
                        su[:, None, :])                      # (B,33,4N+1)
    emain = torch.gather(s_sel, 2, tb["gather"][None].expand(b, -1, -1))
    jj0 = tb["j0"].reshape(33, n * n)[None].expand(b, -1, -1)
    jj1 = tb["j1"].reshape(33, n * n)[None].expand(b, -1, -1)
    p0 = torch.gather(emain, 2, jj0).reshape(b, 33, n, n)
    p1 = torch.gather(emain, 2, jj1).reshape(b, 33, n, n)
    f = tb["fact"][:, :, None]
    ang = ((32 - f)[None] * p0 + f[None] * p1 + 16) >> 5
    ang = torch.where(tb["vert"][None, :, None, None], ang,
                      ang.transpose(2, 3))
    if c_idx == 0 and n < 32:
        col0, row0 = _edge_rows(su, n, maxval)
        ang = ang.clone()
        ang[:, 24, :, 0] = col0
        ang[:, 8, 0, :] = row0
    planar, dcp = _planar_dc(su, sf, log2_size, c_idx, c_idx == 0,
                             bit_depth)
    return torch.cat([planar[:, None], dcp[:, None], ang], 1)


def intra_pred_select_batch(s_unfilt, s_filt, modes, log2_size: int,
                            c_idx: int = 0, bit_depth: int = 8,
                            filt_chroma: bool = False):
    """One selected mode per block: (B, 4N+1) x2, (B,) -> (B, N, N)."""
    n = 1 << log2_size
    maxval = (1 << bit_depth) - 1
    use_f = c_idx == 0 or filt_chroma
    su = s_unfilt.to(I32)
    sf = s_filt.to(I32)
    tb = _tables_dev(log2_size, su.device, use_f)
    ml = modes.long()
    m33 = torch.clip(ml - 2, 0, 32)
    use_filt = tb["filt35"][ml]
    s_sel = torch.where(use_filt[:, None], sf, su)
    emain = torch.gather(s_sel, 1, tb["gather"][m33])
    j0 = tb["j0"][m33].reshape(-1, n * n)
    j1 = tb["j1"][m33].reshape(-1, n * n)
    p0 = torch.gather(emain, 1, j0).reshape(-1, n, n)
    p1 = torch.gather(emain, 1, j1).reshape(-1, n, n)
    f = tb["fact"][m33][:, :, None]
    ang = ((32 - f) * p0 + f * p1 + 16) >> 5
    ang = torch.where(tb["vert"][m33][:, None, None], ang,
                      ang.transpose(1, 2))
    if c_idx == 0 and n < 32:
        col0, row0 = _edge_rows(su, n, maxval)
        a26 = ang.clone()
        a26[:, :, 0] = col0
        ang = torch.where((modes == 26)[:, None, None], a26, ang)
        a10 = ang.clone()
        a10[:, 0, :] = row0
        ang = torch.where((modes == 10)[:, None, None], a10, ang)
    planar, dcp = _planar_dc(su, sf, log2_size, c_idx, use_f, bit_depth)
    return torch.where((modes == 0)[:, None, None], planar,
                       torch.where((modes == 1)[:, None, None], dcp, ang))


def substitute_filter_batch(s_raw, avail, log2_size: int,
                            bit_depth: int = 8, strong: bool = False):
    """Reference substitution (spec 8.4.4.2.2) + [1 2 1] smoothing (and
    the 32x32 strong smoothing).  Returns (s_unfilt, s_filt) int32."""
    slen = s_raw.shape[-1]
    dev = s_raw.device
    s = s_raw.to(I32)
    iota = torch.arange(slen, device=dev, dtype=torch.int64)
    idx = torch.where(avail, iota[None], -1)
    fill = torch.cummax(idx, dim=1).values
    first = torch.argmax(avail.to(torch.uint8), dim=1)
    take = torch.where(fill >= 0, fill, first[:, None])
    s_sub = torch.gather(s, 1, take)
    mid = 1 << (bit_depth - 1)
    any_avail = avail.any(1, keepdim=True)
    s_sub = torch.where(any_avail, s_sub, mid)
    sm = (s_sub[:, :-2] + 2 * s_sub[:, 1:-1] + s_sub[:, 2:] + 2) >> 2
    s_filt = torch.cat([s_sub[:, :1], sm, s_sub[:, -1:]], 1)
    if strong and log2_size == 5:
        n = 1 << log2_size
        bl = s_sub[:, 0]
        corner = s_sub[:, 2 * n]
        tr = s_sub[:, 4 * n]
        thresh = 1 << (bit_depth - 5)
        cond = (torch.abs(corner + tr - 2 * s_sub[:, 3 * n]) < thresh) & \
            (torch.abs(corner + bl - 2 * s_sub[:, n]) < thresh)
        k = iota.to(I32)
        y = 2 * n - 1 - k
        x = k - 2 * n - 1
        left_lin = ((63 - y)[None] * corner[:, None]
                    + (y + 1)[None] * bl[:, None] + 32) >> 6
        top_lin = ((63 - x)[None] * corner[:, None]
                   + (x + 1)[None] * tr[:, None] + 32) >> 6
        lin = torch.where(((k >= 1) & (k < 2 * n))[None], left_lin,
                          torch.where(((k > 2 * n) & (k < 4 * n))[None],
                                      top_lin, s_sub))
        s_filt = torch.where(cond[:, None], lin, s_filt)
    return s_sub, s_filt


# ---------------------------------------------------------------------------
# Golden scalar (numpy) functions of the validation decoder
# (decoder/decoder.py), copied unchanged from the reference module
# ---------------------------------------------------------------------------

def substitute_refs(samples: np.ndarray, available: np.ndarray,
                    bit_depth: int = 8) -> np.ndarray:
    """Reference sample substitution over the S vector (spec 8.4.4.2.2):
    scan from bottom-left (S[0]) to top-right (S[4N]); unavailable samples
    inherit the previous value in scan order."""
    s = samples.astype(np.int32).copy()
    if not available.any():
        s[:] = 1 << (bit_depth - 1)
        return s
    if not available[0]:
        first = np.argmax(available)
        s[0] = s[first]
    for k in range(1, len(s)):
        if not available[k]:
            s[k] = s[k - 1]
    return s


def filter_refs(s: np.ndarray, log2_size: int, strong: bool = False,
                bit_depth: int = 8) -> np.ndarray:
    """[1 2 1]/4 smoothing of the S vector; optional strong (linear) mode
    for 32x32 (spec 8.4.4.2.3)."""
    n = 1 << log2_size
    if strong and log2_size == 5:
        bl, corner, tr = int(s[0]), int(s[2 * n]), int(s[4 * n])
        out = s.astype(np.int32).copy()
        for i in range(1, 2 * n):          # left: S[k]=p[-1][2N-1-k]
            y = 2 * n - 1 - i
            out[i] = ((63 - y) * corner + (y + 1) * bl + 32) >> 6
        for x in range(2 * n - 1):
            out[2 * n + 1 + x] = ((63 - x) * corner + (x + 1) * tr + 32) >> 6
        return out
    out = s.astype(np.int32).copy()
    out[1:-1] = (s[:-2].astype(np.int32) + 2 * s[1:-1] + s[2:] + 2) >> 2
    return out


def strong_smoothing_condition(s: np.ndarray, log2_size: int,
                               bit_depth: int = 8) -> bool:
    if log2_size != 5:
        return False
    n = 1 << log2_size
    corner = int(s[2 * n])
    thresh = 1 << (bit_depth - 5)
    top_ok = abs(corner + int(s[4 * n]) - 2 * int(s[3 * n])) < thresh
    left_ok = abs(corner + int(s[0]) - 2 * int(s[n])) < thresh
    return top_ok and left_ok


def _refs_from_s(s: np.ndarray, n: int):
    left = s[2 * n - 1::-1]        # p[-1][y], y = 0..2N-1
    corner = int(s[2 * n])
    top = s[2 * n + 1:]            # p[x][-1], x = 0..2N-1
    return left, corner, top


def intra_pred_ref(mode: int, s: np.ndarray, log2_size: int, c_idx: int = 0,
                   bit_depth: int = 8) -> np.ndarray:
    """Golden prediction of one mode from a (substituted, pre-filtered as
    appropriate) S vector.  Returns (N, N) int array [y][x]."""
    n = 1 << log2_size
    left, corner, top = _refs_from_s(s.astype(np.int32), n)
    maxval = (1 << bit_depth) - 1

    if mode == 0:  # planar
        x = np.arange(n)[None, :]
        y = np.arange(n)[:, None]
        pred = ((n - 1 - x) * left[y] + (x + 1) * top[n]
                + (n - 1 - y) * top[x] + (y + 1) * left[n] + n) >> (log2_size + 1)
        return pred

    if mode == 1:  # DC
        dc = (int(top[:n].sum()) + int(left[:n].sum()) + n) >> (log2_size + 1)
        pred = np.full((n, n), dc, dtype=np.int32)
        if c_idx == 0 and n < 32:
            pred[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
            pred[0, 1:] = (top[1:n] + 3 * dc + 2) >> 2
            pred[1:, 0] = (left[1:n] + 3 * dc + 2) >> 2
        return pred

    angle = int(INTRA_PRED_ANGLE[mode - 2])
    vertical = mode >= 18
    main = np.zeros(3 * n + 2, dtype=np.int32)   # ref[-N .. 2N+1]
    base, side = (top, left) if vertical else (left, top)
    main[n] = corner
    main[n + 1: 3 * n + 1] = base[:2 * n]
    main[3 * n + 1] = base[2 * n - 1]            # clamp pad
    if angle < 0:
        inv = int(INTRA_INV_ANGLE[mode - 11]) if 11 <= mode <= 25 else 0
        low = (n * angle) >> 5
        for x in range(-1, low - 1, -1):
            idx = ((x * inv + 128) >> 8) - 1
            main[n + x] = side[min(idx, 2 * n - 1)]
    pred = np.zeros((n, n), dtype=np.int32)
    for k in range(n):                            # k = y (vert) or x (hor)
        pos = (k + 1) * angle
        i_idx = pos >> 5
        i_fact = pos & 31
        idx0 = n + 1 + i_idx + np.arange(n)
        row = ((32 - i_fact) * main[idx0] + i_fact * main[idx0 + 1] + 16) >> 5
        if vertical:
            pred[k, :] = row
        else:
            pred[:, k] = row
    # DPCM edge filters for exactly-horizontal/vertical modes (luma, <32)
    if c_idx == 0 and n < 32:
        if mode == 26:
            pred[:, 0] = np.clip(top[0] + ((left[:n] - corner) >> 1), 0, maxval)
        elif mode == 10:
            pred[0, :] = np.clip(left[0] + ((top[:n] - corner) >> 1), 0, maxval)
    return pred


def predict_block_ref(mode: int, s_unfilt: np.ndarray, log2_size: int,
                      c_idx: int = 0, bit_depth: int = 8,
                      strong_smoothing: bool = False,
                      filt_chroma: bool = False) -> np.ndarray:
    """Golden full path: choose filtered/unfiltered refs per spec, then
    predict.  filt_chroma: 4:4:4 chroma filters its reference samples
    like luma (spec 8.4.4.2.3: cIdx==0 || ChromaArrayType==3); the
    luma-only DC/edge post-filters stay off for chroma either way."""
    use_filter = (c_idx == 0 or filt_chroma) and \
        intra_filter_flag(mode, log2_size)
    if use_filter:
        strong = strong_smoothing and \
            strong_smoothing_condition(s_unfilt, log2_size, bit_depth)
        s = filter_refs(s_unfilt, log2_size, strong, bit_depth)
    else:
        s = s_unfilt
    return intra_pred_ref(mode, s, log2_size, c_idx, bit_depth)
