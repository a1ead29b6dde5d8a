"""In-loop deblocking filter (spec 8.7.2), port of
x265_mod_by_patman_tpu/ops/deblock.py.

The boundary-strength map builders are host numpy functions copied
unchanged from the reference (its module imports jax, so they cannot be
imported from there), as are the numpy golden filters of the validation
decoder at the end of the module; the batched V-then-H edge passes run
in torch.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants.hevc_tables import (
    CHROMA_QP_TABLE, DEBLOCK_BETA, DEBLOCK_TC)


# ---------------------------------------------------------------------------
# Boundary-strength maps
# ---------------------------------------------------------------------------

def intra_bs_maps(width: int, height: int, tu_size: int = 16,
                  split_map=None, merge32=None):
    """BS maps for an all-intra frame with a uniform TU grid: every TU
    boundary on the 8-px deblock grid has BS=2 (spec 8.7.2.4: either side
    intra -> bS 2); interior 8-px lines are not transform edges -> 0.
    split_map: optional (nby, nbx) bool — NxN blocks whose interior TU8
    edges are also transform boundaries.
    merge32: optional (n32y, n32x) bool — 32x32 CUs coded with a single
    TU32 whose interior 16-px lines are NOT transform edges.

    Returns (bs_v, bs_h):
      bs_v: (H/4, W/8 - 1) BS of vertical edge at x=8*(e+1), rows 4y..4y+3
      bs_h: (H/8 - 1, W/4) BS of horizontal edge at y=8*(e+1)
    """
    ev = width // 8 - 1
    eh = height // 8 - 1
    bs_v = np.zeros((height // 4, max(ev, 0)), dtype=np.int32)
    bs_h = np.zeros((max(eh, 0), width // 4), dtype=np.int32)
    for e in range(ev):
        if ((e + 1) * 8) % tu_size == 0:
            bs_v[:, e] = 2
    for e in range(eh):
        if ((e + 1) * 8) % tu_size == 0:
            bs_h[e, :] = 2
    if merge32 is not None:
        clear_merge32_edges(bs_v, bs_h, merge32)
    if split_map is not None:
        mark_split_edges(bs_v, bs_h, split_map)
    return bs_v, bs_h


def clear_merge32_edges(bs_v, bs_h, merge32) -> None:
    """Zero the interior 16-px edges of unsplit 32x32 TU32 CUs (they are
    neither TU nor PU boundaries)."""
    n32y, n32x = merge32.shape
    for ry in range(n32y):
        for rx in range(n32x):
            if not merge32[ry, rx]:
                continue
            e = 4 * rx + 1                  # vertical edge at x=rx*32+16
            if e < bs_v.shape[1]:
                bs_v[ry * 8:(ry + 1) * 8, e] = 0
            e = 4 * ry + 1
            if e < bs_h.shape[0]:
                bs_h[e, rx * 8:(rx + 1) * 8] = 0


def mark_split_edges(bs_v, bs_h, split_map) -> None:
    """Mark the interior TU8 edges of split (NxN) 16x16 blocks BS=2."""
    nby, nbx = split_map.shape
    for by in range(nby):
        for bx in range(nbx):
            if not split_map[by, bx]:
                continue
            e = 2 * bx                      # vertical edge at x=bx*16+8
            if e < bs_v.shape[1]:
                bs_v[by * 4:(by + 1) * 4, e] = 2
            e = 2 * by
            if e < bs_h.shape[0]:
                bs_h[e, bx * 4:(bx + 1) * 4] = 2


def inter_bs_maps(intra_mask: np.ndarray, mvs: np.ndarray,
                  cbf_luma: np.ndarray, width: int, height: int,
                  block: int = 16, dirs: np.ndarray = None,
                  mvs1: np.ndarray = None, poc0: np.ndarray = None,
                  poc1: np.ndarray = None, split_map=None,
                  part_map=None, pu1=None, tu32_mask=None):
    """BS maps for a P/B frame with a uniform CU/TU grid (spec 8.7.2.4):
    block-boundary edges on the 8-px grid get BS 2 if either side is
    intra, else 1 if either side has luma coefficients or the motion
    differs (different ref pictures, different MV count, or any matched
    MV component differing by >= 4 qpel), else 0.

    intra_mask/cbf_luma: (nby, nbx) bool; mvs: (nby, nbx, 2) L0 qpel.
    B extras: dirs (bitmask 1/2/3), mvs1 (L1), poc0/poc1 per-block ref
    POCs.  P default: dirs=1 everywhere, single ref.

    Rect PUs: part_map (nby, nbx) int (0=2Nx2N, 1=2NxN, 2=Nx2N) and
    pu1 = (dirs_b, mvs_b, mvs1_b, poc0_b, poc1_b) second-PU fields.
    Motion comparisons then run on an 8-px grid and the CU's interior
    PU edge gets a motion-rule-only BS (spec 8.7.2.4: the cbf term
    applies at transform edges; a PU-only edge uses the motion terms).

    tu32_mask: optional (nby//2, nbx//2) bool — 32-regions coded as ONE
    inter TU32 (frame/inter_tu32.py).  Their interior 16-offset edges
    are not transform edges, so the cbf term is suppressed there (the
    motion term still applies; it is 0 by region uniformity).  The
    caller must broadcast the TU32 cbf into cbf_luma for the region.
    """
    nby, nbx = intra_mask.shape
    if dirs is None:
        dirs = np.ones((nby, nbx), np.int32)
    if mvs1 is None:
        mvs1 = np.zeros_like(mvs)
    if poc0 is None:
        poc0 = np.zeros((nby, nbx), np.int64)
    if poc1 is None:
        poc1 = np.zeros((nby, nbx), np.int64)
    ev = width // 8 - 1
    eh = height // 8 - 1
    bs_v = np.zeros((height // 4, max(ev, 0)), dtype=np.int32)
    bs_h = np.zeros((max(eh, 0), width // 4), dtype=np.int32)

    def motion_differs(p, q, dirs=dirs, mvs=mvs, mvs1=mvs1,
                       poc0=poc0, poc1=poc1):
        dp, dq = dirs[p], dirs[q]
        np_ = (dp & 1) + ((dp >> 1) & 1)
        nq_ = (dq & 1) + ((dq >> 1) & 1)
        diff = np_ != nq_
        # canonical active (poc, mv) per side: uni -> its list; bi -> both
        def active(idx, d):
            a_poc = np.where(d == 2, poc1[idx], poc0[idx])
            a_mv = np.where((d == 2)[..., None], mvs1[idx], mvs[idx])
            return a_poc, a_mv
        ap, amvp = active(p, dp)
        aq, amvq = active(q, dq)
        uni = (np_ == 1) & (nq_ == 1)
        uni_diff = (ap != aq) | \
            (np.abs(amvp.astype(np.int64) - amvq).max(axis=-1) >= 4)
        bi = (np_ == 2) & (nq_ == 2)
        # ref-pair equality (unordered)
        pair_p = np.stack([np.minimum(poc0[p], poc1[p]),
                           np.maximum(poc0[p], poc1[p])], -1)
        pair_q = np.stack([np.minimum(poc0[q], poc1[q]),
                           np.maximum(poc0[q], poc1[q])], -1)
        pair_diff = np.any(pair_p != pair_q, axis=-1)
        # same ref pair: straight and swapped MV matchings
        d00 = np.abs(mvs[p].astype(np.int64) - mvs[q]).max(axis=-1)
        d11 = np.abs(mvs1[p].astype(np.int64) - mvs1[q]).max(axis=-1)
        d01 = np.abs(mvs[p].astype(np.int64) - mvs1[q]).max(axis=-1)
        d10 = np.abs(mvs1[p].astype(np.int64) - mvs[q]).max(axis=-1)
        straight = (d00 < 4) & (d11 < 4)
        swapped = (d01 < 4) & (d10 < 4)
        same_refs = poc0[p] == poc1[p]            # both lists same pic
        # distinct refs: lists are matched by picture; if L0/L1 pics are
        # swapped between P and Q the cross pairing applies
        l0_matches = poc0[p] == poc0[q]
        bi_diff = pair_diff | np.where(
            same_refs, ~(straight | swapped),
            np.where(l0_matches, ~straight, ~swapped))
        return np.where(diff, True,
                        np.where(uni, uni_diff,
                                 np.where(bi, bi_diff, True)))

    def _tu32_interior(off: int, along_idx, scale: int, vert: bool):
        """True per segment when a 16-offset edge at pixel `off` lies
        inside a TU32 region (off % 32 == 16 within a masked region).
        along_idx: per-segment index along the edge, in units of
        `scale` px."""
        if tu32_mask is None or off % 32 != 16:
            return None
        nry, nrx = tu32_mask.shape
        cross = off // 32
        rr = (along_idx * scale) // 32
        if vert:
            if cross >= nrx:
                return None
            valid = rr < nry
            return np.where(valid,
                            tu32_mask[np.minimum(rr, nry - 1), cross],
                            False)
        if cross >= nry:
            return None
        valid = rr < nrx
        return np.where(valid,
                        tu32_mask[cross, np.minimum(rr, nrx - 1)],
                        False)

    def seg_bs(p, q, suppress=None):
        ip, iq = intra_mask[p], intra_mask[q]
        two = ip | iq
        cb = cbf_luma[p] | cbf_luma[q]
        if suppress is not None:
            cb = cb & ~suppress
        one = cb | motion_differs(p, q)
        return np.where(two, 2, np.where(one, 1, 0))

    if part_map is not None and np.any(part_map) and block == 16:
        d_b, mv_b, mv1_b, p0_b, p1_b = pu1

        def exp4(f16, f_b):
            """Expand per-16-block fields to the 4x4 minblock grid with
            the second PU's values over its actual geometry — rect
            halves AND AMP quarter strips (PU edges at 4/12 offsets are
            never on the 8-grid, so they add no edges, but the motion
            sampled at CU-boundary segments must come from the PU that
            covers those samples, spec 8.7.2.4)."""
            f4 = np.repeat(np.repeat(f16, 4, 0), 4, 1)
            ry = np.arange(f16.shape[0] * 4)[:, None] % 4
            cx = np.arange(f16.shape[1] * 4)[None, :] % 4
            pm4 = np.repeat(np.repeat(part_map, 4, 0), 4, 1)
            in_pu1 = ((pm4 == 1) & (ry >= 2)) | ((pm4 == 2) & (cx >= 2)) \
                | ((pm4 == 4) & (ry >= 1)) | ((pm4 == 5) & (ry >= 3)) \
                | ((pm4 == 6) & (cx >= 1)) | ((pm4 == 7) & (cx >= 3))
            fb4 = np.repeat(np.repeat(f_b, 4, 0), 4, 1)
            if f4.ndim == 3:
                in_pu1 = in_pu1[..., None]
            return np.where(in_pu1, fb4, f4)

        dirs4 = exp4(dirs, d_b)
        mvs4 = exp4(mvs, mv_b)
        mvs1_4 = exp4(mvs1, mv1_b)
        poc0_4 = exp4(poc0, p0_b)
        poc1_4 = exp4(poc1, p1_b)
        intra4 = np.repeat(np.repeat(intra_mask, 4, 0), 4, 1)
        cbf4 = np.repeat(np.repeat(cbf_luma, 4, 0), 4, 1)

        def md4(p, q):
            return motion_differs(p, q, dirs4, mvs4, mvs1_4,
                                  poc0_4, poc1_4)

        segs = np.arange(height // 4)
        for e in range(ev):
            x = (e + 1) * 8
            p = (segs, np.full_like(segs, x // 4 - 1))
            q = (segs, np.full_like(segs, x // 4))
            if x % 16 == 0:                      # CU/TU boundary
                two = intra4[p] | intra4[q]
                cb = cbf4[p] | cbf4[q]
                sup = _tu32_interior(x, segs, 4, True)
                if sup is not None:
                    cb = cb & ~sup
                one = cb | md4(p, q)
                bs_v[:, e] = np.where(two, 2, np.where(one, 1, 0))
            else:                                # PU-only (Nx2N) edge
                rows16 = segs * 4 // 16
                exists = (~intra4[p]) & \
                    (part_map[rows16, x // 16] == 2)
                bs_v[:, e] = np.where(exists, md4(p, q).astype(int), 0)
        segs = np.arange(width // 4)
        for e in range(eh):
            yy = (e + 1) * 8
            p = (np.full_like(segs, yy // 4 - 1), segs)
            q = (np.full_like(segs, yy // 4), segs)
            if yy % 16 == 0:
                two = intra4[p] | intra4[q]
                cb = cbf4[p] | cbf4[q]
                sup = _tu32_interior(yy, segs, 4, False)
                if sup is not None:
                    cb = cb & ~sup
                one = cb | md4(p, q)
                bs_h[e, :] = np.where(two, 2, np.where(one, 1, 0))
            else:                                # PU-only (2NxN) edge
                cols16 = segs * 4 // 16
                exists = (~intra4[p]) & \
                    (part_map[yy // 16, cols16] == 1)
                bs_h[e, :] = np.where(exists, md4(p, q).astype(int), 0)
        if split_map is not None:
            mark_split_edges(bs_v, bs_h, split_map)
        return bs_v, bs_h

    for e in range(ev):
        x = (e + 1) * 8
        if x % block:
            continue
        bxq = x // block
        bys = np.arange(height // 4) * 4 // block       # group -> block row
        p = (bys, np.full_like(bys, bxq - 1))
        q = (bys, np.full_like(bys, bxq))
        bs_v[:, e] = seg_bs(p, q, _tu32_interior(
            x, np.arange(height // 4), 4, True))
    for e in range(eh):
        yy = (e + 1) * 8
        if yy % block:
            continue
        byq = yy // block
        bxs = np.arange(width // 4) * 4 // block
        p = (np.full_like(bxs, byq - 1), bxs)
        q = (np.full_like(bxs, byq), bxs)
        bs_h[e, :] = seg_bs(p, q, _tu32_interior(
            yy, np.arange(width // 4), 4, False))
    if split_map is not None:
        mark_split_edges(bs_v, bs_h, split_map)
    return bs_v, bs_h


def chroma_on_maps(bs_v: np.ndarray, bs_h: np.ndarray, hc: int, wc: int,
                   csp: int = 1):
    """Map luma BS to per-chroma-sample edge-on masks.

    4:2:0: chroma vertical edge at chroma x=8c is the luma edge at 16c
    (luma edge index e=2c-1); chroma row r maps to luma 4-row group
    (2r)//4 = r//2.  4:4:4: chroma edges coincide with luma edges.
    Returns on_v: (Hc, Wc/8-1) bool, on_h: (Hc/8-1, Wc) bool.
    """
    ev = wc // 8 - 1
    eh = hc // 8 - 1
    on_v = np.zeros((hc, max(ev, 0)), dtype=bool)
    on_h = np.zeros((max(eh, 0), wc), dtype=bool)
    ssx = 0 if csp == 3 else 1
    ssy = 1 if csp == 1 else 0
    for c in range(ev):
        e = ((c + 1) << ssx) - 1
        # chroma coord -> luma coord (<< shift) -> 4-sample seg (>> 2)
        on_v[:, c] = bs_v[(np.arange(hc) << ssy) >> 2, e] == 2
    for c in range(eh):
        e = ((c + 1) << ssy) - 1
        on_h[c, :] = bs_h[e, (np.arange(wc) << ssx) >> 2] == 2
    return on_v, on_h


# ---------------------------------------------------------------------------
# Batched torch implementation (port of the reference's JAX passes)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tables(device):
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)
    return t(DEBLOCK_BETA), t(DEBLOCK_TC), t(CHROMA_QP_TABLE)


def _luma_edges_pass(plane, bs, edge_x, qp_seg, beta_off: int,
                     tc_off: int, bit_depth: int):
    """Filter all vertical luma edges of a plane in one shot.
    plane (H, W) int32; bs (H/4, E); edge_x (E,); qp_seg (H/4, E) or a
    0-d tensor.  Returns the filtered plane (a new tensor)."""
    h, w = plane.shape
    e_cnt = edge_x.shape[0]
    if e_cnt == 0:
        return plane
    dev = plane.device
    beta_t, tc_t, _ = _tables(dev)
    qp_seg = torch.as_tensor(qp_seg, dtype=torch.int32, device=dev)
    if qp_seg.dim() == 0:
        qp_seg = qp_seg.expand(bs.shape)
    idx_b = torch.clip(qp_seg + (beta_off << 1), 0, 51).long()
    beta = beta_t[idx_b] << (bit_depth - 8)
    ar3 = torch.arange(3, device=dev, dtype=torch.int32)
    idx_t = torch.clip(qp_seg[None] + 2 * (ar3[:, None, None] - 1)
                       + (tc_off << 1), 0, 53).long()
    tc_all = torch.where((ar3 > 0)[:, None, None],
                         tc_t[idx_t] << (bit_depth - 8), 0)
    maxv = (1 << bit_depth) - 1

    cols = (edge_x[:, None] + torch.arange(-4, 4, device=dev)[None, :]) \
        .long()
    seg = plane[:, cols].reshape(h // 4, 4, e_cnt, 8).to(torch.int32)
    p3, p2, p1, p0 = seg[..., 0], seg[..., 1], seg[..., 2], seg[..., 3]
    q0, q1, q2, q3 = seg[..., 4], seg[..., 5], seg[..., 6], seg[..., 7]

    tc = torch.gather(tc_all, 0, torch.clip(bs, 0, 2).long()[None])[0]
    on = (bs > 0) & (beta > 0)
    dp_l = torch.abs(p2 - 2 * p1 + p0)
    dq_l = torch.abs(q2 - 2 * q1 + q0)
    dp0, dp3 = dp_l[:, 0], dp_l[:, 3]
    dq0, dq3 = dq_l[:, 0], dq_l[:, 3]
    d = dp0 + dq0 + dp3 + dq3
    on = on & (d < beta)

    def strong_i(i):
        return (2 * (dp_l[:, i] + dq_l[:, i]) < (beta >> 2)) & \
            (torch.abs(p3[:, i] - p0[:, i]) + torch.abs(q0[:, i] - q3[:, i])
             < (beta >> 3)) & \
            (torch.abs(p0[:, i] - q0[:, i]) < ((5 * tc + 1) >> 1))

    strong = strong_i(0) & strong_i(3)
    tc4 = tc[:, None]
    strong4 = (strong & on)[:, None]
    cl = lambda v, lo, hi: torch.minimum(torch.maximum(v, lo), hi)
    sp0 = cl((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
             p0 - 2 * tc4, p0 + 2 * tc4)
    sp1 = cl((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tc4, p1 + 2 * tc4)
    sp2 = cl((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
             p2 - 2 * tc4, p2 + 2 * tc4)
    sq0 = cl((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
             q0 - 2 * tc4, q0 + 2 * tc4)
    sq1 = cl((q2 + q1 + q0 + p0 + 2) >> 2, q1 - 2 * tc4, q1 + 2 * tc4)
    sq2 = cl((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
             q2 - 2 * tc4, q2 + 2 * tc4)

    thr_side = (beta + (beta >> 1)) >> 3
    filt_p = ((dp0 + dp3) < thr_side)[:, None]
    filt_q = ((dq0 + dq3) < thr_side)[:, None]
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    w_on = (torch.abs(delta) < tc4 * 10) & (~strong & on)[:, None]
    dclip = cl(delta, -tc4, tc4)
    wp0 = torch.clip(p0 + dclip, 0, maxv)
    wq0 = torch.clip(q0 - dclip, 0, maxv)
    dp_side = cl((((p2 + p0 + 1) >> 1) - p1 + dclip) >> 1,
                 -(tc4 >> 1), tc4 >> 1)
    wp1 = torch.clip(p1 + dp_side, 0, maxv)
    dq_side = cl((((q2 + q0 + 1) >> 1) - q1 - dclip) >> 1,
                 -(tc4 >> 1), tc4 >> 1)
    wq1 = torch.clip(q1 + dq_side, 0, maxv)

    np0 = torch.where(strong4, sp0, torch.where(w_on, wp0, p0))
    nq0 = torch.where(strong4, sq0, torch.where(w_on, wq0, q0))
    np1 = torch.where(strong4, sp1, torch.where(w_on & filt_p, wp1, p1))
    nq1 = torch.where(strong4, sq1, torch.where(w_on & filt_q, wq1, q1))
    np2 = torch.where(strong4, sp2, p2)
    nq2 = torch.where(strong4, sq2, q2)
    new_seg = torch.stack([p3, np2, np1, np0, nq0, nq1, nq2, q3], -1)
    out = plane.clone()
    out[:, cols] = new_seg.reshape(h, e_cnt, 8)
    return out


def _chroma_edges_pass(plane, on, edge_x, qpc, tc_off: int,
                       bit_depth: int):
    """All vertical chroma edges; on (H, E) bool; qpc 0-d or (H, E)."""
    h, w = plane.shape
    e_cnt = edge_x.shape[0]
    if e_cnt == 0:
        return plane
    dev = plane.device
    _, tc_t, _ = _tables(dev)
    qpc = torch.as_tensor(qpc, dtype=torch.int32, device=dev)
    if qpc.dim() == 0:
        qpc = qpc.expand(on.shape)
    tc = tc_t[torch.clip(qpc + 2 + (tc_off << 1), 0, 53).long()] \
        << (bit_depth - 8)
    maxv = (1 << bit_depth) - 1
    cols = (edge_x[:, None] + torch.arange(-2, 2, device=dev)[None, :]) \
        .long()
    seg = plane[:, cols].to(torch.int32)
    p1, p0, q0, q1 = seg[..., 0], seg[..., 1], seg[..., 2], seg[..., 3]
    delta = torch.minimum(torch.maximum(
        (((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc), tc)
    on = on & (tc > 0)
    np0 = torch.where(on, torch.clip(p0 + delta, 0, maxv), p0)
    nq0 = torch.where(on, torch.clip(q0 - delta, 0, maxv), q0)
    out = plane.clone()
    out[:, cols] = torch.stack([p1, np0, nq0, q1], -1)
    return out


def _qp_edge_maps(qp, h, w, log2_ctu=5):
    """Per-segment luma QP averages (see the reference)."""
    if qp.dim() == 0:
        return qp, qp
    dev = qp.device
    ctu = 1 << log2_ctu
    ar = lambda *a: torch.arange(*a, device=dev)
    gv = (ar(h // 4) * 4) // ctu
    ex = ar(1, w // 8) * 8
    cxp = torch.clip((ex - 1) // ctu, 0, qp.shape[1] - 1)
    cxq = torch.clip(ex // ctu, 0, qp.shape[1] - 1)
    qp_v = (qp[gv[:, None], cxp[None, :]] +
            qp[gv[:, None], cxq[None, :]] + 1) >> 1
    gh = (ar(w // 4) * 4) // ctu
    ey = ar(1, h // 8) * 8
    cyp = torch.clip((ey - 1) // ctu, 0, qp.shape[0] - 1)
    cyq = torch.clip(ey // ctu, 0, qp.shape[0] - 1)
    qp_h = (qp[cyp[:, None], gh[None, :]] +
            qp[cyq[:, None], gh[None, :]] + 1) >> 1
    return qp_v, qp_h


def _chroma_qp_edge_maps(qp, hc, wc, off_cb, off_cr, log2_ctu=5, csp=1):
    """Per-sample chroma-edge QpC maps from the luma QP map or scalar:
    the Table 8-10 remap for 4:2:0, a clip at 51 for 4:2:2 / 4:4:4
    (spec 8.7.2.5.5); the chroma-to-luma shifts follow csp."""
    dev = qp.device
    if csp == 1:
        tab = _tables(dev)[2]

        def qc(a, off):
            return tab[torch.clip(a + off, 0, 69).long()]
    else:
        def qc(a, off):
            return torch.clip(a + off, 0, 51)
    ssx = 0 if csp == 3 else 1
    ssy = 1 if csp == 1 else 0
    if qp.dim() == 0:
        return (qc(qp, off_cb), qc(qp, off_cr),
                qc(qp, off_cb), qc(qp, off_cr))
    ctu = 1 << log2_ctu
    ar = lambda *a: torch.arange(*a, device=dev)
    rows = (ar(hc) << ssy) // ctu
    exc = ar(1, wc // 8) * (8 << ssx)          # luma x of chroma edges
    cxp = torch.clip((exc - 1) // ctu, 0, qp.shape[1] - 1)
    cxq = torch.clip(exc // ctu, 0, qp.shape[1] - 1)
    avg_v = (qp[rows[:, None], cxp[None, :]] +
             qp[rows[:, None], cxq[None, :]] + 1) >> 1
    cols = (ar(wc) << ssx) // ctu
    eyc = ar(1, hc // 8) * (8 << ssy)
    cyp = torch.clip((eyc - 1) // ctu, 0, qp.shape[0] - 1)
    cyq = torch.clip(eyc // ctu, 0, qp.shape[0] - 1)
    avg_h = (qp[cyp[:, None], cols[None, :]] +
             qp[cyq[:, None], cols[None, :]] + 1) >> 1
    return (qc(avg_v, off_cb), qc(avg_v, off_cr),
            qc(avg_h, off_cb), qc(avg_h, off_cr))


def deblock_frame_batch(y, u, v, bs_v, bs_h, on_vc, on_hc, qp, qpc_cb,
                        qpc_cr, beta_off: int = 0, tc_off: int = 0,
                        bit_depth: int = 8, csp: int = 1,
                        log2_ctu: int = 5):
    """Deblock a frame: luma + chroma, V edges then H edges; csp 1, 2
    or 3 (4:2:0, 4:2:2, 4:4:4) sets the chroma planes' geometry and QpC.
    qp: scalar or per-CTU (nCtuY, nCtuX) map; qpc_cb/qpc_cr are chroma QP
    offsets when qp is a map, absolute chroma QPs when it is a scalar."""
    ys, us, vs = deblock_frame_multi(y[None], u[None], v[None], bs_v, bs_h,
                                     on_vc, on_hc, qp, qpc_cb, qpc_cr,
                                     beta_off, tc_off, bit_depth, log2_ctu,
                                     csp)
    return ys[0], us[0], vs[0]


def deblock_frame_multi(ys, us, vs, bs_v, bs_h, on_vc, on_hc, qp, qpc_cb,
                        qpc_cr, beta_off: int = 0, tc_off: int = 0,
                        bit_depth: int = 8, log2_ctu: int = 5,
                        csp: int = 1):
    """Deblock F frames (F, h, w) / (F, hc, wc) in one pass, their BS
    maps and QPs shared (see deblock_frame_batch for the arguments): the
    frames are stacked along the rows and each edge pass takes every
    frame's edges at once (a vertical pass the maps repeated per frame,
    a horizontal pass each frame's edge rows; no edge is taken between
    two frames)."""
    f, h, w = ys.shape
    hc, wc = us.shape[1:]
    dev = ys.device
    qp_j = torch.as_tensor(np.asarray(qp, np.int32), device=dev)
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=dev)
    bs_v, bs_h = t(bs_v, np.int32), t(bs_h, np.int32)
    on_vc, on_hc = t(on_vc, bool), t(on_hc, bool)
    ar = lambda n: torch.arange(1, n // 8, device=dev) * 8
    rows = lambda n: ar(n) if f == 1 else (ar(n)[None, :] + n * torch.arange(
        f, device=dev)[:, None]).reshape(-1)
    tile_v = lambda a: a.repeat(f, 1) if f > 1 and a.dim() else a
    tile_h = lambda a: (a.T.repeat(1, f) if f > 1 else a.T) if a.dim() \
        else a
    qp_v, qp_h = _qp_edge_maps(qp_j, h, w, log2_ctu)
    y = _luma_edges_pass(ys.reshape(f * h, w), tile_v(bs_v), ar(w),
                         tile_v(qp_v), beta_off, tc_off, bit_depth)
    y = _luma_edges_pass(y.T, tile_h(bs_h), rows(h), tile_h(qp_h),
                         beta_off, tc_off, bit_depth).T
    if qp_j.dim():
        cbv, crv, cbh, crh = _chroma_qp_edge_maps(qp_j, hc, wc, qpc_cb,
                                                  qpc_cr, log2_ctu, csp)
        chroma_qps = ((tile_v(cbv), tile_h(cbh)),
                      (tile_v(crv), tile_h(crh)))
    else:
        chroma_qps = ((qpc_cb, qpc_cb), (qpc_cr, qpc_cr))
    out = []
    for pl, (qcv, qch) in zip((us, vs), chroma_qps):
        pl = _chroma_edges_pass(pl.reshape(f * hc, wc), tile_v(on_vc),
                                ar(wc), qcv, tc_off, bit_depth)
        pl = _chroma_edges_pass(pl.T, tile_h(on_hc), rows(hc), qch,
                                tc_off, bit_depth).T
        out.append(pl.reshape(f, hc, wc).contiguous())
    return y.reshape(f, h, w).contiguous(), out[0], out[1]


# ---------------------------------------------------------------------------
# Golden scalar (numpy) functions of the validation decoder
# (decoder/decoder.py), copied unchanged from the reference module
# ---------------------------------------------------------------------------

def _clip3(lo, hi, x):
    return np.minimum(np.maximum(x, lo), hi)


def _filter_luma_edge_ref(seg: np.ndarray, bs: int, qp: int,
                          beta_off: int, tc_off: int, bit_depth: int):
    """Filter one 4-line luma edge segment.  seg: (4, 8) int array of
    [p3 p2 p1 p0 q0 q1 q2 q3] per line; modified in place."""
    if bs == 0:
        return
    idx_b = min(max(qp + (beta_off << 1), 0), 51)
    beta = int(DEBLOCK_BETA[idx_b]) << (bit_depth - 8)
    idx_t = min(max(qp + 2 * (bs - 1) + (tc_off << 1), 0), 53)
    tc = int(DEBLOCK_TC[idx_t]) << (bit_depth - 8)
    if beta == 0:
        return
    p = seg[:, 3::-1]   # p0..p3 (view with reversed cols)
    q = seg[:, 4:]
    dp0 = abs(int(seg[0, 1]) - 2 * int(seg[0, 2]) + int(seg[0, 3]))
    dp3 = abs(int(seg[3, 1]) - 2 * int(seg[3, 2]) + int(seg[3, 3]))
    dq0 = abs(int(seg[0, 6]) - 2 * int(seg[0, 5]) + int(seg[0, 4]))
    dq3 = abs(int(seg[3, 6]) - 2 * int(seg[3, 5]) + int(seg[3, 4]))
    d = dp0 + dq0 + dp3 + dq3
    if d >= beta:
        return
    maxv = (1 << bit_depth) - 1

    def strong_line(i):
        return (2 * ((dp0 if i == 0 else dp3) + (dq0 if i == 0 else dq3))
                < (beta >> 2)) and \
            (abs(int(seg[i, 0]) - int(seg[i, 3]))
             + abs(int(seg[i, 4]) - int(seg[i, 7])) < (beta >> 3)) and \
            (abs(int(seg[i, 3]) - int(seg[i, 4])) < ((5 * tc + 1) >> 1))

    strong = strong_line(0) and strong_line(3)
    s = seg.astype(np.int64)
    if strong:
        for i in range(4):
            p3, p2, p1, p0, q0, q1, q2, q3 = (int(x) for x in s[i])
            seg[i, 3] = _clip3(p0 - 2 * tc, p0 + 2 * tc,
                               (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
            seg[i, 2] = _clip3(p1 - 2 * tc, p1 + 2 * tc,
                               (p2 + p1 + p0 + q0 + 2) >> 2)
            seg[i, 1] = _clip3(p2 - 2 * tc, p2 + 2 * tc,
                               (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
            seg[i, 4] = _clip3(q0 - 2 * tc, q0 + 2 * tc,
                               (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3)
            seg[i, 5] = _clip3(q1 - 2 * tc, q1 + 2 * tc,
                               (q2 + q1 + q0 + p0 + 2) >> 2)
            seg[i, 6] = _clip3(q2 - 2 * tc, q2 + 2 * tc,
                               (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3)
        return
    # weak filter
    thr_side = (beta + (beta >> 1)) >> 3
    filt_p = (dp0 + dp3) < thr_side
    filt_q = (dq0 + dq3) < thr_side
    for i in range(4):
        p2, p1, p0, q0, q1 = (int(s[i, 1]), int(s[i, 2]), int(s[i, 3]),
                              int(s[i, 4]), int(s[i, 5]))
        delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
        if abs(delta) >= tc * 10:
            continue
        delta = _clip3(-tc, tc, delta)
        seg[i, 3] = _clip3(0, maxv, p0 + delta)
        seg[i, 4] = _clip3(0, maxv, q0 - delta)
        if filt_p:
            dp = _clip3(-(tc >> 1), tc >> 1,
                        (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1)
            seg[i, 2] = _clip3(0, maxv, p1 + dp)
        if filt_q:
            q2 = int(s[i, 6])
            dq = _clip3(-(tc >> 1), tc >> 1,
                        (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1)
            seg[i, 5] = _clip3(0, maxv, q1 + dq)


def deblock_luma_ref(plane: np.ndarray, bs_v: np.ndarray, bs_h: np.ndarray,
                     qp, beta_off: int = 0, tc_off: int = 0,
                     bit_depth: int = 8, log2_ctu: int = 5) -> np.ndarray:
    """Golden frame deblock: all vertical edges, then all horizontal.
    qp: scalar or (nCtuY, nCtuX) per-CTU map (per-segment averaging per
    spec 8.7.2.5.3)."""
    out = plane.astype(np.int32).copy()
    h, w = out.shape
    qmap = None if np.isscalar(qp) else np.asarray(qp)
    ctu = 1 << log2_ctu

    def seg_qp(py, px, qy, qx):
        if qmap is None:
            return qp
        a = int(qmap[min(py // ctu, qmap.shape[0] - 1),
                     min(px // ctu, qmap.shape[1] - 1)])
        b = int(qmap[min(qy // ctu, qmap.shape[0] - 1),
                     min(qx // ctu, qmap.shape[1] - 1)])
        return (a + b + 1) >> 1

    for e in range(bs_v.shape[1]):
        x = (e + 1) * 8
        for g in range(h // 4):
            seg = out[g * 4:g * 4 + 4, x - 4:x + 4]
            _filter_luma_edge_ref(seg, int(bs_v[g, e]),
                                  seg_qp(g * 4, x - 1, g * 4, x),
                                  beta_off, tc_off, bit_depth)
    for e in range(bs_h.shape[0]):
        y = (e + 1) * 8
        for g in range(w // 4):
            seg = out[y - 4:y + 4, g * 4:g * 4 + 4].T.copy()
            _filter_luma_edge_ref(seg, int(bs_h[e, g]),
                                  seg_qp(y - 1, g * 4, y, g * 4),
                                  beta_off, tc_off, bit_depth)
            out[y - 4:y + 4, g * 4:g * 4 + 4] = seg.T
    return out


def deblock_chroma_ref(plane: np.ndarray, on_v: np.ndarray,
                       on_h: np.ndarray, qpc: int, tc_off: int = 0,
                       bit_depth: int = 8, qp_map=None, c_off: int = 0,
                       log2_ctu: int = 5, csp: int = 1) -> np.ndarray:
    """Golden chroma deblock: per-sample on masks from chroma_on_maps.
    With qp_map given (per-CTU luma QPs), QpC is derived per edge sample
    from the averaged luma QPs + c_off via the chroma table."""
    out = plane.astype(np.int32).copy()
    h, w = out.shape
    maxv = (1 << bit_depth) - 1
    ctu = 1 << log2_ctu
    ssx = 0 if csp == 3 else 1           # chroma -> luma coord shifts
    ssy = 1 if csp == 1 else 0

    def qc_of(avg):
        if csp == 1:
            return int(CHROMA_QP_TABLE[min(max(avg + c_off, 0), 69)])
        return min(max(avg + c_off, 0), 51)

    def tc_of(ly, lxp, lxq):
        if qp_map is None:
            q = qpc
        else:
            a = int(qp_map[min(ly // ctu, qp_map.shape[0] - 1),
                           min(lxp // ctu, qp_map.shape[1] - 1)])
            b = int(qp_map[min(ly // ctu, qp_map.shape[0] - 1),
                           min(lxq // ctu, qp_map.shape[1] - 1)])
            q = qc_of((a + b + 1) >> 1)
        idx = min(max(q + 2 + (tc_off << 1), 0), 53)
        return int(DEBLOCK_TC[idx]) << (bit_depth - 8)

    def tc_of_h(lyp, lyq, lx):
        if qp_map is None:
            q = qpc
        else:
            a = int(qp_map[min(lyp // ctu, qp_map.shape[0] - 1),
                           min(lx // ctu, qp_map.shape[1] - 1)])
            b = int(qp_map[min(lyq // ctu, qp_map.shape[0] - 1),
                           min(lx // ctu, qp_map.shape[1] - 1)])
            q = qc_of((a + b + 1) >> 1)
        idx = min(max(q + 2 + (tc_off << 1), 0), 53)
        return int(DEBLOCK_TC[idx]) << (bit_depth - 8)

    for e in range(on_v.shape[1]):
        x = (e + 1) * 8
        for y in range(h):
            if not on_v[y, e]:
                continue
            tc = tc_of(y << ssy, (x << ssx) - 1, x << ssx)
            if tc == 0:
                continue
            p1, p0, q0, q1 = (int(out[y, x - 2]), int(out[y, x - 1]),
                              int(out[y, x]), int(out[y, x + 1]))
            delta = _clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3))
            out[y, x - 1] = _clip3(0, maxv, p0 + delta)
            out[y, x] = _clip3(0, maxv, q0 - delta)
    for e in range(on_h.shape[0]):
        y = (e + 1) * 8
        for x in range(w):
            if not on_h[e, x]:
                continue
            tc = tc_of_h((y << ssy) - 1, y << ssy, x << ssx)
            if tc == 0:
                continue
            p1, p0, q0, q1 = (int(out[y - 2, x]), int(out[y - 1, x]),
                              int(out[y, x]), int(out[y + 1, x]))
            delta = _clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3))
            out[y - 1, x] = _clip3(0, maxv, p0 + delta)
            out[y, x] = _clip3(0, maxv, q0 - delta)
    return out
