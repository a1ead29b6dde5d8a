"""P- and B-frame analysis: batched ME + merge/AMVP candidate rounds +
region homogenization + inter/intra decision + MC prediction (port of
x265_mod_by_patman_tpu/analysis/inter_mode.py).

lambda_qp, _scale_mv_np, temporal_merge_field, _b_tmvp_field,
WINDOW_NBY_LIMIT and _analysis_bands are host functions copied unchanged
from the reference (its module imports jax).  Frames above 9000 16x16
blocks (4K) are analysed in row bands on sliced sub-planes
(_banded_analysis), HME seeds the full search (_hme_center_fullres),
rect PUs (2NxN / Nx2N) are searched on 8x8 sub-blocks, AMP PUs (2NxnU,
2NxnD, nLx2N, nRx2N) pick each strip's MV from 4x4-tile SATD maps,
`--me sea` runs the SEA-pruned integer search (ops/sea.py) and weighted
B (`--weightb`) searches pre-weighted planes, as in the reference.
_p_core also takes one band of a tile-row sharded analysis (Band;
parallel/tiles.py).  The TPU-only _chain scheduling barriers and lane
chunking have no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..frame.planes import dev_i32
from ..frame.zscan import frame_avail_masks
from ..ops.cost import _had, _tiles, satd_batch
from ..ops.interp import (bi_combine, mc_batch, mc_batch_14, wp_apply_batch,
                          wp_bi_combine)
from ..ops.me import (_org_blocks, full_search_batch, half_res,
                      hme_upsample, mv_bits, subpel_refine_batch)
from ..ops.numeric import fma32, osum
from ..ops.sea import sea_search_batch
from ..ops.transform import dct_batch, dequant_dyn, idct_batch, quant_dyn
from .intra_mode import _mode_costs
from .weightp import weighted_plane

I32 = torch.int32
F32 = torch.float32



def _group_sum(a, gh: int, g: int, gw: int):
    """(gh, gw) float32 sums of the g x g groups of a (gh*g, gw*g) map,
    each group's terms added in row-major order, as the reference's
    CPU backend adds a.reshape(gh, g, gw, g).sum((1, 3)) (osum: K3 on
    the card)."""
    return osum(a.reshape(gh, g, gw, g), (1, 3))


def lambda_qp(qp: int) -> Tuple[float, float]:
    """(lambda, lambda2) — SAD/SATD and SSE lambdas (reference
    constants.cpp:34 x265_lambda_tab / x265_lambda2_tab derivation)."""
    lam2 = 0.85 * (2.0 ** ((qp - 12) / 3.0))
    return math.sqrt(lam2), lam2


def _scale_mv_np(mvx, mvy, tb: int, td):
    """Vectorized POC-distance MV scaling (spec 8.5.3.2.8; the batched
    form of entropy.mv_pred._scale_mv, kept numerically identical so an
    analysis-adopted temporal candidate matches the syntax encoder's
    derived merge candidate exactly)."""
    td = np.asarray(td, np.int64)
    same = td == tb
    tds = np.where(td == 0, 1, td)
    num = 16384 + (np.abs(tds) >> 1)
    tx = np.where(tds < 0, -(num // -tds), num // tds)
    dsf = np.clip((tb * tx + 32) >> 6, -4096, 4095)
    out = []
    for c in (np.asarray(mvx, np.int64), np.asarray(mvy, np.int64)):
        v = dsf * c
        s = (np.abs(v) + 127) >> 8
        out.append(np.clip(np.where(v < 0, -s, s), -32768, 32767))
    return (np.where(same, mvx, out[0]).astype(np.int32),
            np.where(same, mvy, out[1]).astype(np.int32))


def temporal_merge_field(col, nby: int, nbx: int, n: int, pic_w: int,
                         pic_h: int, log2_ctu: int, lst: int,
                         target_poc: int, cur_poc: int,
                         low_delay: bool):
    """Per-block temporal merge candidate for list `lst` over the whole
    (nby, nbx) grid of n-pel blocks — the batched analog of
    entropy.mv_pred.temporal_candidate (spec 8.5.3.2.8): bottom-right
    col block C0 (same CTU row only), center C1 fallback, listCol
    selection per 8.5.3.2.9, POC-distance scaling.  Returns
    (valid (nby,nbx) bool, mvx, mvy int32)."""
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    x0 = bxs * n
    y0 = bys * n
    val = np.zeros((nby, nbx), bool)
    omx = np.zeros((nby, nbx), np.int32)
    omy = np.zeros((nby, nbx), np.int32)
    ch, cw = col.dir.shape
    tb = cur_poc - target_poc
    for i, (xc, yc) in enumerate(((x0 + n, y0 + n),
                                  (x0 + (n >> 1), y0 + (n >> 1)))):
        ok = (xc < pic_w) & (yc < pic_h)
        if i == 0:
            ok &= (yc >> log2_ctu) == (y0 >> log2_ctu)
        cby = np.clip(yc >> 4, 0, ch - 1)
        cbx = np.clip(xc >> 4, 0, cw - 1)
        d = col.dir[cby, cbx]
        ok &= d != 0
        if low_delay:
            bi_l = lst
        else:
            bi_l = 1 if col.from_l0 else 0
        l = np.where(d == 1, 0, np.where(d == 2, 1, bi_l))
        rp = col.ref_poc[cby, cbx]                 # (nby, nbx, 2)
        crf = np.where(l == 0, rp[..., 0], rp[..., 1])
        td = col.poc - crf
        ok &= td != 0
        mv = col.mv[cby, cbx]                      # (nby, nbx, 2, 2)
        mvx = np.where(l == 0, mv[..., 0, 0], mv[..., 1, 0])
        mvy = np.where(l == 0, mv[..., 0, 1], mv[..., 1, 1])
        smx, smy = _scale_mv_np(mvx, mvy, tb, td)
        newly = ok & ~val
        omx = np.where(newly, smx, omx)
        omy = np.where(newly, smy, omy)
        val |= ok
    return val, omx, omy


def _neigh_field(f2d, sy: int, sx: int):
    """Coding-order neighbour gather on a (nby, nbx) block field:
    out[y, x] = f2d[y - sy, x - sx] plus an in-frame validity mask."""
    nby, nbx = f2d.shape[:2]
    dev = f2d.device
    s = torch.roll(f2d, (sy, sx), (0, 1))
    iy = torch.arange(nby, device=dev)[:, None] - sy
    ix = torch.arange(nbx, device=dev)[None, :] - sx
    ok = (iy >= 0) & (iy < nby) & (ix >= 0) & (ix < nbx)
    return s, ok


def _stack_refs(planes, m: int):
    """Stack reference planes vertically with per-plane edge padding of
    `m` rows (see the reference): block (bx, by) on ref r reads the tall
    plane at y = by + r*strip + m."""
    padded = [torch.cat([p[:1].expand(m, -1), p, p[-1:].expand(m, -1)], 0)
              for p in planes]
    tall = torch.cat(padded, 0).contiguous()
    return tall, padded[0].shape[0]


_SUBB_H = torch.tensor([0, 0, 1, 1], dtype=I32)   # PU1's sub-blocks, 2NxN
_SUBB_V = torch.tensor([0, 1, 0, 1], dtype=I32)   # and Nx2N


def _sub4(bx, by):
    """Origins of each 16-block's four 8x8 sub-blocks, in k-order
    (dy, dx) = (0, 0), (0, 8), (8, 0), (8, 8): (4B,) x and y."""
    dx = torch.tensor([0, 8, 0, 8], dtype=I32, device=bx.device)
    dy = torch.tensor([0, 0, 8, 8], dtype=I32, device=bx.device)
    return ((bx[:, None] + dx[None]).reshape(-1),
            (by[:, None] + dy[None]).reshape(-1))


def _from_sub4(p, sz: int):
    """(4B, sz/2, sz/2) sub-block predictions in k-order -> (B, sz, sz)."""
    half = sz // 2
    return p.reshape(-1, 2, 2, half, half).permute(0, 1, 3, 2, 4) \
        .reshape(-1, sz, sz)


def _amp_shapes(nt: int):
    """The AMP part codes with the (rows, cols) tile ranges of PU0 and
    PU1 on the (nt, nt) grid of 4x4 tiles (spec 7.4.9.5: 2NxnU, 2NxnD,
    nLx2N, nRx2N)."""
    f = (0, nt)
    return ((4, ((0, 1), f), ((1, nt), f)),
            (5, ((0, nt - 1), f), ((nt - 1, nt), f)),
            (6, (f, (0, 1)), (f, (1, nt))),
            (7, (f, (0, nt - 1)), (f, (nt - 1, nt))))


def _amp_tile_satd(org, tall, bx, y0, cmvs, n: int, bd: int):
    """(C, B, n/4, n/4) 4x4-tile SATD maps of the (B, n, n) source blocks
    against each of the C candidate MVs' predictions, read from the
    stacked planes `tall` at rows y0 (one MC batch)."""
    c = len(cmvs)
    pr = mc_batch(tall, bx.repeat(c), y0.repeat(c),
                  torch.cat([m[0] for m in cmvs]),
                  torch.cat([m[1] for m in cmvs]), n, 0, bd)
    ht = _had(_tiles(org.repeat(c, 1, 1) - pr, 4), 4)
    ts = (torch.abs(ht).sum((-2, -1), dtype=I32) + 1) >> 1
    return ts.reshape(c, -1, n // 4, n // 4)


def _amp_region_best(ts, cbits, reg, fields):
    """Best candidate per block for one PU region of the (C, B, nt, nt)
    tile-SATD maps: the region's SATD + cbits (C, B), first minimum.
    Returns (cost, each of `fields` (C, B) at the chosen candidate)."""
    (r0, r1), (c0, c1) = reg
    tot = ts[:, :, r0:r1, c0:c1].sum((-2, -1), dtype=I32) + cbits
    ci = torch.argmin(tot, 0)[None]
    return (tot.amin(0),) + tuple(torch.gather(f, 0, ci)[0] for f in fields)


def _amp_mask(part, sz: int, dev):
    """(B, sz, sz) mask of PU1's samples for the AMP part codes 4-7."""
    q = sz // 4
    yy = torch.arange(sz, device=dev)[None, :, None]
    xx = torch.arange(sz, device=dev)[None, None, :]
    pm = part[:, None, None]
    return torch.where(pm == 4, yy >= q,
                       torch.where(pm == 5, yy >= 3 * q,
                                   torch.where(pm == 6, xx >= q,
                                               xx >= 3 * q)))


def _amp_p_cands(org, tall, bx, y0, ref_sel, cmvs, nby: int, nbx: int,
                 lam256: int, n: int, bd: int):
    """The P AMP candidates (code, PU0 mvx, mvy, PU1 mvx, mvy, cost) of
    the reference: each quarter strip and its complementary body pick
    the best MV by strip SATD + lambda * (mv bits + 3 + ref_idx) from
    {cmvs (2Nx2N and the four rect PU MVs), the top and the left
    neighbours' 2Nx2N MVs}; a shape whose two PUs share one MV is never
    picked.  y0: each block's row on the stacked planes `tall`."""
    f2x = cmvs[0][0].reshape(nby, nbx)
    f2y = cmvs[0][1].reshape(nby, nbx)
    nbr = []
    for sy, sx in ((1, 0), (0, 1)):             # top, left
        nx, ok = _neigh_field(f2x, sy, sx)
        ny, _ = _neigh_field(f2y, sy, sx)
        nbr.append((torch.where(ok, nx, f2x).reshape(-1),
                    torch.where(ok, ny, f2y).reshape(-1)))
    cmvs = list(cmvs) + nbr
    ts = _amp_tile_satd(org, tall, bx, y0, cmvs, n, bd)
    cax = torch.stack([c[0] for c in cmvs])
    cay = torch.stack([c[1] for c in cmvs])
    cbits = (lam256 * (mv_bits(cax, cay) + 3 + ref_sel[None])) >> 8
    part_bins = (lam256 * 4) >> 8
    out = []
    for code, ra, rb in _amp_shapes(n // 4):
        c0, m0x, m0y = _amp_region_best(ts, cbits, ra, (cax, cay))
        c1, m1x, m1y = _amp_region_best(ts, cbits, rb, (cax, cay))
        cc = torch.where((m0x == m1x) & (m0y == m1y), 1 << 30,
                         c0 + c1 + part_bins)
        out.append((code, m0x, m0y, m1x, m1y, cc))
    return out


def _rd_resid_cost(org, pred, qp_b, log2n: int, bd: int, lam2):
    """Transform-domain RD of one motion option's luma residual: returns
    (coded_cost_sans_syntax, zero_residual_sse) per block (float32).
    The squared-error sums are integers below 2**24, so summing them as
    int32 and converting equals the reference's float32 sum."""
    imask = torch.zeros(org.shape[:1], dtype=torch.bool, device=org.device)
    coef = dct_batch(org - pred, log2n, bd)
    lev = quant_dyn(coef, imask, qp_b, log2n, bd)
    deq = dequant_dyn(lev, qp_b, log2n, bd)
    rec = torch.clip(pred + idct_batch(deq, log2n, bd), 0, (1 << bd) - 1)
    sse_c = ((org - rec) ** 2).sum((1, 2), dtype=I32).to(F32)
    sse_z = ((org - pred) ** 2).sum((1, 2), dtype=I32).to(F32)
    nz = (lev != 0).sum((1, 2), dtype=I32).to(F32)
    bits = (10.0 + 8.0 * torch.clamp(nz, max=4.0)
            + 6.0 * torch.clip(nz - 4.0, 0.0, 12.0)
            + 4.5 * torch.clamp(nz - 16.0, min=0.0))
    bits = torch.where(nz > 0, bits, 0.0)
    return fma32(lam2, bits, sse_c), sse_z


def _hme_center_fullres(ry, oy, nby: int, nbx: int, lam256: int,
                        sr: int):
    """Quarter-res HME tier for the main per-ref search (see the
    reference): 8x8 blocks on 1/4-res planes, each covering a 2x2 group
    of 16-blocks, full-search +-sr (K1); the MVs become FULLPEL window
    centres of the 16-blocks, extending the range to ~5*sr."""
    rq, oq = half_res(half_res(ry)), half_res(half_res(oy))
    gh, gw = max(nby // 2, 1), max(nbx // 2, 1)
    x0, y0 = _grid(gh, gw, 8, ry.device)
    zero = torch.zeros_like(x0)
    mvx, mvy, _ = full_search_batch(rq, oq, x0, y0, zero, zero, lam256, 8,
                                    sr)
    return (hme_upsample((mvx >> 2) * 4, gh, gw, nby, nbx),
            hme_upsample((mvy >> 2) * 4, gh, gw, nby, nbx))


def _me_one_ref(oy, ry, bx, by, n: int, lam256: int, search_range: int,
                bit_depth: int = 8, subme: int = 2, org=None, hme=None,
                me_sea: bool = False):
    """Full search (K1), or under me_sea the SEA-pruned search (k = 64,
    no window centres, as the reference calls it), + subpel against one
    reference, zero-pred regularized.  hme: optional (cx, cy) FULLPEL
    window centres from the quarter-res tier.  Returns (mvx, mvy, cost,
    org) int32; `org` (the (B, n, n) source blocks) is gathered here
    unless the caller passes it, as a P frame does once for all its
    references."""
    pz = torch.zeros_like(bx)
    if me_sea:
        imx, imy, _ = sea_search_batch(ry, oy, bx, by, pz, pz, lam256, n,
                                       search_range, k=64)
    else:
        imx, imy, _ = full_search_batch(
            ry, oy, bx, by, pz, pz, lam256, n, search_range,
            center_x=None if hme is None else hme[0],
            center_y=None if hme is None else hme[1])
    if org is None:
        org = _org_blocks(oy, bx, by, n)
    mvx, mvy, cost = subpel_refine_batch(ry, oy, bx, by, imx, imy, pz, pz,
                                         lam256, n, bit_depth, subme, org)
    return mvx, mvy, cost, org


WINDOW_NBY_LIMIT = 32     # block rows per banded analysis dispatch:
                          # the 4K cores measured 6.5 (P) / 13 (B) GiB
                          # of HLO temps whole-frame (tools/mem_probe);
                          # sequential row bands cap the working set
                          # like the reference's CTU-row processing
                          # (frameencoder.cpp:1638)


def _analysis_bands(sps, block: int, search_range: int):
    """None (whole-frame fits), or a list of
    (r0, r1, halo_top_rows, halo_bot_rows) block-row bands."""
    nby = sps.height // block
    nbx = sps.width // block
    if nby * nbx <= 9000:        # 1080p (8040 blocks) stays one dispatch
        return None
    halo = -(-(search_range + 24) // block) + 1
    per = max(4, (WINDOW_NBY_LIMIT - 2 * halo) & ~3)
    bands = []
    r0 = 0
    while r0 < nby:
        r1 = min(nby, r0 + per)
        bands.append((r0, r1, min(halo, r0), min(halo, nby - r1)))
        r0 = r1
    return bands


def _banded_analysis(fn, bands, sps, block, plane_args, col_field,
                     grid_outs, device):
    """Run `fn` per row band on sliced sub-planes and concatenate the
    block-grid outputs (the reference's _banded_analysis).  plane_args:
    name -> (y, u, v) planes or a list of them; col_field: the
    full-frame TMVP tuple of (nby, nbx) arrays, or None.  Each band is
    analysed as a frame of height y1 - y0, so its reads clamp at the
    band's edges (decision-only: entropy derives the true candidates)."""
    cs_y = 1 if getattr(sps, "chroma_format_idc", 1) == 1 else 0

    def dev_planes(t):
        return tuple(dev_i32(a, device) for a in t)

    devved = {name: [dev_planes(t) for t in val] if isinstance(val, list)
              else dev_planes(val) for name, val in plane_args.items()}
    outs = None
    for (r0, r1, ht, hb) in bands:
        y0 = (r0 - ht) * block
        y1 = (r1 + hb) * block
        sl = slice(y0, y1)
        csl = slice(y0 >> cs_y, y1 >> cs_y)

        def cut(t):
            return (t[0][sl], t[1][csl], t[2][csl])

        args = {name: [cut(t) for t in val] if isinstance(val, list)
                else cut(val) for name, val in devved.items()}
        sub_sps = dataclasses.replace(sps, height=y1 - y0)
        tm = None
        if col_field is not None:
            tm = tuple(a[r0 - ht:r1 + hb] for a in col_field)
        got = fn(sub_sps, args, tm)
        got = [o[ht:ht + (r1 - r0)] if i in grid_outs else o
               for i, o in enumerate(got)]
        if outs is None:
            outs = [[o] for o in got]
        else:
            for acc, o in zip(outs, got):
                acc.append(o)
    return [acc[0] if len(acc) == 1 else
            torch.cat(acc, 0) if isinstance(acc[0], torch.Tensor) else
            np.concatenate(acc, 0) for acc in outs]


def analyse_p_frame(y, u, v, refs, sps, qp: int, device,
                    search_range: int = 16, block: int = 16,
                    weights=None, subme: int = 2, rect: bool = False,
                    amp: bool = False, chroma_weights=None,
                    me_sea: bool = False, col=None, ref_pocs=None,
                    cur_poc: int = 0, pad_refs: int = 0,
                    hme: bool = False, rounds=(2, 1), _tmvp_field=None):
    """Multi-reference P analysis (see the reference's analyse_p_frame).

    refs: list of (ref_y, ref_u, ref_v) planes, L0 order (closest first).
    Returns (intra_modes, inter_mask, mvs, ref_sel, (mc_y, mc_u, mc_v),
    part_map, mvs_b); the mc planes stay device tensors.  part_map: 0
    2Nx2N, 1 2NxN, 2 Nx2N; mvs_b: PU1's MV of a rect block.
    _tmvp_field: set by _banded_analysis (the full-frame TMVP field cut
    to the band, or () for none).  part_map codes 4-7 are the AMP
    shapes 2NxnU, 2NxnD, nLx2N, nRx2N (amp: searched where rect is).
    In 4:2:2 mc_u / mc_v are (nby, nbx, 16, 8): each block's two stacked
    8x8 chroma TBs; in 4:4:4 they are full-size 16x16 blocks."""
    if block != 16:
        raise NotImplementedError("only 16x16 analysis blocks are ported")
    device = torch.device(device)
    csp = getattr(sps, "chroma_format_idc", 1)
    bands = None if _tmvp_field is not None \
        else _analysis_bands(sps, block, search_range)
    if bands is not None:
        field = None
        if col is not None and ref_pocs is not None and ref_pocs[0]:
            low_delay = all(rp <= cur_poc for lst_p in ref_pocs
                            for rp in lst_p)
            field = temporal_merge_field(
                col, sps.height // block, sps.width // block, block,
                sps.width, sps.height, sps.log2_ctu_size, 0,
                ref_pocs[0][0], cur_poc, low_delay)

        def run(sub_sps, args, tm):
            out = analyse_p_frame(
                args["cur"][0], args["cur"][1], args["cur"][2],
                args["refs"], sub_sps, qp, device,
                search_range=search_range, block=block, weights=weights,
                subme=subme, rect=rect, amp=amp,
                chroma_weights=chroma_weights, me_sea=me_sea,
                ref_pocs=ref_pocs, cur_poc=cur_poc, pad_refs=pad_refs,
                hme=hme, rounds=rounds,
                _tmvp_field=tm if tm is not None else ())
            return list(out[:4]) + list(out[4]) + list(out[5:])

        o = _banded_analysis(run, bands, sps, block,
                             {"cur": (y, u, v), "refs": list(refs)},
                             field, set(range(9)), device)
        return (o[0], o[1], o[2], o[3],
                _whole_frame_mc(o, refs, weights, chroma_weights, rect,
                                amp, hme, search_range, block,
                                sps.bit_depth, device, csp), o[7], o[8])
    bd = sps.bit_depth
    if weights is None:
        weights = [None] * len(refs)
    if chroma_weights is None:
        chroma_weights = [None] * len(refs)
    n_real = len(refs)
    if pad_refs > n_real:
        refs = list(refs) + [refs[-1]] * (pad_refs - n_real)
        weights = list(weights) + [None] * (pad_refs - n_real)
        chroma_weights = (list(chroma_weights)
                          + [None] * (pad_refs - n_real))
    oy = dev_i32(y, device)
    rys = [dev_i32(r[0], device) for r in refs]
    rus = [dev_i32(r[1], device) for r in refs]
    rvs = [dev_i32(r[2], device) for r in refs]
    avail = frame_avail_masks(sps.width, sps.height, block,
                              sps.log2_ctu_size, 0)
    lam, _ = lambda_qp(qp)
    lam256 = int(round(lam * 256)) << (bd - 8)
    # rect PUs search on unweighted planes only, and AMP where rect
    # does (see the reference)
    rect_eff = rect and not any(wp is not None for wp in weights)
    amp_eff = amp and rect_eff
    tmvp = None
    if _tmvp_field is not None:
        if len(_tmvp_field):
            tmvp = _tmvp_field
    elif col is not None and ref_pocs is not None and ref_pocs[0]:
        low_delay = all(rp <= cur_poc for lst_p in ref_pocs
                        for rp in lst_p)
        tmvp = temporal_merge_field(
            col, y.shape[0] // block, y.shape[1] // block, block,
            sps.width, sps.height, sps.log2_ctu_size, 0,
            ref_pocs[0][0], cur_poc, low_delay)
    out = _p_core(oy, rys, rus, rvs, weights, chroma_weights,
                  torch.from_numpy(avail.reshape(-1, avail.shape[-1]))
                  .to(device), lam256, qp, search_range, block, bd,
                  sps.log2_ctu_size, subme, tmvp, n_real, tuple(rounds),
                  rect_eff, hme, amp_eff, me_sea, csp)
    modes, inter, mvs, rsel, mcy, mcu, mcv, part, mvs_b = out
    h = lambda a: a.cpu().numpy()
    return (h(modes), h(inter), h(mvs), h(rsel), (mcy, mcu, mcv), h(part),
            h(mvs_b))


@dataclasses.dataclass(frozen=True)
class Band:
    """One band of a tile-row sharded P analysis (parallel/tiles.py).
    The planes given to _p_core are then the band's slab: its block rows
    with `halo` block rows of real neighbour pixels above and below.
    `index` is the band's place, `nby_total` the block rows of all bands
    together, and `exchange(fields)` the in-process counterpart of the
    reference's ppermute: for each (nby, nbx) field it returns the band
    above's last row and the band below's first row, zeros at the
    frame's edges (every band calls it at the same points)."""
    index: int
    nby_total: int
    halo: int
    exchange: object


def _p_core(oy, rys, rus, rvs, weights, chroma_weights, avail, lam256: int,
            qp: int, search_range: int, n: int, bd: int, log2_ctu: int,
            subme: int, tmvp, n_real: int, rounds, rect: bool = False,
            hme: bool = False, amp: bool = False, me_sea: bool = False,
            csp: int = 1, band: Band = None):
    """P analysis of one frame or row band on one device (the
    reference's _p_core); csp: the chroma format of rus / rvs (1, 2 or
    3).  band: None for a whole-frame call, else the Band whose slab the
    planes hold (HME is off in a band, and AMP is not taken)."""
    dev = oy.device
    h, w = oy.shape
    nbx = w // n
    if band is None:
        hb, nby, gby0 = 0, h // n, 0
        nby_total = nby
    else:
        if amp:
            raise NotImplementedError("AMP in a tile-row band")
        hb = band.halo
        nby = h // n - 2 * hb                 # the band's own block rows
        nby_total = band.nby_total
        gby0 = band.index * nby
    nb = nbx * nby
    nref = len(rys)
    log2n = n.bit_length() - 1
    bys_np, bxs_np = np.mgrid[0:nby, 0:nbx]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    bx = t((bxs_np.ravel() * n).astype(np.int32))
    by = t(((bys_np.ravel() + hb) * n).astype(np.int32))
    ry_all = []
    for i in range(nref):
        ry = rys[i]
        if weights[i] is not None:
            ry = weighted_plane(ry, int(weights[i][0]), int(weights[i][1]),
                                bit_depth=bd)
        ry_all.append(ry.contiguous())

    # 1. per-ref full search + subpel (zero-pred regularized); recover
    # pure SATD by subtracting the bit charge the search applied
    cands = []
    org = _org_blocks(oy, bx, by, n)
    for ry in ry_all:
        ctr = None
        if hme and not me_sea and band is None:
            ctr = _hme_center_fullres(ry, oy, nby, nbx, lam256,
                                      search_range)
        mvx, mvy, cost, _ = _me_one_ref(oy, ry, bx, by, n, lam256,
                                        search_range, bd, subme, org, ctr,
                                        me_sea)
        satd = cost - ((lam256 * mv_bits(mvx, mvy)) >> 8)
        cands.append((mvx, mvy, satd))

    satd_r = torch.stack([c[2] for c in cands])
    mvx_r = torch.stack([c[0] for c in cands])
    mvy_r = torch.stack([c[1] for c in cands])
    ridx = torch.arange(nref, device=dev, dtype=I32)[:, None]
    prov = satd_r + ((lam256 * (mv_bits(mvx_r, mvy_r) + ridx + 4)) >> 8)
    prov = torch.where(ridx < n_real, prov, 1 << 30)
    ref_sel = torch.argmin(prov, dim=0).to(I32)
    pick = lambda a: torch.gather(a, 0, ref_sel.long()[None])[0]
    mvx, mvy, satd_me = pick(mvx_r), pick(mvy_r), pick(satd_r)

    # 2. merge/AMVP candidate rounds; seeded (HME) MVs reach ~5*sr, and
    # the tall-strip pad must cover them
    m_pad = (6 * search_range + 12) if hme else (search_range + 12)
    tall, strip = _stack_refs(ry_all, m_pad)
    me_mvx, me_mvy, me_ref = mvx, mvy, ref_sel
    AV_A1, AV_A0, AV_B2, AV_B1, AV_B0 = n, n - 1, 2 * n, 3 * n, 3 * n + 1
    icosts = _mode_costs(oy, avail, t(bxs_np.ravel().astype(np.int32)),
                         t((bys_np.ravel() + hb).astype(np.int32)), log2n,
                         bd)
    intra_best = icosts.amin(1)
    intra_modes = torch.argmin(icosts, dim=1).to(I32)
    inter_est = (satd_me + ((lam256 * 4) >> 8)) <= \
        (intra_best + ((lam256 * 5) >> 8))

    def neigh(f2d, sy: int, sx: int, ext=None):
        """Coding-order neighbour values out[y, x] = f2d[y - sy, x - sx]
        (sy in -1..1).  A band reads the row past its edge from ext =
        (the row above, the row below); validity comes from the global
        availability masks."""
        if band is None or sy == 0:
            return _neigh_field(f2d, sy, sx)[0]
        if sy > 0:
            return torch.roll(torch.cat([ext[0], f2d], 0), sx, 1)[:nby]
        return torch.roll(torch.cat([f2d, ext[1]], 0), sx, 1)[1:nby + 1]
    lam_f = torch.tensor(float(lam256), dtype=F32, device=dev) / 256.0
    lam2 = lam_f * lam_f
    qp_b = torch.full((nb,), qp, dtype=I32, device=dev)
    av2 = avail.reshape(nb, -1)
    if tmvp is not None:
        tval, tmx_, tmy_ = (t(np.asarray(a).reshape(-1)) for a in tmvp)
        tmx_ = tmx_.to(I32)
        tmy_ = tmy_.to(I32)
        tval = tval & (torch.abs(tmy_) <= 4 * (m_pad - 8))
    else:
        zz0 = torch.zeros(nb, dtype=I32, device=dev)
        tval, tmx_, tmy_ = zz0 != 0, zz0, zz0

    def cand_round(mvx, mvy, rsel, rd: bool = False):
        f2x = mvx.reshape(nby, nbx)
        f2y = mvy.reshape(nby, nbx)
        f2r = rsel.reshape(nby, nbx)
        f2i = inter_est.reshape(nby, nbx)
        ext = [None] * 4 if band is None else \
            band.exchange([f2x, f2y, f2r, f2i])

        def gat(sy, sx):
            return (neigh(f2x, sy, sx, ext[0]).reshape(-1),
                    neigh(f2y, sy, sx, ext[1]).reshape(-1),
                    torch.clip(neigh(f2r, sy, sx, ext[2]).reshape(-1), 0,
                               nref - 1))

        def gat_ie(sy, sx):
            return neigh(f2i, sy, sx, ext[3]).reshape(-1)

        a1, b1, b0 = gat(0, 1), gat(1, 0), gat(1, -1)
        a0, b2 = gat(-1, 1), gat(1, 1)
        v_a1 = av2[:, AV_A1] & gat_ie(0, 1)
        v_b1r = av2[:, AV_B1] & gat_ie(1, 0)
        v_b0r = av2[:, AV_B0] & gat_ie(1, -1)
        v_a0r = av2[:, AV_A0] & gat_ie(-1, 1)
        v_b2r = av2[:, AV_B2] & gat_ie(1, 1)
        eq = lambda c, d: ((c[0] == d[0]) & (c[1] == d[1]) &
                           (c[2] == d[2]))
        v_b1 = v_b1r & ~(v_a1 & eq(b1, a1))
        v_b0 = v_b0r & ~(v_b1r & eq(b0, b1))
        v_a0 = v_a0r & ~(v_a1 & eq(a0, a1))
        i32 = lambda b_: b_.to(I32)
        n4 = i32(v_a1) + i32(v_b1) + i32(v_b0) + i32(v_a0)
        v_b2 = (v_b2r & (n4 < 4) & ~(v_a1 & eq(b2, a1))
                & ~(v_b1r & eq(b2, b1)))
        zz = torch.zeros(nb, dtype=I32, device=dev)
        idx_a1 = zz
        idx_b1 = i32(v_a1)
        idx_b0 = idx_b1 + i32(v_b1)
        idx_a0 = idx_b0 + i32(v_b0)
        idx_b2 = idx_a0 + i32(v_a0)
        n_sp = idx_b2 + i32(v_b2)
        v_t = tval & (n_sp < 3)
        idx_t = n_sp
        idx_z = n_sp + i32(v_t)
        v_z = idx_z < 3
        mcands = [(a1, v_a1, idx_a1), (b1, v_b1, idx_b1),
                  (b0, v_b0, idx_b0), (a0, v_a0, idx_a0),
                  (b2, v_b2, idx_b2),
                  ((tmx_, tmy_, zz), v_t, idx_t),
                  ((zz, zz, zz), v_z, idx_z)]
        p0x = torch.where(v_a1, a1[0], 0)
        p0y = torch.where(v_a1, a1[1], 0)
        p1x = torch.where(v_b1r, b1[0], 0)
        p1y = torch.where(v_b1r, b1[1], 0)
        mvd_bits_best = torch.minimum(mv_bits(me_mvx - p0x, me_mvy - p0y),
                                      mv_bits(me_mvx - p1x, me_mvy - p1y))
        cost_me = satd_me + ((lam256 * (mvd_bits_best + 3 + me_ref)) >> 8)
        best_cost = cost_me
        best_x, best_y, best_r = me_mvx, me_mvy, me_ref
        best_rd = None
        if rd:
            pr_me = mc_batch(tall, bx, by + me_ref * strip + m_pad,
                             me_mvx, me_mvy, n, 0, bd)
            cc, sz = _rd_resid_cost(org, pr_me, qp_b, log2n, bd, lam2)
            syn_me = (mvd_bits_best + 3 + me_ref).to(F32)
            best_rd = torch.minimum(fma32(lam2, syn_me, cc),
                                    fma32(lam2, syn_me + 1.0, sz))
        k_c = len(mcands)
        cmx_s = torch.stack([c[0][0] for c in mcands])
        cmy_s = torch.stack([c[0][1] for c in mcands])
        crf_s = torch.stack([c[0][2] for c in mcands])
        idx_s = torch.stack([c[2] for c in mcands])
        ok_s = torch.stack([c[1] for c in mcands]) & (idx_s < 3)
        idxb_s = torch.where(idx_s == 0, 1, 2).to(I32)
        # all candidates as one batch (the reference's vmap)
        pr = mc_batch(tall, bx.repeat(k_c),
                      (by[None] + crf_s * strip + m_pad).reshape(-1),
                      cmx_s.reshape(-1), cmy_s.reshape(-1), n, 0, bd)
        org_k = org.repeat(k_c, 1, 1)
        sc_r = satd_batch(org_k, pr).reshape(k_c, nb)
        sc_all = sc_r + ((lam256 * (2 + idxb_s)) >> 8)
        sc_all = torch.where(ok_s, sc_all, 1 << 30)
        if rd:
            cc_r, sz_r = _rd_resid_cost(org_k, pr, qp_b.repeat(k_c), log2n,
                                        bd, lam2)
            cc_r = cc_r.reshape(k_c, nb)
            sz_r = sz_r.reshape(k_c, nb)
            mb = (2 + idxb_s).to(F32)
            rdk_all = torch.minimum(fma32(lam2, mb + 4.0, cc_r),
                                    fma32(lam2, mb, sz_r))
            rdk_all = torch.where(ok_s, rdk_all,
                                  torch.tensor(3e38, dtype=F32, device=dev))
        for k in range(k_c):
            if rd:
                upd = rdk_all[k] < best_rd
                best_rd = torch.where(upd, rdk_all[k], best_rd)
            else:
                upd = sc_all[k] < best_cost
            best_cost = torch.where(upd, sc_all[k], best_cost)
            best_x = torch.where(upd, cmx_s[k], best_x)
            best_y = torch.where(upd, cmy_s[k], best_y)
            best_r = torch.where(upd, crf_s[k], best_r)
        return best_x, best_y, best_r, best_cost, best_rd

    cost = cost_rd = None
    for _ in range(rounds[0]):
        mvx, mvy, ref_sel, cost, _ = cand_round(mvx, mvy, ref_sel)
    for _ in range(rounds[1]):
        mvx, mvy, ref_sel, cost, cost_rd = cand_round(mvx, mvy, ref_sel,
                                                      rd=True)

    # 2b. rect PU candidates (2NxN / Nx2N): 8x8 sub-block ME on each
    # block's chosen reference (K1 on the stacked planes), then PU costs
    # from own + partner SATD pairings
    part = torch.zeros(nb, dtype=I32, device=dev)
    mvbx = torch.zeros(nb, dtype=I32, device=dev)
    mvby = torch.zeros(nb, dtype=I32, device=dev)
    if rect:
        sx4, sy4 = _sub4(bx, by)
        rsel4 = ref_sel.repeat_interleave(4)
        otall = _stack_refs([oy] * nref, m_pad)[0]
        ytall = sy4 + rsel4 * strip + m_pad
        pz4 = torch.zeros(nb * 4, dtype=I32, device=dev)
        im8x, im8y, _ = full_search_batch(tall, otall, sx4, ytall, pz4, pz4,
                                          lam256, 8, search_range)
        org8 = _org_blocks(oy, sx4, sy4, 8)
        mv8x, mv8y, c8 = subpel_refine_batch(tall, otall, sx4, ytall, im8x,
                                             im8y, pz4, pz4, lam256, 8, bd,
                                             subme)
        own = (c8 - ((lam256 * mv_bits(mv8x, mv8y)) >> 8)).reshape(nb, 4)

        def cross_satd(perm):
            px_ = mv8x.reshape(nb, 4)[:, perm].reshape(-1)
            py_ = mv8y.reshape(nb, 4)[:, perm].reshape(-1)
            pr = mc_batch(tall, sx4, ytall, px_, py_, 8, 0, bd)
            return satd_batch(org8, pr).reshape(nb, 4)

        crossH = cross_satd([1, 0, 3, 2])
        crossV = cross_satd([2, 3, 0, 1])
        m8 = (mv8x.reshape(nb, 4), mv8y.reshape(nb, 4))
        pu_bits = (lam256 * (3 + ref_sel)) >> 8

        def pu_best(sa, sb, ca, cb):
            """PU of sub-blocks (a, b): ca = a's MV over both, cb = b's
            MV; returns (cost, mvx, mvy)."""
            cA = sa[0] + sb[0] + ((lam256 * mv_bits(
                m8[0][:, ca], m8[1][:, ca])) >> 8) + pu_bits
            cB = sa[1] + sb[1] + ((lam256 * mv_bits(
                m8[0][:, cb], m8[1][:, cb])) >> 8) + pu_bits
            useA = cA <= cB
            return (torch.where(useA, cA, cB),
                    torch.where(useA, m8[0][:, ca], m8[0][:, cb]),
                    torch.where(useA, m8[1][:, ca], m8[1][:, cb]))

        # 2NxN: top PU = subs (0, 1), bottom = (2, 3)
        cT, mTx, mTy = pu_best((own[:, 0], crossH[:, 0]),
                               (crossH[:, 1], own[:, 1]), 0, 1)
        cBt, mBx, mBy = pu_best((own[:, 2], crossH[:, 2]),
                                (crossH[:, 3], own[:, 3]), 2, 3)
        costH = cT + cBt + ((lam256 * 2) >> 8)
        # Nx2N: left PU = subs (0, 2), right = (1, 3)
        cL, mLx, mLy = pu_best((own[:, 0], crossV[:, 0]),
                               (crossV[:, 2], own[:, 2]), 0, 2)
        cR, mRx, mRy = pu_best((own[:, 1], crossV[:, 1]),
                               (crossV[:, 3], own[:, 3]), 1, 3)
        costV = cL + cR + ((lam256 * 2) >> 8)
        # a degenerate rect (both PUs one MV) is never picked
        costH = torch.where((mTx == mBx) & (mTy == mBy), 1 << 30, costH)
        costV = torch.where((mLx == mRx) & (mLy == mRy), 1 << 30, costV)
        zero = torch.zeros_like(mvx)
        cands = [(0, mvx, mvy, zero, zero, cost),
                 (1, mTx, mTy, mBx, mBy, costH),
                 (2, mLx, mLy, mRx, mRy, costV)]
        if amp:
            cands += _amp_p_cands(
                org, tall, bx, by + ref_sel * strip + m_pad, ref_sel,
                [(mvx, mvy), (mTx, mTy), (mBx, mBy), (mLx, mLy),
                 (mRx, mRy)], nby, nbx, lam256, n, bd)
        allc = torch.stack([c[5] for c in cands])
        idx = torch.argmin(allc, dim=0)
        part = torch.tensor([c[0] for c in cands], dtype=I32,
                            device=dev)[idx]
        cost = allc.amin(0)
        pick = lambda f: torch.gather(torch.stack([c[f] for c in cands]),
                                      0, idx[None])[0]
        mvx, mvy = pick(1), pick(2)
        mvbx, mvby = pick(3), pick(4)

    # 2c. motion homogenization over 32 (and, at CTU64, 64) regions of
    # 2Nx2N blocks
    def _region_uniform(mvx, mvy, ref_sel, cost, cost_rd, part, g):
        gh, gw = nby // g, nbx // g
        if gh == 0 or gw == 0 or n != 16:
            return mvx, mvy, ref_sel, cost, cost_rd
        f2 = lambda a: a.reshape(nby, nbx)
        crop = lambda a: f2(a)[:gh * g, :gw * g]
        rep2 = lambda a: a.repeat_interleave(g, 0).repeat_interleave(g, 1)
        gsum_f = lambda a: _group_sum(a, gh, g, gw)
        ok = (crop(part) == 0).reshape(gh, g, gw, g).all(3).all(1)
        if band is not None:
            # a band's group must lie inside the bands' rows
            gy = torch.arange(gh, device=dev)[:, None]
            ok = ok & ((gby0 + (gy + 1) * g) <= nby_total)
        indiv_rd = gsum_f(crop(cost_rd))
        s = g // 2

        def setc(a, val):
            o = f2(a).clone()
            o[:gh * g, :gw * g] = val
            return o.reshape(-1)

        def eval_cand(rmx, rmy, rrf, gbits, valid=None):
            fmx = setc(mvx, rep2(rmx))
            fmy = setc(mvy, rep2(rmy))
            frf = setc(ref_sel, rep2(rrf))
            pr = mc_batch(tall, bx, by + frf * strip + m_pad, fmx, fmy, n,
                          0, bd)
            sbc = crop(satd_batch(org, pr))
            cc, sz = _rd_resid_cost(org, pr, qp_b, log2n, bd, lam2)
            blk_rd = crop(torch.minimum(cc, sz))
            tot = fma32(lam2, gbits.to(F32), gsum_f(blk_rd))
            if valid is not None:
                tot = torch.where(valid, tot,
                                  torch.tensor(3e38, dtype=F32, device=dev))
            return [tot, rmx, rmy, rrf, sbc, gbits, blk_rd]

        def merge_best(best, cand):
            if best is None:
                return cand
            u_ = cand[0] < best[0]
            ub = rep2(u_)
            return [torch.where(u_, cand[0], best[0]),
                    torch.where(u_, cand[1], best[1]),
                    torch.where(u_, cand[2], best[2]),
                    torch.where(u_, cand[3], best[3]),
                    torch.where(ub, cand[4], best[4]),
                    torch.where(u_, cand[5], best[5]),
                    torch.where(ub, cand[6], best[6])]

        best = None
        for c in range(4):
            sy, sx = (c >> 1) * s, (c & 1) * s
            rmx = crop(mvx)[sy::g, sx::g]
            rmy = crop(mvy)[sy::g, sx::g]
            rrf = crop(ref_sel)[sy::g, sx::g]
            best = merge_best(best, eval_cand(rmx, rmy, rrf, 8 + rrf))
        ry_i = torch.arange(gh, device=dev) * g
        rx_i = torch.arange(gw, device=dev) * g
        fx2, fy2, fr2 = f2(mvx), f2(mvy), f2(ref_sel)
        a1_r = ry_i + (g - 1)
        a1_c = rx_i - 1
        va1 = (a1_c >= 0)[None, :].expand(gh, gw)
        ac = torch.clip(a1_c, 0, nbx - 1)
        mb3 = torch.full((gh, gw), 3, dtype=I32, device=dev)
        best = merge_best(best, eval_cand(
            fx2[a1_r[:, None], ac[None, :]],
            fy2[a1_r[:, None], ac[None, :]],
            fr2[a1_r[:, None], ac[None, :]], mb3, va1))
        b1_r = ry_i - 1
        b1_c = rx_i + (g - 1)
        if band is None:
            vb1 = (b1_r >= 0)[:, None].expand(gh, gw)
            br = torch.clip(b1_r, 0, nby - 1)
        else:
            # the first group row's B1 lies on the band above's last row
            ups = band.exchange([fx2, fy2, fr2])
            fx2, fy2, fr2 = (torch.cat([e[0], f], 0)
                             for e, f in zip(ups, (fx2, fy2, fr2)))
            vb1 = ((gby0 + b1_r) >= 0)[:, None].expand(gh, gw)
            br = b1_r + 1
        best = merge_best(best, eval_cand(
            fx2[br[:, None], b1_c[None, :]],
            fy2[br[:, None], b1_c[None, :]],
            fr2[br[:, None], b1_c[None, :]], mb3, vb1))
        zz = torch.zeros((gh, gw), dtype=I32, device=dev)
        best = merge_best(best, eval_cand(zz, zz, zz, mb3 + 1))
        tot, rmx, rmy, rrf, sbc, gbits, blk_rd = best
        acc = ok & (tot <= indiv_rd + lam2 * 4.0)
        accb = rep2(acc)
        pb_bits = rep2(((lam256 * gbits) >> 8) // (g * g))
        new = [setc(a, torch.where(accb, rep2(r), crop(a)))
               for a, r in ((mvx, rmx), (mvy, rmy), (ref_sel, rrf))]
        new_cost = setc(cost, torch.where(accb, sbc + pb_bits, crop(cost)))
        new_rd = setc(cost_rd, torch.where(
            accb, blk_rd + lam2 * rep2(gbits).to(F32) / (g * g),
            crop(cost_rd)))
        return new[0], new[1], new[2], new_cost, new_rd

    mvx, mvy, ref_sel, cost, cost_rd = _region_uniform(
        mvx, mvy, ref_sel, cost, cost_rd, part, 2)
    if log2_ctu == 6:
        mvx, mvy, ref_sel, cost, cost_rd = _region_uniform(
            mvx, mvy, ref_sel, cost, cost_rd, part, 4)

    # 4. decision: inter unless intra clearly wins
    use_inter = cost <= (intra_best + ((lam256 * 5) >> 8))

    # 5. MC predictions of the chosen (ref, mv) per block
    mc = [p.reshape(nby, nbx, p.shape[1], p.shape[2]) for p in _p_mc(
        rys, rus, rvs, weights, chroma_weights, bx, by, mvx, mvy, ref_sel,
        part, mvbx, mvby, n, bd, m_pad, rect, tall, amp, csp)]

    mvs = torch.stack([mvx, mvy], -1).reshape(nby, nbx, 2).to(I32)
    mvs_b = torch.stack([mvbx, mvby], -1).reshape(nby, nbx, 2).to(I32)
    return (intra_modes.reshape(nby, nbx), use_inter.reshape(nby, nbx),
            mvs, ref_sel.reshape(nby, nbx), mc[0], mc[1], mc[2],
            part.reshape(nby, nbx), mvs_b)


def _mc_parts(bx, by, n: int, csp: int, pi: int):
    """The MC blocks of component `pi` of each n x n luma block at (bx,
    by): (x and y origins, size, MV scale in x and y) per block.  4:2:0
    chroma is one half-size block at the luma MV; 4:4:4 chroma one
    full-size block, the quarter-pel MV doubled into the chroma MC's
    eighth-pel convention; 4:2:2 chroma two stacked half-width TBs, the
    vertical MV component doubled."""
    if pi == 0:
        return [(bx, by, n, 1, 1)]
    if csp == 2:
        return [(bx >> 1, by + (n >> 1) * j, n >> 1, 1, 2) for j in (0, 1)]
    if csp == 3:
        return [(bx, by, n, 2, 2)]
    return [(bx >> 1, by >> 1, n >> 1, 1, 1)]


def _scaled(mvx, mvy, sx: int, sy: int):
    return (mvx if sx == 1 else mvx * sx), (mvy if sy == 1 else mvy * sy)


def _p_mc(rys, rus, rvs, weights, chroma_weights, bx, by, mvx, mvy,
          ref_sel, part, mvbx, mvby, n: int, bd: int, m_pad: int,
          rect: bool, tall=None, amp: bool = False, csp: int = 1):
    """Final P predictions (B, sz, sz) of the planes' three components:
    the chosen (ref, mv) per block from the per-ref planes (weighted refs
    take the exact 14-bit path), for rect blocks the per-sub-block MC and
    for AMP blocks the quarter-strip combine of two full-block MCs (PU0's
    and PU1's MV), both from the references stacked with `m_pad`-row pads
    (`tall`: the stacked luma planes, when the caller holds them).
    csp: the chroma format (rect and AMP are 4:2:0 only); 4:2:2 chroma
    comes as (B, n, n // 2), the block's two stacked TBs."""
    dev = bx.device
    nref = len(rys)
    if rect:
        # per-sub-block final MVs: PU1 covers the bottom row (2NxN) or
        # the right column (Nx2N) of the 2x2 sub-block grid
        sx4, sy4 = _sub4(bx, by)
        rsel4 = ref_sel.repeat_interleave(4)
        if tall is None:
            tall = _stack_refs(rys, m_pad)[0]
        strip = rys[0].shape[0] + 2 * m_pad
        ytall = sy4 + rsel4 * strip + m_pad
        subB = torch.where(
            (part == 1)[:, None], _SUBB_H.to(dev)[None, :],
            torch.where((part == 2)[:, None], _SUBB_V.to(dev)[None, :], 0))
        fmvx = torch.where(subB == 1, mvbx[:, None], mvx[:, None]).reshape(-1)
        fmvy = torch.where(subB == 1, mvby[:, None], mvy[:, None]).reshape(-1)
        m_c = m_pad // 2
        strip_c = rus[0].shape[0] + 2 * m_c
        tall_c = [None, _stack_refs(rus, m_c)[0], _stack_refs(rvs, m_c)[0]]
        ytall_c = sy4 // 2 + rsel4 * strip_c + m_c
    mc = []
    for pi in range(3):
        parts = []
        for bx_, by_, sz, sx, sy in _mc_parts(bx, by, n, csp, pi):
            mx, my = _scaled(mvx, mvy, sx, sy)
            sel = None
            for r_i in range(nref):
                rp = (rys, rus, rvs)[pi][r_i]
                wp = weights[r_i]
                cw = chroma_weights[r_i]
                if pi == 0 and wp is not None:
                    p14 = mc_batch_14(rp, bx_, by_, mx, my, sz, 0, bd)
                    pr = wp_apply_batch(p14, int(wp[0]), int(wp[1]), 6, bd)
                elif pi != 0 and cw is not None:
                    p14 = mc_batch_14(rp, bx_, by_, mx, my, sz, pi, bd)
                    pr = wp_apply_batch(p14, int(cw[pi - 1][0]),
                                        int(cw[pi - 1][1]), 6, bd)
                else:
                    pr = mc_batch(rp, bx_, by_, mx, my, sz, pi, bd)
                sel = pr if sel is None else torch.where(
                    (ref_sel == r_i)[:, None, None], pr, sel)
            parts.append(sel)
        sel = torch.cat(parts, 1)
        # rect and AMP are 4:2:0 only: one block per component, `sz`
        if rect:
            if pi == 0:
                rp8 = mc_batch(tall, sx4, ytall, fmvx, fmvy, 8, 0, bd)
            else:
                rp8 = mc_batch(tall_c[pi], sx4 // 2, ytall_c, fmvx, fmvy,
                               4, pi, bd)
            sel = torch.where(((part > 0) & (part < 4))[:, None, None],
                              _from_sub4(rp8, sz), sel)
            if amp:
                if pi == 0:
                    ya, pa, bxa = by + ref_sel * strip + m_pad, tall, bx
                else:
                    ya = by // 2 + ref_sel * strip_c + m_c
                    pa, bxa = tall_c[pi], bx // 2
                a0 = mc_batch(pa, bxa, ya, mvx, mvy, sz, pi, bd)
                a1 = mc_batch(pa, bxa, ya, mvbx, mvby, sz, pi, bd)
                sel = torch.where((part >= 4)[:, None, None],
                                  torch.where(_amp_mask(part, sz, dev), a1,
                                              a0), sel)
        mc.append(sel)
    return mc


def _grid(nby: int, nbx: int, n: int, device):
    """(B,) x and y origins of the (nby, nbx) grid of n-blocks."""
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    t = lambda a: torch.from_numpy((a.ravel() * n).astype(np.int32)) \
        .to(device)
    return t(bxs), t(bys)


def _whole_frame_mc(o, refs, weights, chroma_weights, rect: bool,
                    amp: bool, hme: bool, sr: int, n: int, bd: int, device,
                    csp: int = 1):
    """The final P predictions of a banded analysis (outputs `o` of the
    band runs), read again from the whole-frame planes.  A band's own
    MC clamps its reads at the band's edges, which differs from the
    decoder's MC once a motion vector reaches past the band's halo (HME
    centres reach ~5*sr; the halo is sr + 24 px and a block row); the
    reference keeps the band's predictions, so its banded streams can
    fail to decode, and this port departs from it there."""
    nby, nbx = o[1].shape
    refs = list(refs)
    weights = list(weights or [None] * len(refs))
    chroma_weights = list(chroma_weights or [None] * len(refs))
    pl = [[dev_i32(r[i], device) for r in refs] for i in range(3)]
    rect = rect and not any(wp is not None for wp in weights)
    amp = amp and rect
    bx, by = _grid(nby, nbx, n, device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device) \
        .to(I32)
    mvs, mvs_b = t(o[2]).reshape(-1, 2), t(o[8]).reshape(-1, 2)
    m_pad = (6 * sr + 12) if hme else (sr + 12)
    mc = _p_mc(*pl, weights, chroma_weights, bx, by, mvs[:, 0], mvs[:, 1],
               t(o[3]).reshape(-1), t(o[7]).reshape(-1), mvs_b[:, 0],
               mvs_b[:, 1], n, bd, m_pad, rect, amp=amp, csp=csp)
    return tuple(p.reshape(nby, nbx, p.shape[1], p.shape[2]) for p in mc)


def _whole_frame_mc_b(o, refs0, refs1, rect: bool, amp: bool, hme: bool,
                      sr: int, n: int, bd: int, device, weights_b=None,
                      csp: int = 1):
    """The final B predictions of a banded analysis, read again from the
    whole-frame planes (see _whole_frame_mc)."""
    nby, nbx = o[1].shape
    pl = lambda rl: tuple([dev_i32(r[i], device) for r in rl]
                          for i in range(3))
    bx, by = _grid(nby, nbx, n, device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device) \
        .to(I32).reshape(-1)
    fl = lambda a: t(a).reshape(-1, 2)
    m0, m1, p0, p1 = fl(o[3]), fl(o[4]), fl(o[12]), fl(o[13])
    m_pad = (6 * sr + 12) if hme else (sr + 12)
    mc = _b_mc(pl(refs0), pl(refs1), bx, by, t(o[2]), m0[:, 0], m0[:, 1],
               m1[:, 0], m1[:, 1], t(o[5]), t(o[6]), t(o[10]), t(o[11]),
               p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1], n, bd, m_pad, rect,
               amp=amp, weights_b=weights_b, csp=csp)
    return tuple(p.reshape(nby, nbx, p.shape[1], p.shape[2]) for p in mc)


def _b_tmvp_field(col, sps, block, ref_pocs, cur_poc):
    """Full-frame 2-D B TMVP field (td, m0x, m0y, m1x, m1y) for the
    band driver to row-slice (same derivation as the whole-frame
    analyse_b_frame path)."""
    low_delay = all(rp <= cur_poc for lst_p in ref_pocs
                    for rp in lst_p)
    nby_ = sps.height // block
    nbx_ = sps.width // block
    v0, m0x_, m0y_ = temporal_merge_field(
        col, nby_, nbx_, block, sps.width, sps.height,
        sps.log2_ctu_size, 0, ref_pocs[0][0], cur_poc, low_delay)
    v1 = np.zeros_like(v0)
    m1x_ = np.zeros_like(m0x_)
    m1y_ = np.zeros_like(m0y_)
    if ref_pocs[1]:
        v1, m1x_, m1y_ = temporal_merge_field(
            col, nby_, nbx_, block, sps.width, sps.height,
            sps.log2_ctu_size, 1, ref_pocs[1][0], cur_poc, low_delay)
    td_ = (v0.astype(np.int32) | (v1.astype(np.int32) << 1))
    return (td_, np.asarray(m0x_), np.asarray(m0y_),
            np.asarray(m1x_), np.asarray(m1y_))


def _wb_pairs(weights_b):
    """Per-list explicit luma (w, o) of a weighted-B call, (64, 0) for an
    unweighted list (the default weights, denominator 6)."""
    return tuple((int(wp[0]), int(wp[1])) if wp is not None else (64, 0)
                 for wp in weights_b)


def _b_mc(refs0, refs1, bx, by, dirs, mv0x, mv0y, mv1x, mv1y, ref0_f,
          ref1_f, part, dirs_b, pu1_0x, pu1_0y, pu1_1x, pu1_1y, n: int,
          bd: int, m_pad: int, rect: bool, talls=(None, None),
          amp: bool = False, weights_b=None, csp: int = 1):
    """Final B predictions (B, sz, sz) of the three components: the chosen
    (dir, ref, mv) per block from the per-ref planes with a select (so
    edge clamping matches the decoder's spec MC), for rect blocks the
    per-sub-block uni MC from ref 0 of each PU's list, on the references
    stacked with `m_pad`-row pads (`talls`: the stacked luma planes per
    list, when the caller holds them), and for AMP blocks the
    quarter-strip combine of each PU's full-block uni MC from ref 0 of
    its list.  refs0 / refs1: (y, u, v) plane lists per list.
    weights_b: per-list luma (w, o) or None (weighted B: luma only).
    csp: the chroma format (rect and AMP are 4:2:0 only); 4:2:2 chroma
    comes as (B, n, n // 2), the block's two stacked TBs."""
    r0ys, ru0s, rv0s = refs0
    r1ys, ru1s, rv1s = refs1
    dev = bx.device
    if rect:
        sx4, sy4 = _sub4(bx, by)
        ytall = sy4 + m_pad                     # ref 0 of each list
        tall0, tall1 = (t if t is not None else _stack_refs(p, m_pad)[0]
                        for t, p in zip(talls, (r0ys, r1ys)))
        # PU0 rides dirs and the CU's MV of its list; PU1 dirs_b and the
        # PU1 MV of its list
        p0l, p1l = dirs - 1, dirs_b - 1
        p0x = torch.where(p0l == 0, mv0x, mv1x)
        p0y = torch.where(p0l == 0, mv0y, mv1y)
        p1x = torch.where(p1l == 0, pu1_0x, pu1_1x)
        p1y = torch.where(p1l == 0, pu1_0y, pu1_1y)
        subB = torch.where(
            (part == 1)[:, None], _SUBB_H.to(dev)[None, :],
            torch.where((part == 2)[:, None], _SUBB_V.to(dev)[None, :], 0))
        s_l = torch.where(subB == 1, p1l[:, None], p0l[:, None]).reshape(-1)
        s_x = torch.where(subB == 1, p1x[:, None], p0x[:, None]).reshape(-1)
        s_y = torch.where(subB == 1, p1y[:, None], p0y[:, None]).reshape(-1)
    is_bi = (dirs == 3)[:, None, None]
    use_l0 = ((dirs == 1)[:, None, None]) | is_bi

    def sel_ref_mc(planes, rsel_f, fn):
        sel = None
        for ridx, rp in enumerate(planes):
            pr = fn(rp)
            sel = pr if sel is None else torch.where(
                (rsel_f == ridx)[:, None, None], pr, sel)
        return sel

    mc = []
    for (pls0, pls1, c_idx) in ((r0ys, r1ys, 0), (ru0s, ru1s, 1),
                                (rv0s, rv1s, 2)):
        parts = []
        for bx_, by_, sz, sx, sy in _mc_parts(bx, by, n, csp, c_idx):
            m0x, m0y = _scaled(mv0x, mv0y, sx, sy)
            m1x, m1y = _scaled(mv1x, mv1y, sx, sy)
            per = lambda fn, p, mx, my: fn(p, bx_, by_, mx, my, sz, c_idx,
                                           bd)
            b0 = sel_ref_mc(pls0, ref0_f,
                            lambda p: per(mc_batch_14, p, m0x, m0y))
            b1 = sel_ref_mc(pls1, ref1_f,
                            lambda p: per(mc_batch_14, p, m1x, m1y))
            if c_idx == 0 and weights_b is not None:
                # weighted B is luma-only (the chroma flags stay 0)
                (w0, o0), (w1, o1) = _wb_pairs(weights_b)
                u0 = wp_apply_batch(b0, w0, o0, 6, bd)
                u1 = wp_apply_batch(b1, w1, o1, 6, bd)
                bi = wp_bi_combine(b0, b1, w0, o0, w1, o1, 6, bd)
            else:
                u0 = sel_ref_mc(pls0, ref0_f,
                                lambda p: per(mc_batch, p, m0x, m0y))
                u1 = sel_ref_mc(pls1, ref1_f,
                                lambda p: per(mc_batch, p, m1x, m1y))
                bi = bi_combine(b0, b1, bd)
            parts.append(torch.where(is_bi, bi, torch.where(use_l0, u0, u1)))
        sel = torch.cat(parts, 1)
        # rect and AMP are 4:2:0 only: one block per component, `per`
        # and `sz` its own
        if rect:
            # rect winners: per-sub-block uni MC from ref 0 of each sub's
            # list, reassembled into the full block (MVs stay inside the
            # strips' pad, so the stacked planes clamp as the spec does)
            if c_idx == 0:
                s0 = mc_batch(tall0, sx4, ytall, s_x, s_y, 8, 0, bd)
                s1 = mc_batch(tall1, sx4, ytall, s_x, s_y, 8, 0, bd)
            else:
                m_c = m_pad // 2
                ytc = (sy4 >> 1) + m_c
                s0, s1 = (mc_batch(_stack_refs(pls, m_c)[0], sx4 >> 1, ytc,
                                   s_x, s_y, 4, c_idx, bd)
                          for pls in (pls0, pls1))
            s8 = torch.where((s_l == 0)[:, None, None], s0, s1)
            sel = torch.where(((part > 0) & (part < 4))[:, None, None],
                              _from_sub4(s8, sz), sel)
            if amp:
                # AMP winners: each PU's full-block uni MC from ref 0 of
                # its list, combined on the quarter-strip geometry
                pu = [torch.where((lst == 0)[:, None, None],
                                  per(mc_batch, pls0[0], mx, my),
                                  per(mc_batch, pls1[0], mx, my))
                      for lst, mx, my in ((p0l, p0x, p0y),
                                          (p1l, p1x, p1y))]
                sel = torch.where((part >= 4)[:, None, None],
                                  torch.where(_amp_mask(part, sz, dev),
                                              pu[1], pu[0]), sel)
        mc.append(sel)
    return mc


def analyse_b_frame(y, u, v, refs0, refs1, sps, qp: int, device,
                    search_range: int = 16, block: int = 16,
                    subme: int = 2, weights_b=None, rect: bool = False,
                    me_sea: bool = False, amp: bool = False,
                    col=None, ref_pocs=None, cur_poc: int = 0,
                    pad_refs=(0, 0), hme: bool = False,
                    rounds=(2, 2), _tmvp_field=None):
    """B-frame analysis (see the reference's analyse_b_frame): per-list
    multi-reference ME, the bi-prediction test, merge/AMVP candidate
    rounds over (dir, mv0, ref0, mv1, ref1), region homogenization and
    the intra fallback.

    refs0/refs1: lists of (y, u, v) planes in L0/L1 order (closest
    first); a bare (y, u, v) tuple is accepted too.  ref_pocs: (l0_pocs,
    l1_pocs) matching the lists (TMVP scaling, combined-bi pruning).
    pad_refs: the reference pads each list to a fixed lane count to
    bound recompiles and masks the padded lanes so they never win; here
    the padded references are not searched at all, which gives the same
    outputs.  rect: 2NxN / Nx2N PUs with a per-PU list choice (uni-pred
    per rect PU on ref 0 of the list).  Returns (intra_modes, inter_mask,
    dirs, mv_l0, mv_l1, ref_sel0, ref_sel1, (mc_y, mc_u, mc_v), part,
    (dirs_b, mv0_b, mv1_b)); the mc planes stay device tensors.
    weights_b: optional ((w0, o0)-or-None, (w1, o1)-or-None) explicit
    luma weights per list (--weightb): the lists collapse to their first
    reference, ME searches pre-weighted planes and rect / AMP are off.
    amp: AMP PUs with a per-strip (list, MV) choice, where rect is on.
    _tmvp_field: set by _banded_analysis (see analyse_p_frame).  Outside
    4:2:0 the lists collapse to their first reference and rect / AMP
    are off, as in the reference; the chroma mc planes are shaped as
    analyse_p_frame's."""
    if block != 16:
        raise NotImplementedError("only 16x16 analysis blocks are ported")

    def _norm(rl):
        if len(rl) == 3 and getattr(rl[0], "ndim", 0) == 2:
            return [rl]
        return list(rl)
    refs0 = _norm(refs0)
    refs1 = _norm(refs1)
    device = torch.device(device)
    csp = getattr(sps, "chroma_format_idc", 1)
    if weights_b is not None and all(wp is None for wp in weights_b):
        weights_b = None
    rect_eff = rect and weights_b is None and csp == 1
    amp_eff = amp and rect_eff
    # multi-reference lists assume 4:2:0 and unweighted lists: otherwise
    # they collapse to 1 + 1, as in the reference
    one_ref = weights_b is not None or csp != 1
    bands = None if _tmvp_field is not None \
        else _analysis_bands(sps, block, search_range)
    if bands is not None:
        field = None
        if col is not None and ref_pocs is not None and ref_pocs[0]:
            field = _b_tmvp_field(col, sps, block, ref_pocs, cur_poc)

        def run(sub_sps, args, tm):
            out = analyse_b_frame(
                args["cur"][0], args["cur"][1], args["cur"][2],
                args["refs0"], args["refs1"], sub_sps, qp, device,
                search_range=search_range, block=block, subme=subme,
                weights_b=weights_b, rect=rect, me_sea=me_sea, amp=amp,
                ref_pocs=ref_pocs, cur_poc=cur_poc,
                pad_refs=pad_refs, hme=hme, rounds=rounds,
                _tmvp_field=tm if tm is not None else ())
            return (list(out[:7]) + list(out[7]) + [out[8]]
                    + list(out[9]))

        o = _banded_analysis(run, bands, sps, block,
                             {"cur": (y, u, v), "refs0": list(refs0),
                              "refs1": list(refs1)},
                             field, set(range(14)), device)
        cut = slice(0, 1) if one_ref else slice(None)
        return (o[0], o[1], o[2], o[3], o[4], o[5], o[6],
                _whole_frame_mc_b(o, refs0[cut], refs1[cut], rect_eff,
                                  amp_eff, hme, search_range, block,
                                  sps.bit_depth, device, weights_b, csp),
                o[10], (o[11], o[12], o[13]))
    if one_ref:
        refs0 = refs0[:1]
        refs1 = refs1[:1]
        if ref_pocs is not None:
            ref_pocs = (tuple(ref_pocs[0][:1]), tuple(ref_pocs[1][:1]))
    bd = sps.bit_depth
    lam, _ = lambda_qp(qp)
    lam256 = int(round(lam * 256)) << (bd - 8)
    avail = frame_avail_masks(sps.width, sps.height, block,
                              sps.log2_ctu_size, 0)
    if ref_pocs is not None and ref_pocs[0] and ref_pocs[1]:
        l0p = [int(p) for p in ref_pocs[0]]
        l1p = [int(p) for p in ref_pocs[1]]
    else:
        l0p = list(range(len(refs0)))
        l1p = [-1 - i for i in range(len(refs1))]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tmvp = None
    if _tmvp_field is not None:
        if len(_tmvp_field):
            tmvp = tuple(t(np.ascontiguousarray(a).ravel()).to(I32)
                         for a in _tmvp_field)
    elif col is not None and ref_pocs is not None and ref_pocs[0]:
        # bi temporal merge candidate (both lists scaled independently,
        # spec 8.5.3.2.3/8)
        tmvp = tuple(t(a.ravel()).to(I32) for a in
                     _b_tmvp_field(col, sps, block, ref_pocs, cur_poc))
    pl = lambda rl, i: [dev_i32(r[i], device) for r in rl]
    out = _b_core(dev_i32(y, device), pl(refs0, 0), pl(refs0, 1),
                  pl(refs0, 2), pl(refs1, 0), pl(refs1, 1), pl(refs1, 2),
                  t(avail.reshape(-1, avail.shape[-1])), lam256, qp,
                  search_range, block, bd, subme, sps.log2_ctu_size, tmvp,
                  t(np.asarray(l0p, np.int64)),
                  t(np.asarray(l1p, np.int64)), tuple(rounds), rect_eff,
                  hme, amp_eff, me_sea, weights_b, csp)
    (modes, inter, dirs, mv0, mv1, rs0, rs1, mcy, mcu, mcv, part,
     dirs_b, mv0_b, mv1_b) = out
    h = lambda a: a.cpu().numpy()
    return (h(modes), h(inter), h(dirs), h(mv0), h(mv1), h(rs0), h(rs1),
            (mcy, mcu, mcv), h(part), (h(dirs_b), h(mv0_b), h(mv1_b)))


def _b_core(oy, r0ys, ru0s, rv0s, r1ys, ru1s, rv1s, avail, lam256: int,
            qp: int, search_range: int, n: int, bd: int, subme: int,
            log2_ctu: int, tmvp, poc0, poc1, rounds, rect: bool = False,
            hme: bool = False, amp: bool = False, me_sea: bool = False,
            weights_b=None, csp: int = 1):
    """B analysis of one frame or row band on one device (the
    reference's _b_core).  weights_b: per-list luma (w, o) or None, for
    a weighted call (lists of one reference); csp: the chroma format of
    the chroma reference planes."""
    dev = oy.device
    h, w = oy.shape
    nbx, nby = w // n, h // n
    nb = nbx * nby
    nref0, nref1 = len(r0ys), len(r1ys)
    log2n = n.bit_length() - 1
    bys_np, bxs_np = np.mgrid[0:nby, 0:nbx]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    bx = t((bxs_np.ravel() * n).astype(np.int32))
    by = t((bys_np.ravel() * n).astype(np.int32))
    org = _org_blocks(oy, bx, by, n)
    use_w = weights_b is not None
    me0, me1 = r0ys, r1ys
    if use_w:
        # ME searches pre-weighted planes; MC weights the 14-bit
        # predictions exactly
        wv = _wb_pairs(weights_b)
        me0, me1 = ([weighted_plane(p, w, o, bit_depth=bd) for p in pl]
                    if wp is not None else pl
                    for pl, wp, (w, o) in zip((r0ys, r1ys), weights_b, wv))

    # per-(list, ref) full search + subpel, then a provisional joint
    # (ref, mv) pick per list with ref_idx bin charges (x265
    # predInterSearch per-ref loop, search.cpp:2554); first minimum
    def list_me(planes):
        cands = [_me_one_ref(
            oy, ry, bx, by, n, lam256, search_range, bd, subme, org,
            _hme_center_fullres(ry, oy, nby, nbx, lam256, search_range)
            if hme and not me_sea else None, me_sea) for ry in planes]
        satd_r = torch.stack([c[2] - ((lam256 * mv_bits(c[0], c[1])) >> 8)
                              for c in cands])
        mvx_r = torch.stack([c[0] for c in cands])
        mvy_r = torch.stack([c[1] for c in cands])
        ridx = torch.arange(len(planes), device=dev, dtype=I32)[:, None]
        prov = satd_r + ((lam256 * (mv_bits(mvx_r, mvy_r) + ridx + 4)) >> 8)
        rsel = torch.argmin(prov, dim=0).to(I32)
        pick = lambda a: torch.gather(a, 0, rsel.long()[None])[0]
        return pick(mvx_r), pick(mvy_r), rsel, pick(satd_r)

    mv0x, mv0y, rsel0, satd0 = list_me(me0)
    mv1x, mv1y, rsel1, satd1 = list_me(me1)

    # stacked tall planes per list: one MC gather serves per-block ref
    # indices (candidate rounds, homogenization); the FINAL MC reads the
    # per-ref planes below so clamping matches the decoder's spec MC
    m_pad = (6 * search_range + 12) if hme else (search_range + 12)
    tall0, strip0 = _stack_refs(r0ys, m_pad)
    tall1, strip1 = _stack_refs(r1ys, m_pad)
    off2 = 1 << (13 - bd)
    sh2 = 14 - bd
    maxv = (1 << bd) - 1

    def uni_of(p14, lst: int):
        if use_w:
            return wp_apply_batch(p14, wv[lst][0], wv[lst][1], 6, bd)
        return torch.clip((p14 + off2) >> sh2, 0, maxv)

    def bi_of(p0, p1):
        if use_w:
            return wp_bi_combine(p0, p1, wv[0][0], wv[0][1], wv[1][0],
                                 wv[1][1], 6, bd)
        return bi_combine(p0, p1, bd)

    def mc14(lst, bxk, byk, cmx, cmy, crf):
        tall, strip = (tall0, strip0) if lst == 0 else (tall1, strip1)
        return mc_batch_14(tall, bxk, byk + crf * strip + m_pad, cmx, cmy,
                           n, 0, bd)

    def pred_of(nd, q0, q1):
        nd = nd[:, None, None]
        return torch.where(nd == 3, bi_of(q0, q1),
                           torch.where(nd == 1, uni_of(q0, 0),
                                       uni_of(q1, 1)))

    # bi-prediction of the two best uni (ref, mv) pairs (checkBidir2Nx2N)
    p0_14 = mc14(0, bx, by, mv0x, mv0y, rsel0)
    p1_14 = mc14(1, bx, by, mv1x, mv1y, rsel1)
    satd_bi = satd_batch(org, bi_of(p0_14, p1_14))

    # S-mask availability indices (see the P side)
    AV_A1, AV_A0, AV_B2, AV_B1, AV_B0 = n, n - 1, 2 * n, 3 * n, 3 * n + 1
    av2 = avail.reshape(nb, -1)
    icosts = _mode_costs(oy, avail, t(bxs_np.ravel().astype(np.int32)),
                         t(bys_np.ravel().astype(np.int32)), log2n, bd)
    intra_best = icosts.amin(1) + ((lam256 * 5) >> 8)
    intra_modes = torch.argmin(icosts, dim=1).to(I32)
    inter_est = (torch.minimum(torch.minimum(satd0, satd1), satd_bi)
                 + ((lam256 * 6) >> 8)) <= intra_best
    lam_f = torch.tensor(float(lam256), dtype=F32, device=dev) / 256.0
    lam2 = lam_f * lam_f
    qp_b = torch.full((nb,), qp, dtype=I32, device=dev)
    big_f = torch.tensor(3e38, dtype=F32, device=dev)
    zz = torch.zeros(nb, dtype=I32, device=dev)
    i32 = lambda b_: b_.to(I32)
    if tmvp is not None:
        # vertical window guard (see the P side): candidate MC reads the
        # stacked tall planes, whose edge replication covers m_pad rows
        td_, t0x, t0y, t1x, t1y = tmvp
        tok = ((torch.abs(t0y) <= 4 * (m_pad - 8))
               & (torch.abs(t1y) <= 4 * (m_pad - 8)))
        tm_c = (td_, t0x, t0y, t1x, t1y, zz, zz)
    else:
        tm_c = (zz,) * 7

    def b_cand_round(dirs, c0x, c0y, c1x, c1y, r0f, r1f, rd=False):
        flds = (dirs, c0x, c0y, c1x, c1y, r0f, r1f)

        def gat(sy, sx):
            return tuple(_neigh_field(a.reshape(nby, nbx), sy, sx)[0]
                         .reshape(-1) for a in flds)

        def gat_ie(sy, sx):
            return _neigh_field(inter_est.reshape(nby, nbx), sy,
                                sx)[0].reshape(-1)

        # exact merge candidate derivation over full (dir, mv0, ref0,
        # mv1, ref1) motion (spec 8.5.3.2.3): spatial A1/B1/B0/A0/B2 with
        # pruning, TMVP, the first two combined-bi candidates and the bi
        # zero-fill entry, each at its true list position
        a1, b1, b0 = gat(0, 1), gat(1, 0), gat(1, -1)
        a0, b2 = gat(-1, 1), gat(1, 1)
        v_a1 = av2[:, AV_A1] & gat_ie(0, 1)
        v_b1r = av2[:, AV_B1] & gat_ie(1, 0)
        v_b0r = av2[:, AV_B0] & gat_ie(1, -1)
        v_a0r = av2[:, AV_A0] & gat_ie(-1, 1)
        v_b2r = av2[:, AV_B2] & gat_ie(1, 1)

        def eq(c, d):
            r = c[0] == d[0]
            for i in range(1, 7):
                r = r & (c[i] == d[i])
            return r

        v_b1 = v_b1r & ~(v_a1 & eq(b1, a1))
        v_b0 = v_b0r & ~(v_b1r & eq(b0, b1))
        v_a0 = v_a0r & ~(v_a1 & eq(a0, a1))
        n4 = i32(v_a1) + i32(v_b1) + i32(v_b0) + i32(v_a0)
        v_b2 = (v_b2r & (n4 < 4) & ~(v_a1 & eq(b2, a1))
                & ~(v_b1r & eq(b2, b1)))
        idx_a1 = zz
        idx_b1 = i32(v_a1)
        idx_b0 = idx_b1 + i32(v_b1)
        idx_a0 = idx_b0 + i32(v_b0)
        idx_b2 = idx_a0 + i32(v_a0)
        n_sp = idx_b2 + i32(v_b2)
        if tmvp is not None:
            v_t = (td_ > 0) & tok & (n_sp < 3)
        else:
            v_t = zz != 0
        idx_t = n_sp
        cnt = n_sp + i32(v_t)
        # combined-bi (0,1)/(1,0): base0/base1 = the list's first two
        # entries, selected across the six candidate slots by position
        spat = [(a1, v_a1, idx_a1), (b1, v_b1, idx_b1),
                (b0, v_b0, idx_b0), (a0, v_a0, idx_a0),
                (b2, v_b2, idx_b2), (tm_c, v_t, idx_t)]
        stk = [torch.stack([c[0][i] for c in spat]) for i in range(7)]
        vstk = torch.stack([c[1] for c in spat])
        istk = torch.stack([c[2] for c in spat])

        def base(k):
            sel = torch.argmax(i32(vstk & (istk == k)), dim=0)
            return [torch.gather(s, 0, sel[None])[0] for s in stk]

        b0_, b1_ = base(0), base(1)
        c01 = (zz + 3, b0_[1], b0_[2], b1_[3], b1_[4], b0_[5], b1_[6])
        c10 = (zz + 3, b1_[1], b1_[2], b0_[3], b0_[4], b1_[5], b0_[6])
        # same-picture pruning by POC (spec 8.5.3.2.4)
        cl0 = lambda r: poc0[torch.clip(r, 0, nref0 - 1).long()]
        cl1 = lambda r: poc1[torch.clip(r, 0, nref1 - 1).long()]
        sp01 = cl0(b0_[5]) == cl1(b1_[6])
        sp10 = cl0(b1_[5]) == cl1(b0_[6])
        v_c01 = ((cnt == 2) & ((b0_[0] & 1) != 0) & ((b1_[0] & 2) != 0))
        v_c01 &= ~(sp01 & (b0_[1] == b1_[3]) & (b0_[2] == b1_[4]))
        v_c10 = ((cnt == 2) & ~v_c01 & ((b1_[0] & 1) != 0)
                 & ((b0_[0] & 2) != 0))
        v_c10 &= ~(sp10 & (b1_[1] == b0_[3]) & (b1_[2] == b0_[4]))
        idx_c = cnt
        idx_z = cnt + i32(v_c01 | v_c10)
        v_z = idx_z < 3
        bcands = spat + [(c01, v_c01, idx_c), (c10, v_c10, idx_c),
                         ((zz + 3, zz, zz, zz, zz, zz, zz), v_z, idx_z)]

        # per-list AMVP predictors ~ A1/B1 neighbour MVs of that list
        def preds(lst):
            out = []
            for (cand, vr) in ((a1, v_a1), (b1, v_b1r)):
                has = vr & ((cand[0] & (1 << lst)) != 0)
                px = torch.where(has, cand[1] if lst == 0 else cand[3], 0)
                py = torch.where(has, cand[2] if lst == 0 else cand[4], 0)
                out.append((px, py))
            return out
        pl0 = preds(0)
        pl1 = preds(1)
        mvd0 = torch.minimum(
            mv_bits(mv0x - pl0[0][0], mv0y - pl0[0][1]),
            mv_bits(mv0x - pl0[1][0], mv0y - pl0[1][1]))
        mvd1 = torch.minimum(
            mv_bits(mv1x - pl1[0][0], mv1y - pl1[0][1]),
            mv_bits(mv1x - pl1[1][0], mv1y - pl1[1][1]))
        # ME modes: satd + merge_flag0/pred/part + inter_pred_idc(2) +
        # mvd + mvp_idx + ref_idx TR bins per used list
        cL0 = satd0 + ((lam256 * (mvd0 + 6 + rsel0)) >> 8)
        cL1 = satd1 + ((lam256 * (mvd1 + 6 + rsel1)) >> 8)
        cBI = satd_bi + ((lam256 * (mvd0 + mvd1 + 7 + rsel0
                                    + rsel1)) >> 8)
        best = torch.stack([cL0, cL1, cBI], 0)
        best_rd = None
        if rd:
            # final round: transform-domain RD arbitration over {L0, L1,
            # BI, merge neighbours} (see the P side's rd round)
            syn_me = [(mvd0 + 6 + rsel0).to(F32),
                      (mvd1 + 6 + rsel1).to(F32),
                      (mvd0 + mvd1 + 7 + rsel0 + rsel1).to(F32)]
            rds = []
            for p, s in zip((uni_of(p0_14, 0), uni_of(p1_14, 1),
                             bi_of(p0_14, p1_14)), syn_me):
                cc, sz = _rd_resid_cost(org, p, qp_b, log2n, bd, lam2)
                rds.append(torch.minimum(fma32(lam2, s, cc),
                                         fma32(lam2, s + 1.0, sz)))
            rd_stack = torch.stack(rds, 0)
            mi = torch.argmin(rd_stack, 0)
            best_rd = rd_stack.amin(0)
        else:
            mi = torch.argmin(best, 0)
        best_cost = torch.gather(best, 0, mi[None])[0]
        best_dir = (mi + 1).to(I32)                # 1=L0, 2=L1, 3=BI
        best_0x = torch.where(mi != 1, mv0x, 0)
        best_0y = torch.where(mi != 1, mv0y, 0)
        best_1x = torch.where(mi != 0, mv1x, 0)
        best_1y = torch.where(mi != 0, mv1y, 0)
        best_r0 = torch.where(mi != 1, rsel0, 0)
        best_r1 = torch.where(mi != 0, rsel1, 0)
        # every merge candidate's MC + SATD (+ residual RD) as one batch
        # (the reference's vmap); the scan below keeps the sequential
        # loop's first-minimum tie-breaking
        k_c = len(bcands)
        nd_s, n0x_s, n0y_s, n1x_s, n1y_s, nr0_s, nr1_s = (
            torch.stack([c[0][i] for c in bcands]) for i in range(7))
        idx_s = torch.stack([c[2] for c in bcands])
        ok_s = (torch.stack([c[1] for c in bcands]) & (idx_s < 3)
                & (nd_s > 0))
        idxb_s = torch.where(idx_s == 0, 1, 2).to(I32)
        bxk, byk = bx.repeat(k_c), by.repeat(k_c)
        q0 = mc14(0, bxk, byk, n0x_s.reshape(-1), n0y_s.reshape(-1),
                  torch.clip(nr0_s, 0, nref0 - 1).reshape(-1))
        q1 = mc14(1, bxk, byk, n1x_s.reshape(-1), n1y_s.reshape(-1),
                  torch.clip(nr1_s, 0, nref1 - 1).reshape(-1))
        pred = pred_of(nd_s.reshape(-1), q0, q1)
        org_k = org.repeat(k_c, 1, 1)
        sc_r = satd_batch(org_k, pred).reshape(k_c, nb)
        sc_all = sc_r + ((lam256 * (2 + idxb_s)) >> 8)
        sc_all = torch.where(ok_s, sc_all, 1 << 30)
        if rd:
            cc_r, sz_r = _rd_resid_cost(org_k, pred, qp_b.repeat(k_c),
                                        log2n, bd, lam2)
            mb = (2 + idxb_s).to(F32)
            rdk_all = torch.minimum(
                fma32(lam2, mb + 4.0, cc_r.reshape(k_c, nb)),
                fma32(lam2, mb, sz_r.reshape(k_c, nb)))
            rdk_all = torch.where(ok_s, rdk_all, big_f)
        for k in range(k_c):
            if rd:
                upd = rdk_all[k] < best_rd
                best_rd = torch.where(upd, rdk_all[k], best_rd)
            else:
                upd = sc_all[k] < best_cost
            best_cost = torch.where(upd, sc_all[k], best_cost)
            best_dir = torch.where(upd, nd_s[k], best_dir)
            best_0x = torch.where(upd, n0x_s[k], best_0x)
            best_0y = torch.where(upd, n0y_s[k], best_0y)
            best_1x = torch.where(upd, n1x_s[k], best_1x)
            best_1y = torch.where(upd, n1y_s[k], best_1y)
            best_r0 = torch.where(upd, nr0_s[k], best_r0)
            best_r1 = torch.where(upd, nr1_s[k], best_r1)
        return (best_dir, best_0x, best_0y, best_1x, best_1y,
                best_r0, best_r1, best_cost, best_rd)

    # provisional direction field from the pure ME costs (zero-pred
    # charges), so round-1 neighbour predictors aren't list-biased
    me_b0 = mv_bits(mv0x, mv0y)
    me_b1 = mv_bits(mv1x, mv1y)
    prov = torch.stack([satd0 + ((lam256 * me_b0) >> 8),
                        satd1 + ((lam256 * me_b1) >> 8),
                        satd_bi + ((lam256 * (me_b0 + me_b1 + 2)) >> 8)], 0)
    dirs = (torch.argmin(prov, 0) + 1).to(I32)
    has0 = dirs != 2
    has1 = dirs != 1
    c0x = torch.where(has0, mv0x, 0)
    c0y = torch.where(has0, mv0y, 0)
    c1x = torch.where(has1, mv1x, 0)
    c1y = torch.where(has1, mv1y, 0)
    r0f = torch.where(has0, rsel0, 0)
    r1f = torch.where(has1, rsel1, 0)
    cost_rd = None
    for _ in range(rounds[0]):
        (dirs, c0x, c0y, c1x, c1y, r0f, r1f, inter_cost,
         _) = b_cand_round(dirs, c0x, c0y, c1x, c1y, r0f, r1f)
    for _ in range(rounds[1]):
        (dirs, c0x, c0y, c1x, c1y, r0f, r1f, inter_cost,
         cost_rd) = b_cand_round(dirs, c0x, c0y, c1x, c1y, r0f, r1f,
                                 rd=True)
    mv0x, mv0y, mv1x, mv1y = c0x, c0y, c1x, c1y
    ref0_f, ref1_f = r0f, r1f

    # 2b. rect PU candidates (2NxN / Nx2N) with a per-PU list choice:
    # 8x8 sub-block ME (K1) on ref 0 of each list, PU costs from own +
    # partner SATD pairings per list, then the cheaper list per PU
    part = torch.zeros(nb, dtype=I32, device=dev)
    dirs_b = torch.zeros(nb, dtype=I32, device=dev)
    pu1_0x = pu1_0y = pu1_1x = pu1_1y = torch.zeros_like(part)
    if rect:
        sx4, sy4 = _sub4(bx, by)
        pz4 = torch.zeros(nb * 4, dtype=I32, device=dev)
        org8 = _org_blocks(oy, sx4, sy4, 8)
        ytall = sy4 + m_pad                     # ref 0 of each list
        sub = []          # per list: (own, crossH, crossV, m8x, m8y)
        for tl, nr in ((tall0, nref0), (tall1, nref1)):
            ot = _stack_refs([oy] * nr, m_pad)[0]
            i8x, i8y, _ = full_search_batch(tl, ot, sx4, ytall, pz4, pz4,
                                            lam256, 8, search_range)
            m8x, m8y, c8 = subpel_refine_batch(tl, ot, sx4, ytall, i8x,
                                               i8y, pz4, pz4, lam256, 8,
                                               bd, subme)
            own = (c8 - ((lam256 * mv_bits(m8x, m8y)) >> 8)).reshape(nb, 4)

            def cross_satd(perm, m8x=m8x, m8y=m8y, tl=tl):
                pr = mc_batch(tl, sx4, ytall,
                              m8x.reshape(nb, 4)[:, perm].reshape(-1),
                              m8y.reshape(nb, 4)[:, perm].reshape(-1), 8,
                              0, bd)
                return satd_batch(org8, pr).reshape(nb, 4)

            sub.append((own, cross_satd([1, 0, 3, 2]),
                        cross_satd([2, 3, 0, 1]), m8x.reshape(nb, 4),
                        m8y.reshape(nb, 4)))
        # merge_flag + inter_pred_idc (2) + mvp_idx + ref_idx bins per
        # uni rect PU
        pu_bits = (lam256 * 4) >> 8

        def pu_best_l(lst, horiz, first):
            """Best (cost, mvx, mvy) of one rect PU on one list: the
            PU's two sub-blocks covered by either sub's MV."""
            own, crH, crV, m8x, m8y = sub[lst]
            cr = crH if horiz else crV
            if horiz:
                a, b2 = (0, 1) if first else (2, 3)
            else:
                a, b2 = (0, 2) if first else (1, 3)
            cA = own[:, a] + cr[:, b2] + \
                ((lam256 * mv_bits(m8x[:, a], m8y[:, a])) >> 8) + pu_bits
            cB = cr[:, a] + own[:, b2] + \
                ((lam256 * mv_bits(m8x[:, b2], m8y[:, b2])) >> 8) + pu_bits
            useA = cA <= cB
            return (torch.where(useA, cA, cB),
                    torch.where(useA, m8x[:, a], m8x[:, b2]),
                    torch.where(useA, m8y[:, a], m8y[:, b2]))

        def pu_best(horiz, first):
            """argmin over the two lists: (cost, list, mvx, mvy)."""
            c0, x0_, y0_ = pu_best_l(0, horiz, first)
            c1, x1_, y1_ = pu_best_l(1, horiz, first)
            use0 = c0 <= c1
            return (torch.where(use0, c0, c1), torch.where(use0, 0, 1)
                    .to(I32), torch.where(use0, x0_, x1_),
                    torch.where(use0, y0_, y1_))

        part_bins = (lam256 * 2) >> 8
        cT, lT, xT, yT = pu_best(True, True)
        cB_, lB, xB, yB = pu_best(True, False)
        costH = cT + cB_ + part_bins
        cL, lL, xL, yL = pu_best(False, True)
        cR, lR, xR, yR = pu_best(False, False)
        costV = cL + cR + part_bins
        # a degenerate rect (both PUs one list and MV) is never picked
        costH = torch.where((lT == lB) & (xT == xB) & (yT == yB), 1 << 30,
                            costH)
        costV = torch.where((lL == lR) & (xL == xR) & (yL == yR), 1 << 30,
                            costV)
        allc = torch.stack([inter_cost, costH, costV])
        part = torch.argmin(allc, dim=0).to(I32)
        inter_cost = allc.amin(0)
        p0l = torch.where(part == 1, lT, lL)        # PU0 list
        p0x = torch.where(part == 1, xT, xL)
        p0y = torch.where(part == 1, yT, yL)
        p1l = torch.where(part == 1, lB, lR)        # PU1 list
        p1x = torch.where(part == 1, xB, xR)
        p1y = torch.where(part == 1, yB, yR)
        if amp:
            # AMP: each quarter strip and its complementary body pick the
            # best uni (list, MV) among both lists' 8x8 sub-block MVs (ref
            # 0, + 4 bits) by strip SATD; a shape wins where it beats the
            # cost so far
            ts = torch.cat([_amp_tile_satd(
                org, tl, bx, by + m_pad,
                [(sub[li][3][:, c], sub[li][4][:, c]) for c in range(4)],
                n, bd) for li, tl in enumerate((tall0, tall1))])
            cax = torch.cat([sub[li][3].t() for li in range(2)])
            cay = torch.cat([sub[li][4].t() for li in range(2)])
            clist = (torch.arange(8, device=dev, dtype=I32) // 4)[:, None] \
                .expand_as(cax)
            cbits = (lam256 * (mv_bits(cax, cay) + 4)) >> 8
            amp_bins = (lam256 * 4) >> 8
            for code, ra, rb in _amp_shapes(n // 4):
                c0, l0_, x0_, y0_ = _amp_region_best(ts, cbits, ra,
                                                     (clist, cax, cay))
                c1, l1_, x1_, y1_ = _amp_region_best(ts, cbits, rb,
                                                     (clist, cax, cay))
                cc = torch.where((l0_ == l1_) & (x0_ == x1_) & (y0_ == y1_),
                                 1 << 30, c0 + c1 + amp_bins)
                u = cc < inter_cost
                inter_cost = torch.where(u, cc, inter_cost)
                part = torch.where(u, code, part)
                p0l = torch.where(u, l0_, p0l)
                p0x = torch.where(u, x0_, p0x)
                p0y = torch.where(u, y0_, p0y)
                p1l = torch.where(u, l1_, p1l)
                p1x = torch.where(u, x1_, p1x)
                p1y = torch.where(u, y1_, p1y)
        # PU0 motion replaces the 2Nx2N fields where rect wins; rect PUs
        # ride ref 0 of their list
        rw = part > 0
        dirs = torch.where(rw, p0l + 1, dirs)
        mv0x = torch.where(rw, torch.where(p0l == 0, p0x, 0), mv0x)
        mv0y = torch.where(rw, torch.where(p0l == 0, p0y, 0), mv0y)
        mv1x = torch.where(rw, torch.where(p0l == 1, p0x, 0), mv1x)
        mv1y = torch.where(rw, torch.where(p0l == 1, p0y, 0), mv1y)
        ref0_f = torch.where(rw, 0, ref0_f)
        ref1_f = torch.where(rw, 0, ref1_f)
        dirs_b = torch.where(rw, p1l + 1, 0)
        pu1_0x = torch.where(rw & (p1l == 0), p1x, 0)
        pu1_0y = torch.where(rw & (p1l == 0), p1y, 0)
        pu1_1x = torch.where(rw & (p1l == 1), p1x, 0)
        pu1_1y = torch.where(rw & (p1l == 1), p1y, 0)

    # 2c. motion homogenization across 32 (and 64) regions: adopt one
    # sub-block's (dir, mv0, ref0, mv1, ref1) for the region when the RD
    # loss is smaller than the CU-syntax saving
    def _b_region_uniform(dirs, m0x, m0y, m1x, m1y, r0m, r1m, cost,
                          cost_rd, part, g):
        gh, gw = nby // g, nbx // g
        if gh == 0 or gw == 0 or n != 16 or use_w:
            return dirs, m0x, m0y, m1x, m1y, r0m, r1m, cost, cost_rd
        f2 = lambda a: a.reshape(nby, nbx)
        crop = lambda a: f2(a)[:gh * g, :gw * g]
        rep2 = lambda a: a.repeat_interleave(g, 0).repeat_interleave(g, 1)
        gsum_f = lambda a: _group_sum(a, gh, g, gw)
        ok = (crop(part) == 0).reshape(gh, g, gw, g).all(3).all(1)
        indiv_rd = gsum_f(crop(cost_rd))
        s = g // 2

        def setc(a, val):
            o = f2(a).clone()
            o[:gh * g, :gw * g] = val
            return o.reshape(-1)

        def eval_cand(rdd, rm0x, rm0y, rm1x, rm1y, rr0, rr1, gbits,
                      valid=None):
            fd = setc(dirs, rep2(rdd))
            q0 = mc14(0, bx, by, setc(m0x, rep2(rm0x)),
                      setc(m0y, rep2(rm0y)),
                      torch.clip(setc(r0m, rep2(rr0)), 0, nref0 - 1))
            q1 = mc14(1, bx, by, setc(m1x, rep2(rm1x)),
                      setc(m1y, rep2(rm1y)),
                      torch.clip(setc(r1m, rep2(rr1)), 0, nref1 - 1))
            pred = pred_of(fd, q0, q1)
            sbc = crop(satd_batch(org, pred))
            cc, sz = _rd_resid_cost(org, pred, qp_b, log2n, bd, lam2)
            blk_rd = crop(torch.minimum(cc, sz))
            tot = fma32(lam2, gbits.to(F32), gsum_f(blk_rd))
            if valid is not None:
                tot = torch.where(valid, tot, big_f)
            return [tot, rdd, rm0x, rm0y, rm1x, rm1y, rr0, rr1, sbc,
                    gbits, blk_rd]

        def merge_best(best, cand):
            if best is None:
                return cand
            u_ = cand[0] < best[0]
            ub = rep2(u_)
            return ([torch.where(u_, cand[i], best[i]) for i in range(8)]
                    + [torch.where(ub, cand[8], best[8]),
                       torch.where(u_, cand[9], best[9]),
                       torch.where(ub, cand[10], best[10])])

        flds = (dirs, m0x, m0y, m1x, m1y, r0m, r1m)
        best = None
        for c in range(4):
            sy, sx = (c >> 1) * s, (c & 1) * s
            # merge/skip-realistic region syntax charge (see the P side)
            best = merge_best(best, eval_cand(
                *(crop(f)[sy::g, sx::g] for f in flds),
                torch.full((gh, gw), 10, dtype=I32, device=dev)))
        # A1/B1 merge-aligned candidates: the region CU's actual spatial
        # merge candidates
        ry_i = torch.arange(gh, device=dev) * g
        rx_i = torch.arange(gw, device=dev) * g
        f2s = [f2(f) for f in flds]
        mb3 = torch.full((gh, gw), 3, dtype=I32, device=dev)
        a1_r = ry_i + (g - 1)
        a1_c = rx_i - 1
        va1 = (a1_c >= 0)[None, :].expand(gh, gw)
        ac = torch.clip(a1_c, 0, nbx - 1)
        ga1 = lambda f: f[a1_r[:, None], ac[None, :]]
        best = merge_best(best, eval_cand(
            *(ga1(f) for f in f2s), mb3, va1 & (ga1(f2s[0]) > 0)))
        b1_r = ry_i - 1
        b1_c = rx_i + (g - 1)
        vb1 = (b1_r >= 0)[:, None].expand(gh, gw)
        br = torch.clip(b1_r, 0, nby - 1)
        gb1 = lambda f: f[br[:, None], b1_c[None, :]]
        best = merge_best(best, eval_cand(
            *(gb1(f) for f in f2s), mb3, vb1 & (gb1(f2s[0]) > 0)))
        # bi zero-mv candidate (the B-slice merge list's zero-fill
        # entry is bidirectional, spec 8.5.3.2.3 step 5)
        z2 = torch.zeros((gh, gw), dtype=I32, device=dev)
        best = merge_best(best, eval_cand(z2 + 3, z2, z2, z2, z2, z2, z2,
                                          mb3 + 1))
        (tot, rdd, rm0x, rm0y, rm1x, rm1y, rr0, rr1, sbc, gbits,
         blk_rd) = best
        # tie-accepting compare with sub-CU syntax slack (see the P
        # side); only regions of 2Nx2N blocks adopt
        acc = ok & (tot <= indiv_rd + lam2 * 4.0)
        accb = rep2(acc)
        pb_bits = rep2(((lam256 * gbits) >> 8) // (g * g))
        out = [setc(a, torch.where(accb, rep2(r), crop(a)))
               for a, r in zip(flds, (rdd, rm0x, rm0y, rm1x, rm1y, rr0,
                                      rr1))]
        new_cost = setc(cost, torch.where(accb, sbc + pb_bits, crop(cost)))
        new_rd = setc(cost_rd, torch.where(
            accb, blk_rd + lam2 * rep2(gbits).to(F32) / (g * g),
            crop(cost_rd)))
        return (*out, new_cost, new_rd)

    (dirs, mv0x, mv0y, mv1x, mv1y, ref0_f, ref1_f, inter_cost,
     cost_rd) = _b_region_uniform(dirs, mv0x, mv0y, mv1x, mv1y, ref0_f,
                                  ref1_f, inter_cost, cost_rd, part, 2)
    if log2_ctu == 6:
        (dirs, mv0x, mv0y, mv1x, mv1y, ref0_f, ref1_f, inter_cost,
         cost_rd) = _b_region_uniform(dirs, mv0x, mv0y, mv1x, mv1y,
                                      ref0_f, ref1_f, inter_cost, cost_rd,
                                      part, 4)

    use_inter = inter_cost <= intra_best
    dirs = torch.where(use_inter, dirs, 0)
    if rect:
        part = torch.where(use_inter, part, 0)
        dirs_b = torch.where(use_inter, dirs_b, 0)

    mc = [p.reshape(nby, nbx, p.shape[1], p.shape[2]) for p in _b_mc(
        (r0ys, ru0s, rv0s), (r1ys, ru1s, rv1s), bx, by, dirs, mv0x, mv0y,
        mv1x, mv1y, ref0_f, ref1_f, part, dirs_b, pu1_0x, pu1_0y, pu1_1x,
        pu1_1y, n, bd, m_pad, rect, (tall0, tall1), amp, weights_b, csp)]

    f = lambda a: a.reshape(nby, nbx).to(I32)
    mv2 = lambda mx, my: torch.stack([mx, my], -1).reshape(nby, nbx, 2) \
        .to(I32)
    return (f(intra_modes), use_inter.reshape(nby, nbx), f(dirs),
            mv2(mv0x, mv0y), mv2(mv1x, mv1y), f(ref0_f), f(ref1_f),
            mc[0], mc[1], mc[2], f(part), f(dirs_b), mv2(pu1_0x, pu1_0y),
            mv2(pu1_1x, pu1_1y))
