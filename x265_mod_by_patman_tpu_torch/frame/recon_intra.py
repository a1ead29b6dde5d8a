"""Batched reconstruction over CTU wavefronts (port of
x265_mod_by_patman_tpu/frame/recon_intra.py).

CTUs on a wavefront diagonal (d = cx + 2*cy) run as one batched step;
within a CTU the z-order block positions are sequential substeps.  The
reference runs the schedule as one lax.fori_loop under jit; here it is
a Python loop over the same precomputed schedule, updating the recon
planes and level stores in place (each step's reads are copies, so the
in-place writes keep the reference's step-by-step semantics).

Invalid lanes of a step are redirected into a dump area below the frame
(as in the reference), so every write is unconditional.

The batched all-intra path (run_batch) advances F frames in lockstep:
the frames' planes and level stores are stacked along the rows, each
with its own dump area, and each step's blocks are repeated once per
frame with that frame's row offset, so a step launches what one frame's
step launches, over F times the blocks."""
from __future__ import annotations

import numpy as np
import torch

from ..constants.hevc_tables import CHROMA_422_ANGLE_MAP, CHROMA_QP_TABLE
from ..constants.scaling import (default_matrix, list_matrix,
                                 quant_mats_custom)
from ..ops.cost import psy_cost_batch, psy_weight
from ..ops.intra import (block_index, gather_ref_samples,
                         intra_pred_select_batch, substitute_filter_batch)
from ..ops.numeric import (LOG2E_F32, fma32, lam2_ref, log_ref,
                           lsum)
from ..ops.rdoq import rdoq_levels, tb_bits_est, wavefront_sum_order
from ..ops.transform import (dct_batch, dequant_dyn, idct_batch, quant_dyn,
                             quant_mats, sbh_adjust)
from .planes import dev_i32
from .zscan import ctu_wavefront_order, frame_avail_masks

I32 = torch.int32
F32 = torch.float32


def chroma_qp(qp: int, offset: int = 0, csp: int = 1) -> int:
    """QpC derivation (spec 8.6.1): the Table 8-10 remap applies only
    for ChromaArrayType == 1 (4:2:0); 4:2:2/4:4:4 clip qPi at 51."""
    if csp == 1:
        return int(CHROMA_QP_TABLE[min(max(qp + offset, 0), 69)])
    return int(min(max(qp + offset, 0), 51))


def _scan_sel_of(modes):
    """Mode-dependent scan id per lane (spec 7.4.9.11 for 4x4 and 8x8
    luma intra TBs): modes 6..14 -> vertical scan (2), 22..30 ->
    horizontal (1), else diagonal (0)."""
    return torch.where((modes >= 6) & (modes <= 14), 2,
                       torch.where((modes >= 22) & (modes <= 30), 1, 0)) \
        .to(I32)


def candidate_cost(lev, sse, lam2, cand_bits):
    """The RD cost sse + lam2 * (rate + cand_bits) of (B, n, n) candidate
    levels, rate = sum over the TB of 3 + 2 * log2(|level| + 1) at the
    nonzero levels, in the reference's compiled float32: the term one
    multiply-add on its log (log(.) * float32(2 / ln 2) + 3), the TB's
    sum in its 8-lane order (lsum), the cost's multiply contracted into
    its add; lam2 from lam2_ref."""
    al = torch.abs(lev)
    term = fma32(log_ref(al + 1), 2 * float(LOG2E_F32), 3.0)
    rate = lsum(torch.where(al > 0, term, 0.0))
    return fma32(lam2, rate + cand_bits, sse)


def skip_costs(sse_skip, sse_coded, bits, lam2, psy=None):
    """(cost of skipping, cost of coding) of the inter zero-residual test
    from the int32 SSEs, the float32 bit estimate and lambda, and psy =
    (weight, int32 psy cost of the prediction, of the reconstruction) or
    None, in the reference's compiled float32: each product contracted
    into the add that consumes it."""
    cost_skip = sse_skip.to(F32)
    cost_coded = fma32(lam2, bits, sse_coded.to(F32))
    if psy is not None:
        psy_w, psy_skip, psy_coded = psy
        cost_skip = fma32(psy_w, psy_skip.to(F32), cost_skip)
        cost_coded = fma32(psy_w, psy_coded.to(F32), cost_coded)
    return cost_skip, cost_coded


def _substep_body(plane, levels, orig, bx, by, modes, avail, log2n: int,
                  qp, c_idx: int, bit_depth: int = 8, mc_pred=None,
                  inter_mask=None, sign_hide: bool = False,
                  rdoq: bool = False, init_type=None, psy256=None,
                  psy_rdoq=None, cand_bits=None, ebits=None, qmats=None,
                  dmats=None, split_map=None, modes8=None, av8=None,
                  m8=(None, None), lossless: bool = False, tu4_map=None,
                  av4y=None, nr=None, m4=(None, None),
                  fchroma: bool = False, est_lanes=None):
    """One wavefront substep for one component, updating `plane` and
    `levels` in place.

    qmats/dmats: scaling-list quant/raw matrices of this TB size (None:
    flat); split_map/modes8/av8: NxN intra (the block is four z-order
    sub-TUs, luma 8x8 / chroma 4x4, each predicted from the partly
    reconstructed plane), m8 the sub-TU matrices; tu4_map/av4y: the
    voluntary TU4 (DST) split of each 8x8 luma sub-TU, m4 its 4x4
    matrices; lossless: transquant bypass; nr: ((n*n,) intra, (n*n,)
    inter) noise-reduction offsets; fchroma: 4:4:4 chroma filters its
    reference samples as luma does (spec 8.4.4.2.3); est_lanes: the
    step's lane count where the reference's program is the 4:2:0
    wavefront, whose skip test then sums its TB bit estimates in that
    program's order (ops.rdoq.tb_bits_est) and whose RDOQ rounds its
    zero-out test as that program does (ops.rdoq.rdoq_levels).  Returns
    (skip (B,) or None, chosen modes or None, this substep's NR sums or
    None)."""
    n = 1 << log2n
    maxval = (1 << bit_depth) - 1
    hp, wp = plane.shape
    dev = plane.device
    x0 = bx.long() * n
    y0 = by.long() * n
    s_sub, s_filt = substitute_filter_batch(gather_ref_samples(plane, x0, y0, n),
                                            avail, log2n, bit_depth)
    ogy, ogx = block_index(x0, y0, n, orig.shape[0], orig.shape[1])
    org = orig[ogy, ogx].to(I32)
    gy, gx = block_index(x0, y0, n, hp, 1 << 30)

    md_sel = None
    if cand_bits is not None:
        # RD-true mode selection among the analysis' top-K candidates
        ones = torch.ones(bx.shape, dtype=torch.bool, device=dev)
        lam2 = lam2_ref(qp, bit_depth)
        best = None
        for kk in range(modes.shape[1]):
            md_k = modes[:, kk]
            pred_k = intra_pred_select_batch(s_sub, s_filt, md_k, log2n,
                                             c_idx, bit_depth)
            coef_k = dct_batch(org - pred_k, log2n, bit_depth)
            lev_k = quant_dyn(coef_k, ones, qp, log2n, bit_depth, qmats)
            deq_k = dequant_dyn(lev_k, qp, log2n, bit_depth, dmats, ones)
            rec_k = torch.clip(pred_k + idct_batch(deq_k, log2n, bit_depth),
                               0, maxval)
            sse = ((org - rec_k) ** 2).sum((1, 2), dtype=I32).to(F32)
            cost = candidate_cost(lev_k, sse, lam2, cand_bits[:, kk])
            if best is None:
                best = (cost, md_k)
            else:
                u = cost < best[0]
                best = (torch.where(u, cost, best[0]),
                        torch.where(u, md_k, best[1]))
        md_sel = best[1]
        modes = md_sel

    pred = intra_pred_select_batch(s_sub, s_filt, modes, log2n, c_idx,
                                   bit_depth,
                                   filt_chroma=fchroma and c_idx > 0)
    if mc_pred is not None:
        is_inter = inter_mask[by.long(), bx.long()]
        pred = torch.where(is_inter[:, None, None],
                           mc_pred[by.long(), bx.long()], pred)
        intra_mask = ~is_inter
    else:
        intra_mask = torch.ones(bx.shape, dtype=torch.bool, device=dev)
    resi = org - pred
    if lossless:
        # transquant bypass (spec 8.6.1): the residual samples are the
        # coded coefficients and the reconstruction is exact
        lev = resi
        skip = None
        if mc_pred is not None:
            skip = (~intra_mask) & (torch.abs(resi).sum((1, 2),
                                                        dtype=I32) == 0)
            lev = torch.where(skip[:, None, None], 0, lev)
        plane[gy, gx] = org
        levels[by.long(), bx.long()] = lev
        return skip, md_sel, None
    coef = dct_batch(resi, log2n, bit_depth)
    nr_out = None
    if nr is not None:
        # noise reduction: this substep's per-position |coef| sums (the
        # next picture's offsets) and the offsets subtracted from |coef|
        off_i, off_p = nr
        ac = torch.abs(coef)
        acf = ac.reshape(ac.shape[0], -1)
        lane_ok = (by < levels.shape[0] - 1).to(I32)
        im = intra_mask.to(I32)
        imask_f = (im * lane_ok)[:, None]
        pmask_f = ((1 - im) * lane_ok)[:, None]
        nr_out = ((acf * imask_f).sum(0, dtype=I32),
                  (acf * pmask_f).sum(0, dtype=I32),
                  imask_f.sum(dtype=I32), pmask_f.sum(dtype=I32))
        off = torch.where(intra_mask[:, None], off_i[None, :],
                          off_p[None, :]).reshape(ac.shape)
        coef = torch.sign(coef) * torch.clamp(ac - off, min=0)
    if rdoq:
        lev = rdoq_levels(coef, intra_mask, qp, log2n, bit_depth, c_idx,
                          init_type, psy_rdoq=psy_rdoq, qmats=qmats,
                          rawmats=dmats, bits_table=ebits, lanes=est_lanes)
    else:
        lev = quant_dyn(coef, intra_mask, qp, log2n, bit_depth, qmats)
    if sign_hide:
        lev = sbh_adjust(lev, coef, intra_mask, qp, log2n, bit_depth)

    skip = None
    if mc_pred is not None:
        # inter zero-residual RD test, per component (see the reference)
        deq0 = dequant_dyn(lev, qp, log2n, bit_depth, dmats, intra_mask)
        rec0 = torch.clip(pred + idct_batch(deq0, log2n, bit_depth), 0,
                          maxval)
        sse_coded = ((org - rec0) ** 2).sum((1, 2), dtype=I32)
        sse_skip = ((org - pred) ** 2).sum((1, 2), dtype=I32)
        lam2 = lam2_ref(qp, bit_depth)
        if init_type is None:
            nzf = (lev != 0).sum((1, 2), dtype=I32).to(F32)
            base_bits = 6.0 if c_idx == 0 else 2.0
            bits = base_bits + torch.where(nzf > 0.0, 10.0, 0.0) + 4.5 * nzf
        else:
            if init_type == 0:
                base_bits = 14.0 if c_idx == 0 else 6.0
            else:
                base_bits = 6.0 if c_idx == 0 else 2.0
            order = None if est_lanes is None else \
                wavefront_sum_order(n, est_lanes)
            bits = base_bits + tb_bits_est(lev, qp, log2n, c_idx, init_type,
                                           bits_table=ebits, order=order)
        psy = None
        if psy256 is not None and c_idx == 0:
            psy = (psy_weight(lam2, psy256,
                              init_type if init_type is not None else 2, qp),
                   psy_cost_batch(org, pred), psy_cost_batch(org, rec0))
        cost_skip, cost_coded = skip_costs(sse_skip, sse_coded, bits, lam2,
                                           psy)
        skip = (~intra_mask) & (cost_skip <= cost_coded)
        lev = torch.where(skip[:, None, None], 0, lev)
    deq = dequant_dyn(lev, qp, log2n, bit_depth, dmats, intra_mask)
    recon = torch.clip(pred + idct_batch(deq, log2n, bit_depth), 0, maxval)

    if split_map is not None:
        recon, lev = _nxn_split(plane, orig, bx, by, x0, y0, modes, n,
                                log2n, qp, c_idx, bit_depth, sign_hide,
                                rdoq, init_type, psy_rdoq,
                                split_map[by.long(), bx.long()] & intra_mask,
                                modes8, av8, m8, tu4_map, av4y, m4, recon,
                                lev, levels.shape)
    plane[gy, gx] = recon
    levels[by.long(), bx.long()] = lev
    return skip, md_sel, nr_out


def _sub_tb(plane, orig, x0, y0, md, avail, log2n: int, qp, c_idx: int,
            bit_depth: int, sign_hide: bool, rdoq: bool, init_type, qm, dm,
            psy_rdoq=None, dst: bool = False):
    """Predict one sub-TU per lane from the current plane (no write) and
    code it: returns (rec, lev, gy, gx)."""
    n = 1 << log2n
    hp = plane.shape[0]
    ones = torch.ones(x0.shape, dtype=torch.bool, device=plane.device)
    ss, sf = substitute_filter_batch(gather_ref_samples(plane, x0, y0, n),
                                     avail, log2n, bit_depth)
    pred = intra_pred_select_batch(ss, sf, md, log2n, c_idx, bit_depth)
    ogy, ogx = block_index(x0, y0, n, orig.shape[0], orig.shape[1])
    coef = dct_batch(orig[ogy, ogx].to(I32) - pred, log2n, bit_depth, dst=dst)
    if rdoq:
        lv = rdoq_levels(coef, ones, qp, log2n, bit_depth, c_idx, init_type,
                         psy_rdoq=psy_rdoq, qmats=qm, rawmats=dm)
    else:
        lv = quant_dyn(coef, ones, qp, log2n, bit_depth, qm)
    if sign_hide:
        # 4x4 and 8x8 luma scans are mode-dependent: the hidden-sign
        # parity must follow the real scan
        lv = sbh_adjust(lv, coef, ones, qp, log2n, bit_depth,
                        scan_sel=_scan_sel_of(md))
    deq = dequant_dyn(lv, qp, log2n, bit_depth, dm, ones)
    rec = torch.clip(pred + idct_batch(deq, log2n, bit_depth, dst=dst), 0,
                     (1 << bit_depth) - 1)
    gy, gx = block_index(x0, y0, n, hp, 1 << 30)
    return rec, lv, gy, gx


_Z4 = ((0, 0), (1, 0), (0, 1), (1, 1))       # z-order (dx, dy) quadrants


def _nxn_split(plane, orig, bx, by, x0, y0, modes, n: int, log2n: int, qp,
               c_idx: int, bit_depth: int, sign_hide: bool, rdoq: bool,
               init_type, psy_rdoq, split, modes8, av8, m8, tu4_map, av4y,
               m4, recon, lev, lshape):
    """The NxN path of a substep (see the reference's _substep_body):
    the four z-order sub-TUs run one after another, each written into
    the plane where `split` holds so the next one predicts from it;
    luma 8x8 sub-TUs may split again into four 4x4 DST TUs (tu4_map).
    Returns the block's (recon, levels) with the split lanes' values."""
    ns = n // 2
    l2s = log2n - 1
    byc = torch.clip(by, 0, lshape[0] - 2).long()
    bxc = torch.clip(bx, 0, lshape[1] - 1).long()
    lev8 = torch.zeros_like(lev)
    for k, (dxs, dys) in enumerate(_Z4):
        x8 = x0 + dxs * ns
        y8 = y0 + dys * ns
        md8 = modes8[byc, bxc, k] if c_idx == 0 else modes
        rec8, lv8, gy8, gx8 = _sub_tb(plane, orig, x8, y8, md8, av8[:, k],
                                      l2s, qp, c_idx, bit_depth, sign_hide,
                                      rdoq, init_type, m8[0], m8[1])
        keep = plane[gy8, gx8]
        if c_idx == 0 and tu4_map is not None:
            t4 = tu4_map[byc, bxc, k] & split
            plane[gy8, gx8] = torch.where((split & ~t4)[:, None, None], rec8,
                                          keep)
            lev4 = torch.zeros_like(lv8)
            for j, (dxq, dyq) in enumerate(_Z4):
                rec4, lv4, gy4, gx4 = _sub_tb(
                    plane, orig, x8 + dxq * 4, y8 + dyq * 4, md8,
                    av4y[:, k, j], 2, qp, 0, bit_depth, sign_hide, rdoq,
                    init_type, m4[0], m4[1], psy_rdoq=psy_rdoq, dst=True)
                keep4 = plane[gy4, gx4]
                plane[gy4, gx4] = torch.where(t4[:, None, None], rec4, keep4)
                lev4[:, dyq * 4:dyq * 4 + 4, dxq * 4:dxq * 4 + 4] = lv4
            lv8 = torch.where(t4[:, None, None], lev4, lv8)
        else:
            plane[gy8, gx8] = torch.where(split[:, None, None], rec8, keep)
        lev8[:, dys * ns:dys * ns + ns, dxs * ns:dxs * ns + ns] = lv8
    gy, gx = block_index(x0, y0, n, plane.shape[0], 1 << 30)
    sp = split[:, None, None]
    return (torch.where(sp, plane[gy, gx], recon),
            torch.where(sp, lev8, lev))


def _intra_tb_whole(plane, orig, x0, y0, modes, avail, log2n: int, qp,
                    c_idx: int, bit_depth: int, sign_hide: bool, rdoq: bool,
                    qm, dm, strong: bool, init_type=None, psy_rdoq=None):
    """Whole-TB intra predict + transform + recon for (B,) lanes at pixel
    coords (x0, y0); does not write the plane.  qm/dm: scaling-list
    matrices for the flat quantizer and the dequantizer (RDOQ runs
    without them, as in the reference).  Returns (rec, lev, gy, gx)."""
    n = 1 << log2n
    maxval = (1 << bit_depth) - 1
    hp, wp = plane.shape
    dev = plane.device
    x0 = x0.long()
    y0 = y0.long()
    s_sub, s_filt = substitute_filter_batch(gather_ref_samples(plane, x0, y0, n),
                                            avail, log2n, bit_depth,
                                            strong=strong)
    pred = intra_pred_select_batch(s_sub, s_filt, modes, log2n, c_idx,
                                   bit_depth)
    ogy, ogx = block_index(x0, y0, n, orig.shape[0], orig.shape[1])
    org = orig[ogy, ogx].to(I32)
    coef = dct_batch(org - pred, log2n, bit_depth)
    ones = torch.ones(x0.shape, dtype=torch.bool, device=dev)
    if rdoq:
        lev = rdoq_levels(coef, ones, qp, log2n, bit_depth, c_idx,
                          init_type, psy_rdoq=psy_rdoq)
    else:
        lev = quant_dyn(coef, ones, qp, log2n, bit_depth, qm)
    if sign_hide:
        lev = sbh_adjust(lev, coef, ones, qp, log2n, bit_depth)
    deq = dequant_dyn(lev, qp, log2n, bit_depth, dm, ones)
    rec = torch.clip(pred + idct_batch(deq, log2n, bit_depth), 0, maxval)
    gy, gx = block_index(x0, y0, n, hp, 1 << 30)
    return rec, lev, gy, gx


def _mats_or_none(mats, k: int = 4):
    return mats if mats is not None else (None,) * k


def _wavefront_tree(yp, up, vp, lev_y, lev_u, lev_v, oy, ou, ov, modes,
                    sched, split32, mode32, qp, qp_cb, qp_cr,
                    bit_depth: int, sign_hide: bool, rdoq: bool,
                    strong: bool, init_type: int, psy_rdoq, cand16,
                    cbits16, mats=None, mats32=None, split_map=None,
                    modes8=None, mats_nxn=None):
    """Variable CU-tree intra wavefront (see the reference's
    _wavefront_tree_body): each step runs the four z-ordered 16x16
    substeps (with their NxN splits) and the whole-region 32x32 CU,
    committing per split32.  mats/mats32: (qm_y, dm_y, qm_c, dm_c)
    scaling-list tables of the 16/8 and 32/16 TBs, mats_nxn those of
    the NxN sub-TUs (IntraReconstructor._build_mats).  Returns the luma
    mode map (with a dump row)."""
    nby = lev_y.shape[0] - 1
    nbx = lev_y.shape[1]
    n32y, n32x = split32.shape
    m_map = torch.cat([modes, torch.zeros((1, nbx), dtype=modes.dtype,
                                          device=modes.device)], 0)
    t_bx, t_by, t_avy, t_avc = sched["bx"], sched["by"], sched["avy"], \
        sched["avc"]
    qm_y, dm_y, qm_c, dm_c = _mats_or_none(mats)
    q8y, d8y, q4y, d4y, q4c, d4c = _mats_or_none(mats_nxn, 6)
    nxn = dict(split_map=split_map, modes8=modes8)
    for s in range(t_bx.shape[0]):
        for z in range(4):
            bx = t_bx[s, z]
            by = t_by[s, z]
            cy = torch.clip(by, 0, qp.shape[0] - 1).long()
            cx = torch.clip(bx, 0, qp.shape[1] - 1).long()
            byc = torch.clip(by, 0, nby - 1).long()
            bxc = torch.clip(bx, 0, nbx - 1).long()
            av8 = sched["av8"][s, z] if split_map is not None else None
            av4c = sched["av4c"][s, z] if split_map is not None else None
            if cand16 is not None:
                _, md_w, _ = _substep_body(
                    yp, lev_y, oy, bx, by, cand16[byc, bxc], t_avy[s, z], 4,
                    qp[cy, cx], 0, bit_depth, sign_hide=sign_hide,
                    rdoq=rdoq, init_type=init_type, psy_rdoq=psy_rdoq,
                    cand_bits=cbits16[byc, bxc], qmats=qm_y, dmats=dm_y,
                    av8=av8, m8=(q8y, d8y), **nxn)
                m_map[by.long(), bx.long()] = md_w
            md = m_map[byc, bxc]
            if cand16 is None:
                _substep_body(yp, lev_y, oy, bx, by, md, t_avy[s, z], 4,
                              qp[cy, cx], 0, bit_depth,
                              sign_hide=sign_hide, rdoq=rdoq,
                              init_type=init_type, psy_rdoq=psy_rdoq,
                              qmats=qm_y, dmats=dm_y, av8=av8,
                              m8=(q8y, d8y), **nxn)
            for (cpl, lev_c, opl, qpc, ci) in ((up, lev_u, ou, qp_cb, 1),
                                               (vp, lev_v, ov, qp_cr, 2)):
                _substep_body(cpl, lev_c, opl, bx, by, md, t_avc[s, z], 3,
                              qpc[cy, cx], ci, bit_depth,
                              sign_hide=sign_hide, rdoq=rdoq,
                              init_type=init_type, qmats=qm_c, dmats=dm_c,
                              av8=av4c, m8=(q4c, d4c), **nxn)

        # whole-region 32x32 CU path
        px = sched["px"][s]
        py = sched["py"][s]
        valid = sched["valid"][s]
        r32x = torch.clip(px >> 5, 0, n32x - 1).long()
        r32y = torch.clip(py >> 5, 0, n32y - 1).long()
        commit = valid & ~split32[r32y, r32x]
        md32 = mode32[r32y, r32x]
        cy = torch.clip(py >> 4, 0, qp.shape[0] - 1).long()
        cx = torch.clip(px >> 4, 0, qp.shape[1] - 1).long()
        q32y, d32y, q32c, d32c = _mats_or_none(mats32)
        rec32, lv32, gy, gx = _intra_tb_whole(
            yp, oy, px, py, md32, sched["ravy"][s], 5, qp[cy, cx], 0,
            bit_depth, sign_hide, rdoq, q32y, d32y, strong, init_type,
            psy_rdoq=psy_rdoq)
        cur = yp[gy, gx]
        yp[gy, gx] = torch.where(commit[:, None, None], rec32, cur)
        for (cpl, lev_c, opl, qpc, mi) in ((up, lev_u, ou, qp_cb, 1),
                                           (vp, lev_v, ov, qp_cr, 2)):
            recc, lvc, gyc, gxc = _intra_tb_whole(
                cpl, opl, px >> 1, py >> 1, md32, sched["ravc"][s], 4,
                qpc[cy, cx], mi, bit_depth, sign_hide, rdoq, q32c, d32c,
                False, init_type)
            curc = cpl[gyc, gxc]
            cpl[gyc, gxc] = torch.where(commit[:, None, None], recc, curc)
            _store_quads(lev_c, lvc, px, py, valid, commit, nby, 8)
        _store_quads(lev_y, lv32, px, py, valid, commit, nby, 16)
    return m_map


def _store_quads(lev, lv, px, py, valid, commit, nby: int, q: int):
    """Store a region TB's levels as q x q quadrants of its 4 blocks."""
    for (dy, dx) in ((0, 0), (0, 1), (1, 0), (1, 1)):
        bq_x = torch.where(valid, (px >> 4) + dx, 0).long()
        bq_y = torch.where(valid, (py >> 4) + dy, nby).long()
        part = lv[:, dy * q:dy * q + q, dx * q:dx * q + q]
        curl = lev[bq_y, bq_x]
        lev[bq_y, bq_x] = torch.where(commit[:, None, None], part, curl)


def _nr_add(acc, out, luma: bool):
    """Add one substep's NR sums to the frame's int32 accumulators
    (ys_i, ys_p, cs_i, cs_p, counts)."""
    si, sp, ci, cp = out
    ys_i, ys_p, cs_i, cs_p, cnt = acc
    z = torch.zeros((), dtype=I32, device=cnt.device)
    if luma:
        return (ys_i + si, ys_p + sp, cs_i, cs_p,
                cnt + torch.stack([ci, cp, z, z]))
    return (ys_i, ys_p, cs_i + si, cs_p + sp,
            cnt + torch.stack([z, z, ci, cp]))


def _wavefront(yp, up, vp, lev_y, lev_u, lev_v, oy, ou, ov, modes, sched,
               mc_y, mc_u, mc_v, inter_mask, qp, qp_cb, qp_cr,
               bit_depth: int, sign_hide: bool, rdoq: bool, init_type: int,
               psy256, psy_rdoq, clog2: int, cand16, cbits16, ebits,
               mats=None, split_map=None, modes8=None,
               lossless: bool = False, tu4_map=None, nr_y=None, nr_c=None,
               mats_nxn=None, fchroma: bool = False, csp422: bool = False,
               imask_c=None):
    """Fixed 16-grid wavefront (see the reference's _wavefront_body).
    mats: (qm_y, dm_y, qm_c, dm_c) scaling-list tables, mats_nxn those
    of the NxN sub-TUs; split_map / modes8 / tu4_map: NxN intra and its
    TU4 splits; nr_y / nr_c: (2, 256) / (2, 64) [intra, inter]
    noise-reduction offsets; clog2: the chroma TB size (3, or 4 in
    4:4:4, whose chroma filters its references: fchroma); csp422: each
    block carries two stacked 8x8 chroma TBs on the row-doubled chroma
    grid, whose inter mask is imask_c.  Returns the
    luma mode map (with a dump row) and the frame's int32 NR sums
    (ys_i, ys_p, cs_i, cs_p, counts) or None."""
    nby = lev_y.shape[0] - 1
    nbx = lev_y.shape[1]
    dev = lev_y.device
    m_map = torch.cat([modes, torch.zeros((1, nbx), dtype=modes.dtype,
                                          device=dev)], 0)
    sb_bx, sb_by, sb_avy, sb_avc = sched["bx"], sched["by"], sched["avy"], \
        sched["avc"]
    qm_y, dm_y, qm_c, dm_c = _mats_or_none(mats)
    q8y, d8y, q4y, d4y, q4c, d4c = _mats_or_none(mats_nxn, 6)
    have_nr = nr_y is not None
    nr_acc = None
    if have_nr:
        z = lambda k: torch.zeros(k, dtype=I32, device=dev)
        nl2 = lev_y.shape[2] * lev_y.shape[3]
        nc2 = lev_u.shape[2] * lev_u.shape[3]
        nr_acc = (z(nl2), z(nl2), z(nc2), z(nc2), z(4))
        nr_l = (nr_y[0], nr_y[1])
        nr_cc = (nr_c[0], nr_c[1])
    else:
        nr_l = nr_cc = None
    # the reference's 4:2:0 program sums the skip test's bit estimates in
    # an order its lane count decides (read at 4:2:0 only)
    est_lanes = sb_bx.shape[1] if clog2 == 3 and not csp422 else None
    for s in range(sb_bx.shape[0]):
        bx = sb_bx[s]
        by = sb_by[s]
        eb_s = ebits
        if ebits is not None and ebits.dim() == 3:
            eb_s = ebits[torch.clip(by, 0, ebits.shape[0] - 1).long()]
        cy = torch.clip(by, 0, qp.shape[0] - 1).long()
        cx = torch.clip(bx, 0, qp.shape[1] - 1).long()
        qp_b = qp[cy, cx]
        byc = torch.clip(by, 0, nby - 1).long()
        bxc = torch.clip(bx, 0, nbx - 1).long()
        luma = dict(qmats=qm_y, dmats=dm_y, split_map=split_map,
                    modes8=modes8,
                    av8=sched["av8"][s] if split_map is not None else None,
                    m8=(q8y, d8y), lossless=lossless, tu4_map=tu4_map,
                    av4y=sched["av4y"][s] if tu4_map is not None else None,
                    m4=(q4y, d4y), nr=nr_l, ebits=eb_s, est_lanes=est_lanes)
        if cand16 is not None:
            _, md_w, nr_o = _substep_body(
                yp, lev_y, oy, bx, by, cand16[byc, bxc], sb_avy[s], 4, qp_b,
                0, bit_depth, mc_y, inter_mask, sign_hide, rdoq, init_type,
                psy256, psy_rdoq, cand_bits=cbits16[byc, bxc], **luma)
            m_map[by.long(), bx.long()] = md_w
        md = m_map[byc, bxc]
        if cand16 is None:
            _, _, nr_o = _substep_body(
                yp, lev_y, oy, bx, by, md, sb_avy[s], 4, qp_b, 0,
                bit_depth, mc_y, inter_mask, sign_hide, rdoq, init_type,
                psy256, psy_rdoq, **luma)
        if have_nr:
            nr_acc = _nr_add(nr_acc, nr_o, True)
        if csp422:
            # 4:2:2: two stacked 8x8 chroma TBs per 16x16 block (spec
            # 7.3.8.10, ChromaArrayType 2) on the row-doubled chroma
            # grid, predicted with the Table 8-3 remapped mode; the
            # reference gives them no rate tables and flat 4x4 lists
            md_c = _angle422(dev)[torch.clip(md, 0, 34).long()]
            for j in (0, 1):
                byj = by * 2 + j
                for (cpl, lev_c, opl, mc_c, qpc, ci) in (
                        (up, lev_u, ou, mc_u, qp_cb, 1),
                        (vp, lev_v, ov, mc_v, qp_cr, 2)):
                    _substep_body(
                        cpl, lev_c, opl, bx, byj, md_c, sb_avc[s][:, j],
                        clog2, qpc[cy, cx], ci, bit_depth, mc_c, imask_c,
                        sign_hide, rdoq, init_type, qmats=qm_c,
                        dmats=dm_c, lossless=lossless)
            continue
        for (cpl, lev_c, opl, mc_c, qpc, ci) in (
                (up, lev_u, ou, mc_u, qp_cb, 1),
                (vp, lev_v, ov, mc_v, qp_cr, 2)):
            _, _, nr_o = _substep_body(
                cpl, lev_c, opl, bx, by, md, sb_avc[s], clog2, qpc[cy, cx],
                ci, bit_depth, mc_c, inter_mask, sign_hide, rdoq, init_type,
                ebits=eb_s, qmats=qm_c, dmats=dm_c, split_map=split_map,
                modes8=modes8,
                av8=sched["av4c"][s] if split_map is not None else None,
                m8=(q4c, d4c), lossless=lossless, nr=nr_cc,
                fchroma=fchroma, est_lanes=est_lanes)
            if have_nr:
                nr_acc = _nr_add(nr_acc, nr_o, False)
    return m_map, nr_acc


def _angle422(device):
    """Table 8-3's 4:2:2 chroma intra mode remap on `device`."""
    return torch.as_tensor(np.asarray(CHROMA_422_ANGLE_MAP, np.int64),
                           device=device)


class IntraReconstructor:
    """Runs the wavefront over a frame on `device`; produces recon planes
    and level stores.  QP is a per-run argument."""

    def __init__(self, sps, device, cb_qp_offset: int = 0,
                 cr_qp_offset: int = 0, sign_hide: bool = False,
                 rdoq: bool = False, slice_tops: tuple = (),
                 nxn: bool = False, lossless: bool = False,
                 tree: bool = False, psy_rd: float = 0.0,
                 psy_rdoq: float = 0.0, tu4: bool = False) -> None:
        self.device = torch.device(device)
        self.tu4 = bool(tu4)
        self.sps = sps
        self.cb_qp_offset = cb_qp_offset
        self.cr_qp_offset = cr_qp_offset
        self.sign_hide = bool(sign_hide)
        self.rdoq = bool(rdoq)
        self.psy256 = int(round(psy_rd * 256.0)) if psy_rd > 0 else None
        self.psy_rdoq = float(np.float32(psy_rdoq)) \
            if (psy_rdoq > 0 and rdoq) else None
        self.mats = None
        self.mats32 = None
        self.mats_nxn = None
        if getattr(sps, "scaling_list_enabled", False):
            self._build_mats(getattr(sps, "scaling_lists", None), tree)
        self.bd = sps.bit_depth
        self.log2_ctu = sps.log2_ctu_size
        self.csp = getattr(sps, "chroma_format_idc", 1)
        # horizontal chroma shift (0 only for 4:4:4); 4:2:2 halves x but
        # keeps full-height chroma on a row-doubled 8x8 block grid
        self.cshift = 0 if self.csp == 3 else 1
        self.is422 = self.csp == 2
        self.nl = 16
        self.nc = self.nl >> self.cshift
        w, h = sps.width, sps.height
        assert w % self.nl == 0 and h % self.nl == 0, \
            "v1 requires 16-aligned dimensions"
        self.nbx = w // self.nl
        self.nby = h // self.nl
        self.n_ctu_x = sps.pic_width_in_ctus
        self.n_ctu_y = sps.pic_height_in_ctus
        self.bpc = (1 << self.log2_ctu) // self.nl
        self.slice_tops = tuple(slice_tops)
        self.nxn = bool(nxn)
        self.lossless = bool(lossless)
        self.tree = bool(tree)
        if self.tree:
            assert self.log2_ctu >= 5 and not self.lossless
            self.n32x = w // 32
            self.n32y = h // 32
            self._build_tree_schedule()
        self._build_schedule()

    def _t(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _build_mats(self, sl, tree: bool) -> None:
        """Scaling-list tables (qm_y, dm_y, qm_c, dm_c) for the 16/8 TBs
        (and the 32/16 TBs of the CU tree) from the default lists or the
        parsed custom ones (luma and chroma each from their own
        listId), as the reference builds them; and the NxN sub-TUs'
        tables (luma 8x8, luma 4x4, chroma 4x4).

        The NxN sub-TUs depart from the reference, which quantizes a
        luma 8x8 sub-TU with the chroma 8x8 list and every 4x4 TB as
        flat, so that its stream does not decode to its recon under a
        custom list whose luma and chroma 8x8 lists differ or whose 4x4
        lists are not flat.  The port takes each TB's own list (the
        decoder's).  Under the default lists these are the tables the
        reference uses (the 8x8 lists do not depend on the component)
        or flat (4x4, kept as None), so the bytes are the reference's."""
        if sl is not None:
            qm = lambda l2, c: quant_mats_custom(l2, sl[0], sl[1], c)
            raw = lambda l2, c: np.stack(
                [list_matrix(sl[0], sl[1], l2, True, c),
                 list_matrix(sl[0], sl[1], l2, False, c)])
        else:
            qm = lambda l2, c: quant_mats(l2)
            raw = lambda l2, c: np.stack([default_matrix(l2, True),
                                          default_matrix(l2, False)])
        t = lambda a: self._t(np.asarray(a).astype(np.int32))
        self.mats = tuple(t(a) for a in (qm(4, 0), raw(4, 0), qm(3, 1),
                                         raw(3, 1)))
        m4 = (None,) * 4 if sl is None else \
            tuple(t(a) for a in (qm(2, 0), raw(2, 0), qm(2, 1), raw(2, 1)))
        self.mats_nxn = (t(qm(3, 0)), t(raw(3, 0))) + m4
        if tree:
            self.mats32 = tuple(t(a) for a in (qm(5, 0), raw(5, 0),
                                               qm(4, 1), raw(4, 1)))

    def _sub_avail(self, byp, bxp, valid, av8_full, av4c_full,
                   av4y_full=None):
        """(B, 4, 33) luma 8x8 and (B, 4, 17) chroma 4x4 sub-block
        availability of the NxN quadrants (and (B, 4, 4, 17) of the TU4
        sub-blocks) for the lanes (byp, bxp); invalid lanes all False."""
        nb = len(valid)
        a8 = np.zeros((len(bxp), 4, 33), bool)
        a4 = np.zeros((len(bxp), 4, 17), bool)
        a4y = np.zeros((len(bxp), 4, 4, 17), bool) \
            if av4y_full is not None else None
        byv, bxv = byp[:nb], bxp[:nb]
        for k, (dx8, dy8) in enumerate(_Z4):
            a8[:nb, k] = av8_full[np.where(valid, 2 * byv + dy8, 0),
                                  np.where(valid, 2 * bxv + dx8, 0)] \
                & valid[:, None]
            a4[:nb, k] = av4c_full[np.where(valid, 2 * byv + dy8, 0),
                                   np.where(valid, 2 * bxv + dx8, 0)] \
                & valid[:, None]
            if a4y is not None:
                for j, (dxq, dyq) in enumerate(_Z4):
                    a4y[:nb, k, j] = av4y_full[
                        np.where(valid, 4 * byv + 2 * dy8 + dyq, 0),
                        np.where(valid, 4 * bxv + 2 * dx8 + dxq, 0)] \
                        & valid[:, None]
        return a8, a4, a4y

    def _build_tree_schedule(self) -> None:
        """(S, 4, B) 16-block + (S, B) 32-region schedule (same order as
        the reference's _build_tree_schedule)."""
        w, h = self.sps.width, self.sps.height
        avail_y = frame_avail_masks(w, h, self.nl, self.log2_ctu, 0,
                                    self.slice_tops)
        avail_c = frame_avail_masks(w, h, self.nc, self.log2_ctu, 1,
                                    self.slice_tops)
        av32 = frame_avail_masks(w, h, 32, self.log2_ctu, 0,
                                 self.slice_tops)
        av16c = frame_avail_masks(w, h, 16, self.log2_ctu, 1,
                                  self.slice_tops)
        av8_full = av4c_full = None
        if self.nxn:
            av8_full = frame_avail_masks(w, h, 8, self.log2_ctu, 0,
                                         self.slice_tops)
            av4c_full = frame_avail_masks(w, h, 4, self.log2_ctu, 1,
                                          self.slice_tops)
        waves = ctu_wavefront_order(self.n_ctu_x, self.n_ctu_y)
        B = max(len(wv[0]) for wv in waves)
        rpc = self.bpc // 2
        sub_keys = ("bx", "by", "avy", "avc") + \
            (("av8", "av4c") if self.nxn else ())
        st = {k: [] for k in sub_keys + ("px", "py", "valid", "ravy",
                                         "ravc")}
        for (cxs, cys) in waves:
            nb = len(cxs)
            pad = B - nb
            for q in range(rpc * rpc):
                qx = ((q >> 0) & 1) | (((q >> 2) & 1) << 1)
                qy = ((q >> 1) & 1) | (((q >> 3) & 1) << 1)
                rx = cxs * rpc + qx
                ry = cys * rpc + qy
                rvalid = ((rx + 1) * 32 <= w) & ((ry + 1) * 32 <= h)
                any_blk = False
                zb = {k: [] for k in sub_keys}
                for z in range(4):
                    zx, zy = z & 1, z >> 1
                    bx = rx * 2 + zx
                    by = ry * 2 + zy
                    valid = (bx < self.nbx) & (by < self.nby)
                    any_blk |= valid.any()
                    bxp = np.where(valid, bx, 0).astype(np.int32)
                    byp = np.where(valid, by, self.nby).astype(np.int32)
                    avy = avail_y[np.where(valid, byp, 0),
                                  np.where(valid, bxp, 0)] & valid[:, None]
                    avc = avail_c[np.where(valid, byp, 0),
                                  np.where(valid, bxp, 0)] & valid[:, None]
                    if pad:
                        bxp = np.concatenate([bxp, np.zeros(pad, np.int32)])
                        byp = np.concatenate(
                            [byp, np.full(pad, self.nby, np.int32)])
                        avy = np.concatenate(
                            [avy, np.zeros((pad, avy.shape[1]), bool)])
                        avc = np.concatenate(
                            [avc, np.zeros((pad, avc.shape[1]), bool)])
                    zb["bx"].append(bxp)
                    zb["by"].append(byp)
                    zb["avy"].append(avy)
                    zb["avc"].append(avc)
                    if av8_full is not None:
                        a8, a4, _ = self._sub_avail(byp, bxp, valid,
                                                    av8_full, av4c_full)
                        zb["av8"].append(a8)
                        zb["av4c"].append(a4)
                if not any_blk:
                    continue
                px = np.where(rvalid, rx * 32, 0).astype(np.int32)
                py = np.where(rvalid, ry * 32, h).astype(np.int32)
                ravy = av32[np.where(rvalid, np.minimum(ry, self.n32y - 1),
                                     0),
                            np.where(rvalid, np.minimum(rx, self.n32x - 1),
                                     0)] & rvalid[:, None]
                ravc = av16c[np.where(rvalid,
                                      np.minimum(ry, self.n32y - 1), 0),
                             np.where(rvalid,
                                      np.minimum(rx, self.n32x - 1), 0)] \
                    & rvalid[:, None]
                if pad:
                    px = np.concatenate([px, np.zeros(pad, np.int32)])
                    py = np.concatenate([py, np.full(pad, h, np.int32)])
                    rvalid = np.concatenate([rvalid, np.zeros(pad, bool)])
                    ravy = np.concatenate(
                        [ravy, np.zeros((pad, 129), bool)])
                    ravc = np.concatenate(
                        [ravc, np.zeros((pad, 65), bool)])
                for k in sub_keys:
                    st[k].append(np.stack(zb[k]))
                st["px"].append(px)
                st["py"].append(py)
                st["valid"].append(rvalid)
                st["ravy"].append(ravy)
                st["ravc"].append(ravc)
        self.tree_sched = {k: self._t(np.stack(v)) for k, v in st.items()}

    def _build_schedule(self) -> None:
        """Stacked (S, B) 16-grid wavefront schedule (with the NxN and
        TU4 sub-block availability when those are on)."""
        w, h = self.sps.width, self.sps.height
        avail_y = frame_avail_masks(w, h, self.nl, self.log2_ctu, 0,
                                    self.slice_tops)
        if self.is422:
            # 4:2:2 chroma availability on the row-doubled 8x8 grid
            avail_c = frame_avail_masks(w, h, 8, self.log2_ctu, 1,
                                        self.slice_tops, comp_shift_y=0)
        else:
            avail_c = frame_avail_masks(w, h, self.nc, self.log2_ctu,
                                        self.cshift, self.slice_tops)
        av8_full = av4c_full = av4y_full = None
        if self.nxn:
            av8_full = frame_avail_masks(w, h, 8, self.log2_ctu, 0,
                                         self.slice_tops)
            av4c_full = frame_avail_masks(w, h, 4, self.log2_ctu, 1,
                                          self.slice_tops)
            if self.tu4:
                av4y_full = frame_avail_masks(w, h, 4, self.log2_ctu, 0,
                                              self.slice_tops)
        waves = ctu_wavefront_order(self.n_ctu_x, self.n_ctu_y)
        B = max(len(wv[0]) for wv in waves)
        st = {k: [] for k in ("bx", "by", "avy", "avc", "av8", "av4c",
                              "av4y")}
        for (cxs, cys) in waves:
            nb = len(cxs)
            for z in range(self.bpc * self.bpc):
                zx = ((z >> 0) & 1) | (((z >> 2) & 1) << 1)
                zy = ((z >> 1) & 1) | (((z >> 3) & 1) << 1)
                bx = cxs * self.bpc + zx
                by = cys * self.bpc + zy
                valid = (bx < self.nbx) & (by < self.nby)
                bxp = np.where(valid, bx, 0).astype(np.int32)
                byp = np.where(valid, by, self.nby).astype(np.int32)
                if nb < B:
                    pad = B - nb
                    bxp = np.concatenate([bxp, np.zeros(pad, np.int32)])
                    byp = np.concatenate(
                        [byp, np.full(pad, self.nby, np.int32)])
                    valid = np.concatenate([valid, np.zeros(pad, bool)])
                if not valid.any():
                    continue
                st["bx"].append(bxp)
                st["by"].append(byp)
                st["avy"].append(avail_y[np.where(valid, byp, 0),
                                         np.where(valid, bxp, 0)]
                                 & valid[:, None])
                if self.is422:
                    # both stacked 8x8 chroma TBs' masks (B, 2, 33)
                    st["avc"].append(np.stack(
                        [avail_c[np.where(valid, 2 * byp + j, 0),
                                 np.where(valid, bxp, 0)] & valid[:, None]
                         for j in (0, 1)], axis=1))
                else:
                    st["avc"].append(avail_c[np.where(valid, byp, 0),
                                             np.where(valid, bxp, 0)]
                                     & valid[:, None])
                if av8_full is not None:
                    a8, a4, a4y = self._sub_avail(byp, bxp, valid,
                                                  av8_full, av4c_full,
                                                  av4y_full)
                    st["av8"].append(a8)
                    st["av4c"].append(a4)
                    if a4y is not None:
                        st["av4y"].append(a4y)
        self.sched = {k: self._t(np.stack(v)) for k, v in st.items() if v}

    def _qp_maps(self, qp):
        """(luma, cb, cr) per-16-block QP maps from a scalar or a
        (nCtuY, nCtuX) array."""
        if np.isscalar(qp):
            qy = np.full((self.nby, self.nbx), qp, np.int32)
        else:
            qc = np.asarray(qp, np.int32)
            bpc = self.bpc
            qy = np.repeat(np.repeat(qc, bpc, 0), bpc, 1)[
                :self.nby, :self.nbx]
        if self.csp == 1:
            tab = CHROMA_QP_TABLE
            qcb = tab[np.clip(qy + self.cb_qp_offset, 0, 69)]
            qcr = tab[np.clip(qy + self.cr_qp_offset, 0, 69)]
        else:                   # 4:2:2 / 4:4:4: qPi clipped, no remap
            qcb = np.clip(qy + self.cb_qp_offset, 0, 51)
            qcr = np.clip(qy + self.cr_qp_offset, 0, 51)
        return (self._t(qy), self._t(qcb.astype(np.int32)),
                self._t(qcr.astype(np.int32)))

    def _alloc(self, h: int, w: int, hc: int, wc: int, dump_l: int,
               dump_c: int, nbc: int = None, cdump: int = 1):
        """Recon planes with their dump rows and the level stores with
        their dump block rows (nbc + cdump chroma block rows)."""
        z = lambda *s: torch.zeros(s, dtype=I32, device=self.device)
        nl, nc = self.nl, self.nc
        nbc = self.nby if nbc is None else nbc
        return (z(h + dump_l, w), z(hc + dump_c, wc), z(hc + dump_c, wc),
                z(self.nby + 1, self.nbx, nl, nl),
                z(nbc + cdump, self.nbx, nc, nc),
                z(nbc + cdump, self.nbx, nc, nc))

    def _padb(self, a, k: int = 1):
        """Append k dump block rows."""
        a = torch.as_tensor(a, device=self.device)
        return torch.cat([a, torch.zeros((k,) + tuple(a.shape[1:]),
                                         dtype=a.dtype, device=self.device)],
                         0)

    def _chroma_blocks(self, a):
        """(nby, nbx, 16, 8) 4:2:2 chroma predictions -> the row-doubled
        (2 * nby + 2, nbx, 8, 8) block store."""
        nc = self.nc
        a = torch.as_tensor(a, device=self.device)
        t = a.reshape(self.nby, self.nbx, 2, nc, nc).transpose(1, 2) \
            .reshape(2 * self.nby, self.nbx, nc, nc)
        return self._padb(t, 2)

    def _nxn_maps(self, split_map, modes8):
        if split_map is None:
            return None, None
        return (self._padb(self._t(np.asarray(split_map, bool))),
                self._t(np.asarray(modes8, np.int32)))

    def run_tree(self, y, u, v, modes, split32, mode32, qp=32,
                 split_map=None, modes8=None, materialize: bool = True,
                 init_type: int = 2, cand=None):
        """Intra variable-CU-tree reconstruction (32x32 CUs where split32
        is False, the 16-grid with its NxN splits elsewhere)."""
        assert self.tree
        qp_map = self._qp_maps(qp)
        w, h = self.sps.width, self.sps.height
        wc, hc = w // 2, h // 2
        yp, up, vp, lev_y, lev_u, lev_v = self._alloc(h, w, hc, wc, 32, 16)
        dev = self.device
        oy, ou, ov = (dev_i32(a, dev) for a in (y, u, v))
        sm, m8j = self._nxn_maps(split_map, modes8)
        c16 = cb16 = None
        if cand is not None and split_map is None:
            c16 = self._t(np.asarray(cand[0], np.int32))
            cb16 = self._t(np.asarray(cand[1], np.float32))
        m_map = _wavefront_tree(
            yp, up, vp, lev_y, lev_u, lev_v, oy, ou, ov,
            self._t(np.asarray(modes, np.int32)), self.tree_sched,
            self._t(np.asarray(split32, bool)),
            self._t(np.asarray(mode32, np.int32)),
            qp_map[0], qp_map[1], qp_map[2], self.bd, self.sign_hide,
            self.rdoq, bool(getattr(self.sps, "strong_intra_smoothing",
                                    True)),
            int(init_type), self.psy_rdoq, c16, cb16, self.mats,
            self.mats32, sm, m8j, self.mats_nxn)
        rd = {"recon_y": yp[:h], "recon_u": up[:hc], "recon_v": vp[:hc],
              "lev_y": lev_y[:self.nby], "lev_u": lev_u[:self.nby],
              "lev_v": lev_v[:self.nby]}
        if c16 is not None:
            rd["modes_sel"] = m_map[:self.nby]
        return self.materialize(rd) if materialize else rd

    def run(self, y, u, v, modes, mc_pred=None, inter_mask=None, qp=32,
            materialize: bool = True, split_map=None, modes8=None,
            init_type: int = 2, tu4_map=None, cand=None, nr=None,
            ebits=None):
        """16-grid reconstruction.  mc_pred: optional (mc_y, mc_u, mc_v)
        inter predictions (nby, nbx, N, N) tensors (4:2:2 chroma
        (nby, nbx, 16, 8), the two stacked TBs); inter_mask:
        (nby, nbx) bool; split_map / modes8 / tu4_map: NxN intra and
        its TU4 splits; nr: ((2, 256), (2, 64)) int32 [intra, inter]
        noise-reduction offsets, which add the frame's int32 |coef|
        sums to the result as "nr_stats"."""
        qp_map = self._qp_maps(qp)
        nl, nc = self.nl, self.nc
        w, h = self.sps.width, self.sps.height
        wc = w >> self.cshift
        hc = h if self.is422 else h >> self.cshift
        # 4:2:2: chroma stores live on a row-doubled 8x8 block grid
        nbc = 2 * self.nby if self.is422 else self.nby
        cdump = 2 if self.is422 else 1
        dev = self.device
        yp, up, vp, lev_y, lev_u, lev_v = self._alloc(
            h, w, hc, wc, nl, cdump * nc, nbc, cdump)
        oy, ou, ov = (dev_i32(a, dev) for a in (y, u, v))
        modes_j = self._t(np.asarray(modes, np.int32))
        imask_c = None
        if mc_pred is None:
            z = lambda *s: torch.zeros(s, dtype=I32, device=dev)
            mc_y = z(self.nby + 1, self.nbx, nl, nl)
            mc_u = z(nbc + cdump, self.nbx, nc, nc)
            mc_v = z(nbc + cdump, self.nbx, nc, nc)
            imask = torch.zeros((self.nby + 1, self.nbx), dtype=torch.bool,
                                device=dev)
            if self.is422:
                imask_c = torch.zeros((nbc + cdump, self.nbx),
                                      dtype=torch.bool, device=dev)
        else:
            mc_y = self._padb(mc_pred[0])
            imask = self._padb(np.asarray(inter_mask, bool))
            if self.is422:
                mc_u = self._chroma_blocks(mc_pred[1])
                mc_v = self._chroma_blocks(mc_pred[2])
                imask_c = self._padb(self._t(np.repeat(
                    np.asarray(inter_mask, bool), 2, axis=0)), 2)
            else:
                mc_u = self._padb(mc_pred[1])
                mc_v = self._padb(mc_pred[2])
        sm, m8j = self._nxn_maps(split_map, modes8)
        t4j = None
        if split_map is not None and tu4_map is not None and self.tu4:
            t4j = self._t(np.asarray(tu4_map, bool))
        c16 = cb16 = None
        if cand is not None and split_map is None and not self.lossless:
            c16 = self._t(np.asarray(cand[0], np.int32))
            cb16 = self._t(np.asarray(cand[1], np.float32))
        nr_y = nr_c = None
        if nr is not None and self.csp == 1 and not self.lossless:
            nr_y = self._t(np.asarray(nr[0], np.int32))
            nr_c = self._t(np.asarray(nr[1], np.int32))
        eb = None if ebits is None else \
            self._t(np.asarray(ebits, np.float32))
        m_map, nr_stats = _wavefront(
            yp, up, vp, lev_y, lev_u, lev_v, oy, ou, ov, modes_j,
            self.sched, mc_y, mc_u, mc_v, imask, qp_map[0], qp_map[1],
            qp_map[2], self.bd, self.sign_hide, self.rdoq, int(init_type),
            self.psy256, self.psy_rdoq, 4 - self.cshift, c16, cb16, eb,
            self.mats, sm, m8j, self.lossless, t4j, nr_y, nr_c,
            self.mats_nxn, self.cshift == 0, self.is422, imask_c)
        out = {"recon_y": yp[:h], "recon_u": up[:hc], "recon_v": vp[:hc],
               "lev_y": lev_y[:self.nby], "lev_u": lev_u[:nbc],
               "lev_v": lev_v[:nbc]}
        if c16 is not None:
            out["modes_sel"] = m_map[:self.nby]
        if nr_stats is not None:
            out["nr_stats"] = nr_stats
        return self.materialize(out) if materialize else out

    def check_batch(self) -> None:
        """The reference's limits on the multi-frame wavefront: 4:2:0,
        8-12 bits, the fixed 16-grid, no NxN, lists or lossless."""
        bad = [name for cond, name in (
            (self.csp != 1, "4:2:2 / 4:4:4"),
            (self.nxn, "--nxn-intra"),
            (self.lossless, "--lossless"),
            (self.mats is not None, "--scaling-list"),
            (not 8 <= self.bd <= 12, "bit depth outside 8-12"))
            if cond]
        if bad:
            raise NotImplementedError("batched all-intra path: "
                                      + ", ".join(bad))

    def _batch_sched(self, f: int) -> dict:
        """The 16-grid schedule repeated for F row-stacked frames: frame
        k's lanes follow frame k - 1's, their block rows offset by
        k * (nby + 1) (each frame keeps its dump block row)."""
        off = torch.arange(f, dtype=torch.int32, device=self.device) \
            * (self.nby + 1)
        sc = self.sched
        rep = lambda a: a.repeat(1, f, *([1] * (a.dim() - 2)))
        by = (sc["by"][:, None, :] + off[None, :, None]).reshape(
            sc["by"].shape[0], -1)
        return {"bx": rep(sc["bx"]), "by": by, "avy": rep(sc["avy"]),
                "avc": rep(sc["avc"])}

    def run_batch(self, ys, us, vs, modes, qp=32, materialize: bool = True):
        """Intra-reconstruct F frames in one lockstep pass of the 16-grid
        wavefront (the schedule and QPs shared).  ys/us/vs: (F, h, w)
        source stacks; modes: (F, nby, nbx) int32 (numpy or a device
        tensor).  Returns per-frame result dicts (the keys of run()), or
        with materialize=False the device stacks (F, ...) with their dump
        rows."""
        self.check_batch()
        nl, nc = self.nl, self.nc
        w, h = self.sps.width, self.sps.height
        wc, hc = w >> self.cshift, h >> self.cshift
        dev = self.device
        src = lambda a: (a if isinstance(a, torch.Tensor) else
                         torch.from_numpy(np.ascontiguousarray(a))) \
            .to(device=dev, dtype=I32)
        oy, ou, ov = src(ys), src(us), src(vs)
        f = oy.shape[0]
        pad = lambda a, k: torch.nn.functional.pad(a, (0, 0, 0, k))
        oy = pad(oy, nl).reshape(-1, w)
        ou = pad(ou, nc).reshape(-1, wc)
        ov = pad(ov, nc).reshape(-1, wc)
        z = lambda *s: torch.zeros(s, dtype=I32, device=dev)
        yp, up, vp = z(f * (h + nl), w), z(f * (hc + nc), wc), \
            z(f * (hc + nc), wc)
        lev_y = z(f * (self.nby + 1), self.nbx, nl, nl)
        lev_u = z(f * (self.nby + 1), self.nbx, nc, nc)
        lev_v = z(f * (self.nby + 1), self.nbx, nc, nc)
        # each frame's modes with its dump block row; _wavefront appends
        # the last frame's
        m = pad(src(modes), 1).reshape(-1, self.nbx)[:-1]
        qmaps = tuple(pad(q, 1).repeat(f, 1) for q in self._qp_maps(qp))
        _wavefront(yp, up, vp, lev_y, lev_u, lev_v, oy, ou, ov, m,
                   self._batch_sched(f), None, None, None, None, *qmaps,
                   self.bd, self.sign_hide, self.rdoq, 2, None,
                   self.psy_rdoq, 4 - self.cshift, None, None, None)
        rd = {"recon_y": yp.reshape(f, h + nl, w),
              "recon_u": up.reshape(f, hc + nc, wc),
              "recon_v": vp.reshape(f, hc + nc, wc),
              "lev_y": lev_y.reshape(f, self.nby + 1, self.nbx, nl, nl),
              "lev_u": lev_u.reshape(f, self.nby + 1, self.nbx, nc, nc),
              "lev_v": lev_v.reshape(f, self.nby + 1, self.nbx, nc, nc)}
        if not materialize:
            return rd
        return self.materialize_batch(self.pack_batch(rd))

    def copy_to_host(self, tensors: dict) -> dict:
        """Start copies of device tensors into pinned host buffers on a
        side stream (the counterpart of the reference's
        copy_to_host_async), so the transfer overlaps the host's other
        work; wait_host() finishes them.  CPU tensors are returned as
        they are."""
        if self.device.type != "cuda":
            return dict(tensors)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        host = {}
        with torch.cuda.stream(side):
            for k, a in tensors.items():
                host[k] = torch.empty(a.shape, dtype=a.dtype,
                                      pin_memory=True)
                host[k].copy_(a, non_blocking=True)
                a.record_stream(side)
            done = torch.cuda.Event()
            done.record(side)
        host["_done"] = done
        return host

    @staticmethod
    def wait_host(host: dict) -> dict:
        """numpy arrays of a copy_to_host() result, once its copies end."""
        if "_done" in host:
            host["_done"].synchronize()
        return {k: v.cpu().numpy() for k, v in host.items() if k != "_done"}

    def pack_batch(self, rd) -> dict:
        """Narrow a batch's recon to the pixel type and its levels to
        int16 on the device, then start their copies to the host
        (copy_to_host)."""
        dt = torch.uint8 if self.bd == 8 else torch.int16
        return self.copy_to_host({
            k: rd[k].to(dt if k.startswith("recon") else torch.int16)
            for k in rd})

    def materialize_batch(self, rd) -> list:
        """Host per-frame dicts (the keys of run()) of a packed
        run_batch(materialize=False) result, waiting for its copies."""
        h, hc, nby = self.sps.height, self.sps.height // 2, self.nby
        dt = np.uint8 if self.bd == 8 else np.uint16
        a = self.wait_host(rd)
        return [{
            "recon_y": a["recon_y"][i, :h].view(dt),
            "recon_u": a["recon_u"][i, :hc].view(dt),
            "recon_v": a["recon_v"][i, :hc].view(dt),
            "lev_y": a["lev_y"][i, :nby],
            "lev_u": a["lev_u"][i, :nby],
            "lev_v": a["lev_v"][i, :nby],
        } for i in range(a["recon_y"].shape[0])]

    def materialize(self, rd: dict) -> dict:
        dt = np.uint8 if self.bd == 8 else np.uint16
        out = {}
        for k in ("recon_y", "recon_u", "recon_v"):
            out[k] = rd[k].cpu().numpy().astype(dt)
        for k in ("lev_y", "lev_u", "lev_v"):
            out[k] = rd[k].cpu().numpy()
        if "modes_sel" in rd:
            out["modes_sel"] = rd["modes_sel"].cpu().numpy()
        if "nr_stats" in rd:
            out["nr_stats"] = tuple(a.cpu().numpy() for a in rd["nr_stats"])
        return out
