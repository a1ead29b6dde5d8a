"""Inter TU32 pre-pass (port of x265_mod_by_patman_tpu/frame/inter_tu32.py):
32x32 same-motion inter regions are residual-coded as ONE luma TU32
(+ TU16 chroma) outside the wavefront, and the wavefront is then forced
to reproduce that reconstruction (TU32 recon spliced into both source
and prediction, so the in-wavefront residual is zero).

It runs only under the variable CU tree (`var_cu_tree`,
Encoder._inter_recon_fn), which the parameters turn off outside 4:2:0,
so its chroma is always the 4:2:0 TU16 of a 32x32 region.

region_uniform_mask is a host numpy function copied unchanged from the
reference (its module imports jax)."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.cost import psy_cost_batch, psy_weight
from ..ops.numeric import fma32, lam2_exp_ref, lam2_ref
from ..ops.rdoq import rdoq_levels, tb_bits_est, tu32_sum_order
from ..ops.transform import (dct_batch, dequant_dyn, idct_batch, quant_dyn,
                             sbh_adjust)
from .recon_intra import skip_costs

F32 = torch.float32
I32 = torch.int32


def _plane_rd(org, pred, qp_b, log2n: int, c_idx: int, bd: int,
              sign_hide: bool, rdoq: bool, init_type: int, psy256,
              psy_rdoq, qmats=None, dmats=None, ebits=None):
    """Residual-code one TB per batch row with the wavefront's machinery
    and the per-plane zero-residual RD test; returns (lev, recon, cost)
    with cost = min(coded, zero) in SSE + lam2*bits units.  qmats/dmats:
    scaling-list quant/raw matrices of this TB size (None: flat).  The
    float32 arithmetic is the reference's compiled jit(_tu32_core): the
    bit estimate summed in tu32_sum_order's order for this batch, the
    lambda lam2_ref, the costs' products contracted (skip_costs; the
    linear bits' nz * 4.5 + 10 is exact either way), the psy weight
    folded (psy_weight(folded=True))."""
    maxval = (1 << bd) - 1
    n = 1 << log2n
    imask = torch.zeros(org.shape[:1], dtype=torch.bool, device=org.device)
    coef = dct_batch(org - pred, log2n, bd)
    if rdoq:
        lev = rdoq_levels(coef, imask, qp_b, log2n, bd, c_idx, init_type,
                          psy_rdoq=psy_rdoq, qmats=qmats, rawmats=dmats,
                          bits_table=ebits)
    else:
        lev = quant_dyn(coef, imask, qp_b, log2n, bd, qmats)
    if sign_hide:
        lev = sbh_adjust(lev, coef, imask, qp_b, log2n, bd)
    deq0 = dequant_dyn(lev, qp_b, log2n, bd, dmats, imask)
    rec0 = torch.clip(pred + idct_batch(deq0, log2n, bd), 0, maxval)
    sse_coded = ((org - rec0) ** 2).sum((1, 2), dtype=I32)
    sse_skip = ((org - pred) ** 2).sum((1, 2), dtype=I32)
    nz = (lev != 0).sum((1, 2), dtype=I32)
    lam2 = lam2_ref(qp_b, bd)
    base_bits = 6.0 if c_idx == 0 else 2.0
    est = tb_bits_est(lev, qp_b, log2n, c_idx, init_type, bits_table=ebits,
                      order=tu32_sum_order(n, lev.shape[0]))
    if c_idx != 0:
        bits = base_bits + est
    else:
        nzf = nz.to(F32)
        lin = torch.where(nzf > 0.0, 10.0, 0.0) + 4.5 * nzf
        bits = base_bits + torch.maximum(lin, est)
    psy = None
    if psy256 is not None and c_idx == 0:
        psy = (psy_weight(lam2, psy256, init_type, qp_b, folded=True),
               psy_cost_batch(org, pred), psy_cost_batch(org, rec0))
    cost_skip, cost_coded = skip_costs(sse_skip, sse_coded, bits, lam2, psy)
    skip = cost_skip <= cost_coded
    lev = torch.where(skip[:, None, None], 0, lev)
    recon = torch.where(skip[:, None, None], torch.clip(pred, 0, maxval),
                        rec0)
    return lev, recon, torch.minimum(cost_skip, cost_coded)


def use32_choice(cost32, c16, qp_y, bd: int):
    """The TU32-vs-quad choice cost32 <= cost16 + lam2 * 3.0 in the
    reference's compiled float32: cost16 the quad's four costs added in
    order, lam2 * 3.0 folded by its compiler into lam2_exp_ref(qp) times
    float32(0.85 * 3) * 4**(bd - 8), that product contracted into the
    add.  c16: (R, 4) quad costs."""
    cost16 = ((c16[:, 0] + c16[:, 1]) + c16[:, 2]) + c16[:, 3]
    three = float(np.float32(0.85) * np.float32(3.0)) * (1 << (2 * (bd - 8)))
    return cost32 <= fma32(lam2_exp_ref(qp_y), three, cost16)


def _tu32_core(oy32, py32, ou16, pu16, ov16, pv16, qp_y, qp_cb, qp_cr,
               init_type: int, psy256, psy_rdoq, bd: int, sign_hide: bool,
               rdoq: bool, mats32=None, ebits=None):
    """(rp,32,32)/(rp,16,16) region stacks, padded to rp regions as the
    reference pads them -> TU32 coding + use32 RD pick.  mats32: (qm_y,
    dm_y, qm_c, dm_c) scaling-list tables of the TU32 luma / TU16
    chroma, or None."""
    qm_l, dm_l, qm_c, dm_c = mats32 if mats32 is not None else (None,) * 4
    levy, recy, cost32 = _plane_rd(oy32, py32, qp_y, 5, 0, bd, sign_hide,
                                   rdoq, init_type, psy256, psy_rdoq, qm_l,
                                   dm_l, ebits)

    def quads(a):
        r = a.shape[0]
        return a.reshape(r, 2, 16, 2, 16).permute(0, 1, 3, 2, 4) \
            .reshape(r * 4, 16, 16)
    qp4 = qp_y.repeat_interleave(4)
    _, _, c16 = _plane_rd(quads(oy32), quads(py32), qp4, 4, 0, bd,
                          sign_hide, rdoq, init_type, psy256, psy_rdoq,
                          ebits=ebits)
    use32 = use32_choice(cost32, c16.reshape(-1, 4), qp_y, bd)
    levu, recu, _ = _plane_rd(ou16, pu16, qp_cb, 4, 1, bd, sign_hide, rdoq,
                              init_type, psy256, psy_rdoq, qm_c, dm_c,
                              ebits)
    levv, recv, _ = _plane_rd(ov16, pv16, qp_cr, 4, 2, bd, sign_hide, rdoq,
                              init_type, psy256, psy_rdoq, qm_c, dm_c,
                              ebits)
    nz = lambda a: (a != 0).any(2).any(1)
    return (use32, levy, recy, nz(levy), levu, recu, nz(levu), levv, recv,
            nz(levv))


def region_uniform_mask(inter_mask, mvs, mvs1, dirs, ref_sel,
                        part_map, width: int, height: int,
                        ref_sel1=None):
    """(nry, nrx) bool: 32-regions whose four 16-blocks will merge into
    one 2Nx2N inter CU in build_region (encoder/top.py) — all inter,
    part 2Nx2N, identical canonical motion (_motion_key), fully inside
    the picture."""
    nby, nbx = inter_mask.shape
    nry, nrx = nby // 2, nbx // 2
    if nry == 0 or nrx == 0:
        return np.zeros((max(nry, 1), max(nrx, 1)), bool)[:nry, :nrx]
    c = lambda a: a[:nry * 2, :nrx * 2]
    dirs_m = np.ones((nby, nbx), np.int32) if dirs is None \
        else np.asarray(dirs, np.int32)
    mvs1_m = np.zeros_like(mvs) if mvs1 is None else np.asarray(mvs1)
    rs = np.zeros((nby, nbx), np.int32) if ref_sel is None \
        else np.asarray(ref_sel, np.int32)
    rs1 = np.zeros((nby, nbx), np.int32) if ref_sel1 is None \
        else np.asarray(ref_sel1, np.int32)
    # canonical motion per block (unused list zeroed, like _motion_key)
    l0_on = (dirs_m & 1) > 0
    l1_on = (dirs_m & 2) > 0
    m0 = np.where(l0_on[..., None], np.asarray(mvs), 0)
    r0 = np.where(l0_on, rs, -1)
    m1 = np.where(l1_on[..., None], mvs1_m, 0)
    r1 = np.where(l1_on, rs1, -1)
    fields = [dirs_m, m0[..., 0], m0[..., 1], r0,
              m1[..., 0], m1[..., 1], r1]
    ok = c(np.asarray(inter_mask, bool))
    if part_map is not None:
        ok = ok & (c(np.asarray(part_map)) == 0)
    q = lambda a: c(a).reshape(nry, 2, nrx, 2)
    okq = q(ok).all((1, 3))
    for f in fields:
        fq = q(f)
        okq &= (fq == fq[:, :1, :, :1]).all((1, 3))
    # region fully inside the picture
    xs = (np.arange(nrx) + 1) * 32 <= width
    ys = (np.arange(nry) + 1) * 32 <= height
    return okq & ys[:, None] & xs[None, :]


def prepare_inter_tu32(y, u, v, mc, region_mask, qp_map, recon,
                       init_type: int, ebits=None):
    """Run the TU32 pre-pass for the masked regions.  Returns None when
    no region qualifies, else a dict of per-region stores plus the
    spliced (y2, u2, v2, mc2) inputs for the wavefront (mc2 as device
    tensors)."""
    nry, nrx = region_mask.shape
    if not region_mask.any():
        return None
    dev = recon.device
    qp_y16, qp_cb16, qp_cr16 = (a.cpu().numpy()
                                for a in recon._qp_maps(qp_map))
    ys, xs = np.nonzero(region_mask)
    R = len(ys)
    oy = np.asarray(y, np.int32)
    ou = np.asarray(u, np.int32)
    ov = np.asarray(v, np.int32)
    mc_y = mc[0].cpu().numpy()
    mc_u = mc[1].cpu().numpy()
    mc_v = mc[2].cpu().numpy()

    def blocks2x2(src_blocks, n):
        out = np.empty((R, 2 * n, 2 * n), np.int32)
        for i, (ry, rx) in enumerate(zip(ys, xs)):
            b = src_blocks[2 * ry:2 * ry + 2, 2 * rx:2 * rx + 2]
            out[i] = np.block([[b[0, 0], b[0, 1]], [b[1, 0], b[1, 1]]])
        return out

    def region(pl, n):
        out = np.empty((R, n, n), np.int32)
        for i, (ry, rx) in enumerate(zip(ys, xs)):
            out[i] = pl[n * ry:n * ry + n, n * rx:n * rx + n]
        return out
    # the reference pads the region batch to rp = 8, 16, 32, ... regions
    # (zero planes at QP 32); its float32 sums' order depends on rp
    rp = 1 << max(3, (R - 1).bit_length())

    def t(a, fill=0):
        a = np.concatenate([a, np.full((rp - R,) + a.shape[1:], fill,
                                       np.int32)])
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    qps = [t(q[2 * ys, 2 * xs].astype(np.int32), 32)
           for q in (qp_y16, qp_cb16, qp_cr16)]
    out = _tu32_core(
        t(region(oy, 32)), t(blocks2x2(mc_y, 16)), t(region(ou, 16)),
        t(blocks2x2(mc_u, 8)), t(region(ov, 16)), t(blocks2x2(mc_v, 8)),
        *qps, int(init_type), recon.psy256, recon.psy_rdoq, recon.bd,
        recon.sign_hide, recon.rdoq, recon.mats32,
        None if ebits is None else
        torch.from_numpy(np.asarray(ebits, np.float32)).to(dev))
    (use32, levy, recy, nzy, levu, recu, nzu, levv, recv,
     nzv) = (a[:R].cpu().numpy() for a in out)
    if not use32.any():
        return None
    st = {
        "use": np.zeros((nry, nrx), bool),
        "levy": {}, "levu": {}, "levv": {},
        "nzy": np.zeros((nry, nrx), bool),
        "nzu": np.zeros((nry, nrx), bool),
        "nzv": np.zeros((nry, nrx), bool),
    }
    y2 = oy.copy()
    u2 = ou.copy()
    v2 = ov.copy()
    mc_y2 = mc_y.copy()
    mc_u2 = mc_u.copy()
    mc_v2 = mc_v.copy()
    dt = np.uint8 if recon.bd == 8 else np.uint16
    for i, (ry, rx) in enumerate(zip(ys, xs)):
        if not use32[i]:
            continue
        st["use"][ry, rx] = True
        st["nzy"][ry, rx] = bool(nzy[i])
        st["nzu"][ry, rx] = bool(nzu[i])
        st["nzv"][ry, rx] = bool(nzv[i])
        if nzy[i]:
            st["levy"][(ry, rx)] = levy[i]
        if nzu[i]:
            st["levu"][(ry, rx)] = levu[i]
        if nzv[i]:
            st["levv"][(ry, rx)] = levv[i]
        y2[32 * ry:32 * ry + 32, 32 * rx:32 * rx + 32] = recy[i]
        u2[16 * ry:16 * ry + 16, 16 * rx:16 * rx + 16] = recu[i]
        v2[16 * ry:16 * ry + 16, 16 * rx:16 * rx + 16] = recv[i]
        for (zy, zx) in ((0, 0), (0, 1), (1, 0), (1, 1)):
            mc_y2[2 * ry + zy, 2 * rx + zx] = \
                recy[i][16 * zy:16 * zy + 16, 16 * zx:16 * zx + 16]
            mc_u2[2 * ry + zy, 2 * rx + zx] = \
                recu[i][8 * zy:8 * zy + 8, 8 * zx:8 * zx + 8]
            mc_v2[2 * ry + zy, 2 * rx + zx] = \
                recv[i][8 * zy:8 * zy + 8, 8 * zx:8 * zx + 8]
    dv = lambda a: torch.from_numpy(a).to(dev)
    st["spliced"] = (y2.astype(dt), u2.astype(dt), v2.astype(dt),
                     (dv(mc_y2), dv(mc_u2), dv(mc_v2)))
    return st
