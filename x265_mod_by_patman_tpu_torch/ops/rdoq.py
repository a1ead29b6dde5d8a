"""Batched rate-distortion optimized quantization and the TB rate estimate
(port of x265_mod_by_patman_tpu/ops/rdoq.py; same static/EstBits bit
models, float32 "level units" working domain)."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants.hevc_tables import scan_order
from ..entropy.est_bits import (
    BITS_TABLE, residual_ctx_scalars, sig_ctx_map)
from .numeric import (csum, exp2_ref, floor_log2_ref, fma32, fsqrt, fsum,
                      lsum, osum)
from .transform import (MAX_TR_DYNAMIC_RANGE, QUANT_SHIFT, _mat_sel, _qp_vec,
                        const)

F32 = torch.float32
I32 = torch.int32

_SIG0, _SIG1 = 0.55, 1.45
_GT1_0, _GT1_1 = 0.6, 1.5
_GT2_0, _GT2_1 = 0.7, 1.4
_SIGN = 1.0
_CG_FLAG = 1.0
K_INTRA = 0.06
K_INTER = 0.12


def _floor_log2(x):
    """floor(log2(x)) of integer-valued float32 x >= 1, exactly."""
    return (torch.frexp(x)[1] - 1).to(F32)


def _level_bits(lv):
    lv = lv.to(F32)
    rem = torch.clamp(lv - 3.0, min=0.0)
    rem_bits = 2.0 * _floor_log2(rem + 1.0) + 1.0
    return torch.where(
        lv == 0, _SIG0,
        _SIG1 + _SIGN + torch.where(
            lv == 1, _GT1_0,
            _GT1_1 + torch.where(lv == 2, _GT2_0, _GT2_1 + rem_bits)))


def _rem_bits(v):
    """coeff_abs_level_remaining length at rice 0 for v = lv - 3 >= 0."""
    return torch.where(v < 3.0, v + 1.0,
                       4.0 + 2.0 * _floor_log2(torch.clamp(v - 2.0,
                                                           min=1.0)))


def _rem_bits_ref(v):
    """_rem_bits with the floor the reference's compiled programs take
    (the wavefront's and the TU32 pre-pass's TB bit estimates, RDOQ's
    level bits): floor_log2_ref, one less than the exact floor at 8192
    (v = 8194)."""
    return torch.where(v < 3.0, v + 1.0,
                       4.0 + 2.0 * floor_log2_ref(torch.clamp(v - 2.0,
                                                              min=1.0)))


def wavefront_sum_order(n: int, lanes: int):
    """(lanes, span) of the chained lane order (numeric.chain_sum_plain)
    in which the reference's compiled wavefront sums an n x n TB's bit
    estimate when its steps hold `lanes` blocks: its CPU backend
    vectorises the sum by rows, 16 or 8 wide at n = 16 and 8 or 4 wide
    at n = 8, as the lane count of the step decides.  Read from the
    object code of jit(_wavefront_body) (4:2:0, 8, 10 and 12 bits) at
    1, 2, 3, 4, 5, 7, 8, 9, 10, 12, 15, 20 and 30 lanes (frame widths 96
    to 3840); 16 lanes a row sum as 8 lanes of two terms each."""
    if n == 8:
        return (8, 8) if lanes == 1 else (4, 8)
    if n == 16:
        return (8, 8) if 2 <= lanes <= 8 else (8, 16)
    raise ValueError(f"wavefront_sum_order: no read order for n = {n}")


def tu32_sum_order(n: int, blocks: int):
    """(lanes, span) of the chained lane order in which the reference's
    compiled inter TU32 pre-pass (jit(_tu32_core)) sums the bit estimate
    of its `blocks` n x n TBs: the TU32 luma (n = 32) and the chroma
    TU16s (n = 16) at the padded region count rp, the quad luma TU16s at
    4 rp.  At rp = 8 its levels lie 8 blocks apart and the CPU backend
    vectorises a row 16 wide at n = 32 (then the row's tail one by one)
    and 4 wide at n = 16 (three strips, then the tail); from 16 blocks
    on a whole row 16 wide (two strips at n = 32).  Read from the LLVM
    IR and object code of jit(_tu32_core) (8 and 10 bits, RDOQ off and
    on) at rp = 8, 16, 32, ..., 2048; 16 lanes of one strip sum as 8
    lanes of two terms each."""
    if n == 32:
        return (8, 16) if blocks <= 8 else (16, 32)
    if n == 16:
        return (4, 12) if blocks <= 8 else (8, 16)
    raise ValueError(f"tu32_sum_order: no read order for n = {n}")


@functools.lru_cache(maxsize=None)
def _dev_tables(log2_size: int, c_idx: int, device):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    n = 1 << log2_size
    g = max(1, n // 4)
    pos = np.stack(np.meshgrid(np.arange(g), np.arange(g), indexing="ij"),
                   -1)
    return {"smap": t(sig_ctx_map(log2_size, c_idx).astype(np.int64)),
            "S": t(_scan_idx_map(log2_size)),
            "sc": t(scan_order(log2_size, 0).astype(np.int64)),
            "pos": t(pos.astype(np.int32)),
            "lut": t(_LAST_BITS_LUT)}


@functools.lru_cache(maxsize=None)
def _bits_table_dev(device):
    return torch.from_numpy(BITS_TABLE).to(device)


def _bt(bits_table, init_type, qp, b: int, device):
    """(B, C, 2) per-lane bit tables."""
    if bits_table is not None:
        bt = torch.as_tensor(bits_table, dtype=F32, device=device)
        if bt.dim() == 3:
            return bt
        return bt[None].expand(b, *bt.shape)
    tbl = _bits_table_dev(device)
    it = torch.as_tensor(init_type, device=device).long()
    return tbl[it, torch.clip(qp, 0, 51).long()]


def rdoq_cost(cs, lv, k, bits, psy_k=None):
    """RDOQ's cost of level lv, (cs - lv)**2 + k * bits, less psy_k * lv
    with psy-RDOQ, as the reference's compiled program rounds it: k *
    bits rounded, the square contracted into the add that takes it, the
    psy product into the subtraction (fma32 twice).  Read from the
    object code of its level and CG-sum fusions in jit(_wavefront_body)
    at 1 and 15 blocks, jit(_tu32_core) at rp = 8 to 2048 and
    jit(_wavefront_tree_body)."""
    d = cs - lv
    c = fma32(d, d, k * bits)
    return c if psy_k is None else fma32(-psy_k, lv, c)


def cg_keep_kill(cbest, cs, k, saving, contract: bool = False):
    """(keep, kill) of RDOQ's per-4x4-group zero-out test of (B, n, n)
    TBs, (B, n/4, n/4) each, as the reference's compiled program sums
    them: a group's four rows each added left to right as 4-lane vectors
    (row r in lane r), the lanes as a tree (lane 0 + lane 2) + (lane 1 +
    lane 3) -- lsum's order at n = 4, K3's lane mode on the card -- with
    kill's squares cs * cs contracted into the row adds; kill = that sum
    less k * saving, the product rounded apart, or with contract (the P/B
    wavefront at 4 blocks a step or more, rdoq_levels) contracted into
    the subtraction.  k, saving: (B,) or a number."""
    b, n = cs.shape[0], cs.shape[-1]
    g = n // 4
    groups = lambda a: a.reshape(b, g, 4, g, 4).permute(0, 1, 3, 2, 4)
    keep = lsum(groups(cbest))
    c = groups(cs).to(torch.float64)
    row = (c[..., 0] * c[..., 0]).to(F32)
    for j in range(1, 4):
        row = (c[..., j] * c[..., j] + row.to(torch.float64)).to(F32)
    sq = (row[..., 0] + row[..., 2]) + (row[..., 1] + row[..., 3])
    kb = torch.as_tensor(k, dtype=F32, device=cs.device)
    sv = torch.as_tensor(saving, dtype=F32, device=cs.device)
    if kb.dim():
        kb = kb[:, None, None]
    if sv.dim():
        sv = sv[:, None, None]
    return keep, fma32(-kb, sv, sq) if contract else sq - kb * sv


def rdoq_candidates(coef, intra_mask, qp, log2_size: int,
                    bit_depth: int = 8, c_idx: int = 0, init_type=None,
                    psy_rdoq=None, qmats=None, rawmats=None,
                    bits_table=None):
    """RDOQ's per-coefficient choice among ceil, floor and zero: (c, cs,
    k, cg_save, level_bits, psy_k, lv, cbest), lv the chosen |level| and
    cbest its cost (rdoq_cost), both (B, n, n) float32."""
    dev = coef.device
    b = coef.shape[0]
    qp = _qp_vec(qp, b, dev)
    per, rem6 = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = (QUANT_SHIFT + per + transform_shift)[:, None, None]
    sel_m = _mat_sel(intra_mask, b, dev)
    if qmats is None:
        scale = const("qs", None, dev)[rem6.long()][:, None, None]
    else:
        # scaling-list-aware RDOQ: the per-coefficient forward scale
        scale = qmats[sel_m, rem6.long()]
    c = coef.to(I32)
    cs = torch.abs(c).to(F32) * scale.to(F32) / exp2_ref(qbits)
    if intra_mask is None:
        k = torch.full((b,), K_INTRA, dtype=F32, device=dev)
    else:
        k = torch.where(intra_mask, K_INTRA, K_INTER).to(F32)
    k = k[:, None, None]
    if rawmats is not None:
        # a level-unit error on a coefficient with scaling m costs
        # (m/16)^2 the distortion of the flat step
        w = rawmats[sel_m].to(F32) / 16.0
        k = k * w * w
    hi = torch.ceil(cs)
    lo = torch.floor(cs)

    if init_type is None:
        level_bits = _level_bits
        cg_save = None
    else:
        tb = _dev_tables(log2_size, c_idx, dev)
        bt = _bt(bits_table, init_type, qp, b, dev)
        sig0 = bt[:, tb["smap"], 0]
        sig1 = bt[:, tb["smap"], 1]
        g1c, g2c, cgc = residual_ctx_scalars(log2_size, c_idx)
        g1_0 = bt[:, g1c, 0][:, None, None]
        g1_1 = bt[:, g1c, 1][:, None, None]
        g2_0 = bt[:, g2c, 0][:, None, None]
        g2_1 = bt[:, g2c, 1][:, None, None]
        cg_save = bt[:, cgc, 1] - bt[:, cgc, 0]

        def level_bits(lv):
            rem = _rem_bits_ref(torch.clamp(lv - 3.0, min=0.0))
            return torch.where(
                lv == 0, sig0,
                sig1 + _SIGN + torch.where(
                    lv == 1, g1_0,
                    g1_1 + torch.where(lv == 2, g2_0, g2_1 + rem)))

    psy_k = None
    if psy_rdoq is not None and c_idx == 0:
        n_ = 1 << log2_size
        nondc = torch.ones((n_, n_), dtype=F32, device=dev)
        nondc[0, 0] = 0.0
        psy_k = (torch.as_tensor(psy_rdoq, dtype=F32, device=dev)
                 * fsqrt(k)) * nondc[None]

    def cost(lv):
        return rdoq_cost(cs, lv, k, level_bits(lv), psy_k)

    zero = torch.zeros_like(cs)
    c_hi, c_lo, c_z = cost(hi), cost(lo), cost(zero)
    lv = torch.where(c_hi < c_lo, hi, lo)
    cbest = torch.minimum(c_hi, c_lo)
    lv = torch.where(c_z <= cbest, zero, lv)
    cbest = torch.minimum(c_z, cbest)

    return c, cs, k, cg_save, level_bits, psy_k, lv, cbest


def rdoq_levels(coef, intra_mask, qp, log2_size: int, bit_depth: int = 8,
                c_idx: int = 0, init_type=None, sign_hide: bool = False,
                psy_rdoq=None, qmats=None, rawmats=None, bits_table=None,
                lanes=None):
    """RD-quantize a batch of TUs; drop-in for quant_dyn.  sign_hide:
    the reference's RDOQ-integrated sign-bit hiding (see below).  lanes:
    the step's block count where the caller is the reference's 4:2:0 P/B
    wavefront, whose program contracts the zero-out test's k * saving
    into kill (cg_keep_kill) from 4 blocks a step on: read from the
    object code of its levels' fusions at every count 1 to 30, where
    every lane rounds alike at 1, 2 (and 3 in chroma) apart and at 4-16,
    20, 24 and 28-30 contracted; at 3 (luma), 17-19, 21-23 and 25-27 its
    vector body contracts and its scalar tail does not (ROADMAP.md §3).
    Elsewhere (the I-picture tree, the TU32 pre-pass, 4:2:2 / 4:4:4)
    kill rounds the product apart."""
    c, cs, k, cg_save, level_bits, psy_k, lv, cbest = rdoq_candidates(
        coef, intra_mask, qp, log2_size, bit_depth, c_idx, init_type,
        psy_rdoq, qmats, rawmats, bits_table)
    dev = coef.device
    n = 1 << log2_size
    if n > 4:
        g = n // 4
        saving = cg_save if init_type is not None else _CG_FLAG
        keep, kill = cg_keep_kill(cbest, cs, k[:, 0, 0], saving,
                                  lanes is not None and lanes >= 4)
        zero_cg = (kill < keep)[:, :, None, :, None]
        lv = torch.where(zero_cg, 0.0, lv.reshape(-1, g, 4, g, 4)) \
            .reshape(-1, n, n)

    if sign_hide:
        # RDOQ-integrated sign-bit hiding: where a CG's level-sum parity
        # mismatches the first coefficient's sign, flip the single level
        # +-1 whose (cs - L)^2 + K*bits delta is smallest (first minimum
        # in scan order), keeping the first/last scan positions
        g = max(1, n // 4)
        diag = const("diag", 2, dev)             # 4x4 diagonal scan
        b = lv.shape[0]

        def tiles(a):
            t = a.reshape(b, g, 4, g, 4).permute(0, 1, 3, 2, 4) \
                .reshape(b, g, g, 16)
            return t[..., diag]                     # scan order per CG

        lv_t = tiles(lv)
        cs_t = tiles(cs)
        sgn_t = tiles(torch.sign(c).to(F32))
        pos = torch.arange(16, device=dev)
        sig = lv_t != 0
        first = torch.where(sig, pos, 99).amin(-1)
        last = torch.where(sig, pos, -1).amax(-1)
        hide = (last - first) >= 4
        parity = lv_t.sum(-1, dtype=torch.int32) & 1
        first_sgn = torch.gather(sgn_t, -1,
                                 torch.clamp(first, max=15)[..., None])[..., 0]
        want = (first_sgn < 0).to(torch.int32)
        mismatch = hide & (parity != want)

        kt = k[:, 0, 0][:, None, None, None]
        if psy_k is not None:
            psy_t = tiles(psy_k.expand(lv.shape))
        else:
            psy_t = torch.tensor(0.0, dtype=F32, device=dev)
        cost_cur = ((cs_t - lv_t) ** 2 + kt * tiles(level_bits(lv))
                    - psy_t * lv_t)
        cost_up = ((cs_t - (lv_t + 1)) ** 2
                   + kt * tiles(level_bits(lv + 1)) - psy_t * (lv_t + 1))
        cost_dn = ((cs_t - (lv_t - 1)) ** 2
                   + kt * tiles(level_bits(torch.clamp(lv - 1, min=0)))
                   - psy_t * torch.clamp(lv_t - 1, min=0))
        in_win = (pos >= first[..., None]) & (pos <= last[..., None])
        edge = (pos == first[..., None]) | (pos == last[..., None])
        big = torch.tensor(1e30, dtype=F32, device=dev)
        du = torch.where(in_win, cost_up - cost_cur, big)
        dd = torch.where(in_win & (lv_t >= 1) & ~(edge & (lv_t == 1)),
                         cost_dn - cost_cur, big)
        step = torch.where(du <= dd, 1.0, -1.0)
        pick = torch.argmin(torch.minimum(du, dd), dim=-1)
        onehot = (pos == pick[..., None]) & mismatch[..., None]
        new_t = lv_t + torch.where(onehot, step, 0.0)
        inv = torch.argsort(diag)                  # scan -> raster
        lv = new_t[..., inv].reshape(b, g, g, 4, 4) \
            .permute(0, 1, 3, 2, 4).reshape(b, n, n)

    lv = torch.clip(lv, 0, 32767).to(I32)
    return torch.sign(c) * lv


@functools.lru_cache(maxsize=None)
def _scan_idx_map(log2_size: int) -> np.ndarray:
    s = scan_order(log2_size, 0)
    n = 1 << log2_size
    m = np.zeros((n, n), np.int32)
    m[s[:, 1], s[:, 0]] = np.arange(s.shape[0], dtype=np.int32)
    return m


_LAST_GROUP_IDX = np.array(
    [0, 1, 2, 3, 4, 4, 5, 5] + [6] * 4 + [7] * 4 + [8] * 8 + [9] * 8,
    np.int32)
_LAST_BITS_LUT = ((_LAST_GROUP_IDX + 1).astype(np.float32) * 0.9
                  + np.maximum(0, (_LAST_GROUP_IDX >> 1) - 1)
                  .astype(np.float32))


def tb_bits_est(lev, qp, log2_size: int, c_idx: int = 0, init_type=None,
                bits_table=None, order=None):
    """Rate estimate (float32 bits, (B,)) of coding each TB's levels;
    0 for all-zero TBs.  order: the (lanes, span) in which the caller's
    program in the reference sums the coefficient bits
    (wavefront_sum_order for the 4:2:0 wavefront, tu32_sum_order for the
    inter TU32 pre-pass): the sums then follow that compiled program
    (the coefficient bits in that chained lane order, the CG flag bits
    row-major) and so does the remaining-level floor (_rem_bits_ref).
    Without it the sums take fsum's pairwise order and the floor is
    exact."""
    dev = lev.device
    b = lev.shape[0]
    qp = _qp_vec(qp, b, dev)
    it = init_type if init_type is not None else 2
    bt = _bt(bits_table, it, qp, b, dev)
    tb = _dev_tables(log2_size, c_idx, dev)
    sig0 = bt[:, tb["smap"], 0]
    sig1 = bt[:, tb["smap"], 1]
    g1c, g2c, cgc = residual_ctx_scalars(log2_size, c_idx)
    g1_0 = bt[:, g1c, 0][:, None, None]
    g1_1 = bt[:, g1c, 1][:, None, None]
    g2_0 = bt[:, g2c, 0][:, None, None]
    g2_1 = bt[:, g2c, 1][:, None, None]

    n = 1 << log2_size
    al = torch.abs(lev).to(F32)
    S = tb["S"]
    nz = al > 0
    any_nz = nz.any(2).any(1)
    last = torch.where(nz, S[None], -1).amax((1, 2))
    region = S[None] <= last[:, None, None]
    if order is None:
        rem = _rem_bits(torch.clamp(al - 3.0, min=0.0))
        coeff_sum = cg_sum = lambda t: fsum(t, (1, 2))
    else:
        rem = _rem_bits_ref(torch.clamp(al - 3.0, min=0.0))
        coeff_sum = lambda t: csum(t, *order)
        cg_sum = lambda t: osum(t, (1, 2))
    lb = torch.where(
        al == 0, sig0,
        sig1 + _SIGN + torch.where(
            al == 1, g1_0,
            g1_1 + torch.where(al == 2, g2_0, g2_1 + rem)))

    sc = tb["sc"]
    lxy = sc[torch.clip(last, 0, n * n - 1).long()]
    if n > 4:
        g = n // 4
        cg_nz = nz.reshape(-1, g, 4, g, 4).any(4).any(2)
        cg_reg = region.reshape(-1, g, 4, g, 4).any(4).any(2)
        cg_nz_b = cg_nz.repeat_interleave(4, 1).repeat_interleave(4, 2)
        pos = tb["pos"]
        dc_cg = (pos[..., 0] == 0) & (pos[..., 1] == 0)
        dc_cg_b = dc_cg[None].repeat_interleave(4, 1) \
            .repeat_interleave(4, 2)
        coeff_bits = coeff_sum(torch.where(region & (cg_nz_b | dc_cg_b), lb,
                                           0.0))
        cg0b = bt[:, cgc, 0][:, None, None]
        cg1b = bt[:, cgc, 1][:, None, None]
        last_cg = ((pos[None, ..., 0] == (lxy[:, 1] >> 2)[:, None, None])
                   & (pos[None, ..., 1] == (lxy[:, 0] >> 2)[:, None, None]))
        cg_mask = cg_reg & ~dc_cg[None] & ~last_cg
        cg_bits = cg_sum(torch.where(cg_mask, torch.where(cg_nz, cg1b, cg0b),
                                     0.0))
    else:
        coeff_bits = coeff_sum(torch.where(region, lb, 0.0))
        cg_bits = 0.0
    bidx = torch.arange(b, device=dev)
    sig1_last = sig1[bidx, torch.clip(lxy[:, 1], 0, n - 1),
                     torch.clip(lxy[:, 0], 0, n - 1)]
    lut = tb["lut"]
    last_bits = lut[torch.clip(lxy[:, 0], 0, 31)] + \
        lut[torch.clip(lxy[:, 1], 0, 31)]
    total = coeff_bits + cg_bits + last_bits - sig1_last + 0.8
    return torch.where(any_nz, total, 0.0)


def tu_rd_levels(coef, qp, log2_size: int, bit_depth: int = 8,
                 k: float = 0.134):
    """Level-units RD estimate sum((cs - round(cs))^2 + K * bits) (B,)."""
    dev = coef.device
    qp = _qp_vec(qp, coef.shape[0], dev)
    per, rem6 = qp // 6, qp % 6
    tshift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = (QUANT_SHIFT + per + tshift)[:, None, None]
    scale = const("qs", None, dev)[rem6.long()][:, None, None]
    cs = torch.abs(coef).to(F32) * scale.to(F32) / exp2_ref(qbits)
    lv = torch.round(cs)
    d = cs - lv
    # the reference's fused loop contracts d * d into the add and sums
    # each block in its 8-lane order (K3's lane mode)
    return lsum(fma32(d, d, k * _level_bits(lv)))
