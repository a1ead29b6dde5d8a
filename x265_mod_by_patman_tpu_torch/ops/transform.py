"""Forward/inverse transforms and (de)quantization, batched over a leading
blocks axis (port of x265_mod_by_patman_tpu/ops/transform.py).

Integer math stays int32 as in the reference; the transform matmuls go
through ops.numeric.ieinsum (exact on every backend).  QP is a runtime
tensor (scalar or per-block).  The numpy goldens at the end of the
module (the validation decoder's) are copied unchanged from the
reference."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants.hevc_tables import (
    DST4, QUANT_SCALES, INV_QUANT_SCALES, dct_matrix)
from .numeric import ieinsum

MAX_TR_DYNAMIC_RANGE = 15
QUANT_SHIFT = 14
IQUANT_SHIFT = 20

I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _const(key, device):
    """Cached device copy of a constant table."""
    kind, arg = key
    if kind == "tmat":
        log2n, dst = arg
        a = (DST4 if dst else dct_matrix(log2n)).astype(np.int32)
    elif kind == "qs":
        a = QUANT_SCALES.astype(np.int32)
    elif kind == "iqs":
        a = INV_QUANT_SCALES.astype(np.int32)
    elif kind == "diag":
        a = _diag_scan_idx(arg).astype(np.int64)
    elif kind == "scans3":
        from ..constants.hevc_tables import (
            scan_raster_index, SCAN_DIAG, SCAN_HOR, SCAN_VER)
        a = np.stack([np.ascontiguousarray(scan_raster_index(arg, si))
                      for si in (SCAN_DIAG, SCAN_HOR, SCAN_VER)]) \
            .astype(np.int64)
    else:
        raise KeyError(kind)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def const(kind, arg, device):
    return _const((kind, arg), torch.device(device))


def _jr(x, shift: int):
    return (x + (1 << (shift - 1))) >> shift


def dct_batch(resi, log2n: int, bit_depth: int = 8, dst: bool = False):
    """(B, N, N) int residual -> (B, N, N) int32 coefficients."""
    t = const("tmat", (log2n, dst), resi.device)
    s1 = log2n - 9 + bit_depth
    s2 = log2n + 6
    src = resi.to(I32)
    tmp = _jr(ieinsum("ki,bji->bkj", t, src), s1)
    return _jr(ieinsum("ki,bji->bkj", t, tmp), s2)


def idct_batch(coef, log2n: int, bit_depth: int = 8, dst: bool = False):
    t = const("tmat", (log2n, dst), coef.device)
    s2 = 20 - bit_depth
    c = coef.to(I32)
    tmp = torch.clip(_jr(ieinsum("ik,bij->bjk", t, c), 7), -32768, 32767)
    return torch.clip(_jr(ieinsum("ik,bij->bjk", t, tmp), s2),
                      -32768, 32767)


def _qp_vec(qp, b: int, device):
    qp = torch.as_tensor(qp, dtype=I32, device=device)
    if qp.dim() == 0:
        qp = qp.expand(b)
    return qp


def quant_batch(coef, qp: int, log2_size: int, bit_depth: int = 8,
                is_intra: bool = True):
    per, rem = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = QUANT_SHIFT + per + transform_shift
    add = (171 if is_intra else 85) << (qbits - 9)
    scale = int(QUANT_SCALES[rem])
    c = coef.to(I32)
    level = torch.clip((torch.abs(c) * scale + add) >> qbits, 0, 32767)
    return (torch.sign(c) * level).to(I32)


def quant_batch_mask(coef, intra_mask, qp: int, log2_size: int,
                     bit_depth: int = 8):
    per, rem = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = QUANT_SHIFT + per + transform_shift
    add = torch.where(intra_mask, 171, 85).to(I32) << (qbits - 9)
    scale = int(QUANT_SCALES[rem])
    c = coef.to(I32)
    level = torch.clip((torch.abs(c) * scale + add[:, None, None]) >> qbits,
                       0, 32767)
    return (torch.sign(c) * level).to(I32)


def quant_mats(log2_size: int):
    """(2, 6, n, n) int32 forward-quant coefficient tables for the spec
    DEFAULT scaling lists, [intra/inter][qp%6] (host numpy, copied from
    the reference)."""
    from ..constants.scaling import default_matrix
    out = np.zeros((2, 6, 1 << log2_size, 1 << log2_size), np.int32)
    for ii, intra in enumerate((True, False)):
        m = default_matrix(log2_size, intra).astype(np.float64)
        for r in range(6):
            out[ii, r] = np.round(QUANT_SCALES[r] * 16.0 / m)
    return out


def _mat_sel(intra_mask, b: int, device):
    """(B,) row of a [intra, inter] matrix stack per block."""
    if intra_mask is None:
        return torch.zeros(b, dtype=torch.long, device=device)
    return torch.where(intra_mask, 0, 1).long()


def quant_dyn(coef, intra_mask, qp, log2_size: int, bit_depth: int = 8,
              mats=None):
    """Quantization with a runtime qp (scalar or (B,)) and per-block
    intra/inter rounding; mats: optional (2, 6, n, n) int32 scaling-list
    quant tables (quant_mats)."""
    dev = coef.device
    qp = _qp_vec(qp, coef.shape[0], dev)
    per, rem = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = (QUANT_SHIFT + per + transform_shift)[:, None, None]
    add = (torch.where(intra_mask, 171, 85).to(I32)[:, None, None]
           << (qbits - 9))
    if mats is None:
        scale = const("qs", None, dev)[rem.long()][:, None, None]
    else:
        scale = mats[_mat_sel(intra_mask, coef.shape[0], dev), rem.long()]
    c = coef.to(I32)
    level = torch.clip((torch.abs(c) * scale + add) >> qbits, 0, 32767)
    return (torch.sign(c) * level).to(I32)


@functools.lru_cache(maxsize=None)
def _diag_scan_idx(log2_size: int):
    from ..constants.hevc_tables import (
        scan_raster_index, SCAN_DIAG)
    return np.ascontiguousarray(scan_raster_index(log2_size, SCAN_DIAG))


def sbh_adjust(lev, coef, intra_mask, qp, log2_size: int,
               bit_depth: int = 8, scan_sel=None):
    """Sign-bit-hiding quantizer adjustment (see the reference's
    sbh_adjust for the rule)."""
    dev = lev.device
    qp = _qp_vec(qp, lev.shape[0], dev)
    per, rem = qp // 6, qp % 6
    tshift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = (QUANT_SHIFT + per + tshift)[:, None, None]
    scale = const("qs", None, dev)[rem.long()][:, None, None]

    n = 1 << log2_size
    b = lev.shape[0]
    lev_f = lev.reshape(b, n * n)
    coef_f = coef.reshape(b, n * n)
    if scan_sel is None:
        scan = const("diag", log2_size, dev)
        lev_s = lev_f[:, scan]
        coef_s = coef_f[:, scan]
    else:
        scans3 = const("scans3", log2_size, dev)
        scan = scans3[torch.clip(scan_sel, 0, 2).long()]
        lev_s = torch.gather(lev_f, 1, scan)
        coef_s = torch.gather(coef_f, 1, scan)
    ncg = (n * n) // 16
    lev_cg = lev_s.reshape(b, ncg, 16)
    coef_cg = coef_s.reshape(b, ncg, 16)

    sig = lev_cg != 0
    pos = torch.arange(16, device=dev, dtype=I32)
    first = torch.where(sig, pos, 99).amin(-1)
    last = torch.where(sig, pos, -1).amax(-1)
    hide = (last - first) >= 4
    absl = torch.abs(lev_cg)
    parity = absl.sum(-1, dtype=I32) & 1
    first_lev = torch.gather(lev_cg, -1,
                             torch.clamp(first, max=15)[..., None].long())[..., 0]
    want = (first_lev < 0).to(I32)
    mismatch = hide & (parity != want)

    delta_u = torch.abs(coef_cg) * scale - (absl << qbits)
    half = torch.ones_like(qbits) << (qbits - 1)
    up_bias = half >> 1
    prefer_up = delta_u >= half + up_bias
    can_down = absl >= 2
    go_up = prefer_up | ~can_down
    cost = torch.where(go_up, (torch.ones_like(qbits) << qbits) - delta_u
                       + up_bias, delta_u)
    in_win = (pos[None, None] >= first[..., None]) & \
        (pos[None, None] <= last[..., None]) & sig
    cost = torch.where(in_win, cost, 1 << 30)
    pick = torch.argmin(cost, dim=-1)
    onehot = (pos[None, None] == pick[..., None]) & \
        mismatch[..., None] & in_win
    step = torch.where(go_up, 1, -1).to(I32)
    new_abs = absl + torch.where(onehot, step, 0)
    out_cg = torch.where(lev_cg < 0, -new_abs, new_abs)

    out_s = out_cg.reshape(b, n * n)
    out_f = torch.zeros_like(out_s)
    if scan_sel is None:
        out_f[:, scan] = out_s
    else:
        out_f.scatter_(1, scan, out_s)
    return out_f.reshape(b, n, n)


def dequant_dyn(level, qp, log2_size: int, bit_depth: int = 8, dmats=None,
                intra_mask=None):
    """dmats: optional (2, n, n) int32 [intra, inter] raw scaling
    matrices (spec 8.6.3 per-coefficient dequant; the flat path folds
    m = 16 into a 4-bit smaller shift)."""
    dev = level.device
    qp = _qp_vec(qp, level.shape[0], dev)
    per, rem = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    shift = IQUANT_SHIFT - QUANT_SHIFT - transform_shift
    lv = level.to(I32)
    if dmats is None:
        scale = (const("iqs", None, dev)[rem.long()] << per)[:, None, None]
        coef = (lv * scale + (1 << (shift - 1))) >> shift
    else:
        m = dmats[_mat_sel(intra_mask, lv.shape[0], dev)]
        base = const("iqs", None, dev)[rem.long()][:, None, None]
        scale = (m * base) << per[:, None, None]
        coef = (lv * scale + (1 << (shift + 3))) >> (shift + 4)
    return torch.clip(coef, -32768, 32767).to(I32)


# ---------------------------------------------------------------------------
# Golden scalar (numpy) functions of the validation decoder
# (decoder/decoder.py), copied unchanged from the reference module
# ---------------------------------------------------------------------------

def _rshift_round(x: np.ndarray, shift: int) -> np.ndarray:
    return (x + (1 << (shift - 1))) >> shift


def idct_ref(coef: np.ndarray, bit_depth: int = 8, dst: bool = False) -> np.ndarray:
    """Inverse core transform -> int16 residual (clipped per spec)."""
    n = coef.shape[0]
    log2n = n.bit_length() - 1
    t = (DST4 if dst else dct_matrix(log2n)).astype(np.int64)
    s1 = 7
    s2 = 20 - bit_depth
    tmp = np.clip(_rshift_round((t.T @ coef.astype(np.int64)).T, s1),
                  -32768, 32767)
    out = np.clip(_rshift_round((t.T @ tmp).T, s2), -32768, 32767)
    return out.astype(np.int16)


def dequant_ref(level: np.ndarray, qp: int, log2_size: int,
                bit_depth: int = 8, mat=None) -> np.ndarray:
    """Flat-list dequant (x265 dequant_normal_c); with mat: spec 8.6.3
    scaling-list dequant (x265 dequant_scaling_c)."""
    per, rem = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    shift = IQUANT_SHIFT - QUANT_SHIFT - transform_shift
    lv = level.astype(np.int64)
    if mat is None:
        scale = int(INV_QUANT_SCALES[rem]) << per
        coef = (lv * scale + (1 << (shift - 1))) >> shift
    else:
        scale = (mat.astype(np.int64) * int(INV_QUANT_SCALES[rem])) << per
        coef = (lv * scale + (1 << (shift + 3))) >> (shift + 4)
    return np.clip(coef, -32768, 32767).astype(np.int16)
