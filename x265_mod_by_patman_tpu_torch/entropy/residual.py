"""residual_coding syntax (spec 7.3.8.11) — bin-IR writer + CABAC parser.

Analog of the reference's Entropy::codeCoeffNxN hot path (x265
source/encoder/entropy.cpp:2231) and its decoder mirror; restructured as a
pure function coefficients -> bin IR so it can later be vectorized over
TUs.  The parser half drives the conformance-validation decoder.
"""
from __future__ import annotations

import numpy as np

from ..constants.hevc_tables import (
    scan_order, cg_scan_order, SCAN_DIAG, SCAN_VER,
)
from .contexts import OFF
from .binir import BinIR
from .cabac import CabacDecoder

# sig_coeff_flag ctxIdxMap for 4x4 TBs (spec 9.3.4.2.5)
_CTX_IDX_MAP_4x4 = np.array(
    [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8], dtype=np.int32)

C1FLAG_NUMBER = 8      # max greater1 flags per CG
C2FLAG_NUMBER = 1      # max greater2 flags per CG
SBH_THRESHOLD = 4      # sign-hide span threshold (last-first > 3)


def _last_ctx_params(log2_tb: int, c_idx: int):
    """(ctx_offset, ctx_shift) for last_sig_coeff_{x,y}_prefix
    (spec 9.3.4.2.3)."""
    if c_idx == 0:
        return 3 * (log2_tb - 2) + ((log2_tb - 1) >> 2), (log2_tb + 1) >> 2
    return 15, log2_tb - 2


def _write_last_prefix(ir: BinIR, pos: int, log2_tb: int, c_idx: int,
                       base_ctx: int) -> None:
    """Truncated-unary prefix of a last-position component."""
    group_idx = _group_idx(pos)
    ctx_offset, ctx_shift = _last_ctx_params(log2_tb, c_idx)
    cmax = (log2_tb << 1) - 1
    for b in range(group_idx):
        ir.cbin(1, base_ctx + ctx_offset + (b >> ctx_shift))
    if group_idx < cmax:
        ir.cbin(0, base_ctx + ctx_offset + (group_idx >> ctx_shift))


# group index table: position -> TR prefix value (spec Table 9-48 g_groupIdx)
def _group_idx(pos: int) -> int:
    if pos < 4:
        return pos
    k = pos.bit_length() - 1  # floor(log2 pos)
    return 2 * k + ((pos >> (k - 1)) & 1)


def _min_in_group(gidx: int) -> int:
    if gidx < 4:
        return gidx
    return (2 + (gidx & 1)) << ((gidx >> 1) - 1)


_NATIVE = None
_NATIVE_BUFS = None
_SCAN_CACHE_C: dict = {}
_OFF_ARR = None


def _native_setup():
    global _NATIVE, _NATIVE_BUFS, _OFF_ARR
    if _NATIVE is None:
        from ..native import native_entropy
        nat = native_entropy()
        _NATIVE = nat if nat.available else False
        if _NATIVE:
            _NATIVE_BUFS = (np.empty(1 << 16, np.uint8),
                            np.empty(1 << 16, np.int32))
            _OFF_ARR = np.array(
                [OFF["SIG_CG"], OFF["SIG"], OFF["LAST_X"], OFF["LAST_Y"],
                 OFF["ONE"], OFF["ABS"]], dtype=np.int32)
    return _NATIVE


def _scan_arrays(log2_tb: int, scan_idx: int):
    key = (log2_tb, scan_idx)
    if key not in _SCAN_CACHE_C:
        _SCAN_CACHE_C[key] = (
            np.ascontiguousarray(scan_order(log2_tb, scan_idx), np.int32),
            np.ascontiguousarray(cg_scan_order(log2_tb, scan_idx),
                                 np.int32))
    return _SCAN_CACHE_C[key]


_MERGE = None


def _merge_tables():
    """Lazy singleton for the slice-level merge call: (native, scan blob,
    scan offsets, ctx-group offsets).  The blob concatenates scan_xy +
    cg_xy for every (log2_tb, scan_idx); offsets index int32 elements."""
    global _MERGE
    if _MERGE is None:
        nat = _native_setup()
        assert nat, "merge path requires the native library"
        parts = []
        offs = np.full(4 * 6, -1, dtype=np.int32)
        cur = 0
        for log2 in range(2, 6):
            for scan in range(3):
                if log2 > 3 and scan != SCAN_DIAG:
                    continue          # hor/ver scans exist only for 4x4/8x8
                sxy, cgxy = _scan_arrays(log2, scan)
                offs[(log2 - 2) * 6 + scan * 2] = cur
                parts.append(sxy.ravel())
                cur += sxy.size
                offs[(log2 - 2) * 6 + scan * 2 + 1] = cur
                parts.append(cgxy.ravel())
                cur += cgxy.size
        blob = np.ascontiguousarray(np.concatenate(parts), dtype=np.int32)
        _MERGE = (nat, blob, offs, _OFF_ARR)
    return _MERGE


def encode_residual(ir: BinIR, level: np.ndarray, log2_tb: int, c_idx: int,
                    scan_idx: int, sign_hide: bool = False) -> None:
    """Append the residual_coding bins of one TB to `ir`.

    level: (N, N) int array of quantized levels [y][x]; must be nonzero
    somewhere (caller checks cbf).  With the native library the TB is
    DEFERRED — binarized by one merge_residual_ir call per slice/row at
    ir.finalize() (bit-exact parity vs the python golden enforced by
    tests/test_native_entropy.py)."""
    if _native_setup():
        ir.defer_residual(level, log2_tb, c_idx, scan_idx, sign_hide)
        return
    return _encode_residual_py(ir, level, log2_tb, c_idx, scan_idx,
                               sign_hide)


def _encode_residual_py(ir: BinIR, level: np.ndarray, log2_tb: int,
                        c_idx: int, scan_idx: int,
                        sign_hide: bool = False) -> None:
    """Pure-python reference implementation (kept as the golden)."""
    n = 1 << log2_tb
    scan = scan_order(log2_tb, scan_idx)          # (nCoeff, 2) of (x, y)
    sx, sy = scan[:, 0], scan[:, 1]
    lev_scan = level[sy, sx].astype(np.int64)     # levels in scan order
    nz = np.nonzero(lev_scan)[0]
    assert len(nz), "encode_residual on all-zero block"
    last_scan_pos = int(nz[-1])
    last_x, last_y = int(sx[last_scan_pos]), int(sy[last_scan_pos])

    # --- last_sig_coeff_x/y prefix+suffix (swap for vertical scan) --------
    lx, ly = (last_y, last_x) if scan_idx == SCAN_VER else (last_x, last_y)
    _write_last_prefix(ir, lx, log2_tb, c_idx, OFF["LAST_X"])
    _write_last_prefix(ir, ly, log2_tb, c_idx, OFF["LAST_Y"])
    for pos in (lx, ly):
        g = _group_idx(pos)
        if g > 3:
            nbits = (g >> 1) - 1
            ir.bypass_bits(pos - _min_in_group(g), nbits)

    num_cg = 1 << (2 * (log2_tb - 2)) if log2_tb > 2 else 1
    cg_size = 16
    last_cg = last_scan_pos >> 4
    # coded_sub_block_flag values (by CG scan index)
    cg_has = np.zeros(num_cg, dtype=bool)
    for i in range(last_cg + 1):
        cg_has[i] = bool(np.any(lev_scan[i * 16:(i + 1) * 16]))
    # CG (x, y) by CG-scan index: same scan pattern over the CG grid
    cg_xy = cg_scan_order(log2_tb, scan_idx)
    cg_grid = max(1, n >> 2)
    cg_map = np.zeros((cg_grid, cg_grid), dtype=bool)

    c1 = 1  # greater1 context state, carried across CGs for ctxSet bump
    for i in range(last_cg, -1, -1):
        cgx, cgy = int(cg_xy[i, 0]), int(cg_xy[i, 1])
        infer_dc_sig = False
        if i == last_cg or i == 0:
            # coded_sub_block_flag inferred 1: the DC CG is always
            # processed even if all its coefficients are zero
            cg_map[cgy, cgx] = True
        else:
            right = cg_map[cgy, cgx + 1] if cgx + 1 < cg_grid else False
            below = cg_map[cgy + 1, cgx] if cgy + 1 < cg_grid else False
            ctx = OFF["SIG_CG"] + (2 if c_idx else 0) + (1 if (right or below) else 0)
            ir.cbin(1 if cg_has[i] else 0, ctx)
            infer_dc_sig = bool(cg_has[i])
            cg_map[cgy, cgx] = bool(cg_has[i])
            if not cg_has[i]:
                continue

        base = i * cg_size
        in_cg = lev_scan[base:base + cg_size]
        first_pos_in_cg = 0
        last_pos_in_cg = cg_size - 1 if i < last_cg else last_scan_pos - base

        # --- sig_coeff_flag ------------------------------------------------
        sig_coded_one = False
        sig_positions = []   # scan positions (within CG) with sig==1
        for p in range(last_pos_in_cg, -1, -1):
            is_last = (i == last_cg and p == last_pos_in_cg)
            sig = int(in_cg[p] != 0)
            if is_last:
                sig_positions.append(p)
                sig_coded_one = True
                continue
            if p == 0 and infer_dc_sig and not sig_coded_one:
                # inferred significant
                sig_positions.append(p)
                break
            xc = int(sx[base + p])
            yc = int(sy[base + p])
            ctx = _sig_ctx(xc, yc, cgx, cgy, cg_map, cg_grid, log2_tb,
                           c_idx, scan_idx)
            ir.cbin(sig, ctx)
            if sig:
                sig_positions.append(p)
                sig_coded_one = True
        # sig_positions is in reverse scan order (coding order)
        coeffs = np.array([in_cg[p] for p in sig_positions], dtype=np.int64)
        abs_lv = np.abs(coeffs)
        signs = (coeffs < 0).astype(np.int64)
        num_nz = len(coeffs)
        if num_nz == 0:                # empty inferred DC CG: nothing more
            continue

        # --- greater1 / greater2 flags -------------------------------------
        ctx_set = (2 if (i > 0 and c_idx == 0) else 0) + (1 if c1 == 0 else 0)
        c1 = 1
        g1_base = OFF["ONE"] + (16 if c_idx else 0) + 4 * ctx_set
        first_g2_idx = -1
        num_g1 = min(num_nz, C1FLAG_NUMBER)
        for k in range(num_g1):
            flag = int(abs_lv[k] > 1)
            ir.cbin(flag, g1_base + c1)
            if flag:
                c1 = 0
                if first_g2_idx == -1:
                    first_g2_idx = k
            elif 0 < c1 < 3:
                c1 += 1
        if first_g2_idx != -1:
            g2_ctx = OFF["ABS"] + (4 if c_idx else 0) + ctx_set
            ir.cbin(int(abs_lv[first_g2_idx] > 2), g2_ctx)

        # --- signs (with optional hidden sign) -----------------------------
        first_sig_scan = sig_positions[-1]
        last_sig_scan = sig_positions[0]
        hidden = sign_hide and (last_sig_scan - first_sig_scan >= SBH_THRESHOLD)
        # hidden sign = sign of the lowest-scan-pos coeff (coded last),
        # inferred by the decoder from the parity of the CG level sum
        for s in (signs[:-1] if hidden else signs):
            ir.bypass(int(s))

        # --- coeff_abs_level_remaining --------------------------------------
        rice = 0
        for k in range(num_nz):
            base_level = 1
            if k < C1FLAG_NUMBER:
                base_level = 2
                if k == first_g2_idx:
                    base_level = 3
            if abs_lv[k] >= base_level:
                _write_remaining(ir, int(abs_lv[k]) - base_level, rice)
                if abs_lv[k] > (3 << rice):
                    rice = min(rice + 1, 4)


def _sig_ctx(xc: int, yc: int, cgx: int, cgy: int, cg_map: np.ndarray,
             cg_grid: int, log2_tb: int, c_idx: int, scan_idx: int) -> int:
    """sig_coeff_flag ctxIdx (spec 9.3.4.2.5)."""
    base = OFF["SIG"] + (27 if c_idx else 0)
    if log2_tb == 2:
        return base + int(_CTX_IDX_MAP_4x4[(yc << 2) + xc])
    if xc == 0 and yc == 0:
        return base + 0
    right = bool(cg_map[cgy, cgx + 1]) if cgx + 1 < cg_grid else False
    below = bool(cg_map[cgy + 1, cgx]) if cgy + 1 < cg_grid else False
    prev_csbf = (1 if right else 0) | (2 if below else 0)
    xp, yp = xc & 3, yc & 3
    if prev_csbf == 0:
        s = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
    elif prev_csbf == 1:
        s = 2 if yp == 0 else (1 if yp == 1 else 0)
    elif prev_csbf == 2:
        s = 2 if xp == 0 else (1 if xp == 1 else 0)
    else:
        s = 2
    if c_idx == 0 and (cgx or cgy):
        s += 3
    if log2_tb == 3:
        s += (9 if scan_idx == SCAN_DIAG else 15) if c_idx == 0 else 9
    else:
        s += 21 if c_idx == 0 else 12
    return base + s


def _write_remaining(ir: BinIR, value: int, rice: int) -> None:
    """coeff_abs_level_remaining binarization (spec 9.3.3.10; x265
    writeCoefRemainExGolomb)."""
    if value < (3 << rice):
        length = value >> rice
        for _ in range(length):
            ir.bypass(1)
        ir.bypass(0)
        ir.bypass_bits(value & ((1 << rice) - 1), rice)
    else:
        length = rice
        value -= 3 << rice
        while value >= (1 << length):
            value -= 1 << length
            length += 1
        nb = 3 + length + 1 - rice
        ir.bypass_bits((1 << nb) - 2, nb)
        ir.bypass_bits(value, length)


# ---------------------------------------------------------------------------
# Decoder side (conformance validation)
# ---------------------------------------------------------------------------

def _read_last_prefix(dec: CabacDecoder, states, log2_tb: int, c_idx: int,
                      base_ctx: int) -> int:
    ctx_offset, ctx_shift = _last_ctx_params(log2_tb, c_idx)
    cmax = (log2_tb << 1) - 1
    g = 0
    while g < cmax and dec.decode_bin(states, base_ctx + ctx_offset + (g >> ctx_shift)):
        g += 1
    return g


def decode_residual(dec: CabacDecoder, states: np.ndarray, log2_tb: int,
                    c_idx: int, scan_idx: int,
                    sign_hide: bool = False) -> np.ndarray:
    """Parse residual_coding, returning the (N, N) level array."""
    n = 1 << log2_tb
    scan = scan_order(log2_tb, scan_idx)
    sx, sy = scan[:, 0], scan[:, 1]
    level = np.zeros((n, n), dtype=np.int32)

    gx = _read_last_prefix(dec, states, log2_tb, c_idx, OFF["LAST_X"])
    gy = _read_last_prefix(dec, states, log2_tb, c_idx, OFF["LAST_Y"])
    pos = []
    for g in (gx, gy):
        if g > 3:
            nbits = (g >> 1) - 1
            suffix = dec.decode_bins_ep(nbits)
            pos.append(_min_in_group(g) + suffix)
        else:
            pos.append(g)
    lx, ly = pos
    if scan_idx == SCAN_VER:
        lx, ly = ly, lx
    # find last scan position
    pos_of = {(int(sx[i]), int(sy[i])): i for i in range(n * n)}
    last_scan_pos = pos_of[(lx, ly)]

    last_cg = last_scan_pos >> 4
    cg_xy = cg_scan_order(log2_tb, scan_idx)
    cg_grid = max(1, n >> 2)
    cg_map = np.zeros((cg_grid, cg_grid), dtype=bool)

    c1 = 1
    for i in range(last_cg, -1, -1):
        cgx, cgy = int(cg_xy[i, 0]), int(cg_xy[i, 1])
        infer_dc_sig = False
        if i == last_cg or i == 0:
            cg_flag = True
        else:
            right = cg_map[cgy, cgx + 1] if cgx + 1 < cg_grid else False
            below = cg_map[cgy + 1, cgx] if cgy + 1 < cg_grid else False
            ctx = OFF["SIG_CG"] + (2 if c_idx else 0) + (1 if (right or below) else 0)
            cg_flag = bool(dec.decode_bin(states, ctx))
            infer_dc_sig = cg_flag
        cg_map[cgy, cgx] = cg_flag
        if not cg_flag:
            continue

        base = i * 16
        last_pos_in_cg = 15 if i < last_cg else last_scan_pos - base
        sig_positions = []
        sig_coded_one = False
        for p in range(last_pos_in_cg, -1, -1):
            if i == last_cg and p == last_pos_in_cg:
                sig_positions.append(p)
                sig_coded_one = True
                continue
            if p == 0 and infer_dc_sig and not sig_coded_one:
                sig_positions.append(p)
                break
            xc, yc = int(sx[base + p]), int(sy[base + p])
            ctx = _sig_ctx(xc, yc, cgx, cgy, cg_map, cg_grid, log2_tb,
                           c_idx, scan_idx)
            if dec.decode_bin(states, ctx):
                sig_positions.append(p)
                sig_coded_one = True

        num_nz = len(sig_positions)
        if num_nz == 0:                # empty inferred DC CG
            continue
        ctx_set = (2 if (i > 0 and c_idx == 0) else 0) + (1 if c1 == 0 else 0)
        c1 = 1
        g1_base = OFF["ONE"] + (16 if c_idx else 0) + 4 * ctx_set
        abs_lv = np.ones(num_nz, dtype=np.int64)
        first_g2_idx = -1
        num_g1 = min(num_nz, C1FLAG_NUMBER)
        for k in range(num_g1):
            flag = dec.decode_bin(states, g1_base + c1)
            if flag:
                abs_lv[k] = 2
                c1 = 0
                if first_g2_idx == -1:
                    first_g2_idx = k
            elif 0 < c1 < 3:
                c1 += 1
        if first_g2_idx != -1:
            g2_ctx = OFF["ABS"] + (4 if c_idx else 0) + ctx_set
            if dec.decode_bin(states, g2_ctx):
                abs_lv[first_g2_idx] = 3

        first_sig_scan = sig_positions[-1]
        last_sig_scan = sig_positions[0]
        hidden = sign_hide and (last_sig_scan - first_sig_scan >= SBH_THRESHOLD)
        n_signs = num_nz - 1 if hidden else num_nz
        sign_bits = dec.decode_bins_ep(n_signs) if n_signs else 0
        signs = [(sign_bits >> (n_signs - 1 - k)) & 1 for k in range(n_signs)]

        rice = 0
        for k in range(num_nz):
            base_level = 1
            if k < C1FLAG_NUMBER:
                base_level = 2
                if k == first_g2_idx:
                    base_level = 3
            # remaining present iff the coded flags saturated exactly at
            # base_level (abs_lv holds the flags-implied value here)
            if abs_lv[k] == base_level:
                abs_lv[k] = base_level + _read_remaining(dec, rice)
                if abs_lv[k] > (3 << rice):
                    rice = min(rice + 1, 4)
        if hidden:
            total = int(abs_lv.sum())
            signs.append(total & 1)

        for k, p in enumerate(sig_positions):
            v = int(abs_lv[k])
            if signs[k]:
                v = -v
            xc, yc = int(sx[base + p]), int(sy[base + p])
            level[yc, xc] = v
    return level


def _read_remaining(dec: CabacDecoder, rice: int) -> int:
    prefix = 0
    while prefix < 32 and dec.decode_bin_ep():
        prefix += 1
    if prefix < 3:
        suffix = dec.decode_bins_ep(rice) if rice else 0
        return (prefix << rice) + suffix
    length = prefix - 3 + rice
    suffix = dec.decode_bins_ep(length) if length else 0
    return (3 << rice) + ((1 << (prefix - 3)) - 1 << rice) + suffix
