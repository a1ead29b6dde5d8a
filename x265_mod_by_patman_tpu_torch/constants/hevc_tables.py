"""HEVC (Rec. ITU-T H.265) normative constant tables.

Every table in this module is mandated by the HEVC specification itself —
any conforming encoder/decoder must contain bit-identical values.  Citations
give both the spec clause and the reference encoder location used to
cross-check values (x265: source/common/constants.cpp, source/encoder/
entropy.cpp), per the parity-audit convention of this project.

Where a table has exploitable structure (transform matrices, scan orders,
state machines) we *generate* it from its defining rule instead of embedding
a verbatim dump.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Core transform matrices (spec 8.6.4.2; x265 constants.cpp:270-344 g_t4..g_t32)
#
# The 32-point HEVC core transform matrix T32[k][n] follows the DCT-II
# cosine symmetry T32[k][n] = M[(k*(2n+1)) mod 128] where M is an odd-
# symmetric extension of 32 hand-tuned magnitudes (the spec's integerized
# basis amplitudes).  The 4/8/16-point matrices are row subsamplings:
# T_N[k][n] = T32[k*32/N][n].
# ---------------------------------------------------------------------------

_DCT32_MAGS = np.array([
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4,
], dtype=np.int64)


def _gen_dct32() -> np.ndarray:
    """Generate the 32x32 core transform matrix from cosine symmetry:
    T32[k][n] = lut[(k*(2n+1)) mod 128] with lut the odd-symmetric
    extension of the 32 magnitudes (lut[i] ~ cos(i*pi/64))."""
    mag = np.concatenate([_DCT32_MAGS, [0]])  # mag[32] = cos(pi/2) = 0
    lut = np.zeros(128, dtype=np.int64)
    for i in range(128):
        if i <= 32:
            lut[i] = mag[i]
        elif i <= 64:
            lut[i] = -mag[64 - i]
        elif i <= 96:
            lut[i] = -mag[i - 64]
        else:
            lut[i] = mag[128 - i]
    k = np.arange(32)[:, None]
    n = np.arange(32)[None, :]
    idx = (k * (2 * n + 1)) % 128
    return lut[idx].astype(np.int16)


DCT32 = _gen_dct32()
DCT16 = DCT32[::2, :16].copy()
DCT8 = DCT32[::4, :8].copy()
DCT4 = DCT32[::8, :4].copy()

# DST-VII 4x4 for intra luma 4x4 TUs (spec 8.6.4.1; x265 dct.cpp dst4)
DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], dtype=np.int16)


def dct_matrix(log2_size: int) -> np.ndarray:
    return {2: DCT4, 3: DCT8, 4: DCT16, 5: DCT32}[log2_size]


# ---------------------------------------------------------------------------
# Quantization scales (spec 8.6.3; x265 constants.cpp g_quantScales/g_invQuantScales)
# ---------------------------------------------------------------------------
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

# Chroma QP mapping for 4:2:0 (spec Table 8-10; x265 constants.cpp:346)
CHROMA_QP_TABLE = np.array(
    list(range(30)) + [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]
    + [38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51] + [51] * 12,
    dtype=np.int32)
assert CHROMA_QP_TABLE.shape[0] == 70  # indices 0..69 (qp + offset clamp domain)


# ---------------------------------------------------------------------------
# Interpolation filter taps (spec 8.5.4.2.2; x265 constants.cpp:250-268)
# ---------------------------------------------------------------------------
LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int16)

CHROMA_FILTER = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int16)


# ---------------------------------------------------------------------------
# Intra prediction angle tables (spec 8.4.4.2.6 Table 8-4/8-5)
# ---------------------------------------------------------------------------
# intraPredAngle for modes 2..34
INTRA_PRED_ANGLE = np.array([
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32,
], dtype=np.int32)
# invAngle for modes 11..25 (angles -2..-32..-2)
INTRA_INV_ANGLE = np.array([
    -4096, -1638, -910, -630, -482, -390, -315, -256,
    -315, -390, -482, -630, -910, -1638, -4096,
], dtype=np.int32)


def intra_filter_flag(mode: int, log2_size: int) -> bool:
    """Reference-sample smoothing decision (spec 8.4.4.2.3)."""
    if mode == 1 or log2_size >= 6:
        return False
    if mode == 0:  # planar filters except 4x4
        return log2_size != 2
    dist = min(abs(mode - 26), abs(mode - 10))
    thresh = {2: 10, 3: 7, 4: 1, 5: 0}[log2_size]
    return dist > thresh


# ---------------------------------------------------------------------------
# Coefficient scan orders (spec 6.5.3-6.5.5).  Generated from the defining
# pseudo-code, not embedded.  scan[i] = (x, y) position of i-th coefficient.
# ---------------------------------------------------------------------------
SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


def _diag_scan(size: int) -> np.ndarray:
    """Up-right diagonal scan order array (spec 6.5.3 pseudo-code)."""
    order = []
    x = y = 0
    while len(order) < size * size:
        while y >= 0:
            if x < size and y < size:
                order.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return np.array(order, dtype=np.int32)


def _hor_scan(size: int) -> np.ndarray:
    g = np.mgrid[0:size, 0:size]  # y, x
    return np.stack([g[1].ravel(), g[0].ravel()], axis=1).astype(np.int32)


def _ver_scan(size: int) -> np.ndarray:
    g = np.mgrid[0:size, 0:size]
    return np.stack([g[1].T.ravel(), g[0].T.ravel()], axis=1).astype(np.int32)


def _sub_block_scan(log2_tb: int, scan_idx: int) -> np.ndarray:
    """Full-TB scan as 4x4 coefficient groups, each scanned internally.

    Returns (nCoeff, 2) array of (x, y), following spec 6.5.3: both the CG
    grid and the in-CG positions use the same scan pattern.
    """
    size = 1 << log2_tb
    if size == 4:
        return {SCAN_DIAG: _diag_scan, SCAN_HOR: _hor_scan, SCAN_VER: _ver_scan}[scan_idx](4)
    if size == 8 and scan_idx in (SCAN_HOR, SCAN_VER):
        # 8x8 hor/ver scans are also CG-based in HEVC
        pass
    n_cg = size >> 2
    cg_scan = {SCAN_DIAG: _diag_scan, SCAN_HOR: _hor_scan, SCAN_VER: _ver_scan}[scan_idx](n_cg)
    in_scan = {SCAN_DIAG: _diag_scan, SCAN_HOR: _hor_scan, SCAN_VER: _ver_scan}[scan_idx](4)
    out = []
    for cx, cy in cg_scan:
        for px, py in in_scan:
            out.append((cx * 4 + px, cy * 4 + py))
    return np.array(out, dtype=np.int32)


def cg_scan_order(log2_tb: int, scan_idx: int) -> np.ndarray:
    """(nCG, 2) array of 4x4 coefficient-group (x, y) grid positions in
    scan order for a TB of the given size (grid = N/4)."""
    if log2_tb == 2:
        return np.zeros((1, 2), dtype=np.int32)
    grid = 1 << (log2_tb - 2)
    return {SCAN_DIAG: _diag_scan, SCAN_HOR: _hor_scan,
            SCAN_VER: _ver_scan}[scan_idx](grid)


_SCAN_CACHE: dict = {}


def scan_order(log2_tb: int, scan_idx: int) -> np.ndarray:
    """(nCoeff, 2) array of (x, y) coefficient positions in scan order."""
    key = (log2_tb, scan_idx)
    if key not in _SCAN_CACHE:
        _SCAN_CACHE[key] = _sub_block_scan(log2_tb, scan_idx)
    return _SCAN_CACHE[key]


def scan_raster_index(log2_tb: int, scan_idx: int) -> np.ndarray:
    """scan position -> raster index (y*size + x)."""
    s = scan_order(log2_tb, scan_idx)
    return (s[:, 1] << log2_tb) + s[:, 0]


def intra_scan_idx(mode: int, log2_tb: int, c_idx: int) -> int:
    """Mode-dependent scan selection (spec 7.4.9.11): for 4x4/8x8 luma and
    4x4 chroma intra TBs, near-horizontal modes use vertical scan and vice
    versa."""
    if log2_tb == 2 or (log2_tb == 3 and c_idx == 0):
        if 6 <= mode <= 14:
            return SCAN_VER
        if 22 <= mode <= 30:
            return SCAN_HOR
    return SCAN_DIAG


# ---------------------------------------------------------------------------
# CABAC engine tables (spec 9.3.4.3 Tables 9-46/9-47;
# x265 constants.cpp:484 g_lpsTable, entropy.cpp:3031 g_nextState)
# ---------------------------------------------------------------------------
LPS_TABLE = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], dtype=np.uint8)

# State transition: transIdxLps (Table 9-47), transIdxMps = min(s+1, 62).
TRANS_IDX_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
], dtype=np.uint8)


def _gen_next_state() -> np.ndarray:
    """Packed-state transition table next[state128][bin].

    Packed state = (pStateIdx << 1) | valMps.  Bin index is the *actual*
    coded bin value.  States 126/127 are the terminate states (absorbing).
    """
    nxt = np.zeros((128, 2), dtype=np.uint8)
    for s in range(128):
        p, mps = s >> 1, s & 1
        if p == 63:  # terminate states
            nxt[s][0] = nxt[s][1] = s if s >= 126 else s
            nxt[s][mps] = s
            nxt[s][1 - mps] = s
            continue
        mps_next = min(p + 1, 62)
        lps_next = int(TRANS_IDX_LPS[p])
        new_mps = (1 - mps) if p == 0 else mps
        nxt[s][mps] = (mps_next << 1) | mps
        nxt[s][1 - mps] = (lps_next << 1) | new_mps
    return nxt


NEXT_STATE = _gen_next_state()

# Fractional-bit cost per (packed state XOR bin), in 1/32768 bit units.
# Used for RD bit estimation without running the arithmetic coder
# (x265 entropy.cpp:3018 g_entropyBits; derived from HM's table).
ENTROPY_BITS = np.array([
    0x07b23, 0x085f9, 0x074a0, 0x08cbc, 0x06ee4, 0x09354, 0x067f4, 0x09c1b,
    0x060b0, 0x0a62a, 0x05a9c, 0x0af5b, 0x0548d, 0x0b955, 0x04f56, 0x0c2a9,
    0x04a87, 0x0cbf7, 0x045d6, 0x0d5c3, 0x04144, 0x0e01b, 0x03d88, 0x0e937,
    0x039e0, 0x0f2cd, 0x03663, 0x0fc9e, 0x03347, 0x10600, 0x03050, 0x10f95,
    0x02d4d, 0x11a02, 0x02ad3, 0x12333, 0x0286e, 0x12cad, 0x02604, 0x136df,
    0x02425, 0x13f48, 0x021f4, 0x149c4, 0x0203e, 0x1527b, 0x01e4d, 0x15d00,
    0x01c99, 0x166de, 0x01b18, 0x17017, 0x019a5, 0x17988, 0x01841, 0x18327,
    0x016df, 0x18d50, 0x015d9, 0x19547, 0x0147c, 0x1a083, 0x0138e, 0x1a8a3,
    0x01251, 0x1b418, 0x01166, 0x1bd27, 0x01068, 0x1c77b, 0x00f7f, 0x1d18e,
    0x00eda, 0x1d91a, 0x00e19, 0x1e254, 0x00d4f, 0x1ec9a, 0x00c90, 0x1f6e0,
    0x00c01, 0x1fef8, 0x00b5f, 0x208b1, 0x00ab6, 0x21362, 0x00a15, 0x21e46,
    0x00988, 0x2285d, 0x00934, 0x22ea8, 0x008a8, 0x239b2, 0x0081d, 0x24577,
    0x007c9, 0x24ce6, 0x00763, 0x25663, 0x00710, 0x25e8f, 0x006a0, 0x26a26,
    0x00672, 0x26f23, 0x005e8, 0x27ef8, 0x005ba, 0x284b5, 0x0055e, 0x29057,
    0x0050c, 0x29bab, 0x004c1, 0x2a674, 0x004a7, 0x2aa5e, 0x0046f, 0x2b32f,
    0x0041f, 0x2c0ad, 0x003e7, 0x2ca8d, 0x003ba, 0x2d323, 0x0010c, 0x3bfbb,
], dtype=np.uint32)

# Golomb-Rice adaptation range (x265 constants.cpp g_goRiceRange; spec 9.3.3.13)
GO_RICE_RANGE = np.array([7, 14, 26, 46, 78], dtype=np.uint8)

# ---------------------------------------------------------------------------
# Deblocking filter thresholds (spec Table 8-12; x265 deblock.cpp:499-507)
# ---------------------------------------------------------------------------
DEBLOCK_TC = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
    13, 14, 16, 18, 20, 22, 24], dtype=np.int32)

DEBLOCK_BETA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
    44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], dtype=np.int32)

# sig_coeff_flag context map for 4x4 TBs (spec 9.3.4.2.5 ctxIdxMap)
SIG_CTX_MAP_4x4 = np.array(
    [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8], dtype=np.int32)


# 4:2:2 chroma intra mode remap (spec 8.4.4.2.3 Table 8-3,
# process for ChromaArrayType == 2: the half-width sampling grid
# changes the effective prediction angle; indexed by the DERIVED
# chroma mode 0..34)
CHROMA_422_ANGLE_MAP = (
    0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18, 19, 20,
    21, 22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28, 28, 29, 29, 30,
    31)
