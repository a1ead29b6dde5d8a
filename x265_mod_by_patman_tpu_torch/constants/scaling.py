"""HEVC default scaling lists (spec 7.4.5 tables; reference
common/scalinglist.cpp ScalingList defaults).

Default-matrix mode only ("--scaling-list default"): the SPS signals
scaling_list_enabled with no explicit data, and both quant and dequant
apply the spec default matrices.  m[i] == 16 is the flat (disabled)
behavior; the default lists shape quantization toward low frequencies.
"""
from __future__ import annotations

import functools

import numpy as np

# spec Table 7-5: default 4x4 (flat 16) — sizeId 0
FLAT4 = np.full((4, 4), 16, np.int32)

# spec Table 7-6: default 8x8 intra / inter lists (raster from the
# up-right diagonal coefficient order of the spec text)
_D8_INTRA = np.array([
    [16, 16, 16, 16, 17, 18, 21, 24],
    [16, 16, 16, 16, 17, 19, 22, 25],
    [16, 16, 17, 18, 20, 22, 25, 29],
    [16, 16, 18, 21, 24, 27, 31, 36],
    [17, 17, 20, 24, 30, 35, 41, 47],
    [18, 19, 22, 27, 35, 44, 54, 65],
    [21, 22, 25, 31, 41, 54, 70, 88],
    [24, 25, 29, 36, 47, 65, 88, 115]], np.int32)

_D8_INTER = np.array([
    [16, 16, 16, 16, 17, 18, 20, 24],
    [16, 16, 16, 17, 18, 20, 24, 25],
    [16, 16, 17, 18, 20, 24, 25, 28],
    [16, 17, 18, 20, 24, 25, 28, 33],
    [17, 18, 20, 24, 25, 28, 33, 41],
    [18, 20, 24, 25, 28, 33, 41, 54],
    [20, 24, 25, 28, 33, 41, 54, 71],
    [24, 25, 28, 33, 41, 54, 71, 91]], np.int32)


# x265/HM scaling-list file block names (reference scalinglist.cpp:69
# MatrixType / :104 MatrixType_DC): per sizeId 0-3, listId 0-5 =
# intra {Y, Cb, Cr}, inter {Y, Cb, Cr}; sizeId 3 files carry luma only
_SIZE_NAMES = ("4X4", "8X8", "16X16", "32X32")
_LIST_NAMES = ("INTRA{}_LUMA", "INTRA{}_CHROMAU", "INTRA{}_CHROMAV",
               "INTER{}_LUMA", "INTER{}_CHROMAU", "INTER{}_CHROMAV")


def parse_scaling_list_file(path: str):
    """Parse an x265/HM custom scaling-list file (the format
    reference scalinglist.cpp:246 parseScalingList reads): per
    (sizeId, listId) block header line containing e.g.
    'INTRA8X8_LUMA =' followed by comma-separated coefficients in
    RASTER order of the (up to 8x8) signaled matrix, plus a
    '*_DC' value for 16x16/32x32.  Returns (lists, dc): lists maps
    (sizeId, listId) -> raster np.int32 array (4x4 or 8x8); dc maps
    (sizeId>=2, listId) -> int.  sizeId-3 chroma lists are filled from
    sizeId 2 like the reference does."""
    text = open(path).read()
    toks = text.replace("=", " ").split()
    lists: dict = {}
    dc: dict = {}

    def read_block(name: str, count: int):
        try:
            i = toks.index(name)
        except ValueError:
            raise ValueError(f"scaling list file missing {name}")
        vals = []
        j = i + 1
        while len(vals) < count and j < len(toks):
            for piece in toks[j].split(","):
                if piece.strip():
                    vals.append(int(piece))
            j += 1
        if len(vals) < count:
            raise ValueError(f"scaling list {name}: expected {count}")
        return vals[:count]

    for size_id in range(4):
        n = 4 if size_id == 0 else 8
        for list_id in range(0, 6, 3 if size_id == 3 else 1):
            name = _LIST_NAMES[list_id].format(_SIZE_NAMES[size_id])
            vals = read_block(name, n * n)
            lists[(size_id, list_id)] = np.asarray(
                vals, np.int32).reshape(n, n)
            if size_id >= 2:
                dval = read_block(name + "_DC", 1)[0]
                dc[(size_id, list_id)] = int(dval)
        if size_id == 3:
            for list_id in (1, 2, 4, 5):
                lists[(3, list_id)] = lists[(2, list_id)].copy()
                dc[(3, list_id)] = dc[(2, list_id)]
    for v in lists.values():
        assert np.all((v >= 1) & (v <= 255)), "scaling coefs in 1..255"
    return lists, dc


def list_matrix(lists, dc, log2_size: int, intra: bool,
                comp: int) -> np.ndarray:
    """Full (n x n) scaling matrix for a TU from parsed custom lists
    (reference processScalingListDec layout: pixel-repetition upsample
    of the signaled 8x8, DC overwritten for 16/32).  comp: 0=Y, 1=Cb,
    2=Cr."""
    size_id = log2_size - 2
    list_id = (0 if intra else 3) + comp
    base = lists[(size_id, list_id)]
    n = 1 << log2_size
    rep = n // base.shape[0]
    m = np.repeat(np.repeat(base, rep, axis=0),
                  rep, axis=1).astype(np.int32)
    if rep > 1 and (size_id, list_id) in dc:
        m[0, 0] = dc[(size_id, list_id)]
    return m


def diag_scan_positions(n: int):
    """Up-right diagonal scan of an n x n array (spec 6.5.3): the
    coefficient order scaling_list_delta_coef uses (7.4.5)."""
    pos = []
    for d in range(2 * n - 1):
        y = min(d, n - 1)
        while y >= 0 and d - y < n:
            pos.append((d - y, y))
            y -= 1
    return pos


def quant_mats_custom(log2_size: int, lists, dc, comp: int):
    """(2, 6, n, n) forward-quant tables from custom lists (the
    custom-list analog of ops.transform.quant_mats)."""
    from .hevc_tables import QUANT_SCALES
    n = 1 << log2_size
    out = np.zeros((2, 6, n, n), np.int32)
    for ii, intra in enumerate((True, False)):
        m = list_matrix(lists, dc, log2_size, intra,
                        comp).astype(np.float64)
        for r in range(6):
            out[ii, r] = np.round(QUANT_SCALES[r] * 16.0 / m)
    return out


@functools.lru_cache(maxsize=None)
def default_matrix(log2_size: int, intra: bool) -> np.ndarray:
    """Default scaling matrix for an (n x n) TU (spec 8.6.3: sizes above
    8 upsample the 8x8 list by pixel repetition; DC replaced by the
    signaled/ default DC value 16)."""
    if log2_size == 2:
        return FLAT4.copy()
    base = _D8_INTRA if intra else _D8_INTER
    if log2_size == 3:
        return base.copy()
    rep = 1 << (log2_size - 3)
    m = np.repeat(np.repeat(base, rep, axis=0), rep, axis=1)
    m[0, 0] = 16                     # default dc == 16
    return m
