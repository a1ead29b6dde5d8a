"""Merge and AMVP candidate derivation (spec 8.5.3.2.3-8.5.3.2.7).

Analog of the reference's CUData::getInterMergeCandidates / getPMV
(x265 source/common/cudata.cpp), shared verbatim by the encoder's entropy
stage and the validation decoder so both sides derive identical lists.

Full two-list (B slice) motion with POC-distance MV scaling for spatial
AMVP candidates, plus TMVP: the collocated picture's 16x16-compressed
motion field (spec motion compression) provides the temporal merge and
AMVP candidates (8.5.3.2.8/9) with POC scaling.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..frame.zscan import zscan_scalar


@dataclass(frozen=True)
class Motion:
    """Full inter motion of a PU: direction bitmask (1=L0, 2=L1) plus
    per-list MV/ref (unused list slots zeroed, ref -1)."""
    dir: int
    mv0: Tuple[int, int] = (0, 0)
    ref0: int = -1
    mv1: Tuple[int, int] = (0, 0)
    ref1: int = -1

    def mv(self, lst: int) -> Tuple[int, int]:
        return self.mv0 if lst == 0 else self.mv1

    def ref(self, lst: int) -> int:
        return self.ref0 if lst == 0 else self.ref1

    def has(self, lst: int) -> bool:
        return bool(self.dir & (1 << lst))


@dataclass
class ColMotion:
    """16x16-grid compressed motion field of a reference picture, with
    the POCs needed for temporal MV scaling (the reference's colMV
    storage after motion compression)."""
    poc: int
    dir: "np.ndarray"                  # (nby, nbx) int8 (0 = intra)
    mv: "np.ndarray"                   # (nby, nbx, 2, 2) int32 qpel
    ref_poc: "np.ndarray"              # (nby, nbx, 2) int64
    # the CURRENT slice's collocated_from_l0_flag view of this picture
    # (spec 8.5.3.2.9 listCol selection; our encoder always collocates
    # from L0 so the default matches its written flag)
    from_l0: bool = True


def temporal_candidate(col: ColMotion, x0: int, y0: int, nbw: int,
                       lst: int, target_poc: int, cur_poc: int,
                       pic_w: int, pic_h: int, log2_ctu: int,
                       low_delay: bool,
                       nbh: Optional[int] = None
                       ) -> Optional[Tuple[int, int]]:
    """Temporal MV for list `lst` targeting ref `target_poc` (spec
    8.5.3.2.8): bottom-right col block C0 (same CTU row only), center
    C1 fallback; col list choice per 8.5.3.2.9; POC-distance scaling.
    nbw/nbh: PU width/height (nbh defaults to nbw for square PUs)."""
    if nbh is None:
        nbh = nbw
    c0 = (x0 + nbw, y0 + nbh)
    c1 = (x0 + (nbw >> 1), y0 + (nbh >> 1))
    for i, (xc, yc) in enumerate((c0, c1)):
        if xc >= pic_w or yc >= pic_h:
            continue
        if i == 0 and (yc >> log2_ctu) != (y0 >> log2_ctu):
            continue                   # C0 must not cross the CTU row
        bx, by = xc >> 4, yc >> 4
        d = int(col.dir[by, bx])
        if d == 0:
            continue
        if d == 1:
            l = 0
        elif d == 2:
            l = 1
        else:
            # bi col block: low-delay streams take the target list,
            # otherwise listCol = RefPicList(collocated_from_l0_flag)
            # (spec 8.5.3.2.9 / HM xGetColMVP: crossing rule — col pic
            # in L0 -> take its L1 motion, and vice versa)
            l = lst if low_delay else (1 if col.from_l0 else 0)
        col_ref = int(col.ref_poc[by, bx, l])
        td = col.poc - col_ref
        tb = cur_poc - target_poc
        if td == 0:
            continue
        mv = (int(col.mv[by, bx, l, 0]), int(col.mv[by, bx, l, 1]))
        return _scale_mv(mv, tb, td)
    return None


def uni_motion(lst: int, mv: Tuple[int, int], ref: int) -> Motion:
    if lst == 0:
        return Motion(1, mv, ref)
    return Motion(2, (0, 0), -1, mv, ref)


class InterMaps:
    """4x4-minblock motion state built progressively in coding order
    (the inter half of the reference's CUData SoA arrays)."""

    def __init__(self, width: int, height: int, log2_ctu: int) -> None:
        self.w = width
        self.h = height
        self.log2_ctu = log2_ctu
        self.w_ctus = -(-width // (1 << log2_ctu))
        w4 = -(-width // 4)
        h4 = -(-height // 4)
        self.dir = np.zeros((h4, w4), dtype=np.int8)    # 0 = intra/uncoded
        self.coded = np.zeros((h4, w4), dtype=bool)
        self.skip = np.zeros((h4, w4), dtype=bool)
        self.mv = np.zeros((h4, w4, 2, 2), dtype=np.int32)
        self.ref = np.full((h4, w4, 2), -1, dtype=np.int8)

    def set_cu(self, x0: int, y0: int, log2_size: int, motion=None,
               skip: bool = False) -> None:
        """motion: Motion for inter CUs, None for intra."""
        n = 1 << log2_size
        self.set_pu(x0, y0, n, n, motion, skip)

    def set_pu(self, x0: int, y0: int, w: int, h: int, motion=None,
               skip: bool = False) -> None:
        """Rectangular PU variant (2NxN / Nx2N partitions)."""
        ys = slice(y0 >> 2, (y0 + h) >> 2)
        xs = slice(x0 >> 2, (x0 + w) >> 2)
        self.coded[ys, xs] = True
        self.skip[ys, xs] = skip
        if motion is None:
            self.dir[ys, xs] = 0
        else:
            self.dir[ys, xs] = motion.dir
            self.mv[ys, xs, 0] = motion.mv0
            self.mv[ys, xs, 1] = motion.mv1
            self.ref[ys, xs, 0] = motion.ref0
            self.ref[ys, xs, 1] = motion.ref1

    def _avail(self, x: int, y: int, z0: int) -> bool:
        if x < 0 or y < 0 or x >= self.w or y >= self.h:
            return False
        if not self.coded[y >> 2, x >> 2]:
            return False
        return zscan_scalar(x, y, self.log2_ctu, self.w_ctus) < z0

    def motion_at(self, x: int, y: int, z0: int) -> Optional[Motion]:
        """Motion of the inter PU covering luma sample (x, y), or None."""
        if not self._avail(x, y, z0):
            return None
        d = int(self.dir[y >> 2, x >> 2])
        if d == 0:
            return None
        return Motion(d,
                      (int(self.mv[y >> 2, x >> 2, 0, 0]),
                       int(self.mv[y >> 2, x >> 2, 0, 1])),
                      int(self.ref[y >> 2, x >> 2, 0]),
                      (int(self.mv[y >> 2, x >> 2, 1, 0]),
                       int(self.mv[y >> 2, x >> 2, 1, 1])),
                      int(self.ref[y >> 2, x >> 2, 1]))

    def skip_at(self, x: int, y: int) -> bool:
        if x < 0 or y < 0 or x >= self.w or y >= self.h:
            return False
        return bool(self.coded[y >> 2, x >> 2] and self.skip[y >> 2, x >> 2])


def merge_candidates(maps: InterMaps, x0: int, y0: int, nbs: int,
                     z0: int, max_cands: int = 3,
                     num_refs=(1, 0), ref_pocs=None,
                     col: Optional[ColMotion] = None,
                     cur_poc: int = 0, nbh: Optional[int] = None,
                     part_rule: Optional[str] = None) -> List[Motion]:
    """Merge candidate list for a PU (spec 8.5.3.2.3): spatial,
    temporal (when a collocated field is given), combined-bi
    (8.5.3.2.4), zero fill (bi zeros for B, L0 zeros for P).

    nbs/nbh: PU width/height (nbh defaults to nbs).  part_rule encodes
    the second-PU exclusions of 8.5.3.2.3: 'no_b1' for 2NxN partIdx 1,
    'no_a1' for Nx2N partIdx 1 (prevents the degenerate merge that
    reproduces 2Nx2N)."""
    nbw = nbs
    if nbh is None:
        nbh = nbs
    a1 = None if part_rule == "no_a1" else \
        maps.motion_at(x0 - 1, y0 + nbh - 1, z0)
    b1 = None if part_rule == "no_b1" else \
        maps.motion_at(x0 + nbw - 1, y0 - 1, z0)
    b0 = maps.motion_at(x0 + nbw, y0 - 1, z0)
    a0 = maps.motion_at(x0 - 1, y0 + nbh, z0)
    cands: List[Motion] = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and b1 != a1:
        cands.append(b1)
    if b0 is not None and b0 != b1:
        cands.append(b0)
    if a0 is not None and a0 != a1:
        cands.append(a0)
    if len(cands) < 4:
        b2 = maps.motion_at(x0 - 1, y0 - 1, z0)
        if b2 is not None and b2 != a1 and b2 != b1:
            cands.append(b2)
    is_b_ = num_refs[1] > 0
    if col is not None and len(cands) < max_cands:
        low_delay = all(rp <= cur_poc
                        for lst_p in (ref_pocs or ((), ()))
                        for rp in lst_p)
        mv0 = temporal_candidate(col, x0, y0, nbw, 0, ref_pocs[0][0],
                                 cur_poc, maps.w, maps.h, maps.log2_ctu,
                                 low_delay, nbh)
        mv1 = None
        if is_b_ and ref_pocs[1]:
            mv1 = temporal_candidate(col, x0, y0, nbw, 1,
                                     ref_pocs[1][0], cur_poc, maps.w,
                                     maps.h, maps.log2_ctu, low_delay,
                                     nbh)
        if mv0 is not None or mv1 is not None:
            d = (1 if mv0 is not None else 0) | \
                (2 if mv1 is not None else 0)
            cands.append(Motion(d, mv0 or (0, 0),
                                0 if mv0 is not None else -1,
                                mv1 or (0, 0),
                                0 if mv1 is not None else -1))
    # combined bi-predictive candidates (spec 8.5.3.2.4) are only derived
    # from existing bi lists; with spatial-only cands and no TMVP the
    # combined stage contributes when two uni cands of opposite lists
    # exist — HEVC derives them for B slices:
    is_b = num_refs[1] > 0
    if is_b and len(cands) > 1 and len(cands) < max_cands:
        order = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
                 (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))
        base = list(cands)
        for (i, j) in order:
            if len(cands) >= max_cands:
                break
            if i >= len(base) or j >= len(base):
                continue
            ci, cj = base[i], base[j]
            if ci.has(0) and cj.has(1):
                # add unless both directions reference the same picture
                # with the same MV (POC comparison, spec 8.5.3.2.4)
                same_pic = (ref_pocs is not None and
                            ref_pocs[0][ci.ref0] == ref_pocs[1][cj.ref1])
                if same_pic and ci.mv0 == cj.mv1:
                    continue
                cands.append(Motion(3, ci.mv0, ci.ref0, cj.mv1, cj.ref1))
    zero_ref = 0
    nr = min(num_refs[0], num_refs[1]) if is_b else num_refs[0]
    while len(cands) < max_cands:
        r = zero_ref if zero_ref < nr else 0
        if is_b:
            cands.append(Motion(3, (0, 0), r, (0, 0), r))
        else:
            cands.append(Motion(1, (0, 0), r))
        zero_ref += 1
    return cands[:max_cands]


def _scale_mv(mv: Tuple[int, int], tb: int, td: int) -> Tuple[int, int]:
    """POC-distance MV scaling (spec 8.5.3.2.8 derivation)."""
    if td == tb:
        return mv
    # tx = (16384 + |td|/2) / td with C-style truncation toward zero
    # (spec 8.5.3.2.8; Python // floors, which is off by one for td < 0)
    num = 16384 + (abs(td) >> 1)
    tx = -(num // -td) if td < 0 else num // td
    dsf = min(4095, max(-4096, (tb * tx + 32) >> 6))
    out = []
    for c in mv:
        v = dsf * c
        s = (abs(v) + 127) >> 8
        out.append(min(32767, max(-32768, -s if v < 0 else s)))
    return (out[0], out[1])


def amvp_candidates(maps: InterMaps, x0: int, y0: int, nbs: int,
                    z0: int, lst: int, ref_idx: int,
                    ref_pocs, cur_poc: int,
                    col: Optional[ColMotion] = None,
                    nbh: Optional[int] = None
                    ) -> List[Tuple[int, int]]:
    """AMVP list (2 entries) for list `lst` (spec 8.5.3.2.6/7).

    ref_pocs: (pocs_l0, pocs_l1) tuples of reference POCs.
    nbs/nbh: PU width/height (nbh defaults to nbs).
    Spatial candidates only (no TMVP); same-POC pass then scaled pass
    following the spec's A/B candidate rules.
    """
    nbw = nbs
    if nbh is None:
        nbh = nbs
    target_poc = ref_pocs[lst][ref_idx]

    def neigh(nx, ny):
        return maps.motion_at(nx, ny, z0)

    a_pos = ((x0 - 1, y0 + nbh), (x0 - 1, y0 + nbh - 1))
    b_pos = ((x0 + nbw, y0 - 1), (x0 + nbw - 1, y0 - 1), (x0 - 1, y0 - 1))
    a_motions = [neigh(*p) for p in a_pos]
    b_motions = [neigh(*p) for p in b_pos]

    def same_poc_pass(motions):
        for m in motions:
            if m is None:
                continue
            for l in (lst, 1 - lst):
                if m.has(l) and ref_pocs[l][m.ref(l)] == target_poc:
                    return m.mv(l)
        return None

    def scaled_pass(motions):
        for m in motions:
            if m is None:
                continue
            for l in (lst, 1 - lst):
                if m.has(l):
                    src_poc = ref_pocs[l][m.ref(l)]
                    tb = cur_poc - target_poc
                    td = cur_poc - src_poc
                    if td == 0:
                        continue
                    return _scale_mv(m.mv(l), tb, td)
        return None

    mv_a = same_poc_pass(a_motions)
    is_scaled = any(m is not None for m in a_motions)
    if mv_a is None and is_scaled:
        mv_a = scaled_pass(a_motions)
    mv_b = same_poc_pass(b_motions)
    if mv_b is None and not is_scaled:
        mv_b = scaled_pass(b_motions)

    cands: List[Tuple[int, int]] = []
    if mv_a is not None:
        cands.append(mv_a)
    if mv_b is not None and mv_b != mv_a:
        cands.append(mv_b)
    if col is not None and len(cands) < 2:
        low_delay = all(rp <= cur_poc for lp in ref_pocs for rp in lp)
        t = temporal_candidate(col, x0, y0, nbw, lst, target_poc,
                               cur_poc, maps.w, maps.h, maps.log2_ctu,
                               low_delay, nbh)
        if t is not None and t not in cands:
            cands.append(t)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands[:2]


def mvd_bits(mvd_x: int, mvd_y: int) -> int:
    """Exact mvd_coding bin count (for encoder mvp_idx selection)."""
    bits = 0
    for v in (abs(mvd_x), abs(mvd_y)):
        bits += 1                      # greater0
        if v > 0:
            bits += 1                  # greater1
            if v > 1:
                # EG1 of v-2
                k = (v - 2) >> 1
                bits += 2 * ((k + 1).bit_length() - 1) + 1 + 1
            bits += 1                  # sign
    return bits
