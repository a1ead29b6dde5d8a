"""CU / CTU / transform-tree syntax (spec 7.3.8.4-7.3.8.11), I + P slices.

Analog of the reference's Entropy::encodeCTU CU-syntax path (x265
source/encoder/entropy.cpp:1161 encodeCTU, codeIntraLumaAng, codeQtCbf,
codeMvd etc.), split into a bin-IR writer (SliceSyntaxEncoder) and a CABAC
parser (SliceSyntaxDecoder) for conformance validation.  Both sides share
the neighbor-context derivations via per-frame 4x4-minblock maps,
mirroring the reference's CUData neighbor queries (common/cudata.cpp).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from ..constants.hevc_tables import intra_scan_idx, SCAN_DIAG
from ..frame.zscan import zscan_scalar
from .contexts import OFF
from .binir import BinIR
from .cabac import CabacDecoder
from .residual import encode_residual, decode_residual
from .mv_pred import (Motion, InterMaps, amvp_candidates,
                      merge_candidates, mvd_bits)

INTRA_PLANAR, INTRA_DC, INTRA_HOR, INTRA_VER = 0, 1, 10, 26
CHROMA_MODE_TABLE = (INTRA_PLANAR, INTRA_VER, INTRA_HOR, INTRA_DC)


@dataclass
class CodedCU:
    """One CU's coded decisions + quantized coefficients.

    coeffs maps (c_idx, x, y, log2_size) -> (N, N) int level array, with
    (x, y) in the component's own sample coordinates.  INVARIANT: every
    entry holds at least one nonzero level; absent entries mean cbf=0
    (builders must drop all-zero TBs — the syntax walk infers cbf from
    key presence without re-scanning the arrays).

    Inter fields: is_inter selects the prediction type; mv is the final
    motion vector (qpel); skip/merge coding decisions are derived from the
    candidate lists at syntax time, not stored.
    """
    x0: int
    y0: int
    log2_size: int
    luma_modes: Tuple[int, ...] = (1,)   # len 1 (2Nx2N) or 4 (NxN)
    chroma_idx: int = 4                  # intra_chroma_pred_mode index; 4=DM
    coeffs: Dict = field(default_factory=dict)
    is_inter: bool = False
    tq_bypass: bool = False              # cu_transquant_bypass_flag
    tu_split: bool = False               # voluntary depth-0 TU split
    tu_split8: Tuple = None              # NxN: per-quad TU4(DST) split
    tu_leaves: list = field(default_factory=list)  # decoder: (x, y, log2)
    mv: Tuple[int, int] = (0, 0)         # qpel, list 0 (PU 0)
    ref_idx: int = 0
    inter_dir: int = 1                   # 1=L0, 2=L1, 3=BI
    mv1: Tuple[int, int] = (0, 0)        # qpel, list 1
    ref_idx1: int = 0
    # rect partitions (x265 analysis.cpp checkInter 2NxN/Nx2N):
    # part_mode 0 = 2Nx2N, 1 = 2NxN, 2 = Nx2N; *_b fields are PU 1
    part_mode: int = 0
    mv_b: Tuple[int, int] = (0, 0)
    ref_idx_b: int = 0
    inter_dir_b: int = 1
    mv1_b: Tuple[int, int] = (0, 0)
    ref_idx1_b: int = 0
    # decoder-filled coding metadata (for stats / BS derivation)
    was_skip: bool = False
    qp: int = -1                         # derived CU QP (-1 = slice QP)

    def motion(self, pu: int = 0) -> "Motion":
        if pu == 0:
            d, mv0, r0, mv1, r1 = (self.inter_dir, self.mv, self.ref_idx,
                                   self.mv1, self.ref_idx1)
        else:
            d, mv0, r0, mv1, r1 = (self.inter_dir_b, self.mv_b,
                                   self.ref_idx_b, self.mv1_b,
                                   self.ref_idx1_b)
        return Motion(d,
                      mv0 if d & 1 else (0, 0), r0 if d & 1 else -1,
                      mv1 if d & 2 else (0, 0), r1 if d & 2 else -1)

    @property
    def part_nxn(self) -> bool:
        return (not self.is_inter) and len(self.luma_modes) == 4


def pu_partitions(x0: int, y0: int, nbs: int, part_mode: int):
    """PU geometry list [(x, y, w, h, merge_rule)] for a CU (spec
    7.4.9.5 partition table; merge_rule = second-PU spatial exclusion
    of 8.5.3.2.3).  Part codes follow the reference's PartSize enum:
    0=2Nx2N, 1=2NxN, 2=Nx2N, 4=2NxnU, 5=2NxnD, 6=nLx2N, 7=nRx2N."""
    q = nbs >> 2
    if part_mode == 1:                   # 2NxN
        h = nbs >> 1
        return [(x0, y0, nbs, h, None), (x0, y0 + h, nbs, h, "no_b1")]
    if part_mode == 2:                   # Nx2N
        w = nbs >> 1
        return [(x0, y0, w, nbs, None), (x0 + w, y0, w, nbs, "no_a1")]
    if part_mode == 4:                   # 2NxnU
        return [(x0, y0, nbs, q, None),
                (x0, y0 + q, nbs, nbs - q, "no_b1")]
    if part_mode == 5:                   # 2NxnD
        return [(x0, y0, nbs, nbs - q, None),
                (x0, y0 + nbs - q, nbs, q, "no_b1")]
    if part_mode == 6:                   # nLx2N
        return [(x0, y0, q, nbs, None),
                (x0 + q, y0, nbs - q, nbs, "no_a1")]
    if part_mode == 7:                   # nRx2N
        return [(x0, y0, nbs - q, nbs, None),
                (x0 + nbs - q, y0, q, nbs, "no_a1")]
    return [(x0, y0, nbs, nbs, None)]


class FrameSyntaxMaps:
    """Per-frame neighbor state at 4x4 minblock granularity (the syntax
    analog of x265 CUData SoA arrays)."""

    def __init__(self, width: int, height: int) -> None:
        self.w4 = -(-width // 4)
        self.h4 = -(-height // 4)
        self.depth = np.full((self.h4, self.w4), -1, dtype=np.int8)
        self.mode = np.full((self.h4, self.w4), -1, dtype=np.int8)

    def set_cu(self, x0: int, y0: int, log2_size: int, depth: int) -> None:
        n4 = 1 << (log2_size - 2)
        self.depth[y0 >> 2:(y0 >> 2) + n4, x0 >> 2:(x0 >> 2) + n4] = depth

    def set_mode(self, x0: int, y0: int, log2_size: int, mode: int) -> None:
        n4 = 1 << (log2_size - 2)
        self.mode[y0 >> 2:(y0 >> 2) + n4, x0 >> 2:(x0 >> 2) + n4] = mode

    def depth_at(self, x: int, y: int) -> int:
        if x < 0 or y < 0 or x >= self.w4 * 4 or y >= self.h4 * 4:
            return -1
        return int(self.depth[y >> 2, x >> 2])

    def mode_at(self, x: int, y: int) -> int:
        if x < 0 or y < 0 or x >= self.w4 * 4 or y >= self.h4 * 4:
            return -1
        return int(self.mode[y >> 2, x >> 2])


def derive_mpm(maps: FrameSyntaxMaps, x0: int, y0: int,
               log2_ctu: int) -> list:
    """Luma most-probable-mode list (spec 8.4.2)."""
    a = maps.mode_at(x0 - 1, y0)             # left PU
    if a < 0:
        a = INTRA_DC
    # above PU: unavailable or in the CTU row above -> DC
    if y0 == 0 or ((y0 - 1) >> log2_ctu) != (y0 >> log2_ctu):
        b = INTRA_DC
    else:
        b = maps.mode_at(x0, y0 - 1)
        if b < 0:
            b = INTRA_DC
    if a == b:
        if a < 2:
            return [INTRA_PLANAR, INTRA_DC, INTRA_VER]
        return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
    if a != INTRA_PLANAR and b != INTRA_PLANAR:
        c = INTRA_PLANAR
    elif a != INTRA_DC and b != INTRA_DC:
        c = INTRA_DC
    else:
        c = INTRA_VER
    return [a, b, c]


def chroma_mode_from_idx(idx: int, luma_mode: int) -> int:
    """intra_chroma_pred_mode syntax index -> prediction mode (8.4.3)."""
    if idx == 4:
        return luma_mode
    m = CHROMA_MODE_TABLE[idx]
    return 34 if m == luma_mode else m


def _split_ctx(maps: FrameSyntaxMaps, x0: int, y0: int, depth: int) -> int:
    ctx = 0
    d = maps.depth_at(x0 - 1, y0)
    if d > depth:
        ctx += 1
    d = maps.depth_at(x0, y0 - 1)
    if d > depth:
        ctx += 1
    return OFF["SPLIT_FLAG"] + ctx


class SliceSyntaxEncoder:
    """Walks CTUs in raster order emitting the slice-data bin IR."""

    def __init__(self, sps, pps, slice_qp: int, slice_type: int = 2,
                 max_merge: int = 3, num_refs=(1, 0), ref_pocs=((), ()),
                 cur_poc: int = 0, col_motion=None) -> None:
        self.sps = sps
        self.pps = pps
        self.qp = slice_qp
        self.slice_type = slice_type        # 0=B 1=P 2=I
        self.max_merge = max_merge
        self.num_refs = (num_refs, 0) if isinstance(num_refs, int) \
            else tuple(num_refs)
        if ref_pocs == ((), ()):
            # default synthetic POCs (tests / callers without a DPB):
            # L0 descending behind, L1 ascending ahead of cur_poc
            ref_pocs = (tuple(cur_poc - 1 - i
                              for i in range(self.num_refs[0])),
                        tuple(cur_poc + 1 + i
                              for i in range(self.num_refs[1])))
        self.ref_pocs = ref_pocs
        self.cur_poc = cur_poc
        self.col = col_motion
        self.maps = FrameSyntaxMaps(sps.width, sps.height)
        self.imaps = InterMaps(sps.width, sps.height, sps.log2_ctu_size)
        self.min_log2_cu = sps.log2_min_cu_size
        self.log2_ctu = sps.log2_ctu_size
        # chroma geometry shift: 1 for 4:2:0, 0 for 4:4:4;
        # 4:2:2 keeps x-shift 1 with two stacked TBs per TU
        _csp = getattr(sps, 'chroma_format_idc', 1)
        self.c_shift = 0 if _csp == 3 else 1
        self.is422 = _csp == 2
        # cu_qp_delta state (QG == CTB with diff_cu_qp_delta_depth 0)
        self._qp_prev = slice_qp
        self._qg_pred = slice_qp
        self._dqp_coded = False
        self._cur_ctu_qp = slice_qp

    def _z0(self, x0: int, y0: int) -> int:
        return zscan_scalar(x0, y0, self.log2_ctu,
                            self.sps.pic_width_in_ctus)

    def encode_ctu(self, ir: BinIR, cu_list, ctu_x: int, ctu_y: int,
                   last_ctu: bool, sao=None, ctu_qp: int = None,
                   sao_merge: int = 0, sao_top: int = 0) -> None:
        """cu_list: CodedCU objects of this CTU in z-scan order; sao:
        optional (SaoParams_y, SaoParams_cb, SaoParams_cr); ctu_qp: the
        AQ target QP of this CTU (cu_qp_delta coded when it has coded
        coefficients); sao_merge: 0 explicit, 1 merge-left, 2 merge-up
        (the maps already hold the merged values); sao_top: the slice's
        first CTU row (merge-up not signalable across, spec 7.3.8.3)."""
        if self.pps.cu_qp_delta_enabled:
            if self.pps.entropy_coding_sync and ctu_x == 0:
                self._qp_prev = self.qp    # WPP: reset per CTU row
            self._qg_pred = self._qp_prev
            self._dqp_coded = False
            self._cur_ctu_qp = self.qp if ctu_qp is None else int(ctu_qp)
        if sao is not None:
            self._sao_params(ir, sao, ctu_x, ctu_y, sao_merge, sao_top)
        cu_by_pos = {(cu.x0, cu.y0): cu for cu in cu_list}
        x0 = ctu_x << self.log2_ctu
        y0 = ctu_y << self.log2_ctu
        self._quadtree(ir, cu_by_pos, x0, y0, self.log2_ctu, 0)
        ir.term(1 if last_ctu else 0)
        if self.pps.cu_qp_delta_enabled:
            self._qp_prev = self._cur_ctu_qp if self._dqp_coded \
                else self._qg_pred

    # -- sao (7.3.8.3) with merge-left/up flags ------------------------------
    def _sao_params(self, ir: BinIR, sao, ctu_x: int, ctu_y: int,
                    merge: int = 0, top_row: int = 0) -> None:
        if ctu_x > 0:
            ir.cbin(1 if merge == 1 else 0, OFF["SAO_MERGE"])
        if ctu_y > top_row and merge != 1:
            ir.cbin(1 if merge == 2 else 0, OFF["SAO_MERGE"])
        if merge:
            return
        for c_idx in (0, 1, 2):
            pr = sao[c_idx]
            if c_idx == 0:
                self._sao_type(ir, pr.type_idx)
            elif c_idx == 1:
                self._sao_type(ir, sao[1].type_idx)
            if pr.type_idx == 0:
                continue
            cmax = (1 << (min(self.sps.bit_depth, 10) - 5)) - 1
            for o in pr.offsets:
                self._sao_offset_abs(ir, abs(int(o)), cmax)
            if pr.type_idx == 1:               # band
                for o in pr.offsets:
                    if o != 0:
                        ir.bypass(1 if o < 0 else 0)
                ir.bypass_bits(pr.band_pos, 5)
            elif c_idx == 0:
                ir.bypass_bits(pr.eo_class, 2)
            elif c_idx == 1:
                ir.bypass_bits(pr.eo_class, 2)

    def _sao_type(self, ir: BinIR, t: int) -> None:
        ir.cbin(1 if t > 0 else 0, OFF["SAO_TYPE"])
        if t > 0:
            ir.bypass(1 if t == 2 else 0)

    def _sao_offset_abs(self, ir: BinIR, v: int, cmax: int = 7) -> None:
        for _ in range(v):
            ir.bypass(1)
        if v < cmax:
            ir.bypass(0)

    # -- coding_quadtree (7.3.8.4) -------------------------------------------
    def _quadtree(self, ir: BinIR, cu_by_pos, x0, y0, log2_size, depth):
        sps = self.sps
        # regions fully outside the picture are skipped (implicit split)
        inside = x0 + (1 << log2_size) <= sps.width and \
            y0 + (1 << log2_size) <= sps.height
        cu = cu_by_pos.get((x0, y0))
        split = cu is None or cu.log2_size < log2_size
        if inside and log2_size > self.min_log2_cu:
            ir.cbin(1 if split else 0, _split_ctx(self.maps, x0, y0, depth))
        if split or not inside:
            half = 1 << (log2_size - 1)
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                if x0 + dx < sps.width and y0 + dy < sps.height:
                    self._quadtree(ir, cu_by_pos, x0 + dx, y0 + dy,
                                   log2_size - 1, depth + 1)
            return
        self.maps.set_cu(x0, y0, log2_size, depth)
        self._coding_unit(ir, cu)

    # -- coding_unit (7.3.8.5) --------------------------------------------------
    def _coding_unit(self, ir: BinIR, cu: CodedCU) -> None:
        if self.pps.transquant_bypass:
            ir.cbin(1 if cu.tq_bypass else 0, OFF["TQ_BYPASS"])
        if self.slice_type != 2:
            self._coding_unit_p(ir, cu)
        else:
            self._coding_unit_intra(ir, cu)
            self.imaps.set_cu(cu.x0, cu.y0, cu.log2_size, None)

    def _skip_ctx(self, x0: int, y0: int) -> int:
        ctx = 0
        if self.imaps.skip_at(x0 - 1, y0):
            ctx += 1
        if self.imaps.skip_at(x0, y0 - 1):
            ctx += 1
        return OFF["SKIP_FLAG"] + ctx

    def _coding_unit_p(self, ir: BinIR, cu: CodedCU) -> None:
        x0, y0, log2 = cu.x0, cu.y0, cu.log2_size
        nbs = 1 << log2
        z0 = self._z0(x0, y0)
        has_resi = bool(cu.coeffs)
        if cu.is_inter and cu.part_mode:
            self._inter_rect(ir, cu, has_resi)
            return
        if cu.is_inter:
            mot = cu.motion()
            mlist = merge_candidates(self.imaps, x0, y0, nbs, z0,
                                     self.max_merge, self.num_refs,
                                     self.ref_pocs, self.col,
                                     self.cur_poc)
            midx = mlist.index(mot) if mot in mlist else -1
            if midx >= 0 and not has_resi:
                # SKIP
                ir.cbin(1, self._skip_ctx(x0, y0))
                self._merge_idx(ir, midx)
                self.imaps.set_cu(x0, y0, log2, mot, skip=True)
                return
            ir.cbin(0, self._skip_ctx(x0, y0))
            ir.cbin(0, OFF["PRED_MODE"])          # MODE_INTER
            ir.cbin(1, OFF["PART_SIZE"])          # PART_2Nx2N
            if midx >= 0:
                ir.cbin(1, OFF["MERGE_FLAG"])
                self._merge_idx(ir, midx)
                # rqt_root_cbf not coded for 2Nx2N merge (inferred 1)
            else:
                ir.cbin(0, OFF["MERGE_FLAG"])
                if self.slice_type == 0:
                    self._inter_pred_idc(ir, mot.dir, self.log2_ctu - log2)
                for lst in (0, 1):
                    if not mot.has(lst):
                        continue
                    if self.num_refs[lst] > 1:
                        self._ref_idx(ir, mot.ref(lst), lst)
                    alist = amvp_candidates(self.imaps, x0, y0, nbs, z0,
                                            lst, mot.ref(lst),
                                            self.ref_pocs, self.cur_poc,
                                            self.col)
                    mv = mot.mv(lst)
                    costs = [mvd_bits(mv[0] - c[0], mv[1] - c[1])
                             for c in alist]
                    mvp_idx = 0 if costs[0] <= costs[1] else 1
                    self._mvd(ir, mv[0] - alist[mvp_idx][0],
                              mv[1] - alist[mvp_idx][1])
                    ir.cbin(mvp_idx, OFF["MVP_IDX"])
                ir.cbin(1 if has_resi else 0, OFF["QT_ROOT_CBF"])
            self.imaps.set_cu(x0, y0, log2, mot)
            if has_resi or midx >= 0:
                self._transform_tree(ir, cu, x0, y0, log2, 0, 0,
                                     parent_cbf_cb=True, parent_cbf_cr=True)
            return
        # intra CU in P/B slice
        ir.cbin(0, self._skip_ctx(x0, y0))
        ir.cbin(1, OFF["PRED_MODE"])              # MODE_INTRA
        self._coding_unit_intra(ir, cu)
        self.imaps.set_cu(x0, y0, log2, None)

    def _part_mode_inter(self, ir: BinIR, pm: int, log2: int) -> None:
        """part_mode binarization for inter CUs (spec 9.3.3.7, Table
        9-34; ctxInc per Table 9-37: bin0 ctx0, bin1 ctx1, bin2 ctx2
        at the minimum CB size / ctx3 otherwise (the AMP bin), bin3
        bypass)."""
        amp = getattr(self.sps, "amp_enabled", False) \
            and log2 > self.min_log2_cu
        if pm == 0:
            ir.cbin(1, OFF["PART_SIZE"])             # 2Nx2N
            return
        ir.cbin(0, OFF["PART_SIZE"])
        horiz = pm in (1, 4, 5)
        ir.cbin(1 if horiz else 0, OFF["PART_SIZE"] + 1)
        if amp:
            rect = pm in (1, 2)
            ir.cbin(1 if rect else 0, OFF["PART_SIZE"] + 3)
            if not rect:                             # 2NxnU/D, nL/nRx2N
                ir.bypass(0 if pm in (4, 6) else 1)
            return
        if not horiz and log2 == self.min_log2_cu and (1 << log2) > 8:
            ir.cbin(1, OFF["PART_SIZE"] + 2)         # Nx2N vs inter NxN

    def _inter_rect(self, ir: BinIR, cu: CodedCU, has_resi: bool) -> None:
        """Rect-partitioned inter CU (2NxN / Nx2N): part_mode + two
        prediction_units, each with its own merge/AMVP derivation on
        the rectangular geometry (spec 7.3.8.6; x265 search.cpp
        predInterSearch per-PU loop)."""
        x0, y0, log2 = cu.x0, cu.y0, cu.log2_size
        nbs = 1 << log2
        ir.cbin(0, self._skip_ctx(x0, y0))
        ir.cbin(0, OFF["PRED_MODE"])                 # MODE_INTER
        self._part_mode_inter(ir, cu.part_mode, log2)
        for pi, (px, py, pw, ph, rule) in enumerate(
                pu_partitions(x0, y0, nbs, cu.part_mode)):
            mot = cu.motion(pi)
            zp = self._z0(px, py)
            mlist = merge_candidates(self.imaps, px, py, pw, zp,
                                     self.max_merge, self.num_refs,
                                     self.ref_pocs, self.col,
                                     self.cur_poc, nbh=ph,
                                     part_rule=rule)
            midx = mlist.index(mot) if mot in mlist else -1
            if midx >= 0:
                ir.cbin(1, OFF["MERGE_FLAG"])
                self._merge_idx(ir, midx)
            else:
                ir.cbin(0, OFF["MERGE_FLAG"])
                if self.slice_type == 0:
                    self._inter_pred_idc(ir, mot.dir,
                                         self.log2_ctu - log2)
                for lst in (0, 1):
                    if not mot.has(lst):
                        continue
                    if self.num_refs[lst] > 1:
                        self._ref_idx(ir, mot.ref(lst), lst)
                    alist = amvp_candidates(self.imaps, px, py, pw, zp,
                                            lst, mot.ref(lst),
                                            self.ref_pocs, self.cur_poc,
                                            self.col, nbh=ph)
                    mv = mot.mv(lst)
                    costs = [mvd_bits(mv[0] - c[0], mv[1] - c[1])
                             for c in alist]
                    mvp_idx = 0 if costs[0] <= costs[1] else 1
                    self._mvd(ir, mv[0] - alist[mvp_idx][0],
                              mv[1] - alist[mvp_idx][1])
                    ir.cbin(mvp_idx, OFF["MVP_IDX"])
            self.imaps.set_pu(px, py, pw, ph, mot)
        ir.cbin(1 if has_resi else 0, OFF["QT_ROOT_CBF"])
        if has_resi:
            self._transform_tree(ir, cu, x0, y0, log2, 0, 0,
                                 parent_cbf_cb=True, parent_cbf_cr=True)

    def _inter_pred_idc(self, ir: BinIR, d: int, ct_depth: int) -> None:
        """inter_pred_idc binarization (spec 9.3.3.8, 2Nx2N PU)."""
        if d == 3:
            ir.cbin(1, OFF["INTER_DIR"] + ct_depth)
        else:
            ir.cbin(0, OFF["INTER_DIR"] + ct_depth)
            ir.cbin(0 if d == 1 else 1, OFF["INTER_DIR"] + 4)

    def _merge_idx(self, ir: BinIR, idx: int) -> None:
        cmax = self.max_merge - 1
        if cmax == 0:
            return
        ir.cbin(1 if idx > 0 else 0, OFF["MERGE_IDX"])
        for k in range(1, idx):
            ir.bypass(1)
        if 0 < idx < cmax:
            ir.bypass(0)

    def _ref_idx(self, ir: BinIR, ref: int, lst: int) -> None:
        cmax = self.num_refs[lst] - 1
        ir.cbin(1 if ref > 0 else 0, OFF["REF_NO"])
        if ref > 0 and cmax > 1:
            ir.cbin(1 if ref > 1 else 0, OFF["REF_NO"] + 1)
            for k in range(2, ref):
                ir.bypass(1)
            if 1 < ref < cmax:
                ir.bypass(0)

    def _mvd(self, ir: BinIR, mvd_x: int, mvd_y: int) -> None:
        """mvd_coding (spec 7.3.8.9)."""
        ax, ay = abs(mvd_x), abs(mvd_y)
        ir.cbin(1 if ax > 0 else 0, OFF["MV_RES"])
        ir.cbin(1 if ay > 0 else 0, OFF["MV_RES"])
        if ax > 0:
            ir.cbin(1 if ax > 1 else 0, OFF["MV_RES"] + 1)
        if ay > 0:
            ir.cbin(1 if ay > 1 else 0, OFF["MV_RES"] + 1)
        for v, a in ((mvd_x, ax), (mvd_y, ay)):
            if a > 0:
                if a > 1:
                    self._eg1(ir, a - 2)
                ir.bypass(1 if v < 0 else 0)

    def _eg1(self, ir: BinIR, v: int) -> None:
        """1st-order Exp-Golomb, bypass (abs_mvd_minus2 binarization)."""
        k = 1
        while v >= (1 << k):
            ir.bypass(1)
            v -= 1 << k
            k += 1
        ir.bypass(0)
        ir.bypass_bits(v, k)

    # -- coding_unit, intra ------------------------------------------------------
    def _coding_unit_intra(self, ir: BinIR, cu: CodedCU) -> None:
        log2 = cu.log2_size
        if log2 == self.min_log2_cu:
            ir.cbin(0 if cu.part_nxn else 1, OFF["PART_SIZE"])
        n_pu = 4 if cu.part_nxn else 1
        pu_size = 1 << (log2 - (1 if cu.part_nxn else 0))
        pu_pos = [(cu.x0 + (k & 1) * pu_size, cu.y0 + (k >> 1) * pu_size)
                  for k in range(n_pu)]
        mpms, flags = [], []
        for k in range(n_pu):
            mpm = derive_mpm(self.maps, pu_pos[k][0], pu_pos[k][1],
                             self.log2_ctu)
            mpms.append(mpm)
            flags.append(cu.luma_modes[k] in mpm)
            ir.cbin(1 if flags[k] else 0, OFF["ADI"])
            # modes must be visible to the next PU's MPM inside this CU
            self.maps.set_mode(pu_pos[k][0], pu_pos[k][1],
                               log2 - (1 if cu.part_nxn else 0),
                               cu.luma_modes[k])
        for k in range(n_pu):
            mode = cu.luma_modes[k]
            if flags[k]:
                idx = mpms[k].index(mode)
                ir.bypass(0 if idx == 0 else 1)
                if idx:
                    ir.bypass(idx - 1)
            else:
                rem = mode
                for m in sorted(mpms[k], reverse=True):
                    if mode > m:
                        rem -= 1
                ir.bypass_bits(rem, 5)
        # intra_chroma_pred_mode (one per CU in 4:2:0)
        if cu.chroma_idx == 4:
            ir.cbin(0, OFF["CHROMA_PRED"])
        else:
            ir.cbin(1, OFF["CHROMA_PRED"])
            ir.bypass_bits(cu.chroma_idx, 2)
        self._transform_tree(ir, cu, cu.x0, cu.y0, log2, 0, 0,
                             parent_cbf_cb=True, parent_cbf_cr=True)

    # -- transform_tree / transform_unit (7.3.8.8/7.3.8.10) -------------------
    def _cbf(self, cu: CodedCU, c_idx: int, x: int, y: int, log2: int) -> bool:
        return (c_idx, x, y, log2) in cu.coeffs

    def _cbf_region(self, cu: CodedCU, c_idx: int, x: int, y: int,
                    log2: int) -> bool:
        """cbf over a component region (covers TU-split subtrees)."""
        size = 1 << log2
        for (ci, cx, cy, _cl) in cu.coeffs:
            if ci == c_idx and x <= cx < x + size and y <= cy < y + size:
                return True
        return False

    def _transform_tree(self, ir: BinIR, cu: CodedCU, x0, y0, log2,
                        trafo_depth, blk_idx, parent_cbf_cb, parent_cbf_cr):
        sps = self.sps
        intra_split = cu.part_nxn
        max_depth = (sps.max_transform_hierarchy_depth_inter
                     if cu.is_inter else
                     sps.max_transform_hierarchy_depth_intra) + \
            (1 if intra_split else 0)
        can_code_split = (log2 <= sps.log2_max_tu_size and
                          log2 > sps.log2_min_tu_size and
                          trafo_depth < max_depth and
                          not (intra_split and trafo_depth == 0))
        split = (log2 > sps.log2_max_tu_size or
                 (intra_split and trafo_depth == 0) or
                 (cu.tu_split and trafo_depth == 0 and can_code_split) or
                 (cu.tu_split8 is not None and intra_split and
                  trafo_depth == 1 and can_code_split and
                  bool(cu.tu_split8[blk_idx])))
        if can_code_split:
            ir.cbin(1 if split else 0,
                    OFF["TRANS_SUBDIV"] + 5 - log2)
        cs = self.c_shift
        if self.is422:
            # 4:2:2: two stacked square chroma TBs per TU; cbf_cb /
            # cbf_cr are each coded twice (spec 7.3.8.8
            # ChromaArrayType == 2)
            cx, cy, clog2 = x0 >> 1, y0, log2 - 1
            half = 1 << clog2
            cbf_cb = (self._cbf_region(cu, 1, cx, cy, clog2),
                      self._cbf_region(cu, 1, cx, cy + half, clog2))
            cbf_cr = (self._cbf_region(cu, 2, cx, cy, clog2),
                      self._cbf_region(cu, 2, cx, cy + half, clog2))
            for b in cbf_cb:
                ir.cbin(1 if b else 0, OFF["QT_CBF"] + 2 + trafo_depth)
            for b in cbf_cr:
                ir.cbin(1 if b else 0, OFF["QT_CBF"] + 2 + trafo_depth)
            cbf_cb = any(cbf_cb)
            cbf_cr = any(cbf_cr)
        else:
            cx, cy, clog2 = x0 >> cs, y0 >> cs, log2 - cs
            cbf_cb = cbf_cr = False
            if log2 > 2 or cs == 0:      # 4:4:4 codes chroma cbf always
                cbf_cb = self._cbf_region(cu, 1, cx, cy, clog2)
                cbf_cr = self._cbf_region(cu, 2, cx, cy, clog2)
                if parent_cbf_cb:
                    ir.cbin(1 if cbf_cb else 0,
                            OFF["QT_CBF"] + 2 + trafo_depth)
                if parent_cbf_cr:
                    ir.cbin(1 if cbf_cr else 0,
                            OFF["QT_CBF"] + 2 + trafo_depth)
            else:
                cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if split:
            half = 1 << (log2 - 1)
            for k, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half),
                                          (half, half))):
                self._transform_tree(ir, cu, x0 + dx, y0 + dy, log2 - 1,
                                     trafo_depth + 1, k, cbf_cb, cbf_cr)
            return
        cbf_luma = self._cbf(cu, 0, x0, y0, log2)
        if (not cu.is_inter) or trafo_depth != 0 or cbf_cb or cbf_cr:
            ir.cbin(1 if cbf_luma else 0,
                    OFF["QT_CBF"] + (1 if trafo_depth == 0 else 0))
        else:
            assert cbf_luma, \
                "inter TU with no chroma cbf must have luma residual " \
                "(cbf_luma inferred 1; zero-residual merge must be SKIP)"
        self._transform_unit(ir, cu, x0, y0, log2, trafo_depth, blk_idx,
                             cbf_luma, cbf_cb, cbf_cr)

    def _dqp(self, ir: BinIR) -> None:
        """cu_qp_delta_abs/sign (spec 7.3.8.10, 9.3.3.9)."""
        delta = self._cur_ctu_qp - self._qg_pred
        a = abs(delta)
        prefix = min(a, 5)
        ir.cbin(1 if prefix > 0 else 0, OFF["DELTA_QP"])
        for k in range(1, prefix):
            ir.cbin(1, OFF["DELTA_QP"] + 1)
        if 0 < prefix < 5:
            ir.cbin(0, OFF["DELTA_QP"] + 1)
        if a >= 5:
            self._eg0(ir, a - 5)
        if a:
            ir.bypass(1 if delta < 0 else 0)
        self._dqp_coded = True

    def _eg0(self, ir: BinIR, v: int) -> None:
        k = 0
        while v >= (1 << k):
            ir.bypass(1)
            v -= 1 << k
            k += 1
        ir.bypass(0)
        ir.bypass_bits(v, k)

    def _transform_unit(self, ir: BinIR, cu: CodedCU, x0, y0, log2,
                        trafo_depth, blk_idx, cbf_luma, cbf_cb, cbf_cr):
        if not (cbf_luma or cbf_cb or cbf_cr):
            return
        if self.pps.cu_qp_delta_enabled and not self._dqp_coded:
            self._dqp(ir)
        pu_idx = 0
        if cu.part_nxn:
            half = 1 << (cu.log2_size - 1)
            pu_idx = (1 if x0 & half else 0) + (2 if y0 & half else 0)
        luma_mode = cu.luma_modes[pu_idx]
        chroma_mode = chroma_mode_from_idx(cu.chroma_idx, cu.luma_modes[0])
        if cbf_luma:
            scan = SCAN_DIAG if cu.is_inter else \
                intra_scan_idx(luma_mode, log2, 0)
            encode_residual(ir, cu.coeffs[(0, x0, y0, log2)], log2, 0,
                            scan, self.pps.sign_hide)
        # chroma TBs: at log2>2 (or any size in 4:4:4) alongside; in
        # 4:2:0 at log2==2 only on blk_idx 3 (the shared 4x4 chroma);
        # 4:2:2 codes TWO stacked square TBs per component
        cs = self.c_shift
        if self.is422:
            cx, clog2 = x0 >> 1, log2 - 1
            half = 1 << clog2
            for c_idx in (1, 2):
                for cy2 in (y0, y0 + half):
                    lv = cu.coeffs.get((c_idx, cx, cy2, clog2))
                    if lv is not None:
                        encode_residual(ir, lv, clog2, c_idx,
                                        SCAN_DIAG,
                                        self.pps.sign_hide)
            return
        if log2 > 2 or cs == 0:
            cx, cy, clog2 = x0 >> cs, y0 >> cs, log2 - cs
        elif blk_idx == 3:
            cx, cy, clog2 = (x0 - 4) >> 1, (y0 - 4) >> 1, 2
        else:
            return
        for c_idx, cbf in ((1, cbf_cb), (2, cbf_cr)):
            if cbf:
                scan = SCAN_DIAG if cu.is_inter else \
                    intra_scan_idx(chroma_mode, clog2, c_idx)
                encode_residual(ir, cu.coeffs[(c_idx, cx, cy, clog2)],
                                clog2, c_idx, scan, self.pps.sign_hide)


class SliceSyntaxDecoder:
    """CABAC slice-data parser mirroring SliceSyntaxEncoder; yields
    CodedCU objects for the validation decoder's reconstruction."""

    def __init__(self, dec: CabacDecoder, states: np.ndarray, sps, pps,
                 slice_qp: int, slice_type: int = 2, max_merge: int = 3,
                 num_refs=(1, 0), ref_pocs=((), ()),
                 cur_poc: int = 0, col_motion=None) -> None:
        self.dec = dec
        self.states = states
        self.sps = sps
        self.pps = pps
        self.qp = slice_qp
        self.slice_type = slice_type
        self.max_merge = max_merge
        self.num_refs = (num_refs, 0) if isinstance(num_refs, int) \
            else tuple(num_refs)
        if ref_pocs == ((), ()):
            # default synthetic POCs (tests / callers without a DPB):
            # L0 descending behind, L1 ascending ahead of cur_poc
            ref_pocs = (tuple(cur_poc - 1 - i
                              for i in range(self.num_refs[0])),
                        tuple(cur_poc + 1 + i
                              for i in range(self.num_refs[1])))
        self.ref_pocs = ref_pocs
        self.cur_poc = cur_poc
        self.col = col_motion
        self.maps = FrameSyntaxMaps(sps.width, sps.height)
        self.imaps = InterMaps(sps.width, sps.height, sps.log2_ctu_size)
        self.min_log2_cu = sps.log2_min_cu_size
        self.log2_ctu = sps.log2_ctu_size
        # chroma geometry shift: 1 for 4:2:0, 0 for 4:4:4;
        # 4:2:2 keeps x-shift 1 with two stacked TBs per TU
        _csp = getattr(sps, 'chroma_format_idc', 1)
        self.c_shift = 0 if _csp == 3 else 1
        self.is422 = _csp == 2
        # cu_qp_delta state (mirrors SliceSyntaxEncoder)
        self._qp_prev = slice_qp
        self._qg_pred = slice_qp
        self._dqp_coded = False
        self._cur_qp = slice_qp
        self.last_ctu_qp = slice_qp

    def _z0(self, x0: int, y0: int) -> int:
        return zscan_scalar(x0, y0, self.log2_ctu,
                            self.sps.pic_width_in_ctus)

    def _skip_ctx(self, x0: int, y0: int) -> int:
        ctx = 0
        if self.imaps.skip_at(x0 - 1, y0):
            ctx += 1
        if self.imaps.skip_at(x0, y0 - 1):
            ctx += 1
        return OFF["SKIP_FLAG"] + ctx

    def decode_ctu(self, ctu_x: int, ctu_y: int, sao_flags=(False, False)):
        """Returns (cu_list, end_of_slice_flag, sao_params_or_None)."""
        if self.pps.cu_qp_delta_enabled:
            if self.pps.entropy_coding_sync and ctu_x == 0:
                self._qp_prev = self.qp    # WPP: reset per CTU row
            self._qg_pred = self._qp_prev
            self._dqp_coded = False
            self._cur_qp = self._qp_prev
        sao = None
        if sao_flags[0] or sao_flags[1]:
            sao = self._sao_params(ctu_x, ctu_y, sao_flags)
        cus: list = []
        x0 = ctu_x << self.log2_ctu
        y0 = ctu_y << self.log2_ctu
        self._quadtree(cus, x0, y0, self.log2_ctu, 0)
        end = self.dec.decode_bin_trm()
        if self.pps.cu_qp_delta_enabled:
            ctu_qp = self._cur_qp if self._dqp_coded else self._qg_pred
            self._qp_prev = ctu_qp
            self.last_ctu_qp = ctu_qp
            for cu in cus:
                cu.qp = ctu_qp
        else:
            self.last_ctu_qp = self.qp
        return cus, end, sao

    def _sao_params(self, ctu_x: int, ctu_y: int, sao_flags):
        from ..ops.sao import SaoParams
        dec, states = self.dec, self.states
        top_row = getattr(self, "sao_top_row", 0)
        if not hasattr(self, "_sao_done"):
            self._sao_done = {}
        merge = 0
        if ctu_x > 0 and dec.decode_bin(states, OFF["SAO_MERGE"]):
            merge = 1
        if merge == 0 and ctu_y > top_row and \
                dec.decode_bin(states, OFF["SAO_MERGE"]):
            merge = 2
        if merge:
            src = self._sao_done[(ctu_y, ctu_x - 1) if merge == 1
                                 else (ctu_y - 1, ctu_x)]
            out = [SaoParams(p.type_idx, p.eo_class, p.band_pos,
                             p.offsets) for p in src]
            self._sao_done[(ctu_y, ctu_x)] = out
            return out
        out = [SaoParams(), SaoParams(), SaoParams()]
        for c_idx in (0, 1, 2):
            if c_idx == 0 and not sao_flags[0]:
                continue
            if c_idx > 0 and not sao_flags[1]:
                continue
            if c_idx == 0:
                t = self._sao_type_dec()
            elif c_idx == 1:
                t = self._sao_type_dec()
                out[2].type_idx = t
            else:
                t = out[2].type_idx
            out[c_idx].type_idx = t
            if t == 0:
                continue
            cmax = (1 << (min(self.sps.bit_depth, 10) - 5)) - 1
            absv = [self._sao_offset_abs_dec(cmax) for _ in range(4)]
            if t == 1:                         # band
                offs = []
                for a in absv:
                    if a and dec.decode_bin_ep():
                        offs.append(-a)
                    else:
                        offs.append(a)
                out[c_idx].offsets = tuple(offs)
                out[c_idx].band_pos = dec.decode_bins_ep(5)
            else:                              # edge: signs inferred
                out[c_idx].offsets = (absv[0], absv[1], -absv[2], -absv[3])
                if c_idx == 0:
                    out[0].eo_class = dec.decode_bins_ep(2)
                elif c_idx == 1:
                    ec = dec.decode_bins_ep(2)
                    out[1].eo_class = ec
                    out[2].eo_class = ec
        self._sao_done[(ctu_y, ctu_x)] = out
        return out

    def _sao_type_dec(self) -> int:
        if not self.dec.decode_bin(self.states, OFF["SAO_TYPE"]):
            return 0
        return 2 if self.dec.decode_bin_ep() else 1

    def _sao_offset_abs_dec(self, cmax: int = 7) -> int:
        v = 0
        while v < cmax and self.dec.decode_bin_ep():
            v += 1
        return v

    def _quadtree(self, cus, x0, y0, log2_size, depth):
        sps = self.sps
        inside = x0 + (1 << log2_size) <= sps.width and \
            y0 + (1 << log2_size) <= sps.height
        if inside and log2_size > self.min_log2_cu:
            split = self.dec.decode_bin(
                self.states, _split_ctx(self.maps, x0, y0, depth))
        else:
            split = not inside            # implicit split at boundary
        if split:
            half = 1 << (log2_size - 1)
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                if x0 + dx < sps.width and y0 + dy < sps.height:
                    self._quadtree(cus, x0 + dx, y0 + dy, log2_size - 1,
                                   depth + 1)
            return
        self.maps.set_cu(x0, y0, log2_size, depth)
        cus.append(self._coding_unit(x0, y0, log2_size))

    def _coding_unit(self, x0, y0, log2) -> CodedCU:
        self._tqb = False
        if self.pps.transquant_bypass:
            self._tqb = bool(self.dec.decode_bin(self.states,
                                                 OFF["TQ_BYPASS"]))
        if self.slice_type != 2:
            cu = self._coding_unit_p(x0, y0, log2)
            cu.tq_bypass = self._tqb
            return cu
        cu = self._coding_unit_intra(x0, y0, log2)
        self.imaps.set_cu(x0, y0, log2, None)
        return cu

    def _cu_from_motion(self, x0, y0, log2, mot: Motion,
                        was_skip: bool = False) -> CodedCU:
        return CodedCU(x0, y0, log2, (1,), 4, {}, is_inter=True,
                       mv=mot.mv0, ref_idx=max(mot.ref0, 0),
                       inter_dir=mot.dir, mv1=mot.mv1,
                       ref_idx1=max(mot.ref1, 0), was_skip=was_skip)

    def _coding_unit_p(self, x0, y0, log2) -> CodedCU:
        dec, states = self.dec, self.states
        nbs = 1 << log2
        z0 = self._z0(x0, y0)
        if dec.decode_bin(states, self._skip_ctx(x0, y0)):
            midx = self._merge_idx()
            mlist = merge_candidates(self.imaps, x0, y0, nbs, z0,
                                     self.max_merge, self.num_refs,
                                     self.ref_pocs, self.col,
                                     self.cur_poc)
            mot = mlist[midx]
            cu = self._cu_from_motion(x0, y0, log2, mot, was_skip=True)
            self.imaps.set_cu(x0, y0, log2, mot, skip=True)
            return cu
        if dec.decode_bin(states, OFF["PRED_MODE"]):
            cu = self._coding_unit_intra(x0, y0, log2)
            self.imaps.set_cu(x0, y0, log2, None)
            return cu
        part = self._part_mode_inter_dec(log2)
        if part:
            pus = pu_partitions(x0, y0, nbs, part)
            mots = []
            for (px, py, pw, ph, rule) in pus:
                mot = self._prediction_unit(px, py, pw, ph, rule)
                mots.append(mot)
                self.imaps.set_pu(px, py, pw, ph, mot)
            cu = CodedCU(
                x0, y0, log2, (1,), 4, {}, is_inter=True, part_mode=part,
                mv=mots[0].mv0, ref_idx=max(mots[0].ref0, 0),
                inter_dir=mots[0].dir, mv1=mots[0].mv1,
                ref_idx1=max(mots[0].ref1, 0),
                mv_b=mots[1].mv0, ref_idx_b=max(mots[1].ref0, 0),
                inter_dir_b=mots[1].dir, mv1_b=mots[1].mv1,
                ref_idx1_b=max(mots[1].ref1, 0))
            if dec.decode_bin(states, OFF["QT_ROOT_CBF"]):
                self._transform_tree(cu, x0, y0, log2, 0, 0, True, True)
            return cu
        if dec.decode_bin(states, OFF["MERGE_FLAG"]):
            midx = self._merge_idx()
            mlist = merge_candidates(self.imaps, x0, y0, nbs, z0,
                                     self.max_merge, self.num_refs,
                                     self.ref_pocs, self.col,
                                     self.cur_poc)
            mot = mlist[midx]
            cu = self._cu_from_motion(x0, y0, log2, mot)
            self.imaps.set_cu(x0, y0, log2, mot)
            # rqt_root_cbf inferred 1 for 2Nx2N merge
            self._transform_tree(cu, x0, y0, log2, 0, 0, True, True)
            return cu
        if self.slice_type == 0:
            d = self._inter_pred_idc(self.log2_ctu - log2)
        else:
            d = 1
        mvs = [(0, 0), (0, 0)]
        refs = [-1, -1]
        for lst in (0, 1):
            if not (d & (1 << lst)):
                continue
            refs[lst] = self._ref_idx(lst) if self.num_refs[lst] > 1 else 0
            mvd = self._mvd()
            mvp_idx = dec.decode_bin(states, OFF["MVP_IDX"])
            alist = amvp_candidates(self.imaps, x0, y0, nbs, z0, lst,
                                    refs[lst], self.ref_pocs,
                                    self.cur_poc, self.col)
            mvs[lst] = (alist[mvp_idx][0] + mvd[0],
                        alist[mvp_idx][1] + mvd[1])
        mot = Motion(d, mvs[0], refs[0], mvs[1], refs[1])
        cu = self._cu_from_motion(x0, y0, log2, mot)
        self.imaps.set_cu(x0, y0, log2, mot)
        if dec.decode_bin(states, OFF["QT_ROOT_CBF"]):
            self._transform_tree(cu, x0, y0, log2, 0, 0, True, True)
        return cu

    def _part_mode_inter_dec(self, log2: int) -> int:
        """part_mode parse for inter CUs (mirror of _part_mode_inter):
        0=2Nx2N, 1=2NxN, 2=Nx2N, 4=2NxnU, 5=2NxnD, 6=nLx2N, 7=nRx2N."""
        amp = getattr(self.sps, "amp_enabled", False) \
            and log2 > self.min_log2_cu
        if self.dec.decode_bin(self.states, OFF["PART_SIZE"]):
            return 0
        horiz = self.dec.decode_bin(self.states, OFF["PART_SIZE"] + 1)
        if amp:
            if self.dec.decode_bin(self.states, OFF["PART_SIZE"] + 3):
                return 1 if horiz else 2
            b3 = self.dec.decode_bin_ep()
            return (4 if not b3 else 5) if horiz else (6 if not b3 else 7)
        if horiz:
            return 1
        if log2 == self.min_log2_cu and (1 << log2) > 8:
            b = self.dec.decode_bin(self.states, OFF["PART_SIZE"] + 2)
            assert b, "inter NxN PUs unsupported"
        return 2

    def _prediction_unit(self, px: int, py: int, pw: int, ph: int,
                         rule) -> Motion:
        """prediction_unit parse on rectangular geometry (spec 7.3.8.6;
        mirror of SliceSyntaxEncoder._inter_rect's PU body)."""
        dec, states = self.dec, self.states
        zp = self._z0(px, py)
        if dec.decode_bin(states, OFF["MERGE_FLAG"]):
            midx = self._merge_idx()
            mlist = merge_candidates(self.imaps, px, py, pw, zp,
                                     self.max_merge, self.num_refs,
                                     self.ref_pocs, self.col,
                                     self.cur_poc, nbh=ph,
                                     part_rule=rule)
            return mlist[midx]
        if self.slice_type == 0:
            # ct_depth from the CU size (= max PU dimension)
            d = self._inter_pred_idc(
                self.log2_ctu - max(pw, ph).bit_length() + 1)
        else:
            d = 1
        mvs = [(0, 0), (0, 0)]
        refs = [-1, -1]
        for lst in (0, 1):
            if not (d & (1 << lst)):
                continue
            refs[lst] = self._ref_idx(lst) if self.num_refs[lst] > 1 else 0
            mvd = self._mvd()
            mvp_idx = dec.decode_bin(states, OFF["MVP_IDX"])
            alist = amvp_candidates(self.imaps, px, py, pw, zp, lst,
                                    refs[lst], self.ref_pocs,
                                    self.cur_poc, self.col, nbh=ph)
            mvs[lst] = (alist[mvp_idx][0] + mvd[0],
                        alist[mvp_idx][1] + mvd[1])
        return Motion(d, mvs[0], refs[0], mvs[1], refs[1])

    def _inter_pred_idc(self, ct_depth: int) -> int:
        if self.dec.decode_bin(self.states, OFF["INTER_DIR"] + ct_depth):
            return 3
        return 1 if self.dec.decode_bin(
            self.states, OFF["INTER_DIR"] + 4) == 0 else 2

    def _merge_idx(self) -> int:
        cmax = self.max_merge - 1
        if cmax == 0:
            return 0
        if not self.dec.decode_bin(self.states, OFF["MERGE_IDX"]):
            return 0
        idx = 1
        while idx < cmax and self.dec.decode_bin_ep():
            idx += 1
        return idx

    def _ref_idx(self, lst: int) -> int:
        cmax = self.num_refs[lst] - 1
        if not self.dec.decode_bin(self.states, OFF["REF_NO"]):
            return 0
        if cmax == 1:
            return 1
        if not self.dec.decode_bin(self.states, OFF["REF_NO"] + 1):
            return 1
        ref = 2
        while ref < cmax and self.dec.decode_bin_ep():
            ref += 1
        return ref

    def _mvd(self):
        dec, states = self.dec, self.states
        g0x = dec.decode_bin(states, OFF["MV_RES"])
        g0y = dec.decode_bin(states, OFF["MV_RES"])
        g1x = dec.decode_bin(states, OFF["MV_RES"] + 1) if g0x else 0
        g1y = dec.decode_bin(states, OFF["MV_RES"] + 1) if g0y else 0
        out = []
        for g0, g1 in ((g0x, g1x), (g0y, g1y)):
            if not g0:
                out.append(0)
                continue
            v = 1
            if g1:
                v = 2 + self._eg1()
            out.append(-v if dec.decode_bin_ep() else v)
        return tuple(out)

    def _eg1(self) -> int:
        k = 1
        base = 0
        while self.dec.decode_bin_ep():
            base += 1 << k
            k += 1
        return base + self.dec.decode_bins_ep(k)

    def _coding_unit_intra(self, x0, y0, log2) -> CodedCU:
        dec, states = self.dec, self.states
        part_nxn = False
        if log2 == self.min_log2_cu:
            part_nxn = dec.decode_bin(states, OFF["PART_SIZE"]) == 0
        n_pu = 4 if part_nxn else 1
        pu_size = 1 << (log2 - (1 if part_nxn else 0))
        pu_pos = [(x0 + (k & 1) * pu_size, y0 + (k >> 1) * pu_size)
                  for k in range(n_pu)]
        flags = [dec.decode_bin(states, OFF["ADI"]) for _ in range(n_pu)]
        modes = []
        for k in range(n_pu):
            mpm = derive_mpm(self.maps, pu_pos[k][0], pu_pos[k][1],
                             self.log2_ctu)
            if flags[k]:
                idx = 0
                if dec.decode_bin_ep():
                    idx = 1 + dec.decode_bin_ep()
                mode = mpm[idx]
            else:
                rem = dec.decode_bins_ep(5)
                for m in sorted(mpm):
                    if rem >= m:
                        rem += 1
                mode = rem
            modes.append(mode)
            self.maps.set_mode(pu_pos[k][0], pu_pos[k][1],
                               log2 - (1 if part_nxn else 0), mode)
        if dec.decode_bin(states, OFF["CHROMA_PRED"]):
            chroma_idx = dec.decode_bins_ep(2)
        else:
            chroma_idx = 4
        cu = CodedCU(x0, y0, log2, tuple(modes), chroma_idx)
        cu.tq_bypass = getattr(self, "_tqb", False)
        self._transform_tree(cu, x0, y0, log2, 0, 0, True, True)
        return cu

    def _transform_tree(self, cu, x0, y0, log2, trafo_depth, blk_idx,
                        parent_cbf_cb, parent_cbf_cr):
        sps = self.sps
        intra_split = cu.part_nxn
        max_depth = (sps.max_transform_hierarchy_depth_inter
                     if cu.is_inter else
                     sps.max_transform_hierarchy_depth_intra) + \
            (1 if intra_split else 0)
        can_code_split = (log2 <= sps.log2_max_tu_size and
                          log2 > sps.log2_min_tu_size and
                          trafo_depth < max_depth and
                          not (intra_split and trafo_depth == 0))
        if can_code_split:
            split = bool(self.dec.decode_bin(
                self.states, OFF["TRANS_SUBDIV"] + 5 - log2))
        else:
            split = (log2 > sps.log2_max_tu_size or
                     (intra_split and trafo_depth == 0))
        if trafo_depth == 0:
            cu.tu_split = bool(split)
        cbf_cb = cbf_cr = False
        if self.is422:
            cbf_cb = tuple(bool(self.dec.decode_bin(
                self.states, OFF["QT_CBF"] + 2 + trafo_depth))
                for _ in range(2))
            cbf_cr = tuple(bool(self.dec.decode_bin(
                self.states, OFF["QT_CBF"] + 2 + trafo_depth))
                for _ in range(2))
        elif log2 > 2 or self.c_shift == 0:
            if parent_cbf_cb:
                cbf_cb = bool(self.dec.decode_bin(
                    self.states, OFF["QT_CBF"] + 2 + trafo_depth))
            if parent_cbf_cr:
                cbf_cr = bool(self.dec.decode_bin(
                    self.states, OFF["QT_CBF"] + 2 + trafo_depth))
        else:
            cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if split:
            half = 1 << (log2 - 1)
            for k, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half),
                                          (half, half))):
                self._transform_tree(cu, x0 + dx, y0 + dy, log2 - 1,
                                     trafo_depth + 1, k, cbf_cb, cbf_cr)
            return
        has_cb = any(cbf_cb) if isinstance(cbf_cb, tuple) else cbf_cb
        has_cr = any(cbf_cr) if isinstance(cbf_cr, tuple) else cbf_cr
        if (not cu.is_inter) or trafo_depth != 0 or has_cb or has_cr:
            cbf_luma = bool(self.dec.decode_bin(
                self.states,
                OFF["QT_CBF"] + (1 if trafo_depth == 0 else 0)))
        else:
            cbf_luma = True                    # inferred (inter, no chroma)
        cu.tu_leaves.append((x0, y0, log2, blk_idx))
        self._transform_unit(cu, x0, y0, log2, trafo_depth, blk_idx,
                             cbf_luma, cbf_cb, cbf_cr)

    def _dqp_dec(self) -> None:
        dec, states = self.dec, self.states
        prefix = 0
        if dec.decode_bin(states, OFF["DELTA_QP"]):
            prefix = 1
            while prefix < 5 and dec.decode_bin(states,
                                                OFF["DELTA_QP"] + 1):
                prefix += 1
        a = prefix
        if prefix == 5:
            a = 5 + self._eg0_dec()
        delta = 0
        if a:
            delta = -a if dec.decode_bin_ep() else a
        self._cur_qp = self._qg_pred + delta
        self._dqp_coded = True

    def _eg0_dec(self) -> int:
        k = 0
        base = 0
        while self.dec.decode_bin_ep():
            base += 1 << k
            k += 1
        return base + (self.dec.decode_bins_ep(k) if k else 0)

    def _transform_unit(self, cu, x0, y0, log2, trafo_depth, blk_idx,
                        cbf_luma, cbf_cb, cbf_cr):
        has_cb = any(cbf_cb) if isinstance(cbf_cb, tuple) else cbf_cb
        has_cr = any(cbf_cr) if isinstance(cbf_cr, tuple) else cbf_cr
        if not (cbf_luma or has_cb or has_cr):
            return
        if self.pps.cu_qp_delta_enabled and not self._dqp_coded:
            self._dqp_dec()
        pu_idx = 0
        if cu.part_nxn:
            half = 1 << (cu.log2_size - 1)
            pu_idx = (1 if x0 & half else 0) + (2 if y0 & half else 0)
        luma_mode = cu.luma_modes[pu_idx]
        chroma_mode = chroma_mode_from_idx(cu.chroma_idx, cu.luma_modes[0])
        if cbf_luma:
            scan = SCAN_DIAG if cu.is_inter else \
                intra_scan_idx(luma_mode, log2, 0)
            cu.coeffs[(0, x0, y0, log2)] = decode_residual(
                self.dec, self.states, log2, 0, scan, self.pps.sign_hide)
        cs = self.c_shift
        if self.is422:
            cx, clog2 = x0 >> 1, log2 - 1
            half = 1 << clog2
            for c_idx, pair in ((1, cbf_cb), (2, cbf_cr)):
                for j, cy2 in enumerate((y0, y0 + half)):
                    if pair[j]:
                        cu.coeffs[(c_idx, cx, cy2, clog2)] = \
                            decode_residual(self.dec, self.states,
                                            clog2, c_idx, SCAN_DIAG,
                                            self.pps.sign_hide)
            return
        if log2 > 2 or cs == 0:
            cx, cy, clog2 = x0 >> cs, y0 >> cs, log2 - cs
        elif blk_idx == 3:
            cx, cy, clog2 = (x0 - 4) >> 1, (y0 - 4) >> 1, 2
        else:
            return
        for c_idx, cbf in ((1, cbf_cb), (2, cbf_cr)):
            if cbf:
                scan = SCAN_DIAG if cu.is_inter else \
                    intra_scan_idx(chroma_mode, clog2, c_idx)
                cu.coeffs[(c_idx, cx, cy, clog2)] = decode_residual(
                    self.dec, self.states, clog2, c_idx, scan,
                    self.pps.sign_hide)
