"""Conformance-validation HEVC decoder (intra profile subset).

The testbench role of the reference's checkasm + decoded-picture-hash
validation (SURVEY.md §4): an independent scalar implementation that
parses our bitstreams and reconstructs pictures with the golden numpy
kernels (ops.intra.predict_block_ref, ops.transform.*_ref).  Encoder recon
MUST equal decoder recon; the MD5 hash SEI seals it.

Intentionally scalar/slow — correctness oracle, not a product decoder.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..bitstream.bitreader import BitReader
from ..bitstream.nal import (
    NAL_AUD, NAL_CRA_NUT, NAL_IDR_N_LP, NAL_IDR_W_RADL, NAL_PPS,
    NAL_PREFIX_SEI, NAL_RASL_N, NAL_RASL_R, NAL_SPS, NAL_SUFFIX_SEI,
    NAL_TRAIL_N, NAL_TRAIL_R, NAL_TSA_N, NAL_TSA_R, NAL_VPS,
    is_idr, remove_emulation, split_annexb)
from ..ops.interp import mc_block_ref
from ..bitstream.sei import SEI_DECODED_PICTURE_HASH, parse_sei, plane_md5
from ..bitstream.headers import SPSInfo, PPSInfo, ProfileTierLevel
from ..entropy.cabac import CabacDecoder
from ..entropy.contexts import init_states
from ..entropy.cu_syntax import (
    SliceSyntaxDecoder, chroma_mode_from_idx)
from ..ops.intra import (
    predict_block_ref, substitute_refs, strong_smoothing_condition)
from ..ops.transform import dequant_ref, idct_ref
from ..frame.zscan import s_vector_coords, zscan_index
from ..frame.recon_intra import chroma_qp


def parse_ptl(br, msl: int = 0) -> ProfileTierLevel:
    ptl = ProfileTierLevel()
    br.u(2)
    ptl.tier_flag = br.u(1)
    ptl.profile_idc = br.u(5)
    br.u(32)                              # compatibility flags
    ptl.progressive_source = br.flag()
    ptl.interlaced_source = br.flag()
    ptl.non_packed = br.flag()
    ptl.frame_only = br.flag()
    br.u(32)
    br.u(12)
    ptl.level_idc = br.u(8)
    if msl > 0:
        pp = [(br.flag(), br.flag()) for _ in range(msl)]
        for _ in range(msl, 8):
            br.u(2)                       # reserved_zero_2bits
        for (prof, lev) in pp:
            assert not prof, "sub-layer PTL profiles unsupported"
            if lev:
                br.u(8)
    return ptl


def parse_sps(rbsp: bytes) -> SPSInfo:
    br = BitReader(rbsp)
    s = SPSInfo()
    br.u(4)                               # sps_video_parameter_set_id
    msl = br.u(3)                         # max_sub_layers_minus1
    s.max_sub_layers = msl + 1
    br.flag()                             # temporal_id_nesting
    s.ptl = parse_ptl(br, msl)
    br.ue()                               # sps id
    s.chroma_format_idc = br.ue()
    if s.chroma_format_idc == 3:
        br.flag()
    s.width = br.ue()
    s.height = br.ue()
    if br.flag():                         # conformance window
        br.ue()
        s.conf_win_right = br.ue()
        br.ue()
        s.conf_win_bottom = br.ue()
    s.bit_depth = br.ue() + 8
    br.ue()                               # chroma bit depth
    s.log2_max_poc_lsb = br.ue() + 4
    sloi = br.flag()                      # sub_layer_ordering_info_present
    for _ in range((msl + 1) if sloi else 1):
        s.max_dec_pic_buffering = br.ue() + 1
        s.num_reorder_pics = br.ue()
        br.ue()                           # max_latency
    s.log2_min_cu_size = br.ue() + 3
    s.log2_ctu_size = br.ue() + s.log2_min_cu_size
    s.log2_min_tu_size = br.ue() + 2
    s.log2_max_tu_size = br.ue() + s.log2_min_tu_size
    s.max_transform_hierarchy_depth_inter = br.ue()
    s.max_transform_hierarchy_depth_intra = br.ue()
    s.scaling_list_enabled = br.flag()
    s.scaling_lists = None
    if s.scaling_list_enabled:
        if br.flag():                 # sps_scaling_list_data_present
            s.scaling_lists = _parse_scaling_list_data(br)
    s.amp_enabled = br.flag()
    s.sao_enabled = br.flag()
    assert br.flag() == 0, "pcm unsupported"
    num_rps = br.ue()
    assert num_rps == 0, "SPS RPS unsupported"
    assert br.flag() == 0, "long-term refs unsupported"
    s.temporal_mvp = br.flag()
    s.strong_intra_smoothing = br.flag()
    if br.flag():                         # vui_parameters_present
        _parse_vui(br, s)
    br.flag()                             # extensions
    return s


def _parse_scaling_list_data(br: BitReader):
    """scaling_list_data() (spec 7.3.4) -> (lists, dc) in the
    constants.scaling layout (raster signaled matrices + DC)."""
    from ..constants.scaling import (diag_scan_positions, FLAT4,
                                     _D8_INTRA, _D8_INTER)
    lists: dict = {}
    dc: dict = {}
    for size_id in range(4):
        step = 3 if size_id == 3 else 1
        for list_id in range(0, 6, step):
            n = 4 if size_id == 0 else 8
            if not br.flag():         # scaling_list_pred_mode_flag == 0
                delta = br.ue()       # scaling_list_pred_matrix_id_delta
                if delta == 0:        # spec default matrix
                    intra = list_id < 3
                    m = FLAT4.copy() if size_id == 0 else \
                        (_D8_INTRA if intra else _D8_INTER).copy()
                    lists[(size_id, list_id)] = m
                    if size_id >= 2:
                        dc[(size_id, list_id)] = 16
                else:                 # copy an earlier list
                    ref = list_id - delta * step
                    lists[(size_id, list_id)] = \
                        lists[(size_id, ref)].copy()
                    if size_id >= 2:
                        dc[(size_id, list_id)] = dc[(size_id, ref)]
                continue
            next_coef = 8
            if size_id > 1:
                d = br.se() + 8       # scaling_list_dc_coef_minus8
                dc[(size_id, list_id)] = d
                next_coef = d
            m = np.zeros((n, n), np.int32)
            for (x, y) in diag_scan_positions(n):
                next_coef = (next_coef + br.se() + 256) % 256
                m[y, x] = next_coef
            lists[(size_id, list_id)] = m
        if size_id == 3:
            # chroma 32x32 lists inherit the 16x16 ones (the spec
            # signals only the two luma lists at sizeId 3; the
            # reference fills chroma identically, scalinglist.cpp:327)
            for list_id in (1, 2, 4, 5):
                lists[(3, list_id)] = lists[(2, list_id)].copy()
                dc[(3, list_id)] = dc[(2, list_id)]
    return lists, dc


def _parse_vui(br: BitReader, s: SPSInfo) -> None:
    if br.flag():                         # aspect_ratio_info
        idc = br.u(8)
        if idc == 255:
            s.sar = (br.u(16), br.u(16))
    if br.flag():                         # overscan
        br.flag()
    if br.flag():                         # video_signal_type
        br.u(3)
        s.video_full_range = bool(br.flag())
        if br.flag():                     # colour_description
            s.colour_primaries = br.u(8)
            s.transfer_characteristics = br.u(8)
            s.matrix_coeffs = br.u(8)
    if br.flag():                         # chroma_loc
        br.ue()
        br.ue()
    br.flag()                             # neutral_chroma
    br.flag()                             # field_seq
    br.flag()                             # frame_field_info
    if br.flag():                         # default_display_window
        br.ue(); br.ue(); br.ue(); br.ue()
    if br.flag():                         # timing info
        d = br.u(32)
        n = br.u(32)
        s.fps = (n, d)
        br.flag()                         # poc_proportional
        if br.flag():                     # hrd_parameters (E.2.2)
            _parse_hrd(br, s)
    br.flag()                             # bitstream_restriction


def _parse_hrd(br: BitReader, s: SPSInfo) -> None:
    """hrd_parameters mirror of headers._write_hrd (one CPB, NAL only)."""
    nal_p = br.flag()
    vcl_p = br.flag()
    assert nal_p and not vcl_p, "only NAL HRD supported"
    assert br.flag() == 0                 # sub_pic_hrd
    br_scale = br.u(4)
    cpb_scale = br.u(4)
    br.u(5)                               # initial_cpb_removal_delay_len
    br.u(5)                               # au_cpb_removal_delay_len
    br.u(5)                               # dpb_output_delay_len
    fixed = br.flag()                     # fixed_pic_rate_general
    if fixed:
        br.ue()                           # elemental_duration_minus1
    else:
        if br.flag():                     # fixed_pic_rate_within_cvs
            br.ue()
        else:
            br.flag()                     # low_delay_hrd
    cpb_cnt = br.ue() + 1
    for _ in range(cpb_cnt):
        s.hrd = True
        s.hrd_bitrate = (br.ue() + 1) << (6 + br_scale)
        s.hrd_cpb_size = (br.ue() + 1) << (4 + cpb_scale)
        s.hrd_cbr = bool(br.flag())


def parse_pps(rbsp: bytes) -> PPSInfo:
    br = BitReader(rbsp)
    q = PPSInfo()
    br.ue()                               # pps id
    br.ue()                               # sps id
    assert br.flag() == 0                 # dependent slices
    br.flag()                             # output_flag_present
    br.u(3)                               # extra slice header bits
    q.sign_hide = br.flag()
    q.cabac_init_present = br.flag()
    q.num_ref_idx_l0_default = br.ue() + 1
    q.num_ref_idx_l1_default = br.ue() + 1
    q.init_qp = br.se() + 26
    br.flag()                             # constrained intra
    assert br.flag() == 0, "transform skip unsupported"
    q.cu_qp_delta_enabled = br.flag()
    if q.cu_qp_delta_enabled:
        q.diff_cu_qp_delta_depth = br.ue()
    q.cb_qp_offset = br.se()
    q.cr_qp_offset = br.se()
    br.flag()                             # slice chroma qp offsets present
    q.weighted_pred = br.flag()
    q.weighted_bipred = br.flag()
    q.transquant_bypass = br.flag()
    assert br.flag() == 0, "tiles unsupported"
    q.entropy_coding_sync = br.flag()
    q.loop_filter_across_slices = br.flag()
    if br.flag():                         # deblocking_filter_control_present
        assert br.flag() == 0             # override enabled
        q.deblocking_disabled = br.flag()
        if not q.deblocking_disabled:
            q.deblock_beta_offset_div2 = br.se()
            q.deblock_tc_offset_div2 = br.se()
    return q


@dataclass
class DecodedPicture:
    poc: int
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    md5: bytes = b""
    sei_md5: Optional[bytes] = None
    cus: Optional[list] = None        # CodedCU list (analysis tooling)
    temporal_id: int = 0              # nuh_temporal_id (sub-layers)


class Decoder:
    """Annex-B stream -> decoded pictures."""

    def __init__(self) -> None:
        self.sps: Optional[SPSInfo] = None
        self.pps: Optional[PPSInfo] = None
        self.pictures: List[DecodedPicture] = []
        self._dpb: Dict[int, tuple] = {}      # poc -> (y, u, v) planes
        self._ref_l0: List[tuple] = []
        self._ref_l1: List[tuple] = []
        self._tq_bypass = False
        self._col_store = {}                  # poc -> ColMotion
        self.prefix_seis: List[tuple] = []    # (payload_type, bytes)
        self.unspecified_nals: List[tuple] = []   # (nal_type, bytes)
        self._cur_wp = None                   # (denom, per-L0-ref (w,o))

    def decode(self, stream: bytes) -> List[DecodedPicture]:
        for nal in split_annexb(stream):
            nal_type = (nal[0] >> 1) & 0x3F
            rbsp = remove_emulation(nal[2:])
            if nal_type in (NAL_VPS, NAL_AUD):
                continue
            if nal_type == NAL_SPS:
                self.sps = parse_sps(rbsp)
            elif nal_type == NAL_PPS:
                self.pps = parse_pps(rbsp)
            elif nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP,
                              NAL_TRAIL_R, NAL_TRAIL_N, NAL_CRA_NUT,
                              NAL_RASL_R, NAL_RASL_N,
                              NAL_TSA_R, NAL_TSA_N):
                pic = self._decode_slice(nal_type, rbsp)
                if pic is not None:
                    pic.temporal_id = (nal[1] & 7) - 1
                    self.pictures.append(pic)
            elif nal_type == NAL_PREFIX_SEI:
                self.prefix_seis.extend(parse_sei(rbsp))
            elif nal_type == NAL_SUFFIX_SEI:
                for ptype, payload in parse_sei(rbsp):
                    if ptype == SEI_DECODED_PICTURE_HASH and \
                            payload[0] == 0 and self.pictures:
                        self.pictures[-1].sei_md5 = payload[1:49]
            elif nal_type >= 48:
                # UNSPECIFIED range (Dolby Vision RPU rides as 62):
                # record and continue, as any conforming decoder must
                self.unspecified_nals.append((nal_type, bytes(nal)))
            else:
                raise NotImplementedError(f"nal type {nal_type}")
        return self.pictures

    def _parse_pred_weight_table(self, br: BitReader, n_l0: int,
                                 n_l1: int = 0):
        """pred_weight_table (7.3.6.3) with luma and chroma explicit
        weights (+ L1 luma for B slices).  Returns
        (denom, luma_wps, chroma_wps, luma_wps_l1)."""
        denom = br.ue()
        cdenom = denom + br.se()              # delta_chroma_log2_weight_denom
        lflags = [br.flag() for _ in range(n_l0)]
        cflags = [br.flag() for _ in range(n_l0)]
        wps = []
        cps = []
        for lf, cf in zip(lflags, cflags):
            if lf:
                w = br.se() + (1 << denom)
                o = br.se()
                wps.append((w, o))
            else:
                wps.append(None)
            if cf:
                pair = []
                for _ in range(2):
                    cw = br.se() + (1 << cdenom)
                    # spec 7.4.7.3: o = delta + 128 - ((128*w)>>denom)
                    co = br.se() + 128 - ((128 * cw) >> cdenom)
                    pair.append((cw, max(-128, min(127, co))))
                cps.append(tuple(pair))
            else:
                cps.append(None)
        wps1 = []
        if n_l1:
            lflags1 = [br.flag() for _ in range(n_l1)]
            cflags1 = [br.flag() for _ in range(n_l1)]
            assert not any(cflags1), "L1 chroma weights unsupported"
            for lf in lflags1:
                if lf:
                    w = br.se() + (1 << denom)
                    o = br.se()
                    wps1.append((w, o))
                else:
                    wps1.append(None)
        return (denom, wps, cps, wps1)

    # -- slice ----------------------------------------------------------------
    def _decode_slice(self, nal_type: int, rbsp: bytes) -> DecodedPicture:
        sps, pps = self.sps, self.pps
        br = BitReader(rbsp)
        first_slice = bool(br.flag())
        if 16 <= nal_type <= 23:
            br.flag()                     # no_output_of_prior_pics
        br.ue()                           # pps id
        seg_addr = 0
        if not first_slice:
            total = self.sps.pic_width_in_ctus * \
                self.sps.pic_height_in_ctus
            seg_addr = br.u(max(1, (total - 1).bit_length()))
        slice_type = br.ue()
        poc = 0
        rps_neg, rps_pos = [], []
        if not is_idr(nal_type):
            # PicOrderCntVal derivation (spec 8.3.1): MSB from the lsb
            # delta against prevTid0Pic (any non-RASL picture here)
            lsb = br.u(sps.log2_max_poc_lsb)
            max_lsb = 1 << sps.log2_max_poc_lsb
            prev = getattr(self, "_prev_poc", 0)
            prev_lsb = prev & (max_lsb - 1)
            prev_msb = prev - prev_lsb
            if lsb < prev_lsb and (prev_lsb - lsb) >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif lsb > prev_lsb and (lsb - prev_lsb) > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            poc = msb + lsb
            if nal_type not in (NAL_RASL_R, NAL_RASL_N):
                self._prev_poc = poc
            assert br.flag() == 0          # short_term_ref_pic_set_sps_flag
            rps_neg, rps_pos = self._parse_st_rps(br)
            sh_tmvp = False
            if sps.temporal_mvp:
                sh_tmvp = bool(br.flag())
        sao_luma = sao_chroma = False
        if sps.sao_enabled:
            sao_luma = br.flag()
            sao_chroma = br.flag()
        num_refs = (1, 0)
        col_l0, col_ref_idx = True, 0
        max_merge = 3
        self._cur_wp = None
        if slice_type != 2:
            n_l1 = pps.num_ref_idx_l1_default
            if br.flag():                  # num_ref_idx_active_override
                n_l0 = br.ue() + 1
                if slice_type == 0:
                    n_l1 = br.ue() + 1
            else:
                n_l0 = pps.num_ref_idx_l0_default
            num_refs = (n_l0, n_l1 if slice_type == 0 else 0)
            if slice_type == 0:
                br.flag()                  # mvd_l1_zero
            if sh_tmvp:
                col_l0 = True
                if slice_type == 0:
                    col_l0 = bool(br.flag())   # collocated_from_l0
                ncol = n_l0 if col_l0 else n_l1
                col_ref_idx = br.ue() if ncol > 1 else 0
            self._cur_wp = None
            if pps.weighted_pred and slice_type == 1:
                self._cur_wp = self._parse_pred_weight_table(br, n_l0)
            elif pps.weighted_bipred and slice_type == 0:
                self._cur_wp = self._parse_pred_weight_table(br, n_l0,
                                                             n_l1)
            max_merge = 5 - br.ue()
        qp = br.se() + pps.init_qp
        if pps.loop_filter_across_slices and \
                (sao_luma or sao_chroma or not pps.deblocking_disabled):
            br.flag()
        entry_points = []
        if pps.entropy_coding_sync:
            n_ep = br.ue()
            if n_ep:
                nbits = br.ue() + 1      # offset_len_minus1
                entry_points = [br.u(nbits) + 1 for _ in range(n_ep)]
        br.u(1)                           # byte_alignment stop bit
        br.byte_align()
        data = rbsp[br.byte_pos:]

        # reference lists from the RPS (spec 8.3.2/8.3.4): L0 = used
        # negative refs (closest first) then positive; L1 = positive then
        # negative.  Pictures fetched from the decoded-picture store.
        neg_pocs = [poc + d for (d, used) in rps_neg if used]
        pos_pocs = [poc + d for (d, used) in rps_pos if used]
        l0_pocs = (neg_pocs + pos_pocs)[:num_refs[0]]
        l1_pocs = (pos_pocs + neg_pocs)[:num_refs[1]]
        self._ref_l0 = [self._dpb[p] for p in l0_pocs]
        self._ref_l1 = [self._dpb[p] for p in l1_pocs]
        ref_pocs = (tuple(l0_pocs), tuple(l1_pocs))

        states = init_states(slice_type, qp)
        col = None
        if not is_idr(nal_type) and sh_tmvp:
            # the signaled collocated picture (list + ref idx), viewed
            # through this slice's collocated_from_l0_flag (8.5.3.2.9)
            col_pocs = l0_pocs if col_l0 else l1_pocs
            if col_ref_idx < len(col_pocs):
                col = self._col_store.get(col_pocs[col_ref_idx])
                if col is not None and col.from_l0 != col_l0:
                    from dataclasses import replace
                    col = replace(col, from_l0=col_l0)
        syn = SliceSyntaxDecoder(CabacDecoder(data), states, sps, pps, qp,
                                 slice_type, max_merge, num_refs,
                                 ref_pocs, poc, col_motion=col)

        h, w = sps.height, sps.width
        idc = sps.chroma_format_idc
        csx = 0 if idc == 3 else 1           # horizontal chroma shift
        csy = 1 if idc == 1 else 0           # vertical chroma shift
        cs = csx
        self._cs = csx
        self._csy = csy
        self._is422 = idc == 2
        n_ctu_x = sps.pic_width_in_ctus
        n_ctu_y = sps.pic_height_in_ctus
        if first_slice:
            self._pic = {
                "y": np.zeros((h, w), np.int32),
                "u": np.zeros((h >> csy, w >> csx), np.int32),
                "v": np.zeros((h >> csy, w >> csx), np.int32),
                "all_cus": [],
                "sao_grid": [[None] * n_ctu_x for _ in range(n_ctu_y)],
                "qp_grid": np.full((n_ctu_y, n_ctu_x), qp, np.int32),
            }
        st_pic = self._pic
        y, u, v = st_pic["y"], st_pic["u"], st_pic["v"]
        all_cus = st_pic["all_cus"]
        sao_grid = st_pic["sao_grid"]
        qp_grid = st_pic["qp_grid"]
        qp_cb = chroma_qp(qp, pps.cb_qp_offset, sps.chroma_format_idc)
        qp_cr = chroma_qp(qp, pps.cr_qp_offset, sps.chroma_format_idc)
        # intra prediction must not cross the slice's top boundary
        self._slice_top = (seg_addr // n_ctu_x) << sps.log2_ctu_size
        # SAO merge-up is not signalable across a slice boundary
        syn.sao_top_row = seg_addr // n_ctu_x

        use_wpp = pps.entropy_coding_sync and n_ctu_y > 1
        sub_offsets = [0]
        for ep in entry_points:
            sub_offsets.append(sub_offsets[-1] + ep)
        end = 0
        sync_states = None
        total_ctus = n_ctu_x * n_ctu_y
        addr = seg_addr
        while addr < total_ctus and not end:
            cy, cx = addr // n_ctu_x, addr % n_ctu_x
            if use_wpp and cx == 0 and cy > 0:
                # new substream: fresh arithmetic engine, synced contexts
                syn.dec = CabacDecoder(data[sub_offsets[cy]:])
                syn.states = sync_states.copy()
                states = syn.states
            if True:
                cus, end, sao = syn.decode_ctu(
                    cx, cy, (sao_luma, sao_chroma))
                sao_grid[cy][cx] = sao
                qp_grid[cy, cx] = syn.last_ctu_qp
                all_cus.extend(cus)
                for cu in cus:
                    cqp = cu.qp if cu.qp >= 0 else qp
                    self._recon_cu(cu, y, u, v, cqp,
                                   chroma_qp(cqp, pps.cb_qp_offset,
                                             sps.chroma_format_idc),
                                   chroma_qp(cqp, pps.cr_qp_offset,
                                             sps.chroma_format_idc))
                if use_wpp and cx == min(1, n_ctu_x - 1):
                    sync_states = syn.states.copy()
                if use_wpp and cx == n_ctu_x - 1 and not end:
                    assert syn.dec.decode_bin_trm() == 1, \
                        "missing end_of_subset bit"
            addr += 1
        assert end == 1, "missing end_of_slice flag"
        if addr < total_ctus:
            return None                   # more slices of this picture
        if not pps.deblocking_disabled:
            from ..ops.deblock import (
                deblock_luma_ref, deblock_chroma_ref, chroma_on_maps)
            bs_v, bs_h = self._bs_maps_exact(all_cus, w, h, ref_pocs)
            on_v, on_h = chroma_on_maps(bs_v, bs_h, h >> csy, w >> csx,
                                        csp=sps.chroma_format_idc)
            qarg = qp_grid if pps.cu_qp_delta_enabled else qp
            y = deblock_luma_ref(y, bs_v, bs_h, qarg,
                                 pps.deblock_beta_offset_div2,
                                 pps.deblock_tc_offset_div2,
                                 sps.bit_depth, sps.log2_ctu_size)
            qmap = qp_grid if pps.cu_qp_delta_enabled else None
            u = deblock_chroma_ref(u, on_v, on_h, qp_cb,
                                   pps.deblock_tc_offset_div2,
                                   sps.bit_depth, qmap,
                                   pps.cb_qp_offset, sps.log2_ctu_size,
                                   csp=sps.chroma_format_idc)
            v = deblock_chroma_ref(v, on_v, on_h, qp_cr,
                                   pps.deblock_tc_offset_div2,
                                   sps.bit_depth, qmap,
                                   pps.cr_qp_offset, sps.log2_ctu_size,
                                   csp=sps.chroma_format_idc)
        if sao_luma or sao_chroma:
            from ..ops.sao import sao_apply_ref
            ctu = 1 << sps.log2_ctu_size
            py = [[sao_grid[cy][cx][0] for cx in range(n_ctu_x)]
                  for cy in range(n_ctu_y)]
            pb = [[sao_grid[cy][cx][1] for cx in range(n_ctu_x)]
                  for cy in range(n_ctu_y)]
            pr = [[sao_grid[cy][cx][2] for cx in range(n_ctu_x)]
                  for cy in range(n_ctu_y)]
            if sao_luma:
                y = sao_apply_ref(y, py, ctu, sps.bit_depth)
            if sao_chroma:
                ctile = (ctu, ctu >> 1) if idc == 2 else ctu >> cs
                u = sao_apply_ref(u, pb, ctile, sps.bit_depth)
                v = sao_apply_ref(v, pr, ctile, sps.bit_depth)
        dt = np.uint8 if sps.bit_depth == 8 else np.uint16
        pic = DecodedPicture(poc, y.astype(dt), u.astype(dt),
                             v.astype(dt))
        pic.md5 = plane_md5(pic.y, pic.u, pic.v, bit_depth=sps.bit_depth)
        pic.cus = all_cus
        if is_idr(nal_type):
            self._dpb.clear()
            self._col_store.clear()
            self._prev_poc = 0
        self._dpb[poc] = (pic.y, pic.u, pic.v)
        if sps.temporal_mvp:
            from ..entropy.mv_pred import ColMotion
            nby, nbx = h // 16, w // 16
            d = np.zeros((nby, nbx), np.int8)
            mv = np.zeros((nby, nbx, 2, 2), np.int32)
            rp = np.zeros((nby, nbx, 2), np.int64)
            for cu in all_cus:
                if not cu.is_inter:
                    continue
                # motion compression (spec 8.5.3.2.8): each 16x16 cell
                # samples the PU covering its TOP-LEFT 4x4 — per-PU
                # geometry, and sub-16 CUs off the corner don't clobber
                for (gx, gy, gw, gh, m) in self._pu_geometry(cu):
                    px, py = cu.x0 + gx, cu.y0 + gy
                    cx0 = -(-px // 16)         # first cell whose corner
                    cy0 = -(-py // 16)         # falls inside this PU
                    cx1 = (px + gw - 1) // 16
                    cy1 = (py + gh - 1) // 16
                    if cx1 < cx0 or cy1 < cy0:
                        continue
                    sl = (slice(cy0, cy1 + 1), slice(cx0, cx1 + 1))
                    d[sl] = m.dir
                    mv[sl + (0,)] = m.mv0
                    mv[sl + (1,)] = m.mv1
                    if m.dir & 1:
                        rp[sl + (0,)] = ref_pocs[0][m.ref0]
                    if m.dir & 2:
                        rp[sl + (1,)] = ref_pocs[1][m.ref1]
            self._col_store[poc] = ColMotion(poc, d, mv, rp)
        return pic

    @staticmethod
    def _pu_geometry(cu):
        """(dx, dy, w, h, Motion) per PU of an inter CU (7.4.9.4
        partition geometry; AMP quarters at n/4)."""
        n = 1 << cu.log2_size
        pm = getattr(cu, "part_mode", 0)
        if pm == 0:
            return [(0, 0, n, n, cu.motion(0))]
        q = n // 4
        geo = {1: [(0, 0, n, n // 2), (0, n // 2, n, n // 2)],
               2: [(0, 0, n // 2, n), (n // 2, 0, n // 2, n)],
               4: [(0, 0, n, q), (0, q, n, n - q)],
               5: [(0, 0, n, n - q), (0, n - q, n, q)],
               6: [(0, 0, q, n), (q, 0, n - q, n)],
               7: [(0, 0, n - q, n), (n - q, 0, q, n)]}[pm]
        return [(gx, gy, gw, gh, cu.motion(i))
                for i, (gx, gy, gw, gh) in enumerate(geo)]

    def _bs_maps_exact(self, all_cus, w, h, ref_pocs):
        """Boundary-strength maps painted directly from the parsed
        CU/TU/PU geometry at 4x4 granularity (spec 8.7.2.4) — exact for
        any CU size (incl. 8x8 min CUs of external streams), rect/AMP
        PUs and arbitrary TU trees.  Returns (bs_v, bs_h) in the
        deblock_luma_ref layout: bs_v (H/4, W/8-1), bs_h (H/8-1, W/4)."""
        w4, h4 = w // 4, h // 4
        intra4 = np.ones((h4, w4), bool)
        dir4 = np.zeros((h4, w4), np.int32)
        mv04 = np.zeros((h4, w4, 2), np.int64)
        mv14 = np.zeros((h4, w4, 2), np.int64)
        poc04 = np.zeros((h4, w4), np.int64)
        poc14 = np.zeros((h4, w4), np.int64)
        cbf4 = np.zeros((h4, w4), bool)
        tedge_v = np.zeros((h4, w4), bool)   # transform edge at x=4*x4
        tedge_h = np.zeros((h4, w4), bool)
        pedge_v = np.zeros((h4, w4), bool)   # prediction edge at x=4*x4
        pedge_h = np.zeros((h4, w4), bool)

        pu_geometry = self._pu_geometry
        for cu in all_cus:
            n = 1 << cu.log2_size
            x4a, y4a = cu.x0 // 4, cu.y0 // 4
            n4 = n // 4
            sl = (slice(y4a, y4a + n4), slice(x4a, x4a + n4))
            intra4[sl] = not cu.is_inter
            # transform edges from the parsed TU leaves; a skip CU
            # (no transform tree) is still one cbf=0 TB whose boundary
            # is a transform edge for the neighbor-cbf term
            for (tx, ty, tl, _b) in (cu.tu_leaves or
                                     ((cu.x0, cu.y0, cu.log2_size, 0),)):
                tn4 = (1 << tl) // 4
                tedge_v[ty // 4:ty // 4 + tn4, tx // 4] = True
                tedge_h[ty // 4, tx // 4:tx // 4 + tn4] = True
            if cu.is_inter:
                for (gx, gy, gw, gh, m) in pu_geometry(cu):
                    px4 = (cu.x0 + gx) // 4
                    py4 = (cu.y0 + gy) // 4
                    psl = (slice(py4, py4 + gh // 4),
                           slice(px4, px4 + gw // 4))
                    dir4[psl] = m.dir
                    if m.dir & 1:
                        mv04[psl] = m.mv0
                        poc04[psl] = ref_pocs[0][m.ref0]
                    if m.dir & 2:
                        mv14[psl] = m.mv1
                        poc14[psl] = ref_pocs[1][m.ref1]
                    pedge_v[py4:py4 + gh // 4, px4] = True
                    pedge_h[py4, px4:px4 + gw // 4] = True
            else:
                pedge_v[sl[0], x4a] = True
                pedge_h[y4a, sl[1]] = True
            for (ci, kx, ky, kl), lv in cu.coeffs.items():
                if ci != 0 or not np.any(lv):
                    continue
                kn4 = max(1, (1 << kl) // 4)
                cbf4[ky // 4:ky // 4 + kn4, kx // 4:kx // 4 + kn4] = True

        def motion_differs(p, q):
            dp, dq = dir4[p], dir4[q]
            np_ = (dp & 1) + ((dp >> 1) & 1)
            nq_ = (dq & 1) + ((dq >> 1) & 1)
            diff = np_ != nq_
            ap = np.where(dp == 2, poc14[p], poc04[p])
            amvp = np.where((dp == 2)[..., None], mv14[p], mv04[p])
            aq = np.where(dq == 2, poc14[q], poc04[q])
            amvq = np.where((dq == 2)[..., None], mv14[q], mv04[q])
            uni = (np_ == 1) & (nq_ == 1)
            uni_diff = (ap != aq) | \
                (np.abs(amvp - amvq).max(axis=-1) >= 4)
            bi = (np_ == 2) & (nq_ == 2)
            pair_p = np.stack([np.minimum(poc04[p], poc14[p]),
                               np.maximum(poc04[p], poc14[p])], -1)
            pair_q = np.stack([np.minimum(poc04[q], poc14[q]),
                               np.maximum(poc04[q], poc14[q])], -1)
            pair_diff = np.any(pair_p != pair_q, axis=-1)
            d00 = np.abs(mv04[p] - mv04[q]).max(axis=-1)
            d11 = np.abs(mv14[p] - mv14[q]).max(axis=-1)
            d01 = np.abs(mv04[p] - mv14[q]).max(axis=-1)
            d10 = np.abs(mv14[p] - mv04[q]).max(axis=-1)
            straight = (d00 < 4) & (d11 < 4)
            swapped = (d01 < 4) & (d10 < 4)
            same_refs = poc04[p] == poc14[p]
            l0_matches = poc04[p] == poc04[q]
            bi_diff = pair_diff | np.where(
                same_refs, ~(straight | swapped),
                np.where(l0_matches, ~straight, ~swapped))
            return np.where(diff, True,
                            np.where(uni, uni_diff,
                                     np.where(bi, bi_diff, True)))

        ev = w // 8 - 1
        eh = h // 8 - 1
        bs_v = np.zeros((h4, max(ev, 0)), dtype=np.int32)
        bs_h = np.zeros((max(eh, 0), w4), dtype=np.int32)
        segs = np.arange(h4)
        for e in range(ev):
            xe = (e + 1) * 8 // 4
            p = (segs, np.full_like(segs, xe - 1))
            q = (segs, np.full_like(segs, xe))
            te = tedge_v[:, xe]
            exists = te | pedge_v[:, xe]
            two = intra4[p] | intra4[q]
            one = (te & (cbf4[p] | cbf4[q])) | motion_differs(p, q)
            bs_v[:, e] = np.where(exists, np.where(two, 2,
                                  np.where(one, 1, 0)), 0)
        segs = np.arange(w4)
        for e in range(eh):
            ye = (e + 1) * 8 // 4
            p = (np.full_like(segs, ye - 1), segs)
            q = (np.full_like(segs, ye), segs)
            te = tedge_h[ye, :]
            exists = te | pedge_h[ye, :]
            two = intra4[p] | intra4[q]
            one = (te & (cbf4[p] | cbf4[q])) | motion_differs(p, q)
            bs_h[e, :] = np.where(exists, np.where(two, 2,
                                  np.where(one, 1, 0)), 0)
        return bs_v, bs_h

    def _parse_st_rps(self, br: BitReader):
        """Returns ([(delta_poc, used)...neg], [...pos])."""
        n_neg = br.ue()
        n_pos = br.ue()
        neg, pos = [], []
        prev = 0
        for _ in range(n_neg):
            delta = prev - (br.ue() + 1)
            neg.append((delta, br.flag()))
            prev = delta
        prev = 0
        for _ in range(n_pos):
            delta = prev + br.ue() + 1
            pos.append((delta, br.flag()))
            prev = delta
        return neg, pos

    # -- reconstruction (golden scalar path) -----------------------------------
    def _recon_cu(self, cu, y, u, v, qp, qp_cb, qp_cr) -> None:
        sps = self.sps
        bd = sps.bit_depth
        self._tq_bypass = bool(getattr(cu, "tq_bypass", False))
        if cu.is_inter:
            self._recon_inter_cu(cu, y, u, v, qp, qp_cb, qp_cr)
            return
        if cu.part_nxn:
            half = 1 << (cu.log2_size - 1)
            if cu.tu_leaves:
                # follow the parsed TU tree (8x8 TUs, or 4x4 DST
                # leaves under a depth-1 split_transform_flag); each
                # TB re-predicts from recon with its covering PU's
                # mode (spec 8.4.4.2)
                for (tx, ty, tl, _blk) in cu.tu_leaves:
                    pu = (1 if (tx - cu.x0) & half else 0) + \
                        (2 if (ty - cu.y0) & half else 0)
                    self._recon_tb(y, tx, ty, tl, cu.luma_modes[pu],
                                   0, qp, cu.coeffs.get((0, tx, ty,
                                                         tl)))
            else:
                for k, (dx, dy) in enumerate(((0, 0), (half, 0),
                                              (0, half), (half, half))):
                    self._recon_tb(y, cu.x0 + dx, cu.y0 + dy,
                                   cu.log2_size - 1,
                                   cu.luma_modes[k], 0, qp,
                                   cu.coeffs.get((0, cu.x0 + dx,
                                                  cu.y0 + dy,
                                                  cu.log2_size - 1)))
            # chroma under IntraSplitFlag (spec 7.3.8.8 / 8.4.4.2):
            # the split follows luma only while the chroma TB stays
            # >= 4x4.  16x16 NxN -> four 4x4 chroma TBs; 8x8 NxN (the
            # min-CU-8 case, e.g. x265 streams) keeps ONE 4x4 chroma
            # TB predicted and coded at the CU root.
            cmode = chroma_mode_from_idx(cu.chroma_idx, cu.luma_modes[0])
            ccx, ccy = cu.x0 >> 1, cu.y0 >> 1
            if cu.log2_size == 3:
                self._recon_tb(u, ccx, ccy, 2, cmode, 1, qp_cb,
                               cu.coeffs.get((1, ccx, ccy, 2)))
                self._recon_tb(v, ccx, ccy, 2, cmode, 2, qp_cr,
                               cu.coeffs.get((2, ccx, ccy, 2)))
                return
            ch = half >> 1
            cl = cu.log2_size - 2
            for (dx, dy) in ((0, 0), (ch, 0), (0, ch), (ch, ch)):
                self._recon_tb(u, ccx + dx, ccy + dy, cl, cmode, 1,
                               qp_cb,
                               cu.coeffs.get((1, ccx + dx, ccy + dy,
                                              cl)))
                self._recon_tb(v, ccx + dx, ccy + dy, cl, cmode, 2,
                               qp_cr,
                               cu.coeffs.get((2, ccx + dx, ccy + dy,
                                              cl)))
            return
        else:
            # prediction + recon follow the PARSED TU tree in z-order
            # (spec 8.4.4.2: prediction per transform block when split);
            # tu_leaves was recorded by the syntax parser
            cmode = chroma_mode_from_idx(cu.chroma_idx, cu.luma_modes[0])
            cs = getattr(self, "_cs", 1)
            for (tx, ty, tl, blk) in cu.tu_leaves:
                self._recon_tb(y, tx, ty, tl, cu.luma_modes[0], 0, qp,
                               cu.coeffs.get((0, tx, ty, tl)))
                if getattr(self, "_is422", False):
                    ccx, cl = tx >> 1, tl - 1
                    half = 1 << cl
                    for ccy in (ty, ty + half):
                        self._recon_tb(u, ccx, ccy, cl, cmode, 1,
                                       qp_cb,
                                       cu.coeffs.get((1, ccx, ccy,
                                                      cl)))
                        self._recon_tb(v, ccx, ccy, cl, cmode, 2,
                                       qp_cr,
                                       cu.coeffs.get((2, ccx, ccy,
                                                      cl)))
                    continue
                if tl > 2 or cs == 0:
                    ccx, ccy, cl = tx >> cs, ty >> cs, tl - cs
                elif blk == 3:
                    ccx, ccy, cl = (tx - 4) >> 1, (ty - 4) >> 1, 2
                else:
                    continue
                self._recon_tb(u, ccx, ccy, cl, cmode, 1, qp_cb,
                               cu.coeffs.get((1, ccx, ccy, cl)))
                self._recon_tb(v, ccx, ccy, cl, cmode, 2, qp_cr,
                               cu.coeffs.get((2, ccx, ccy, cl)))

    def _recon_inter_cu(self, cu, y, u, v, qp, qp_cb, qp_cr) -> None:
        """Golden inter recon: uni MC (mc_block_ref) or bi-prediction
        (14-bit combine, spec 8.5.4.3) + residual."""
        from ..ops.interp import mc_block_ref_14, bi_combine_ref
        from ..entropy.cu_syntax import pu_partitions
        bd = self.sps.bit_depth
        maxv = (1 << bd) - 1
        nbs = 1 << cu.log2_size
        pus = pu_partitions(cu.x0, cu.y0, nbs, getattr(cu, "part_mode", 0))

        def pu_pred(pi_pu, px, py, pw, ph, c_idx, rsx, rsy=None):
            if rsy is None:
                rsy = rsx
            mot = cu.motion(pi_pu)
            d = mot.dir
            sx, sy, sw, sh = (px >> rsx, py >> rsy,
                              pw >> rsx, ph >> rsy)
            # chroma MV phase conventions: 4:4:4 doubles both axes
            # into the eighth-pel chroma path; 4:2:2 doubles only the
            # vertical component (SubHeightC == 1)
            if c_idx > 0:
                mx = 1 if getattr(self, "_cs", 1) else 2
                my = 1 if getattr(self, "_csy", 1) else 2
                if mx != 1 or my != 1:
                    mot = type(mot)(
                        mot.dir,
                        (mot.mv0[0] * mx, mot.mv0[1] * my), mot.ref0,
                        (mot.mv1[0] * mx, mot.mv1[1] * my), mot.ref1)
            r0 = self._ref_l0[mot.ref0][c_idx].astype(np.int32) \
                if d & 1 else None
            r1 = self._ref_l1[mot.ref1][c_idx].astype(np.int32) \
                if d & 2 else None
            def lw(lst, ridx):
                if self._cur_wp is None:
                    return None
                tab = self._cur_wp[1] if lst == 0 else \
                    (self._cur_wp[3] if len(self._cur_wp) > 3 else [])
                return tab[ridx] if ridx < len(tab) else None

            if d == 3:
                p0 = mc_block_ref_14(r0, sx, sy, mot.mv0[0], mot.mv0[1],
                                     sw, sh, c_idx, bd)
                p1 = mc_block_ref_14(r1, sx, sy, mot.mv1[0], mot.mv1[1],
                                     sw, sh, c_idx, bd)
                if c_idx == 0 and self._cur_wp is not None:
                    # weighted bipred (8.5.4.3.2 explicit bi arm);
                    # unflagged lists take the default weight, which
                    # degrades exactly to the plain combine
                    from ..ops.interp import wp_bi_combine_ref
                    dn = self._cur_wp[0]
                    w0, o0 = lw(0, mot.ref0) or ((1 << dn), 0)
                    w1, o1 = lw(1, mot.ref1) or ((1 << dn), 0)
                    return wp_bi_combine_ref(p0, p1, w0, o0, w1, o1,
                                             dn, bd)
                return bi_combine_ref(p0, p1, bd)
            if d == 1:
                wp = None
                if self._cur_wp is not None:
                    if c_idx == 0:
                        wp = lw(0, mot.ref0)
                    else:
                        cp = self._cur_wp[2][mot.ref0]
                        wp = cp[c_idx - 1] if cp is not None else None
                if wp is not None:
                    from ..ops.interp import wp_apply_ref
                    p14 = mc_block_ref_14(r0, sx, sy, mot.mv0[0],
                                          mot.mv0[1], sw, sh, c_idx, bd)
                    return wp_apply_ref(p14, wp[0], wp[1],
                                        self._cur_wp[0], bd)
                return mc_block_ref(r0, sx, sy, mot.mv0[0], mot.mv0[1],
                                    sw, sh, c_idx, bd)
            wp = lw(1, mot.ref1) if c_idx == 0 else None
            if wp is not None:
                from ..ops.interp import wp_apply_ref
                p14 = mc_block_ref_14(r1, sx, sy, mot.mv1[0],
                                      mot.mv1[1], sw, sh, c_idx, bd)
                return wp_apply_ref(p14, wp[0], wp[1],
                                    self._cur_wp[0], bd)
            return mc_block_ref(r1, sx, sy, mot.mv1[0], mot.mv1[1],
                                sw, sh, c_idx, bd)

        cs = getattr(self, "_cs", 1)
        csy = getattr(self, "_csy", cs)
        is422 = getattr(self, "_is422", False)
        for (plane, c_idx, qpc, cx, cy, lgx, lgy) in (
                (y, 0, qp, cu.x0, cu.y0, cu.log2_size, cu.log2_size),
                (u, 1, qp_cb, cu.x0 >> cs, cu.y0 >> csy,
                 cu.log2_size - cs, cu.log2_size - csy),
                (v, 2, qp_cr, cu.x0 >> cs, cu.y0 >> csy,
                 cu.log2_size - cs, cu.log2_size - csy)):
            cw_, ch_ = 1 << lgx, 1 << lgy
            sx_ = 0 if c_idx == 0 else cs
            sy_ = 0 if c_idx == 0 else csy
            pred = np.zeros((ch_, cw_), np.int32)
            for pi_pu, (px, py, pw, ph, _rule) in enumerate(pus):
                blk = pu_pred(pi_pu, px, py, pw, ph, c_idx, sx_, sy_)
                oy0 = (py - cu.y0) >> sy_
                ox0 = (px - cu.x0) >> sx_
                pred[oy0:oy0 + (ph >> sy_),
                     ox0:ox0 + (pw >> sx_)] = blk
            # residual applies per leaf of the PARSED TU tree
            rec = pred.astype(np.int32)
            for (lx, ly, ll, blk) in cu.tu_leaves:
                tbs = []
                if c_idx == 0:
                    tbs = [(ll, lx - cu.x0, ly - cu.y0)]
                elif is422:
                    tl = ll - 1
                    half = 1 << tl
                    tbs = [(tl, (lx >> 1) - cx, ly - cy),
                           (tl, (lx >> 1) - cx, ly + half - cy)]
                elif ll > 2 or cs == 0:
                    tbs = [(ll - cs, (lx >> cs) - cx, (ly >> cs) - cy)]
                elif blk == 3:
                    tbs = [(2, ((lx - 4) >> 1) - cx,
                            ((ly - 4) >> 1) - cy)]
                for (tl, tx, ty) in tbs:
                    tn = 1 << tl
                    levels = cu.coeffs.get((c_idx, cx + tx, cy + ty,
                                            tl))
                    if levels is not None and np.any(levels):
                        if getattr(cu, "tq_bypass", False):
                            resi = levels.astype(np.int32)
                        else:
                            coef = dequant_ref(levels.astype(np.int16),
                                               qpc, tl, bd,
                                               self._scal_mat(
                                                   tl, False, c_idx))
                            resi = idct_ref(coef, bd, dst=False)
                        rec[ty:ty + tn, tx:tx + tn] += resi
            plane[cy:cy + ch_, cx:cx + cw_] = np.clip(rec, 0, maxv)

    def _scal_mat(self, log2: int, intra: bool, comp: int = 0):
        if not getattr(self.sps, "scaling_list_enabled", False):
            return None
        sl = getattr(self.sps, "scaling_lists", None)
        if sl is not None:
            from ..constants.scaling import list_matrix
            return list_matrix(sl[0], sl[1], log2, intra, comp)
        from ..constants.scaling import default_matrix
        return default_matrix(log2, intra)

    def _recon_tb(self, plane, x0, y0, log2, mode, c_idx, qp,
                  levels) -> None:
        sps = self.sps
        bd = sps.bit_depth
        n = 1 << log2
        ph, pw = plane.shape
        sxs = getattr(self, "_cs", 1) if c_idx else 0
        sys_ = getattr(self, "_csy", sxs) if c_idx else 0
        if c_idx and getattr(self, "_is422", False):
            # 4:2:2 chroma prediction uses the Table 8-3 remapped angle
            from ..constants.hevc_tables import CHROMA_422_ANGLE_MAP
            mode = CHROMA_422_ANGLE_MAP[mode]
        xs, ys = s_vector_coords(x0, y0, n)
        inside = (xs >= 0) & (ys >= 0) & (xs < pw) & (ys < ph)
        w_ctus = sps.pic_width_in_ctus
        z = zscan_index(np.clip(xs, 0, pw - 1) << sxs,
                        np.clip(ys, 0, ph - 1) << sys_,
                        sps.log2_ctu_size, w_ctus)
        z0 = zscan_index(np.array(x0 << sxs),
                         np.array(y0 << sys_),
                         sps.log2_ctu_size, w_ctus)
        avail = inside & (z < z0)
        if getattr(self, "_slice_top", 0):
            avail &= (ys << sys_) >= self._slice_top
        s_raw = plane[np.clip(ys, 0, ph - 1), np.clip(xs, 0, pw - 1)]
        s = substitute_refs(s_raw, avail, bd)
        pred = predict_block_ref(
            mode, s, log2, c_idx, bd,
            strong_smoothing=sps.strong_intra_smoothing,
            filt_chroma=(c_idx > 0 and getattr(self, "_cs", 1) == 0))
        if levels is not None and np.any(levels):
            if self._tq_bypass:
                resi = levels.astype(np.int32)
            else:
                coef = dequant_ref(levels.astype(np.int16), qp, log2, bd,
                                   self._scal_mat(log2, True, c_idx))
                resi = idct_ref(coef, bd, dst=(log2 == 2 and c_idx == 0))
            rec = np.clip(pred + resi, 0, (1 << bd) - 1)
        else:
            rec = pred
        plane[y0:y0 + n, x0:x0 + n] = rec
