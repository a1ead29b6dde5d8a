"""HEVC parameter-set and slice-header writers (spec 7.3.2, 7.3.6).

Analog of x265's header coders (source/encoder/entropy.cpp codeVPS/codeSPS/
codePPS/codeSliceHeader and source/common/slice.h data model), restructured
as pure functions param->RBSP bytes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..params import EncoderParams, CHROMA_420
from .bitwriter import BitWriter

SLICE_B, SLICE_P, SLICE_I = 0, 1, 2


@dataclass
class ProfileTierLevel:
    profile_idc: int = 1          # 1 Main, 2 Main10
    tier_flag: int = 0
    level_idc: int = 120          # level 4.0 x30
    progressive_source: bool = True
    interlaced_source: bool = False
    non_packed: bool = True
    frame_only: bool = True


@dataclass
class SPSInfo:
    """Derived sequence-level state shared by header writers and the slice
    encoder (analog of x265 common/slice.h SPS)."""
    width: int = 0
    height: int = 0
    conf_win_right: int = 0       # in chroma units
    conf_win_bottom: int = 0
    chroma_format_idc: int = 1
    bit_depth: int = 8
    log2_max_poc_lsb: int = 8
    max_sub_layers: int = 1       # temporal sub-layers (x265 --temporal-layers)
    log2_ctu_size: int = 5
    log2_min_cu_size: int = 3
    log2_min_tu_size: int = 2
    log2_max_tu_size: int = 5
    scaling_list_enabled: bool = False
    scaling_lists: tuple = None      # (lists, dc) custom matrices or None
    # VUI (Annex E; reference Encoder::initVPS/initSPS vui wiring)
    vui_present: bool = False
    sar: tuple = (0, 0)                  # (num, den); (0,0) = unspecified
    video_full_range: bool = False
    colour_primaries: int = 2            # unspecified
    transfer_characteristics: int = 2
    matrix_coeffs: int = 2
    fps: tuple = (0, 1)                  # timing info when num > 0
    # HRD (Annex E.2.2; reference RateControl::initHRD,
    # ratecontrol.cpp:934): signaled when VBV + --hrd
    hrd: bool = False
    hrd_bitrate: int = 0                 # bps (signaled, >= actual)
    hrd_cpb_size: int = 0                # bits (signaled, >= actual)
    hrd_cbr: bool = False
    interlace_mode: int = 0              # VUI field signaling
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    sao_enabled: bool = False
    amp_enabled: bool = False
    temporal_mvp: bool = False
    strong_intra_smoothing: bool = True
    max_dec_pic_buffering: int = 5
    num_reorder_pics: int = 0
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)

    @property
    def pic_width_in_ctus(self) -> int:
        return -(-self.width // (1 << self.log2_ctu_size))

    @property
    def pic_height_in_ctus(self) -> int:
        return -(-self.height // (1 << self.log2_ctu_size))


@dataclass
class PPSInfo:
    sign_hide: bool = False
    cabac_init_present: bool = False
    init_qp: int = 26
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    weighted_pred: bool = False
    weighted_bipred: bool = False
    transquant_bypass: bool = False
    entropy_coding_sync: bool = False   # WPP
    loop_filter_across_slices: bool = True
    deblocking_disabled: bool = False
    deblock_tc_offset_div2: int = 0
    deblock_beta_offset_div2: int = 0
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    log2_parallel_merge_level: int = 2


def build_sps_info(p: EncoderParams) -> SPSInfo:
    s = SPSInfo()
    # pad to the 16-px analysis grid (a legal min-CU multiple); signal
    # the crop via the conformance window
    cu = max(16, p.min_cu_size)
    s.width = -(-p.source_width // cu) * cu
    s.height = -(-p.source_height // cu) * cu
    sub_x = 1 if p.internal_csp == 3 else 2    # SubWidthC
    sub_y = 2 if p.internal_csp == CHROMA_420 else 1   # SubHeightC
    s.conf_win_right = (s.width - p.source_width) // sub_x
    s.conf_win_bottom = (s.height - p.source_height) // sub_y
    s.chroma_format_idc = p.internal_csp
    s.bit_depth = p.internal_bit_depth
    s.log2_ctu_size = p.log2_ctu_size
    s.log2_min_cu_size = p.min_cu_size.bit_length() - 1
    s.log2_max_tu_size = min(p.max_tu_size, p.ctu_size).bit_length() - 1
    s.max_transform_hierarchy_depth_intra = p.tu_intra_depth - 1
    s.scaling_list_enabled = p.scaling_list not in ("off", "")
    if p.scaling_list not in ("off", "default", ""):
        # custom scaling-list file (x265 --scaling-list <file>;
        # reference scalinglist.cpp:246 parseScalingList format)
        from ..constants.scaling import parse_scaling_list_file
        lists, dc = parse_scaling_list_file(p.scaling_list)
        for sid in range(4):
            # ValueError (not assert): must survive python -O — under -O
            # the encoder would quantize Cr with the Cb matrix while the
            # decoder dequants with the signaled Cr list, silently
            # breaking the encode-decodes-bit-exact invariant
            if not (np.array_equal(lists[(sid, 1)], lists[(sid, 2)])
                    and np.array_equal(lists[(sid, 4)], lists[(sid, 5)])):
                raise ValueError(
                    "custom scaling lists: Cb and Cr must match (v1 "
                    "quant plumbing shares one chroma matrix)")
        s.scaling_lists = (lists, dc)
    if p.sar:
        t = p.sar.replace("/", ":").split(":")
        s.sar = (int(t[0]), int(t[1])) if len(t) == 2 else (0, 0)
    s.video_full_range = p.video_full_range
    s.colour_primaries = p.colorprim
    s.transfer_characteristics = p.transfer
    s.matrix_coeffs = p.colormatrix
    if p.hrd and p.vbv_bufsize > 0 and p.vbv_maxrate > 0:
        s.hrd = True
        s.hrd_bitrate = p.vbv_maxrate * 1000
        s.hrd_cpb_size = p.vbv_bufsize * 1000
        s.hrd_cbr = (p.rc_mode == "abr"
                     and p.vbv_maxrate == p.bitrate_kbps)
    if p.vui_timing_info or s.hrd:
        s.fps = (p.fps_num, p.fps_denom)
    s.interlace_mode = getattr(p, "interlace", 0)
    s.ptl.progressive_source = s.interlace_mode == 0
    s.ptl.interlaced_source = s.interlace_mode > 0
    s.vui_present = s.hrd or s.interlace_mode > 0 or bool(
        s.sar[0] or s.video_full_range or
        s.colour_primaries != 2 or
        s.transfer_characteristics != 2 or
        s.matrix_coeffs != 2 or s.fps[0] > 0)
    s.max_transform_hierarchy_depth_inter = p.tu_inter_depth - 1
    s.sao_enabled = p.sao
    s.amp_enabled = p.amp
    s.temporal_mvp = p.temporal_mvp and p.keyframe_max > 1
    s.strong_intra_smoothing = p.strong_intra_smoothing
    tl = getattr(p, "temporal_layers", 0)
    s.max_sub_layers = max(1, min(tl, 3)) if tl and p.bframes > 0 else 1
    s.max_dec_pic_buffering = min(p.max_num_references + 1 + p.bframes, 16)
    s.num_reorder_pics = min(p.bframes, s.max_dec_pic_buffering - 1)
    # profile: 1 Main, 2 Main10, 4 RExt (Main12 / Main 4:4:4 —
    # constraint flags stay zero = unconstrained, spec A.3.5)
    if p.internal_csp != CHROMA_420 or p.internal_bit_depth > 10:
        s.ptl.profile_idc = 4
    else:
        s.ptl.profile_idc = 2 if p.internal_bit_depth == 10 else 1
    from .level import determine_level
    forced = p.level_idc
    if forced and forced < 100:
        forced *= 3                # x265 CLI convention: 51 -> idc 153
    idc, high, dpb = determine_level(
        p.source_width, p.source_height,
        p.fps_num / max(1, p.fps_denom), p.vbv_maxrate, p.vbv_bufsize,
        min(p.max_num_references, 4), forced)
    s.ptl.level_idc = idc
    s.ptl.tier_flag = high
    return s


def build_pps_info(p: EncoderParams) -> PPSInfo:
    q = PPSInfo()
    q.sign_hide = p.sign_hide
    q.init_qp = p.qp if p.rc_mode == "cqp" else 26
    q.cu_qp_delta_enabled = p.aq_mode > 0 or p.cu_tree \
        or p.rc_mode != "cqp" \
        or (p.vbv_bufsize > 0 and p.vbv_maxrate > 0)
    q.diff_cu_qp_delta_depth = 0
    q.cb_qp_offset = p.cb_qp_offset
    q.cr_qp_offset = p.cr_qp_offset
    q.entropy_coding_sync = p.wpp
    q.deblocking_disabled = not p.deblock
    q.deblock_tc_offset_div2 = p.deblock_tc_offset
    q.deblock_beta_offset_div2 = p.deblock_beta_offset
    q.num_ref_idx_l0_default = max(1, p.max_num_references)
    q.weighted_pred = p.weightp and p.keyframe_max != 1
    q.weighted_bipred = getattr(p, "weightb", False) and p.bframes > 0
    q.transquant_bypass = p.lossless
    return q


def _write_ptl(bw: BitWriter, ptl: ProfileTierLevel, max_sub_layers_minus1: int = 0) -> None:
    bw.u(0, 2)                               # general_profile_space
    bw.flag(ptl.tier_flag)
    bw.u(ptl.profile_idc, 5)
    for j in range(32):                      # compatibility flags
        bw.flag(j in (1, 2) if ptl.profile_idc in (1, 2) else j == ptl.profile_idc)
    bw.flag(ptl.progressive_source)
    bw.flag(ptl.interlaced_source)
    bw.flag(ptl.non_packed)
    bw.flag(ptl.frame_only)
    bw.u(0, 32)                              # reserved_zero_44bits
    bw.u(0, 12)
    bw.u(ptl.level_idc, 8)
    # sub-layer PTL (spec 7.3.3): signal nothing per layer (the layers
    # share the general profile/level) — x265 writes the same shape
    for _ in range(max_sub_layers_minus1):
        bw.flag(0)                           # sub_layer_profile_present
        bw.flag(0)                           # sub_layer_level_present
    if max_sub_layers_minus1 > 0:
        for _ in range(max_sub_layers_minus1, 8):
            bw.u(0, 2)                       # reserved_zero_2bits


def write_vps(sps: SPSInfo) -> bytes:
    bw = BitWriter()
    bw.u(0, 4)                               # vps_video_parameter_set_id
    bw.flag(1)                               # vps_base_layer_internal_flag
    bw.flag(1)                               # vps_base_layer_available_flag
    msl = sps.max_sub_layers - 1
    bw.u(0, 6)                               # vps_max_layers_minus1
    bw.u(msl, 3)                             # vps_max_sub_layers_minus1
    bw.flag(1)                               # vps_temporal_id_nesting_flag
    bw.u(0xFFFF, 16)                         # vps_reserved_0xffff_16bits
    _write_ptl(bw, sps.ptl, msl)
    bw.flag(1)                               # vps_sub_layer_ordering_info_present
    for _ in range(msl + 1):
        bw.ue(sps.max_dec_pic_buffering - 1)
        bw.ue(sps.num_reorder_pics)
        bw.ue(0)                             # vps_max_latency_increase_plus1
    bw.u(0, 6)                               # vps_max_layer_id
    bw.ue(0)                                 # vps_num_layer_sets_minus1
    bw.flag(0)                               # vps_timing_info_present_flag
    bw.flag(0)                               # vps_extension_flag
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def write_sps(sps: SPSInfo) -> bytes:
    bw = BitWriter()
    msl = sps.max_sub_layers - 1
    bw.u(0, 4)                               # sps_video_parameter_set_id
    bw.u(msl, 3)                             # sps_max_sub_layers_minus1
    bw.flag(1)                               # sps_temporal_id_nesting_flag
    _write_ptl(bw, sps.ptl, msl)
    bw.ue(0)                                 # sps_seq_parameter_set_id
    bw.ue(sps.chroma_format_idc)
    if sps.chroma_format_idc == 3:
        bw.flag(0)                           # separate_colour_plane_flag
    bw.ue(sps.width)
    bw.ue(sps.height)
    crop = sps.conf_win_right or sps.conf_win_bottom
    bw.flag(crop)
    if crop:
        bw.ue(0)                             # left
        bw.ue(sps.conf_win_right)
        bw.ue(0)                             # top
        bw.ue(sps.conf_win_bottom)
    bw.ue(sps.bit_depth - 8)
    bw.ue(sps.bit_depth - 8)
    bw.ue(sps.log2_max_poc_lsb - 4)
    bw.flag(1)                               # sps_sub_layer_ordering_info_present
    for _ in range(msl + 1):
        bw.ue(sps.max_dec_pic_buffering - 1)
        bw.ue(sps.num_reorder_pics)
        bw.ue(0)                             # sps_max_latency_increase_plus1
    bw.ue(sps.log2_min_cu_size - 3)
    bw.ue(sps.log2_ctu_size - sps.log2_min_cu_size)
    bw.ue(sps.log2_min_tu_size - 2)
    bw.ue(sps.log2_max_tu_size - sps.log2_min_tu_size)
    bw.ue(sps.max_transform_hierarchy_depth_inter)
    bw.ue(sps.max_transform_hierarchy_depth_intra)
    bw.flag(sps.scaling_list_enabled)        # scaling_list_enabled_flag
    if sps.scaling_list_enabled:
        custom = getattr(sps, "scaling_lists", None)
        if custom is None:
            bw.flag(0)                       # sps_scaling_list_data_present
                                             # (-> spec DEFAULT matrices)
        else:
            bw.flag(1)                       # explicit custom lists
            _write_scaling_list_data(bw, custom[0], custom[1])
    bw.flag(sps.amp_enabled)
    bw.flag(sps.sao_enabled)
    bw.flag(0)                               # pcm_enabled_flag
    bw.ue(0)                                 # num_short_term_ref_pic_sets
    bw.flag(0)                               # long_term_ref_pics_present_flag
    bw.flag(sps.temporal_mvp)
    bw.flag(sps.strong_intra_smoothing)
    bw.flag(sps.vui_present)                 # vui_parameters_present_flag
    if sps.vui_present:
        _write_vui(bw, sps)
    bw.flag(0)                               # sps_extension_present_flag
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def _write_vui(bw: BitWriter, sps: SPSInfo) -> None:
    """vui_parameters (Annex E.2.1): SAR, signal range/colour
    description, timing info."""
    has_sar = sps.sar[0] > 0 and sps.sar[1] > 0
    bw.flag(has_sar)                     # aspect_ratio_info_present
    if has_sar:
        bw.u(255, 8)                     # EXTENDED_SAR
        bw.u(sps.sar[0], 16)
        bw.u(sps.sar[1], 16)
    bw.flag(0)                           # overscan_info_present
    desc = (sps.colour_primaries != 2 or
            sps.transfer_characteristics != 2 or sps.matrix_coeffs != 2)
    signal = desc or sps.video_full_range
    bw.flag(signal)                      # video_signal_type_present
    if signal:
        bw.u(5, 3)                       # video_format: unspecified
        bw.flag(sps.video_full_range)
        bw.flag(desc)                    # colour_description_present
        if desc:
            bw.u(sps.colour_primaries, 8)
            bw.u(sps.transfer_characteristics, 8)
            bw.u(sps.matrix_coeffs, 8)
    bw.flag(0)                           # chroma_loc_info_present
    bw.flag(0)                           # neutral_chroma_indication
    bw.flag(1 if sps.interlace_mode else 0)   # field_seq_flag
    bw.flag(1 if sps.interlace_mode else 0)   # frame_field_info_present
    bw.flag(0)                           # default_display_window
    has_timing = sps.fps[0] > 0
    bw.flag(has_timing)                  # vui_timing_info_present
    if has_timing:
        bw.u(sps.fps[1], 32)             # num_units_in_tick
        bw.u(sps.fps[0], 32)             # time_scale
        bw.flag(0)                       # poc_proportional_to_timing
        bw.flag(sps.hrd)                 # hrd_parameters_present
        if sps.hrd:
            _write_hrd(bw, sps)
    bw.flag(0)                           # bitstream_restriction


# fixed HRD field lengths (written into hrd_parameters; reference
# initHRD ratecontrol.cpp:934 picks sizes the same way)
HRD_INIT_LEN = 24                        # initial_cpb_removal_* bits
HRD_AU_LEN = 16                          # au_cpb_removal_delay bits
HRD_DPB_LEN = 8                          # dpb_output_delay bits
HRD_BR_SCALE = 4                         # bit_rate unit = 2^(6+4) = 1024
HRD_CPB_SCALE = 4                        # cpb_size unit = 2^(4+4) = 256


def hrd_signaled(sps: "SPSInfo"):
    """(bitrate_bps, cpb_bits) as actually signaled (unit-rounded up)."""
    br = -(-sps.hrd_bitrate // (1 << (6 + HRD_BR_SCALE))) \
        << (6 + HRD_BR_SCALE)
    cpb = -(-sps.hrd_cpb_size // (1 << (4 + HRD_CPB_SCALE))) \
        << (4 + HRD_CPB_SCALE)
    return br, cpb


def _write_hrd(bw: BitWriter, sps: SPSInfo) -> None:
    """hrd_parameters (E.2.2), NAL HRD only, one CPB, one sub-layer."""
    bw.flag(1)                           # nal_hrd_parameters_present
    bw.flag(0)                           # vcl_hrd_parameters_present
    bw.flag(0)                           # sub_pic_hrd_params_present
    bw.u(HRD_BR_SCALE, 4)                # bit_rate_scale
    bw.u(HRD_CPB_SCALE, 4)               # cpb_size_scale
    bw.u(HRD_INIT_LEN - 1, 5)            # initial_cpb_removal_delay_len
    bw.u(HRD_AU_LEN - 1, 5)              # au_cpb_removal_delay_len
    bw.u(HRD_DPB_LEN - 1, 5)             # dpb_output_delay_len
    # sub-layer 0
    bw.flag(1)                           # fixed_pic_rate_general_flag
    bw.ue(0)                             # elemental_duration_in_tc_minus1
    bw.ue(0)                             # cpb_cnt_minus1
    br, cpb = hrd_signaled(sps)
    bw.ue((br >> (6 + HRD_BR_SCALE)) - 1)     # bit_rate_value_minus1
    bw.ue((cpb >> (4 + HRD_CPB_SCALE)) - 1)   # cpb_size_value_minus1
    bw.flag(sps.hrd_cbr)                 # cbr_flag


def _write_scaling_list_data(bw: BitWriter, lists, dc) -> None:
    """scaling_list_data() (spec 7.3.4): every list written explicitly
    (scaling_list_pred_mode_flag 1) with delta-coded coefficients in
    the up-right diagonal scan; 16/32 carry a DC value.  lists/dc per
    constants.scaling.parse_scaling_list_file."""
    from ..constants.scaling import diag_scan_positions
    for size_id in range(4):
        step = 3 if size_id == 3 else 1
        for list_id in range(0, 6, step):
            bw.flag(1)                  # scaling_list_pred_mode_flag
            n = 4 if size_id == 0 else 8
            coefs = lists[(size_id, list_id)]
            next_coef = 8
            if size_id > 1:
                d = int(dc[(size_id, list_id)])
                bw.se(d - 8)            # scaling_list_dc_coef_minus8
                next_coef = d
            for (x, y) in diag_scan_positions(n):
                c = int(coefs[y, x])
                delta = ((c - next_coef + 128) % 256) - 128
                bw.se(delta)            # scaling_list_delta_coef
                next_coef = c


def write_pps(pps: PPSInfo) -> bytes:
    bw = BitWriter()
    bw.ue(0)                                 # pps_pic_parameter_set_id
    bw.ue(0)                                 # pps_seq_parameter_set_id
    bw.flag(0)                               # dependent_slice_segments_enabled
    bw.flag(0)                               # output_flag_present_flag
    bw.u(0, 3)                               # num_extra_slice_header_bits
    bw.flag(pps.sign_hide)
    bw.flag(pps.cabac_init_present)
    bw.ue(pps.num_ref_idx_l0_default - 1)
    bw.ue(pps.num_ref_idx_l1_default - 1)
    bw.se(pps.init_qp - 26)
    bw.flag(0)                               # constrained_intra_pred_flag
    bw.flag(0)                               # transform_skip_enabled_flag
    bw.flag(pps.cu_qp_delta_enabled)
    if pps.cu_qp_delta_enabled:
        bw.ue(pps.diff_cu_qp_delta_depth)
    bw.se(pps.cb_qp_offset)
    bw.se(pps.cr_qp_offset)
    bw.flag(0)                               # pps_slice_chroma_qp_offsets_present
    bw.flag(pps.weighted_pred)
    bw.flag(pps.weighted_bipred)
    bw.flag(pps.transquant_bypass)
    bw.flag(0)                               # tiles_enabled_flag
    bw.flag(pps.entropy_coding_sync)
    bw.flag(pps.loop_filter_across_slices)
    bw.flag(1)                               # deblocking_filter_control_present
    bw.flag(0)                               # deblocking_filter_override_enabled
    bw.flag(pps.deblocking_disabled)
    if not pps.deblocking_disabled:
        bw.se(pps.deblock_beta_offset_div2)
        bw.se(pps.deblock_tc_offset_div2)
    bw.flag(0)                               # pps_scaling_list_data_present
    bw.flag(0)                               # lists_modification_present_flag
    bw.ue(pps.log2_parallel_merge_level - 2)
    bw.flag(0)                               # slice_segment_header_extension
    bw.flag(0)                               # pps_extension_present_flag
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


@dataclass
class SliceHeader:
    slice_type: int = SLICE_I
    nal_type: int = 19               # IDR_W_RADL
    poc: int = 0
    qp: int = 26
    first_slice: bool = True
    segment_address: int = 0
    sao_luma: bool = False
    sao_chroma: bool = False
    deblocking_disabled: bool = False
    num_ref_idx: tuple = (0, 0)
    # short-term RPS coded inline (delta POCs, negative then positive)
    st_rps_neg: tuple = ()           # tuple of (delta_poc, used) for refs before
    st_rps_pos: tuple = ()
    temporal_mvp: bool = False
    collocated_from_l0: bool = True
    five_minus_max_num_merge_cand: int = 2
    entry_points: tuple = ()         # WPP substream byte sizes (all but last)
    # explicit weighted prediction (P slices): per-L0-ref (w, o) or None,
    # denom fixed at 6 (reference weightPrediction.cpp); wp_l0_chroma
    # entries are ((w_cb, o_cb), (w_cr, o_cr)) or None per ref
    wp_l0: tuple = ()
    wp_l0_chroma: tuple = ()
    wp_l1: tuple = ()                # B slices (x265 --weightb), luma
    luma_log2_weight_denom: int = 6


def write_slice_header(sh: SliceHeader, sps: SPSInfo, pps: PPSInfo) -> BitWriter:
    """Write slice_segment_header; returns the (unaligned until
    byte_align) BitWriter so slice data can be appended after alignment."""
    from .nal import is_idr, is_irap
    bw = BitWriter()
    bw.flag(sh.first_slice)
    if is_irap(sh.nal_type):
        bw.flag(0)                           # no_output_of_prior_pics_flag
    bw.ue(0)                                 # slice_pic_parameter_set_id
    if not sh.first_slice:
        addr_bits = max(1, (sps.pic_width_in_ctus * sps.pic_height_in_ctus - 1)
                        .bit_length())
        bw.u(sh.segment_address, addr_bits)
    bw.ue(sh.slice_type)
    if not is_idr(sh.nal_type):
        bw.u(sh.poc & ((1 << sps.log2_max_poc_lsb) - 1), sps.log2_max_poc_lsb)
        # short_term_ref_pic_set(num_short_term_ref_pic_sets) coded inline
        bw.flag(0)                           # short_term_ref_pic_set_sps_flag
        _write_st_rps(bw, sh)
        if sps.temporal_mvp:
            bw.flag(sh.temporal_mvp)
    if sps.sao_enabled:
        bw.flag(sh.sao_luma)
        if sps.chroma_format_idc != 0:
            bw.flag(sh.sao_chroma)
    if sh.slice_type != SLICE_I:
        defaults = (pps.num_ref_idx_l0_default, pps.num_ref_idx_l1_default)
        explicit = sh.num_ref_idx[:2 if sh.slice_type == SLICE_B else 1] != \
            defaults[:2 if sh.slice_type == SLICE_B else 1]
        bw.flag(explicit)                    # num_ref_idx_active_override_flag
        if explicit:
            bw.ue(sh.num_ref_idx[0] - 1)
            if sh.slice_type == SLICE_B:
                bw.ue(sh.num_ref_idx[1] - 1)
        if sh.slice_type == SLICE_B:
            bw.flag(0)                       # mvd_l1_zero_flag
        if sh.temporal_mvp:
            if sh.slice_type == SLICE_B:
                bw.flag(sh.collocated_from_l0)
            col_refs = sh.num_ref_idx[0 if sh.collocated_from_l0 else 1]
            if col_refs > 1:
                bw.ue(0)                     # collocated_ref_idx
        if (pps.weighted_pred and sh.slice_type == SLICE_P) or \
                (pps.weighted_bipred and sh.slice_type == SLICE_B):
            _write_pred_weight_table(bw, sh)
        bw.ue(sh.five_minus_max_num_merge_cand)
    bw.se(sh.qp - pps.init_qp)
    # deblocking_filter_override is disabled in our PPS, so the slice
    # inherits pps_deblocking_filter_disabled_flag with no syntax here
    if pps.loop_filter_across_slices and \
            (sh.sao_luma or sh.sao_chroma or not pps.deblocking_disabled):
        bw.flag(1)                           # slice_loop_filter_across_slices
    if pps.entropy_coding_sync:
        bw.ue(len(sh.entry_points))
        if sh.entry_points:
            max_len = max(sh.entry_points)
            nbits = max(1, (max_len - 1).bit_length())
            bw.ue(nbits - 1)                 # offset_len_minus1
            for ep in sh.entry_points:
                bw.u(ep - 1, nbits)
    # byte_alignment()
    bw.u(1, 1)
    bw.byte_align_zero()
    return bw


def _write_pred_weight_table(bw: BitWriter, sh: SliceHeader) -> None:
    """pred_weight_table (spec 7.3.6.3) with luma and chroma explicit
    weights (chroma offset coded as the spec's prediction-compensated
    delta, 7.4.7.3; matches x265 entropy.cpp codePredWeightTable)."""
    denom = sh.luma_log2_weight_denom
    bw.ue(denom)
    bw.se(0)                                 # delta_chroma_log2_weight_denom
    wps = sh.wp_l0 or (None,) * sh.num_ref_idx[0]
    cps = sh.wp_l0_chroma or (None,) * len(wps)
    for wp in wps:
        bw.flag(wp is not None)              # luma_weight_l0_flag
    for cp in cps:
        bw.flag(cp is not None)              # chroma_weight_l0_flag
    for wp, cp in zip(wps, cps):
        if wp is not None:
            bw.se(wp[0] - (1 << denom))      # delta_luma_weight_l0
            bw.se(wp[1])                     # luma_offset_l0
        if cp is not None:
            for (w, o) in cp:
                bw.se(w - (1 << denom))      # delta_chroma_weight_l0
                # delta_chroma_offset_l0 = o - (128 - ((128*w)>>denom))
                bw.se(o - (128 - ((128 * w) >> denom)))
    if sh.slice_type == SLICE_B:
        wps1 = sh.wp_l1 or (None,) * sh.num_ref_idx[1]
        for wp in wps1:
            bw.flag(wp is not None)          # luma_weight_l1_flag
        for _ in wps1:
            bw.flag(0)                       # chroma_weight_l1_flag
        for wp in wps1:
            if wp is not None:
                bw.se(wp[0] - (1 << denom))
                bw.se(wp[1])


def _write_st_rps(bw: BitWriter, sh: SliceHeader) -> None:
    """short_term_ref_pic_set coded in the slice header (spec 7.3.7),
    always as explicit delta POCs (inter_ref_pic_set_prediction off)."""
    bw.ue(len(sh.st_rps_neg))
    bw.ue(len(sh.st_rps_pos))
    prev = 0
    for delta_poc, used in sh.st_rps_neg:    # delta_poc negative, descending
        bw.ue(prev - delta_poc - 1)
        bw.flag(used)
        prev = delta_poc
    prev = 0
    for delta_poc, used in sh.st_rps_pos:
        bw.ue(delta_poc - prev - 1)
        bw.flag(used)
        prev = delta_poc
