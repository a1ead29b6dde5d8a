"""Top-level encoder of the port: frames in, Annex-B HEVC out (port of
x265_mod_by_patman_tpu/encoder/top.py).

The device work (the slicetype lookahead, mode decision, P and B
analysis, the reconstruction wavefront, the inter TU32 pre-pass,
deblocking, SAO statistics and apply) runs in torch on the device the
Encoder was given ("cuda" unless the caller asks for "cpu"); syntax and
CABAC run on the host through the port's own copies of the reference's
jax-free modules (``params``, ``bitstream``, ``entropy`` with the native
C CABAC engine, ``rc``).

Scope: the default encode — I, P and B pictures with the b-adapt
lookahead, the B pyramid, open-GOP CRA keyframes with RASL leaders and
scenecut by the lookahead's cost ratio — in 4:2:0, 4:2:2 and 4:4:4 at
8, 10 or 12 bits (4:2:2 / 4:4:4 within the reference's own limits: no
NxN, AMP, rect PUs, NR or analysis reuse there, and the fixed 16-grid
wavefront), under CQP, CRF or ABR with one or two passes, adaptive
quantisation (modes 1-4), the cuTree lookahead (or, in pass 2, its
pass-1 offsets played back), zones, a qpfile, a VBV with the row-level
re-encode, the HRD timing SEIs, HDR10+ metadata and Dolby Vision RPU
pass-through, and the residual-side options: NxN intra PUs with TU4
(DST) splits, scaling lists, noise reduction, lossless (transquant
bypass) and analysis save/load.  Options of the reference outside that
scope raise NotImplementedError naming the option.  Host-only helpers
(slice syntax assembly, headers, QP chain, AQ map, zones, stats, TMVP
motion store, adaptive rate tables, the NR offsets, source padding)
are copied whole from the reference, since its module imports jax;
the slice assembly's `internal_csp == 1` guards (NxN chroma, the
native intra walker) keep 4:2:2 and 4:4:4 on the Python syntax
walker, as in the reference.  B pictures of a mini-GOP are encoded one
after another: the reference's frame-parallel B (--frame-threads > 1)
gives the same bytes under CQP only, so it is rejected under CRF/ABR.
"""
from __future__ import annotations

import dataclasses
import os
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..params import EncoderParams
from ..bitstream.bitwriter import BitWriter
from ..bitstream.headers import (
    SLICE_B, SLICE_I, SLICE_P, SliceHeader, build_pps_info, build_sps_info,
    write_pps, write_slice_header, write_sps, write_vps)
from ..bitstream.nal import (
    NAL_CRA_NUT, NAL_IDR_W_RADL, NAL_PPS, NAL_RASL_N, NAL_RASL_R, NAL_SPS,
    NAL_SUFFIX_SEI, NAL_TRAIL_N, NAL_TRAIL_R, NAL_TSA_N, NAL_TSA_R,
    NAL_VPS, annexb)
from ..bitstream.sei import plane_md5, write_decoded_picture_hash
from ..entropy.binir import BinIR
from ..entropy.cabac import encode_ir_to_writer
from ..entropy.contexts import init_states
from ..entropy.cu_syntax import CodedCU, SliceSyntaxEncoder
from ..rc.ratecontrol import RateControl, frame_complexity
from ..utils import trace
from ..analysis.intra_mode import (decide_modes_rd, decide_modes_split,
                                   decide_modes_tree, decide_tu4_split)
from ..analysis.reuse import mc_for_b, mc_for_p
from ..analysis.lookahead import CuTreeLookahead
from ..analysis.inter_mode import (_whole_frame_mc, analyse_b_frame,
                                   analyse_p_frame, lambda_qp)
from ..frame.planes import (as_devplane, attach_dev, dev_i32, pack_levels,
                            pack_recon)
from ..frame.recon_intra import IntraReconstructor, chroma_qp
from ..ops.deblock import (chroma_on_maps, deblock_frame_batch,
                           inter_bs_maps, intra_bs_maps)
from ..parallel.mesh import make_mesh
from ..parallel.tiles import analyse_p_frame_tiles
from ..utils.device import resolve

MAX_MERGE = 3


def _motion_key(c):
    """Canonical motion identity of an inter CU: the unused list's
    mv/ref are don't-cares and must not block same-motion merges (the
    decoder normalizes them to 0, so stale ME values here would make
    visibly-identical CUs compare unequal)."""
    l0 = (c.mv, c.ref_idx) if c.inter_dir & 1 else ((0, 0), -1)
    l1 = (c.mv1, c.ref_idx1) if c.inter_dir & 2 else ((0, 0), -1)
    return (c.inter_dir, l0, l1)


class _RawIR:
    """Finished (bins, ctx) arrays from the native intra walker,
    presenting the minimal BinIR interface the slice assembler needs."""

    __slots__ = ("_b", "_c", "_m")

    def __init__(self, bins, ctx, mark):
        self._b, self._c, self._m = bins, ctx, mark

    def arrays(self):
        return self._b, self._c

    def resolve_mark(self, _mark):
        return self._m


@dataclass
class EncodedFrame:
    poc: int
    bitstream: bytes              # Annex-B NALs of this AU
    recon: tuple                  # (y, u, v) uint8 / uint16 planes
    bits: int = 0
    md5: bytes = b""
    slice_type: str = "I"
    qp: int = 0
    disp: int = 0                 # global display index
    stats: dict = dataclasses.field(default_factory=dict)
    # per-frame encoder stats (x265 FrameStats / --csv-log-level 2
    # analog): CU-type distribution, MV stats, VBV fullness
    pipeline_runs: int = 1        # 1 + row-level VBV re-encodes
    qp_map: object = None         # coded per-CTU QPs (scalar without)



def _unsupported(p: EncoderParams) -> List[str]:
    """Options of the reference this port does not take."""
    out = []
    checks = (
        # the reference's tile-row analysis reads 4:2:0 chroma planes
        (p.mesh_tile_rows > 1 and p.internal_csp != 1,
         "tile-row analysis (mesh_tile_rows) in 4:2:2 / 4:4:4"),
        # 4:0:0 is not encoded by the reference either (it asserts)
        (p.internal_csp not in (1, 2, 3), "4:0:0 chroma"),
        # the reference quantizes 4:4:4's 16x16 chroma TBs with its 8x8
        # chroma tables and fails on the shape mismatch
        (p.internal_csp == 3 and p.scaling_list != "off",
         "--scaling-list in 4:4:4"),
    )
    out.extend(name for cond, name in checks if cond)
    return out


class Encoder:
    """x265_encoder_open/encode analog on a torch device (the card by
    default; "cpu" on request).

    encode_frame() takes display-order frames and returns 0+ encoded
    frames in decode order; call flush() at the end of the stream."""

    def __init__(self, params: EncoderParams, device="cuda") -> None:
        self.p = params.validate()
        bad = _unsupported(self.p)
        if bad:
            raise NotImplementedError("not ported: " + ", ".join(bad))
        self.device = resolve(device)
        self.pix_dtype = np.uint8 if self.p.internal_bit_depth == 8 \
            else np.uint16
        # chroma geometry shifts: x halves except 4:4:4; y halves
        # only for 4:2:0 (4:2:2 keeps full-height chroma)
        self.cshift = 0 if self.p.internal_csp == 3 else 1
        self.cshift_y = 1 if self.p.internal_csp == 1 else 0
        self.is422 = self.p.internal_csp == 2
        self.sps = build_sps_info(self.p)
        self.pps = build_pps_info(self.p)
        self.pps.entropy_coding_sync = bool(self.p.wpp)
        self.pps.sign_hide = bool(self.p.sign_hide)
        # cuTree runs under CRF/ABR only; AQ and cuTree (or its pass-2
        # playback, or a ladder master's offsets read from the share)
        # code per-CTU QP deltas
        self._cutree = None
        self._lowres = None           # lowres store, built on first use
        self._la_buf: deque = deque()
        self._ctshare_w = self._ctshare_r = None
        self._ct2pass = None          # pass-2 cuTree offsets playback
        self._ct1_offs = None         # pass-1 offsets to persist
        if (self.p.pass_num == 2 and self.p.cu_tree
                and os.path.exists(self.p.stats_file + ".cutree")):
            # 2-pass cuTree reuse (reference cuTreeReadFor2Pass,
            # ratecontrol.cpp:1972): pass 2 plays back the pass-1
            # offsets instead of re-running the lookahead
            self._ct2pass = list(np.load(
                self.p.stats_file + ".cutree")["offs"])
        if getattr(self.p, "cutree_share_read", ""):
            # consume the master rung's published offsets instead of
            # running our own lookahead (ratecontrol.cpp:380 analog)
            from ..analysis.cutree_share import CuTreeShareReader
            self._ctshare_r = CuTreeShareReader(self.p.cutree_share_read)
        elif self._ct2pass is not None:
            pass                      # playback replaces the lookahead
        elif (self.p.cu_tree and self.p.rc_mode != "cqp"
                and self.p.keyframe_max > 1 and self.p.rc_lookahead > 0):
            self._cutree = CuTreeLookahead(
                self.p.pic_width_in_ctus * self.p.ctu_size,
                self.p.pic_height_in_ctus * self.p.ctu_size,
                self.p.ctu_size, self.p.qcomp,
                bframes=self.p.bframes if self.p.keyframe_max > 1
                else 0, hme=self.p.hme,
                store=self._lowres_store())
            if getattr(self.p, "cutree_share_write", ""):
                from ..analysis.cutree_share import CuTreeShareWriter
                self._ctshare_w = CuTreeShareWriter(
                    self.p.cutree_share_write,
                    self.p.pic_height_in_ctus, self.p.pic_width_in_ctus)
        if self.p.pass_num == 1 and self._cutree is not None:
            self._ct1_offs = []
        self.pps.cu_qp_delta_enabled = (self.p.aq_mode > 0
                                        or self._cutree is not None
                                        or self._ctshare_r is not None
                                        or self._ct2pass is not None)
        self.pps.deblocking_disabled = not self.p.deblock
        self.sps.sao_enabled = bool(self.p.sao)
        self.sps.temporal_mvp = bool(self.p.temporal_mvp) and \
            self.p.keyframe_max > 1
        ncy = self.p.pic_height_in_ctus
        ns = max(1, min(self.p.slices, ncy))
        if ns > 1:
            assert not self.p.wpp, "slices+WPP unsupported (v1)"
        bounds = [round(i * ncy / ns) for i in range(ns + 1)]
        self._slice_bands = [(bounds[i], bounds[i + 1])
                             for i in range(ns) if bounds[i] < bounds[i + 1]]
        slice_tops = tuple(r0 << self.p.log2_ctu_size
                           for (r0, _) in self._slice_bands) \
            if len(self._slice_bands) > 1 else ()
        self.recon = IntraReconstructor(self.sps, self.device,
                                        self.p.cb_qp_offset,
                                        self.p.cr_qp_offset,
                                        self.p.sign_hide,
                                        self.p.rdoq_level > 0,
                                        slice_tops, self.p.nxn_intra,
                                        self.p.lossless,
                                        tree=self.p.var_cu_tree,
                                        psy_rd=self.p.psy_rd,
                                        psy_rdoq=self.p.psy_rdoq,
                                        tu4=self.p.nxn_intra and
                                        self.p.tu_intra_depth >= 2)
        self.frame_count = 0          # display index, global
        self._disp_since_idr = 0
        self._queue: List[tuple] = []
        self._anchors: List[tuple] = []
        self._col_store: Dict[int, object] = {}
        # DCT-domain noise reduction running state (x265 --nr-intra/
        # --nr-inter; quant.h NoiseReduction, frameencoder.cpp:2305
        # noiseReductionUpdate) — batched deviation: offsets update
        # once per frame, not per TU (one-frame lag)
        self._nr = None
        if self.p.nr_intra or self.p.nr_inter:
            self._nr = {"sy": np.zeros((2, 256), np.int64),
                        "sc": np.zeros((2, 64), np.int64),
                        "cnt": np.zeros(4, np.int64)}
        self.max_refs = max(1, min(self.p.max_num_references, 4))
        method_r = {"dia": 8, "hex": 16, "umh": 24, "sea": 32,
                    "star": 32, "full": 63}
        if self.p.search_method not in method_r:
            raise ValueError(f"unknown --me {self.p.search_method!r}")
        self._me_range = max(4, min(self.p.search_range,
                                    method_r[self.p.search_method]))
        self._headers_sent = False
        self._rounds_p = (1, 1) if self.p.rd_level <= 2 else (2, 1)
        self._rounds_b = (1, 1) if self.p.rd_level <= 2 else (2, 2)
        self.bframes = max(0, self.p.bframes) if self.p.keyframe_max > 1 \
            else 0
        # lookahead-fed rate control (reference rateEstimateQscale
        # consumes lowres satd costs, ratecontrol.cpp:2101): the
        # slicetype lattice supplies frame complexities whenever RC
        # needs them (CRF/ABR/2-pass/VBV) or b-adapt wants the DP
        self._la_rc = self.p.keyframe_max > 1 and (
            (self.bframes > 0 and self.p.b_adapt > 0)
            or self.p.rc_mode in ("crf", "abr")
            or (self.p.vbv_bufsize > 0 and self.p.vbv_maxrate > 0))
        self.rc = RateControl(self.p.rc_mode, self.p.qp, self.p.crf,
                              self.p.bitrate_kbps,
                              self.p.fps_num / max(1, self.p.fps_denom),
                              self.sps.width, self.sps.height,
                              self.p.qp_min, self.p.qp_max,
                              cu_tree=self._cutree is not None
                              or self._ctshare_r is not None,
                              lookahead_units=self._la_rc,
                              bframes=self.bframes)
        if self.p.vbv_bufsize > 0 and self.p.vbv_maxrate > 0:
            self.rc.set_vbv(self.p.vbv_bufsize, self.p.vbv_maxrate,
                            self.p.vbv_init)
        if self.p.pass_num == 2:
            from ..rc.ratecontrol import read_stats_file
            self.rc.load_pass1(read_stats_file(self.p.stats_file))
        self._prev_src_y = None
        self._cplx_avg = 0.0
        self._idr_base = 0
        self._slicetype = None            # lazy (needs padded geometry)
        self._enc_order = 0               # decode-order AU counter (HRD)
        self._tiles_mesh = None           # tile-row mesh, made on first use
        self._last_bp_order = 0           # last buffering-period AU
        self._last_row_bits = None        # WPP substream bits (row VBV)
        self._last_anchor_disp = -1
        self._keyint_min = params.keyframe_min if params.keyframe_min > 0 \
            else max(1, min(params.keyframe_max // 10,
                            params.keyframe_max - 1))
        self._prev_hist = None
        self._adapt_states = {}
        self._est_pending = {}
        # zones: list of (start, end, qp_override, bitrate_factor)
        self._zones = []
        for z in filter(None, self.p.zones.split("/")):
            parts = z.split(",")
            s0, e0 = int(parts[0]), int(parts[1])
            qov, bf = None, None
            for kv in parts[2:]:
                k, _, vv = kv.partition("=")
                if k == "q":
                    qov = int(vv)
                elif k == "b":
                    bf = float(vv)
            self._zones.append((s0, e0, qov, bf))
        self._mc_buf: deque = deque()     # MCSTF source window
        self._mc_hist: deque = deque(maxlen=2)
        self._mc_disp = 0
        self._dhdr10 = None
        if self.p.dhdr10_info:
            from ..bitstream.hdr10plus import load_dhdr10_json
            self._dhdr10 = load_dhdr10_json(self.p.dhdr10_info)
        self._ana_store = self._ana_load = None
        if self.p.analysis_save:
            from ..analysis.reuse import AnalysisStore
            self._ana_store = AnalysisStore(self.p.analysis_save)
        if self.p.analysis_load:
            from ..analysis.reuse import AnalysisLoad
            self._ana_load = AnalysisLoad(self.p.analysis_load)
        # Dolby Vision RPU passthrough (reference frameencoder.cpp:1281
        # emits each picture's RPU as an UNSPECIFIED(62) NAL after the
        # slice): the side file is concatenated Annex-B RPU NALs, one
        # per display-order picture
        self._rpus: List[bytes] = []
        if getattr(self.p, "dolby_vision_rpu", ""):
            data = open(self.p.dolby_vision_rpu, "rb").read()
            starts = []
            i = 0
            while i < len(data) - 3:
                if data[i:i + 3] == b"\x00\x00\x01":
                    starts.append(i)
                    i += 3
                else:
                    i += 1
            for k, st in enumerate(starts):
                e = starts[k + 1] if k + 1 < len(starts) else len(data)
                s0 = st - 1 if st > 0 and data[st - 1] == 0 else st
                self._rpus.append(data[s0:e])
        # qpfile: display idx -> (ftype, qp)
        self._qpfile: Dict[int, tuple] = {}
        if self.p.qpfile:
            with open(self.p.qpfile) as f:
                for line in f:
                    t = line.split()
                    if len(t) >= 3:
                        self._qpfile[int(t[0])] = (t[1].upper(),
                                                   int(t[2]))

    @staticmethod
    def _luma_hist(y: np.ndarray) -> np.ndarray:
        """Normalized 64-bin luma histogram (reference
        computeIntensityHistogramBinsLuma, slicetype.cpp:1715)."""
        h = np.bincount((np.asarray(y).ravel() >> 2).astype(np.int64),
                        minlength=64)[:64]
        return h / max(h.sum(), 1)

    def _zone_qp(self, disp: int, qp: int) -> int:
        """Zone / qpfile frame-QP overrides (reference zones,
        encoder.cpp:3806 + CLI --qpfile)."""
        if disp in self._qpfile and self._qpfile[disp][1] >= 0:
            return self._qpfile[disp][1]
        for (s0, e0, qov, bf) in self._zones:
            if s0 <= disp <= e0:
                if qov is not None:
                    return qov
                if bf:
                    import math
                    return int(np.clip(round(qp - 6.0 * math.log2(bf)),
                                       self.p.qp_min, self.p.qp_max))
        return qp

    def _aq_map(self, y: np.ndarray, qp: int):
        """Per-CTU QP offsets (reference aq modes 1-4,
        slicetype.cpp calcAdaptiveQuantFrame:490 / edgeDensityCu:278):
        1 variance, 2 auto-variance (z-score normalized), 3 +dark-scene
        bias, 4 edge-density blended.  Returns an (nCtuY, nCtuX) int
        map, or the scalar qp when AQ is off."""
        mode = self.p.aq_mode
        if mode <= 0:
            return qp
        ctu = 1 << self.sps.log2_ctu_size
        h, w = y.shape
        ncy = -(-h // ctu)
        ncx = -(-w // ctu)
        yv = np.asarray(y, np.int64)
        gx = np.abs(np.diff(yv, axis=1, prepend=yv[:, :1]))
        gy = np.abs(np.diff(yv, axis=0, prepend=yv[:1]))
        g = gx + gy

        def tiles(a):
            """(ncy, ncx, ctu*ctu) edge-padded CTU tiles (ragged edge
            tiles keep their true pixel population via NaN masking)."""
            pad = np.full((ncy * ctu, ncx * ctu), np.nan)
            pad[:h, :w] = a
            return pad.reshape(ncy, ctu, ncx, ctu) \
                      .transpose(0, 2, 1, 3).reshape(ncy, ncx, -1)
        ty = tiles(yv)
        mean = np.nanmean(ty, axis=-1)
        var = np.nanvar(ty, axis=-1)
        edge = np.nanmean(tiles(g), axis=-1)
        lv = np.log2(var + 1.0)
        if mode == 1:
            off = self.p.aq_strength * (lv - lv.mean())
        else:
            sd = max(lv.std(), 1e-3)
            off = self.p.aq_strength * 1.5 * (lv - lv.mean()) / sd
            if mode == 3:
                # darker blocks get lower QP (reference dark bias)
                off = off - np.where(mean < 60, 1.5,
                                     np.where(mean < 100, 0.5, 0.0))
            if mode == 4:
                le = np.log2(edge + 1.0)
                se = max(le.std(), 1e-3)
                off = 0.5 * off + self.p.aq_strength * 0.75 * \
                    (le - le.mean()) / se
        off = np.rint(off)
        return np.clip(qp + np.clip(off, -6, 6), self.p.qp_min,
                       min(51, self.p.qp_max)).astype(np.int32)

    def _derived_qp_map(self, qp_map, r: dict,
                        slice_qp: int = 0) -> np.ndarray:
        """The decoder-visible per-CTU QP chain: signaled when the CTU has
        coded coefficients, inherited (qPY_PREV) otherwise; WPP resets the
        chain per CTU row (spec 8.6.1)."""
        if np.isscalar(qp_map):
            return qp_map
        ncy, ncx = qp_map.shape
        bpc = self.recon.bpc
        nby, nbx = self.recon.nby, self.recon.nbx
        nz = self._block_nz(r)
        pad = np.zeros((ncy * bpc, ncx * bpc), bool)
        pad[:nz.shape[0], :nz.shape[1]] = nz[:ncy * bpc, :ncx * bpc]
        has = pad.reshape(ncy, bpc, ncx, bpc).any(axis=(1, 3))
        derived = np.zeros_like(qp_map)
        slice_qp = int(slice_qp)
        qp_prev = slice_qp
        cols = np.arange(ncx)
        for cy in range(ncy):
            if self.pps.entropy_coding_sync:
                qp_prev = slice_qp
            # last signaled CTU at-or-before each column this row
            idx = np.maximum.accumulate(np.where(has[cy], cols, -1))
            derived[cy] = np.where(
                idx >= 0, qp_map[cy][np.clip(idx, 0, None)], qp_prev)
            if idx[-1] >= 0:
                qp_prev = int(qp_map[cy, idx[-1]])
        return derived

    def _block_nz(self, r: dict) -> np.ndarray:
        """(nby, nbx) bool: block has any coded luma or chroma level
        (from the device-computed nz maps when present)."""
        nzs = []
        for plane, key in (("lev_y", "nz_y"), ("lev_u", "nz_u"),
                           ("lev_v", "nz_v")):
            nz = r.get(key)
            if nz is None:
                lv = np.asarray(r[plane])
                nz = (lv.reshape(lv.shape[0], lv.shape[1], -1)
                      != 0).any(-1)
            if nzs and nz.shape != nzs[0].shape:
                # 4:2:2 row-doubled chroma block grid
                nz = nz[:2 * nzs[0].shape[0]].reshape(
                    nzs[0].shape[0], 2, -1).any(1)
            nzs.append(nz)
        nz = nzs[0] | nzs[1] | nzs[2]
        i32 = r.get("inter32")
        if i32 is not None:
            # TU32 regions code their residual as one TU32 (their per-16
            # levels are zero): the syntax codes cu_qp_delta there, so
            # the decoder's QP chain sees them.  The reference omits
            # this, and its deblocking then uses the inherited QP where
            # the decoder uses the signalled one (ROADMAP §3).
            any32 = i32["nzy"] | i32["nzu"] | i32["nzv"]
            up = np.repeat(np.repeat(any32, 2, 0), 2, 1)
            h2, w2 = min(up.shape[0], nz.shape[0]), min(up.shape[1],
                                                        nz.shape[1])
            nz[:h2, :w2] |= up[:h2, :w2]
        return nz

    # -- headers -------------------------------------------------------------
    def headers(self) -> bytes:
        out = (annexb(NAL_VPS, write_vps(self.sps)) +
               annexb(NAL_SPS, write_sps(self.sps)) +
               annexb(NAL_PPS, write_pps(self.pps)))
        from ..bitstream.nal import NAL_PREFIX_SEI
        from ..bitstream.sei import (
            parse_master_display, write_content_light_level,
            write_mastering_display, write_user_data_info)
        if self.p.info_sei:
            out += annexb(NAL_PREFIX_SEI, write_user_data_info(
                "x265-tpu - HEVC encoder - " + self.p.to_string()))
        if self.p.master_display:
            out += annexb(NAL_PREFIX_SEI, write_mastering_display(
                parse_master_display(self.p.master_display)))
        if self.p.max_cll or self.p.max_fall:
            out += annexb(NAL_PREFIX_SEI, write_content_light_level(
                self.p.max_cll, self.p.max_fall))
        if self.p.film_grain:
            from ..bitstream.sei import (parse_film_grain_json,
                                         write_film_grain)
            out += annexb(NAL_PREFIX_SEI, write_film_grain(
                parse_film_grain_json(self.p.film_grain)))
        return out

    # -- streaming API -------------------------------------------------------
    def encode_frame(self, y: np.ndarray, u: np.ndarray,
                     v: np.ndarray) -> List[EncodedFrame]:
        """Display-order input; returns decode-order encoded frames.
        With MCSTF on, sources pass a +-2-frame temporal filter window;
        with cuTree active they then pass a rc_lookahead-deep window
        (reference Lookahead thread analog)."""
        if not self.p.mcstf:
            return self._post_filter_frame(y, u, v)
        self._mc_buf.append((y, u, v))
        out: List[EncodedFrame] = []
        while len(self._mc_buf) > 2:
            out.extend(self._mcstf_pop())
        return out

    def _mcstf_pop(self) -> List[EncodedFrame]:
        from ..analysis.mcstf import filter_strength, mcstf_filter
        center = self._mc_buf.popleft()
        future = list(self._mc_buf)[:2]
        past = list(self._mc_hist)
        strength = filter_strength(self._mc_disp)
        self._mc_disp += 1
        self._mc_hist.append(center)
        if strength > 0:
            window = past + [center] + future
            center = mcstf_filter(window, len(past), strength, self.p.qp,
                                  self.p.internal_bit_depth, self.device)
        return self._post_filter_frame(*center)

    def _post_filter_frame(self, y, u, v) -> List[EncodedFrame]:
        if self._ctshare_r is not None:
            # slave rung: mirror the master's lookahead delay so its
            # published record for this display index exists by the
            # time we ingest (the ladder drives rungs master-first)
            self._la_buf.append((y, u, v))
            out: List[EncodedFrame] = []
            while len(self._la_buf) > self.p.rc_lookahead:
                fy, fu, fv = self._la_buf.popleft()
                off = self._ctshare_r.get(self.frame_count,
                                          self.p.pic_height_in_ctus,
                                          self.p.pic_width_in_ctus)
                out.extend(self._ingest(fy, fu, fv, off))
            return out
        if self._ct2pass is not None:
            i = min(self.frame_count, len(self._ct2pass) - 1)
            return self._ingest(y, u, v, self._ct2pass[i])
        if self._cutree is None:
            return self._ingest(y, u, v)
        self._la_buf.append((y, u, v))
        with trace.scope("cutree_push"):
            self._cutree.push(self._pad(y, 0))
        out: List[EncodedFrame] = []
        while len(self._la_buf) > self.p.rc_lookahead:
            fy, fu, fv = self._la_buf.popleft()
            out.extend(self._ingest(fy, fu, fv, self._cutree_pop()))
        return out

    def _cutree_pop(self):
        with trace.scope("cutree_pop"):
            off = self._cutree.pop()
        if self._ctshare_w is not None:
            # keyed by the display index the popped frame will take
            self._ctshare_w.publish(self.frame_count, off)
        if self._ct1_offs is not None:
            self._ct1_offs.append(np.asarray(off, np.int8))
        return off

    def _ingest(self, y, u, v, qp_off=None) -> List[EncodedFrame]:
        p = self.p
        planes = (as_devplane(self._pad(y, 0)),
                  as_devplane(self._pad(u, self.cshift)),
                  as_devplane(self._pad(v, self.cshift)))
        st = self._slicetype
        if st is None and self._la_rc:
            from ..analysis.slicetype import SlicetypeLookahead
            st = self._slicetype = SlicetypeLookahead(
                planes[0].shape[1], planes[0].shape[0], self.bframes,
                p.b_adapt, p.scenecut_bias / 100.0, p.scenecut_threshold,
                b_frame_bias=p.b_frame_bias, hme=p.hme,
                store=self._lowres_store())
        if st is not None:
            with trace.scope("slicetype_push"):
                st.push(self.frame_count, planes[0])
            # ingest-time complexity = lowres lattice P-cost vs the
            # previous display frame (refined to the decided refs in
            # _emit_minigop); first frame = lowres intra cost
            d = self.frame_count
            with trace.scope("la_ingest_cost"):
                if d > 0 and st.has(d - 1):
                    cplx = st.frame_cost(d, d - 1, d)
                else:
                    cplx = st.intra_cost(d)
        else:
            cplx = frame_complexity(planes[0], self._prev_src_y)
        self._prev_src_y = planes[0]
        out: List[EncodedFrame] = []
        force_idr = (self.frame_count % max(1, p.keyframe_max) == 0)
        self._closed_kf_next = False
        if getattr(self, "_force_idr_next", False):
            # x265_encoder_intra_refresh analog (api.cpp:365): the next
            # ingested frame opens a fresh IDR (always closed)
            force_idr = True
            self._force_idr_next = False
            self._closed_kf_next = True
        if self._qpfile.get(self.frame_count, ("", 0))[0] == "I":
            force_idr = True
            self._closed_kf_next = True
        if not force_idr and p.hist_scenecut and \
                self._prev_hist is not None:
            hist = self._luma_hist(planes[0])
            if np.abs(hist - self._prev_hist).sum() > 0.4:
                force_idr = self._disp_since_idr >= self._keyint_min
            self._prev_hist = hist
        elif p.hist_scenecut:
            self._prev_hist = self._luma_hist(planes[0])
        # scene-cut detection: the lookahead's intra/inter cost-ratio
        # test when available (slicetype.cpp scenecutInternal:2832),
        # else the temporal-complexity-spike fallback
        if not force_idr and p.scenecut and p.keyframe_max > 1 \
                and self._disp_since_idr >= self._keyint_min:
            if st is not None and self.frame_count > 0:
                force_idr = st.scenecut(
                    self.frame_count, self.frame_count - 1,
                    self._disp_since_idr, self._keyint_min,
                    p.keyframe_max)
                if force_idr and p.fades and \
                        st.fade_state(self.frame_count) != 0:
                    # mid-fade brightness ramps read as scene changes
                    # to the cost-ratio test; hold the cut until the
                    # ramp ends (x265 --fades)
                    force_idr = False
            elif self._cplx_avg > 0 and cplx > 4.0 * self._cplx_avg \
                    and cplx > 0.1 * self.sps.width * self.sps.height:
                force_idr = True
        if not force_idr:
            self._cplx_avg = 0.9 * self._cplx_avg + 0.1 * cplx \
                if self._cplx_avg else cplx
        if force_idr:
            open_kf = (p.open_gop and self.frame_count > 0
                       and p.keyframe_max > 1
                       and not self._closed_kf_next)
            if open_kf:
                # open GOP (x265 --open-gop, dpb.cpp getNalUnitType):
                # the keyframe is a CRA continuing the POC sequence and
                # the queued frames become its RASL leading pictures,
                # referencing across the keyframe (prev anchor + CRA)
                prev_anchor = self._anchors[0] if self._anchors else None
                prev_disp = self._last_anchor_disp
                kf_poc = self.frame_count - self._idr_base
                self._disp_since_idr = 0
                self._last_anchor_disp = self.frame_count
                if st is not None:
                    cplx = st.intra_cost(self.frame_count)
                cra = self._encode_picture(planes, kf_poc, "I", cplx,
                                           qp_off=qp_off,
                                           nal_class="cra")
                out.append(cra)
                cra_ref = (cra.recon, kf_poc)
                leaders, self._queue = self._queue, []
                for (pl, pc, cx2, qo) in leaders:
                    if st is not None and prev_disp >= 0:
                        cx2 = st.frame_cost(self._idr_base + pc,
                                            prev_disp, self.frame_count)
                    out.append(self._encode_picture(
                        pl, pc, "B", cx2,
                        b_refs=([prev_anchor], [cra_ref], (), False),
                        qp_off=qo, nal_class="rasl"))
                if st is not None:
                    st.drop_before(self.frame_count)
                self.frame_count += 1
                self._disp_since_idr = 1
                self._adapt_states.update(self._est_pending)
                self._est_pending = {}
                return out
            while self._queue:
                out.extend(self._emit_minigop(self._next_gop_len()))
            self._disp_since_idr = 0
            self._idr_base = self.frame_count
            self._last_anchor_disp = self.frame_count
            if st is not None:
                cplx = st.intra_cost(self.frame_count)
            out.append(self._encode_picture(planes, 0, "I", cplx,
                                            qp_off=qp_off))
            self._adapt_states.update(self._est_pending)
            self._est_pending = {}
            if st is not None:
                st.drop_before(self.frame_count)
        else:
            # queue poc is relative to the last IDR (CVS base) — under
            # open GOP that differs from the distance-to-keyframe
            # counter (_disp_since_idr resets at CRAs too)
            self._queue.append((planes,
                                self.frame_count - self._idr_base, cplx,
                                qp_off))
            # b-adapt: spike fallback only without the lookahead (the
            # DP's P placement subsumes it)
            spike = (st is None and p.b_adapt > 0 and
                     len(self._queue) > 1 and self._cplx_avg > 0 and
                     cplx > 2.5 * self._cplx_avg)
            if len(self._queue) >= self.bframes + 1 or spike:
                out.extend(self._emit_minigop(self._next_gop_len()))
        self.frame_count += 1
        self._disp_since_idr += 1
        return out

    def _next_gop_len(self) -> Optional[int]:
        """Mini-GOP length for the head of the queue: the b-adapt DP's
        P-anchor placement (slicetype.cpp slicetypePath analog), or the
        whole queue without the lookahead."""
        st = self._slicetype
        if st is None or not self._queue:
            return None
        p0 = self._last_anchor_disp
        disps = [self._idr_base + q[1] for q in self._queue]
        if p0 < 0:
            return None
        try:
            with trace.scope("la_decide_gop"):
                return st.decide_gop(p0, disps)
        except KeyError:
            return None

    def _lowres_store(self):
        """The one lowres store shared by the slicetype lookahead and
        cuTree: a plane lives until both have released it."""
        if self._lowres is None:
            from ..analysis.lookahead import LowresStore
            # coded (min-CU-aligned) size == the _pad()ded plane shape
            self._lowres = LowresStore(self.sps.width, self.sps.height,
                                       self.device)
        return self._lowres

    def flush(self) -> List[EncodedFrame]:
        out: List[EncodedFrame] = []
        while self._mc_buf:
            out.extend(self._mcstf_pop())
        if self._cutree is not None:
            while self._la_buf:
                fy, fu, fv = self._la_buf.popleft()
                out.extend(self._ingest(fy, fu, fv, self._cutree_pop()))
        elif self._ctshare_r is not None:
            while self._la_buf:
                fy, fu, fv = self._la_buf.popleft()
                off = self._ctshare_r.get(self.frame_count,
                                          self.p.pic_height_in_ctus,
                                          self.p.pic_width_in_ctus)
                out.extend(self._ingest(fy, fu, fv, off))
        while self._queue:
            out.extend(self._emit_minigop(self._next_gop_len()))
        return out

    def write_stats(self) -> None:
        """Pass-1 stats / analysis emission (call after final flush)."""
        if self.p.pass_num == 1:
            from ..rc.ratecontrol import write_stats_file
            write_stats_file(self.p.stats_file, self.rc.history)
            if self._ct1_offs:
                np.savez(self.p.stats_file + ".cutree",
                         offs=np.stack(self._ct1_offs))
                import os as _os
                _os.replace(self.p.stats_file + ".cutree.npz",
                            self.p.stats_file + ".cutree")
        if self._ana_store is not None:
            self._ana_store.close()
            self._ana_store = None

    # -- batched all-intra path (multi-frame throughput) --------------------
    def _batch_limits(self) -> None:
        """The multi-frame wavefront's limits (the reference's): those of
        the reconstructor, and no NR."""
        if self._nr is not None:
            raise NotImplementedError("batched all-intra path: "
                                      "--nr-intra / --nr-inter")
        self.recon.check_batch()

    def _idr_nal(self, rbsp, md5) -> bytes:
        """One all-intra AU: the headers before the first, the IDR slices
        and the MD5 SEI."""
        nal = b""
        if not self._headers_sent:
            nal += self.headers()
            self._headers_sent = True
        for rb in (rbsp if isinstance(rbsp, list) else [rbsp]):
            nal += annexb(NAL_IDR_W_RADL, rb)
        if self.p.decoded_picture_hash:
            nal += annexb(NAL_SUFFIX_SEI, write_decoded_picture_hash(md5))
        return nal

    def _intra_slice(self, modes, r: dict, yuv, qp: int):
        """SAO and the slice of one all-intra picture of the batched
        paths: (rbsp, md5)."""
        inter_mask = np.zeros(modes.shape, bool)
        mvs = np.zeros(modes.shape + (2,), np.int32)
        sao_maps = self._sao(r, *yuv, qp) if self.p.sao else None
        rbsp = self._encode_slice(modes, inter_mask, mvs, None, None, r,
                                  "I", 0, qp, ((), ()), sao_maps, None, (),
                                  None, None, None, None, None,
                                  NAL_IDR_W_RADL)
        md5 = plane_md5(r["recon_y"], r["recon_u"], r["recon_v"],
                        bit_depth=self.sps.bit_depth)
        return rbsp, md5

    def _emit_intra(self, rbsp, md5, r: dict, qp: int,
                    cplx: float) -> EncodedFrame:
        nal = self._idr_nal(rbsp, md5)
        fr = EncodedFrame(0, nal, (r["recon_y"], r["recon_u"], r["recon_v"]),
                          bits=len(nal) * 8, md5=md5, slice_type="I", qp=qp,
                          disp=self.frame_count)
        self.rc.update("I", qp, fr.bits, cplx)
        self.frame_count += 1
        return fr

    def _dbl_maps(self):
        w, h = self.sps.width, self.sps.height
        bs_v, bs_h = intra_bs_maps(w, h, 16)
        return (bs_v, bs_h) + tuple(chroma_on_maps(bs_v, bs_h, h // 2,
                                                   w // 2))

    def _dbl_args(self, qp: int) -> tuple:
        p = self.p
        return (qp, chroma_qp(qp, p.cb_qp_offset),
                chroma_qp(qp, p.cr_qp_offset), p.deblock_beta_offset,
                p.deblock_tc_offset, self.sps.bit_depth)

    def _pad_yuv(self, frames) -> list:
        return [(self._pad(y, 0), self._pad(u, self.cshift),
                 self._pad(v, self.cshift)) for (y, u, v) in frames]

    def encode_batch(self, frames) -> List[EncodedFrame]:
        """Encode a list of (y, u, v) frames as IDRs through one
        multi-frame mode decision, wavefront and deblock
        (keyframe_max must be 1); host entropy runs per frame.  The
        analysis is the fixed 16-grid (rd 2): at rd >= 3 the streaming
        encoder's output differs from this path's."""
        from ..analysis.intra_mode import decide_modes_batch
        from ..ops.deblock import deblock_frame_multi
        assert self.p.keyframe_max == 1, "batched path is all-intra"
        assert self.p.internal_csp == 1, "batched path: 4:2:0 only (v1)"
        self._batch_limits()
        p = self.p
        padded = self._pad_yuv(frames)
        ys, us, vs = (np.stack([f[c] for f in padded]) for c in range(3))
        cplx = [frame_complexity(f[0]) for f in padded]
        qp = self.rc.frame_qp("I", cplx[0])
        modes = decide_modes_batch(ys, self.sps, self.device, block=16,
                                   qp=qp)
        results = self.recon.run_batch(ys, us, vs, modes, qp=qp)
        if p.deblock:
            stack = lambda k: torch.from_numpy(np.stack(
                [r[k] for r in results]).astype(np.int32)).to(self.device)
            dbl = deblock_frame_multi(
                stack("recon_y"), stack("recon_u"), stack("recon_v"),
                *self._dbl_maps(), *self._dbl_args(qp))
            for key, d in zip(("recon_y", "recon_u", "recon_v"), dbl):
                d = d.cpu().numpy()
                for i, r in enumerate(results):
                    r[key] = d[i].astype(self.pix_dtype)
        return [self._emit_intra(*self._intra_slice(modes[i], r, (
            ys[i], us[i], vs[i]), qp), r, qp, cplx[i])
            for i, r in enumerate(results)]

    def encode_intra_pipelined(self, frames) -> List[EncodedFrame]:
        """All-intra pipelined encode: the device mode decision,
        wavefront and deblock of frame k+1 are queued before frame k's
        results are brought to the host, so the host's entropy overlaps
        the device's work."""
        assert self.p.keyframe_max == 1
        p = self.p
        qp = self.rc.frame_qp("I", 0.0)
        padded = self._pad_yuv(frames)
        maps = self._dbl_maps()

        def dispatch(planes):
            y, u, v = planes
            modes = decide_modes_rd(y, self.sps, qp, self.device, block=16)
            with trace.scope("wavefront", type="I", frames=1):
                rd = self.recon.run(y, u, v, modes, qp=qp,
                                    materialize=False)
            if p.deblock:
                rd["recon_y"], rd["recon_u"], rd["recon_v"] = \
                    deblock_frame_batch(rd["recon_y"], rd["recon_u"],
                                        rd["recon_v"], *maps,
                                        *self._dbl_args(qp))
            return modes, rd

        out: List[EncodedFrame] = []
        prev = None
        for k in range(len(padded) + 1):
            cur = dispatch(padded[k]) if k < len(padded) else None
            if prev is not None:
                modes, rd = prev
                r = self.recon.materialize(rd)
                out.append(self._emit_intra(*self._intra_slice(
                    modes, r, padded[k - 1], qp), r, qp, 0.0))
            prev = cur
        return out

    def encode_intra_batched(self, frames, batch: int = 8,
                             entropy_workers: int = 1
                             ) -> List[EncodedFrame]:
        """All-intra multi-frame pipeline (the throughput path): each
        batch of F frames runs the batched mode decision, the
        multi-frame wavefront and the multi-frame deblock on the device
        with no host sync between them, and while batch k+1 runs there,
        batch k's entropy runs on the host (on a thread pool when
        entropy_workers > 1: the native CABAC engine releases the
        GIL)."""
        from concurrent.futures import ThreadPoolExecutor
        from ..analysis.intra_mode import decide_modes_rd_multi
        from ..entropy.residual import _merge_tables, _native_setup
        from ..ops.deblock import deblock_frame_multi
        assert self.p.keyframe_max == 1
        self._batch_limits()
        p = self.p
        qp = self.rc.frame_qp("I", 0.0)
        h = self.sps.height
        maps = self._dbl_maps() if p.deblock else None
        if _native_setup():
            _merge_tables()      # build the shared tables before threading

        def dispatch(fr_batch):
            padded = self._pad_yuv(fr_batch)
            ys, us, vs = (np.stack([f[c] for f in padded]) for c in range(3))
            modes_dev = decide_modes_rd_multi(ys, self.sps, qp, self.device)
            with trace.scope("wavefront", type="I", frames=len(padded)):
                rd = self.recon.run_batch(ys, us, vs, modes_dev, qp=qp,
                                          materialize=False)
            if p.deblock:
                dy, du, dv = deblock_frame_multi(
                    rd["recon_y"][:, :h], rd["recon_u"][:, :h // 2],
                    rd["recon_v"][:, :h // 2], *maps, *self._dbl_args(qp))
                rd = {**rd, "recon_y": dy, "recon_u": du, "recon_v": dv}
            return (self.recon.copy_to_host({"modes": modes_dev}),
                    self.recon.pack_batch(rd), padded)

        batches = [frames[i:i + batch] for i in range(0, len(frames), batch)]
        pool = ThreadPoolExecutor(entropy_workers) \
            if entropy_workers > 1 else None
        out: List[EncodedFrame] = []
        prev = None
        try:
            for k in range(len(batches) + 1):
                cur = dispatch(batches[k]) if k < len(batches) else None
                if prev is not None:
                    modes_h, rd, padded = prev
                    modes_np = self.recon.wait_host(modes_h)["modes"]
                    rs = self.recon.materialize_batch(rd)
                    args = [(modes_np[i], rs[i], padded[i], qp)
                            for i in range(len(rs))]
                    jobs = [pool.submit(self._intra_slice, *a) if pool
                            else self._intra_slice(*a) for a in args]
                    for i, jb in enumerate(jobs):
                        rbsp, md5 = jb.result() if pool else jb
                        out.append(self._emit_intra(rbsp, md5, rs[i], qp,
                                                    0.0))
                prev = cur
        finally:
            if pool:
                pool.shutdown()
        return out

    def _emit_minigop(self, k: Optional[int] = None) -> List[EncodedFrame]:
        if k is None or k >= len(self._queue):
            frames, self._queue = self._queue, []
        else:
            frames, self._queue = self._queue[:k], self._queue[k:]
        st = self._slicetype
        prev_disp = self._last_anchor_disp
        anchor_disp = self._idr_base + frames[-1][1]
        if st is not None and prev_disp >= 0:
            # refine complexities with the DECIDED references (the
            # reference feeds rce->lastSatd from the slicetype-decided
            # lowres cost, ratecontrol.cpp:2101): P vs its anchor, Bs
            # vs their actual (p0, p1) pair incl. the pyramid bref
            mid = len(frames) - 1
            if self.p.b_pyramid and len(frames) - 1 >= 3:
                mid = (len(frames) - 1) // 2
            mid_disp = self._idr_base + frames[mid][1]
            ref = []
            with trace.scope("la_rc_refine"):
                for i, (pl, pc, cx, qo) in enumerate(frames):
                    d = self._idr_base + pc
                    if i == len(frames) - 1:
                        cx = st.frame_cost(d, prev_disp, d)
                    elif i == mid:
                        cx = st.frame_cost(d, prev_disp, anchor_disp)
                    elif i < mid:
                        cx = st.frame_cost(d, prev_disp, mid_disp)
                    else:
                        cx = st.frame_cost(d, mid_disp, anchor_disp)
                    ref.append((pl, pc, cx, qo))
            frames = ref
        self._last_anchor_disp = anchor_disp
        if st is not None:
            st.drop_before(self._last_anchor_disp)
        out = [self._encode_picture(frames[-1][0], frames[-1][1], "P",
                                    frames[-1][2], qp_off=frames[-1][3])]
        anchor1 = (out[0].recon, out[0].poc)
        bs = frames[:-1]
        # full B reference lists (reference dpb.cpp:151): L0 = past
        # anchors closest-first up to --ref, L1 = the future anchor(s).
        # Every retained picture appears in some list, so the per-slice
        # RPS keeps the DPB coherent for later frames of the mini-GOP and
        # the next P.
        past = list(self._anchors)[:self.max_refs]
        if self.p.b_pyramid and len(bs) >= 3:
            # referenced middle B (reference placeBref, slicetype.cpp:1849)
            mid = len(bs) // 2
            bref_fr = self._encode_picture(
                bs[mid][0], bs[mid][1], "B", bs[mid][2],
                b_refs=(past, [anchor1], (), True), qp_off=bs[mid][3])
            out.append(bref_fr)
            bref = (bref_fr.recon, bref_fr.poc)
            jobs = []
            for k, (planes, poc, cplx, qoff) in enumerate(bs):
                if k == mid:
                    continue
                if k < mid:
                    # L1 = both future refs (bref closest); the far
                    # anchor rides the list, so it needs no keep entry
                    jobs.append((planes, poc, cplx, qoff,
                                 (past, [bref, anchor1], (), False)))
                else:
                    jobs.append((planes, poc, cplx, qoff,
                                 (([bref] + past)[:self.max_refs],
                                  [anchor1], (), False)))
        else:
            jobs = [(planes, poc, cplx, qoff, (past, [anchor1], (), False))
                    for (planes, poc, cplx, qoff) in bs]
        out.extend(self._encode_b_jobs(jobs))
        # decode order emitted; DPB advances to the new P anchor
        self._anchors.insert(0, anchor1)
        del self._anchors[self.max_refs:]
        self._adapt_states.update(self._est_pending)
        self._est_pending = {}
        return out

    def _encode_b_jobs(self, jobs) -> List[EncodedFrame]:
        """Encode a set of mutually independent B pictures (their anchors
        are all in hand).  Under --frame-threads > 1 they form the
        reference's frame-parallel window: each picture skips its
        rate-control update and decode-order step (defer_rc), which are
        replayed in decode order once the window is done, so every
        picture of the window takes its QP from the state before it.
        Not with HRD, VBV, NR or an analysis store, as in the
        reference.  The bytes come from the deferral alone: the jobs run
        in turn on the encoder's stream (on one card, threads made each
        job's host-bound launches slower than the two in turn; PERF.md),
        and their CABAC-state publishes land in decode order as they
        would after the reference's join."""
        par_ok = (self.p.frame_parallel_window > 1 and len(jobs) > 1
                  and not self.sps.hrd
                  and self.rc.vbv_buffer <= 0
                  and self._nr is None
                  and self._ana_store is None)
        out = [self._encode_picture(pl, pc, "B", cx, b_refs=br, qp_off=qo,
                                    defer_rc=par_ok)
               for (pl, pc, cx, qo, br) in jobs]
        if par_ok:
            for f, (_pl, _pc, cx, _qo, br) in zip(out, jobs):
                self.rc.update("B" if br[3] else "b", f.qp, f.bits, cx)
                self._enc_order += 1
        return out

    def _tiled_p_analysis(self, y, u, v, refs, qp: int, wp_l0, rect: bool,
                          col, rp_p, poc: int):
        """Tile-row sharded P analysis over the encoder's mesh of
        mesh_tile_rows shards (the reference's option set: luma-only
        weights, no AMP / SEA / HME, rounds (2, 1)).  The predictions
        are then read again from the whole-frame planes: a band's own
        MC clamps at its slab, which differs from the decoder's once a
        motion vector reaches past the 32-pixel halo (`--me star`); the
        reference keeps the band's, so its stream can fail to decode
        there, and only there does the port's differ from it."""
        if self._tiles_mesh is None:
            self._tiles_mesh = make_mesh(self.p.mesh_tile_rows, "rows",
                                         self.device)
        o = analyse_p_frame_tiles(
            y, u, v, refs, self.sps, qp, search_range=self._me_range,
            weights=wp_l0, subme=self.p.subpel_refine, rect=rect,
            mesh=self._tiles_mesh, col=col, ref_pocs=rp_p, cur_poc=poc)
        flat = list(o[:4]) + list(o[4]) + list(o[5:])
        mc = _whole_frame_mc(flat, refs, wp_l0, None, rect, False, False,
                             self._me_range, 16, self.sps.bit_depth,
                             self.device)
        return o[:4] + (mc,) + o[5:]

    # -- one picture ---------------------------------------------------------
    def _encode_picture(self, planes, poc: int, ftype: str,
                        complexity: float = 0.0, b_refs=None,
                        qp_off=None, nal_class=None,
                        defer_rc: bool = False) -> EncodedFrame:
        """b_refs: for B pictures, (L0 [(planes, poc)..], L1 [(planes,
        poc)..], extra POCs to retain in the RPS, is_referenced).
        qp_off: per-CTU cuTree QP offsets (<= 0) or None.
        nal_class: None (default typing), "cra" (open-GOP keyframe) or
        "rasl" (leading pictures of a CRA).
        defer_rc: leave the rate-control update and the decode-order
        step to the caller (a frame-parallel B window)."""
        p = self.p
        y, u, v = planes
        rc_type = ftype
        if ftype == "B" and b_refs is not None and not b_refs[3]:
            rc_type = "b"                 # non-referenced B
        # VBV lookahead: complexities of the frames already queued
        # behind this one (mini-GOP queue + lookahead buffer)
        upcoming = [q[2] for q in self._queue][:16] \
            if self.rc.vbv_buffer > 0 else None
        qp = self.rc.frame_qp(rc_type, complexity, upcoming)
        qp = self._zone_qp(self._idr_base + poc, qp)
        with trace.scope("aq_map"):
            qp_map = self._aq_map(y, qp)      # scalar when AQ off
        if qp_off is not None and np.any(qp_off != 0):
            if self.p.rc_mode == "crf":
                # CRF budgets the cuTree pull-down at the mbtree
                # offset the rate factor was raised by (ratecontrol.cpp
                # :223): distribute around the mean, with the mean
                # itself capped at (1-qcomp)*13.5 — otherwise content
                # whose lookahead saturates propagation (our -7 clip
                # everywhere) blows straight through the calibration
                mean_off = float(qp_off.mean())
                budget = (1.0 - self.p.qcomp) * 13.5
                shift = mean_off + min(-mean_off, budget)
                qp_off = np.rint(qp_off - shift).astype(np.int32)
            base = qp_map if not np.isscalar(qp_map) else \
                np.full(qp_off.shape, qp_map, np.int32)
            qp_map = np.clip(base + qp_off, self.p.qp_min,
                             min(51, self.p.qp_max)).astype(np.int32)
        recon = self.recon
        dev = self.device
        dirs = mvs1 = None
        ref_sel = ref_sel1 = None
        wp_l0 = None
        wp_chroma = None
        wp_b_l1 = None            # B-slice L1 luma weights
        rect_info = None          # (part_map, mvs_b) when rect PUs used
        intra_cand = None
        keep_pocs: tuple = ()
        b_is_ref = False
        disp = self._idr_base + poc
        trace.instant("picture", poc=poc, type=ftype, qp=qp)
        rec_a = self._ana_load.get(disp, ftype) if self._ana_load else None
        split_map = modes8 = split32 = mode32 = tu4_map = None
        if ftype == "I":
            if rec_a is not None:
                modes = rec_a["modes"]
                split_map = rec_a.get("split_map")
                modes8 = rec_a.get("modes8")
                split32 = rec_a.get("split32")
                mode32 = rec_a.get("mode32")
            elif p.var_cu_tree:
                (modes, split_map, modes8, split32, mode32, cand16,
                 cbits16) = decide_modes_tree(y, self.sps, qp, dev,
                                              nxn=p.nxn_intra)
                if cand16 is not None and p.rd_level >= 3:
                    intra_cand = (cand16, cbits16)
            elif p.nxn_intra:
                modes, split_map, modes8 = decide_modes_split(
                    y, self.sps, qp, dev, block=16,
                    tu4=p.tu_intra_depth >= 2)
                if p.tu_intra_depth >= 2 and np.any(split_map):
                    tu4_map = decide_tu4_split(y, self.sps, qp, modes8,
                                               split_map, dev)
                    if not tu4_map.any():
                        tu4_map = None
            else:
                if p.rd_level >= 3 and not p.lossless:
                    modes, c16_, cb16_ = decide_modes_rd(
                        y, self.sps, qp, dev, block=16, topk=3)
                    intra_cand = (c16_, cb16_)
                else:
                    modes = decide_modes_rd(y, self.sps, qp, dev, block=16)
            if split32 is not None:
                recon_fn = lambda qpm: recon.run_tree(
                    y, u, v, modes, split32, mode32, qp=qpm,
                    split_map=split_map, modes8=modes8,
                    cand=intra_cand, materialize=not p.deblock)
            else:
                recon_fn = lambda qpm: recon.run(
                    y, u, v, modes, qp=qpm, split_map=split_map,
                    modes8=modes8, tu4_map=tu4_map, cand=intra_cand,
                    nr=self._nr_offsets(), materialize=not p.deblock)
            inter_mask = np.zeros(modes.shape, bool)
            mvs = np.zeros(modes.shape + (2,), np.int32)
            ref_pocs = ((), ())
        elif ftype == "P":
            assert self._anchors
            refs = [a[0] for a in self._anchors]
            if p.weightp:
                from ..analysis.weightp import (
                    analyse_weightp, analyse_weightp_chroma)
                with trace.scope("weightp"):
                    cand = [analyse_weightp(y, rf[0]) for rf in refs]
                    wp_l0 = cand if any(c is not None for c in cand) \
                        else None
                    # analysis-reuse runs, tile-row analysis and the
                    # 4:2:2 / 4:4:4 formats stay luma-only, as in the
                    # reference
                    if wp_l0 is not None and rec_a is None \
                            and p.mesh_tile_rows <= 1 \
                            and p.internal_csp == 1:
                        wp_chroma = [
                            analyse_weightp_chroma(u, rf[1], v, rf[2])
                            if wp_l0[i] is not None else None
                            for i, rf in enumerate(refs)]
                        if not any(c is not None for c in wp_chroma):
                            wp_chroma = None
            rp_p = (tuple(a[1] for a in self._anchors), ())
            if rec_a is not None:
                modes = rec_a["modes"]
                inter_mask = rec_a["inter_mask"]
                mvs = rec_a["mvs"]
                ref_sel = rec_a["ref_sel"]
                mc = mc_for_p(refs, mvs, ref_sel, self.sps, dev, wp_l0)
            else:
                # rect PUs are off while saving analysis (the file
                # carries 2Nx2N motion only)
                use_rect = p.rect and self._ana_store is None
                col_a = self._col_store.get(rp_p[0][0]) \
                    if self.sps.temporal_mvp else None
                with trace.scope("analysis", type="P"):
                    if p.mesh_tile_rows > 1:
                        got = self._tiled_p_analysis(
                            y, u, v, refs, qp, wp_l0, use_rect, col_a,
                            rp_p, poc)
                    else:
                        got = analyse_p_frame(
                            y, u, v, refs, self.sps, qp, dev,
                            search_range=self._me_range, weights=wp_l0,
                            subme=p.subpel_refine, rect=use_rect,
                            amp=p.amp, chroma_weights=wp_chroma,
                            me_sea=p.search_method == "sea", col=col_a,
                            ref_pocs=rp_p, cur_poc=poc,
                            pad_refs=self.max_refs, hme=p.hme,
                            rounds=self._rounds_p)
                modes, inter_mask, mvs, ref_sel, mc, part_map, mvs_b = got
                if np.any(part_map):
                    rect_info = (part_map, mvs_b)
            recon_fn = self._inter_recon_fn(
                y, u, v, modes, mc, inter_mask, 1, mvs, None, None,
                ref_sel, rect_info,
                ebits=(self._ebits_for(1, qp, per_row=True),
                       self._ebits_for(1, qp)))
            ref_pocs = rp_p
        else:
            (list0, list1, keep_pocs, b_is_ref) = b_refs
            wpb = None
            if getattr(p, "weightb", False) and rec_a is None:
                from ..analysis.weightp import analyse_weightp
                c0 = analyse_weightp(y, list0[0][0][0])
                c1 = analyse_weightp(y, list1[0][0][0])
                if c0 is not None or c1 is not None:
                    wpb = (c0, c1)
                    wp_l0 = (c0,)
                    wp_b_l1 = (c1,)
                    # the weight tables carry one set per list — keep
                    # the lists at 1+1 so wp entries match num_ref_idx
                    list0 = list0[:1]
                    list1 = list1[:1]
            rp_b = (tuple(a[1] for a in list0),
                    tuple(a[1] for a in list1))
            if rec_a is not None:
                modes = rec_a["modes"]
                inter_mask = rec_a["inter_mask"]
                dirs = rec_a["dirs"]
                mvs = rec_a["mvs"]
                mvs1 = rec_a["mvs1"]
                ref_sel = rec_a.get("ref_sel")
                ref_sel1 = rec_a.get("ref_sel1")
                mc = mc_for_b([a[0] for a in list0], [a[0] for a in list1],
                              dirs, mvs, mvs1, self.sps, dev,
                              ref_sel0=ref_sel, ref_sel1=ref_sel1)
            else:
                use_rect_b = p.rect and self._ana_store is None
                col_b = self._col_store.get(rp_b[0][0]) \
                    if self.sps.temporal_mvp else None
                with trace.scope("analysis", type="B"):
                    (modes, inter_mask, dirs, mvs, mvs1, ref_sel, ref_sel1,
                     mc, part_map_b, pu1_b) = analyse_b_frame(
                        y, u, v, [a[0] for a in list0],
                        [a[0] for a in list1], self.sps, qp, dev,
                        search_range=self._me_range, subme=p.subpel_refine,
                        weights_b=wpb, rect=use_rect_b, amp=p.amp,
                        me_sea=p.search_method == "sea", col=col_b,
                        ref_pocs=rp_b, cur_poc=poc,
                        pad_refs=(self.max_refs, 2 if p.b_pyramid else 1),
                        hme=p.hme, rounds=self._rounds_b)
                if np.any(part_map_b):
                    # B rect: (part, PU1 dirs, PU1 mv L0, PU1 mv L1)
                    rect_info = (part_map_b, pu1_b[1], pu1_b[2], pu1_b[0])
            recon_fn = self._inter_recon_fn(
                y, u, v, modes, mc, inter_mask, 0, mvs, mvs1, dirs,
                ref_sel, rect_info, ref_sel1=ref_sel1,
                ebits=(self._ebits_for(0, qp, per_row=True),
                       self._ebits_for(0, qp)))
            ref_pocs = rp_b
        if nal_class == "cra":
            nal_unit = NAL_CRA_NUT
        elif nal_class == "rasl":
            nal_unit = NAL_RASL_R if b_is_ref else NAL_RASL_N
        else:
            nal_unit = {"I": NAL_IDR_W_RADL, "P": NAL_TRAIL_R,
                        "B": NAL_TRAIL_R if b_is_ref else NAL_TRAIL_N
                        }[ftype]
        # temporal sub-layers (x265 --temporal-layers, dpb.cpp:181/241):
        # non-ref b ride the top layer as TSA_N; at 3 layers the
        # pyramid's referenced mid-B is layer 1 (TSA_R).  RASL typing
        # (open-GOP leading pictures) outranks TSA.
        temporal_id = 0
        if p.temporal_layers >= 2 and ftype == "B" and nal_class is None:
            if not b_is_ref:
                temporal_id = p.temporal_layers - 1
                nal_unit = NAL_TSA_N
            elif p.temporal_layers >= 3:
                temporal_id = 1
                nal_unit = NAL_TSA_R

        def run_pipeline(qpm):
            with trace.scope("wavefront", type=ftype):
                r = recon_fn(qpm)
                self._post_wavefront(r)
            # in-wavefront RD mode selection: syntax codes the winners
            ms = r.get("modes_sel", modes)
            dqp_map = self._derived_qp_map(qpm, r, qp)
            with trace.scope("loopfilter", type=ftype):
                self._deblock(r, inter_mask, mvs, mvs1, dirs, ref_pocs,
                              dqp_map, recon, ref_sel, split_map, split32,
                              rect_info, ref_sel1=ref_sel1)
                self._force_levels(r)
                sao_maps = self._sao(r, y, u, v, qp) if p.sao else None
            with trace.scope("entropy", type=ftype):
                rbsp = self._encode_slice(
                    ms, inter_mask, mvs, mvs1, dirs, r, ftype, poc, qp,
                    ref_pocs, sao_maps, ref_sel, keep_pocs, qpm, wp_l0,
                    split32, mode32, wp_chroma, nal_unit, rect_info,
                    ref_sel1=ref_sel1, wp_b_l1=wp_b_l1,
                    split_map=split_map, modes8=modes8, tu4_map=tu4_map)
            with trace.scope("recon_fetch", type=ftype):
                self._finalize_recon(r)
            return r, sao_maps, rbsp

        r, sao_maps, slice_rbsp = run_pipeline(qp_map)
        runs = 1
        # row-level VBV: when the coded frame would underflow the CPB,
        # raise QP from the first over-budget CTU row on and re-encode
        # (reference rowVbvRateControl + row re-encode,
        # ratecontrol.cpp:3034 / frameencoder.cpp:1990)
        if self.rc.vbv_buffer > 0 and self.pps.cu_qp_delta_enabled:
            for retry in range(3):
                adj = self.rc.row_vbv_plan(
                    slice_rbsp if isinstance(slice_rbsp, list)
                    else [slice_rbsp],
                    self._last_row_bits, retry)
                if adj is None:
                    break
                r0_adj, dq = adj
                base = qp_map if not np.isscalar(qp_map) else np.full(
                    (self.sps.pic_height_in_ctus,
                     self.sps.pic_width_in_ctus), qp_map, np.int32)
                base = base.copy()
                base[r0_adj:] = np.clip(base[r0_adj:] + dq, self.p.qp_min,
                                        min(51, self.p.qp_max))
                qp_map = base
                with trace.scope("vbv_reencode", type=ftype, retry=retry):
                    r, sao_maps, slice_rbsp = run_pipeline(qp_map)
                runs += 1
        self._nr_update(r)
        if self._ana_store is not None:
            # saved after the final pipeline run, so the stored modes are
            # the in-wavefront RD winners the syntax coded
            self._ana_store.save(
                disp, ftype,
                modes=np.asarray(r.get("modes_sel", modes)),
                inter_mask=inter_mask,
                mvs=mvs, ref_sel=ref_sel, ref_sel1=ref_sel1,
                dirs=dirs, mvs1=mvs1,
                split_map=split_map, modes8=modes8, split32=split32,
                mode32=mode32)
        with trace.scope("md5"):
            md5 = plane_md5(r["recon_y"], r["recon_u"], r["recon_v"],
                            bit_depth=self.sps.bit_depth)
        out = b""
        if self._dhdr10:
            from ..bitstream.hdr10plus import write_dhdr10_sei
            from ..bitstream.nal import NAL_PREFIX_SEI
            disp_i = self._idr_base + poc
            if disp_i < len(self._dhdr10):
                out += annexb(NAL_PREFIX_SEI,
                              write_dhdr10_sei(self._dhdr10[disp_i]))
        if p.aud:
            from ..bitstream.nal import NAL_AUD
            bw_aud = BitWriter()
            bw_aud.u({"I": 0, "P": 1, "B": 2}[ftype], 3)   # pic_type
            bw_aud.rbsp_trailing_bits()
            out += annexb(NAL_AUD, bw_aud.get_bytes())
        if not self._headers_sent or (p.repeat_headers and ftype == "I"):
            out += self.headers()
            self._headers_sent = True
        # interlace signaling (reference frameencoder.cpp:803-830):
        # pic_struct per AU when the VUI declared frame_field_info
        pic_struct = None
        if p.interlace:
            disp_ix = self._idr_base + poc
            if p.interlace == 1:                 # tff
                pic_struct = 2 if (disp_ix & 1) else 1
            else:                                # bff
                pic_struct = 1 if (disp_ix & 1) else 2
        if self.sps.hrd:
            # HRD timing SEIs (reference initHRD/hrdFullness,
            # ratecontrol.cpp:934/2694): buffering period on IDR, pic
            # timing on every AU
            from ..bitstream.sei import (write_buffering_period,
                                         write_pic_timing)
            from ..bitstream.headers import hrd_signaled
            from ..bitstream.nal import NAL_PREFIX_SEI
            br, cpb = hrd_signaled(self.sps)
            if ftype == "I":
                fill = min(self.rc.vbv_fullness, cpb)
                delay = min(int(round(90000.0 * fill / br)),
                            (1 << 24) - 1)
                offset = min(int(round(90000.0 * (cpb - fill) / br)),
                             (1 << 24) - 1)
                out += annexb(NAL_PREFIX_SEI,
                              write_buffering_period(delay, offset))
                self._last_bp_order = self._enc_order
            au_delay_m1 = max(0, self._enc_order - self._last_bp_order
                              - 1)
            dpb_delay = (self.sps.num_reorder_pics
                         + (self._idr_base + poc) - self._enc_order)
            out += annexb(NAL_PREFIX_SEI,
                          write_pic_timing(au_delay_m1,
                                           max(0, dpb_delay),
                                           pic_struct=pic_struct))
        elif pic_struct is not None:
            from ..bitstream.sei import write_pic_timing
            from ..bitstream.nal import NAL_PREFIX_SEI
            out += annexb(NAL_PREFIX_SEI,
                          write_pic_timing(pic_struct=pic_struct))
        if not defer_rc:
            self._enc_order += 1
        if isinstance(slice_rbsp, list):
            for rb in slice_rbsp:
                out += annexb(nal_unit, rb, temporal_id=temporal_id)
        else:
            out += annexb(nal_unit, slice_rbsp, temporal_id=temporal_id)
        if p.decoded_picture_hash:
            out += annexb(NAL_SUFFIX_SEI, write_decoded_picture_hash(md5),
                          temporal_id=temporal_id)
        if self._rpus:
            disp_i = self._idr_base + poc
            out += self._rpus[min(disp_i, len(self._rpus) - 1)]
        frame = EncodedFrame(poc, out,
                             (r["recon_y"], r["recon_u"], r["recon_v"]),
                             bits=len(out) * 8, md5=md5, slice_type=ftype,
                             qp=qp, disp=self._idr_base + poc,
                             stats=self._frame_stats(r, inter_mask, mvs,
                                                     rect_info),
                             pipeline_runs=runs, qp_map=qp_map)
        if not defer_rc:
            self.rc.update(rc_type, qp, frame.bits, complexity)
        if self.sps.temporal_mvp and (ftype in ("I", "P") or b_is_ref):
            self._col_store[poc] = self._build_col_motion(
                poc, inter_mask, dirs, mvs, mvs1, ref_sel, ref_pocs,
                ref_sel1=ref_sel1)
            if len(self._col_store) > self.max_refs + 3:
                for k in sorted(self._col_store)[:-(self.max_refs + 3)]:
                    del self._col_store[k]
        if ftype == "I":
            self._anchors = [(frame.recon, poc)]
            self._col_store = {k: v for k, v in self._col_store.items()
                               if k == poc}
        return frame

    def _nr_offsets(self):
        """Current denoise offsets ((2,256) luma, (2,64) chroma int32,
        [intra, inter] rows) from the running sums (the
        noiseReductionUpdate formula; DC never denoised)."""
        if self._nr is None:
            return None
        st = self._nr
        caps = (1 << 14, 1 << 14, 1 << 16, 1 << 16)   # y-i y-p c-i c-p
        for ci, cap in enumerate(caps):
            if st["cnt"][ci] > cap:
                arr = st["sy"] if ci < 2 else st["sc"]
                arr[ci & 1] >>= 1
                st["cnt"][ci] >>= 1
        out = []
        for arr, ci0 in ((st["sy"], 0), (st["sc"], 2)):
            offs = np.zeros_like(arr, np.int32)
            for j in (0, 1):
                strength = self.p.nr_intra if j == 0 else self.p.nr_inter
                cnt = st["cnt"][ci0 + j]
                val = (strength * cnt + arr[j] // 2) // (arr[j] + 1)
                offs[j] = val.astype(np.int32)
                offs[j, 0] = 0                     # keep DC intact
            out.append(offs)
        return (out[0], out[1])

    def _nr_update(self, r: dict) -> None:
        if self._nr is None or "nr_stats" not in r:
            return
        ys_i, ys_p, cs_i, cs_p, cnt = [np.asarray(a, np.int64)
                                       for a in r["nr_stats"]]
        self._nr["sy"][0] += ys_i
        self._nr["sy"][1] += ys_p
        self._nr["sc"][0] += cs_i
        self._nr["sc"][1] += cs_p
        self._nr["cnt"] += cnt

    def _frame_stats(self, r, inter_mask, mvs, rect_info) -> dict:
        """Per-frame CU/MV/VBV stats (the x265 FrameStats subset the
        --csv-log-level 2 CSV reports, encoder.cpp writeLog)."""
        st: dict = {}
        rc = self.rc
        if getattr(rc, "vbv_buffer", 0):
            st["vbv_fill_pct"] = round(
                100.0 * rc.vbv_fullness / rc.vbv_buffer, 2)
        try:
            lv_any = ((r["lev_y"].reshape(r["lev_y"].shape[0],
                                          r["lev_y"].shape[1], -1)
                       != 0).any(-1) |
                      (r["lev_u"].reshape(r["lev_u"].shape[0],
                                          r["lev_u"].shape[1], -1)
                       != 0).any(-1) |
                      (r["lev_v"].reshape(r["lev_v"].shape[0],
                                          r["lev_v"].shape[1], -1)
                       != 0).any(-1))
        except Exception:
            lv_any = None
        if inter_mask is None or not inter_mask.any():
            st["cu_intra_pct"] = 100.0
            st["cu_inter_pct"] = st["cu_skip_pct"] = 0.0
        else:
            nb = inter_mask.size
            st["cu_intra_pct"] = round(
                100.0 * (~inter_mask).sum() / nb, 2)
            st["cu_inter_pct"] = round(
                100.0 * inter_mask.sum() / nb, 2)
            if lv_any is not None and lv_any.shape == inter_mask.shape:
                st["cu_skip_pct"] = round(
                    100.0 * (inter_mask & ~lv_any).sum() / nb, 2)
            if rect_info is not None:
                pm = rect_info[0]
                st["cu_rect_pct"] = round(
                    100.0 * ((pm > 0) & (pm < 4) & inter_mask).sum()
                    / nb, 2)
                st["cu_amp_pct"] = round(
                    100.0 * ((pm >= 4) & inter_mask).sum() / nb, 2)
            if mvs is not None:
                m = np.abs(mvs[inter_mask]).astype(np.float64) / 4.0
                if m.size:
                    st["avg_mv"] = round(float(m.mean()), 2)
                    st["max_mv"] = round(float(m.max()), 2)
        return st

    def _build_col_motion(self, poc, inter_mask, dirs, mvs, mvs1,
                          ref_sel, ref_pocs, ref_sel1=None):
        """16x16-grid compressed motion field of this picture for TMVP
        (the reference's motion compression of colMVs)."""
        from ..entropy.mv_pred import ColMotion
        nby, nbx = self.recon.nby, self.recon.nbx
        d = np.zeros((nby, nbx), np.int8)
        mv = np.zeros((nby, nbx, 2, 2), np.int32)
        rp = np.zeros((nby, nbx, 2), np.int64)
        if inter_mask.any():
            dd = np.where(inter_mask, 1 if dirs is None else dirs, 0)
            d[:] = dd.astype(np.int8)
            mv[..., 0, :] = mvs
            if mvs1 is not None:
                mv[..., 1, :] = mvs1
            for lst, sel in ((0, ref_sel), (1, ref_sel1)):
                if ref_pocs[lst]:
                    tab = np.asarray(ref_pocs[lst], np.int64)
                    rp[..., lst] = tab[0] if sel is None else \
                        tab[np.clip(sel, 0, len(tab) - 1)]
        return ColMotion(poc, d, mv, rp)

    def _post_wavefront(self, r: dict) -> None:
        """Pull the small per-block nonzero maps (and the in-wavefront
        mode winners) to the host; the int16-packed levels follow in
        _force_levels, after the loop filters are queued."""
        if not isinstance(r.get("lev_y"), torch.Tensor):
            return
        l16_y, l16_u, l16_v, nzy, nzu, nzv = pack_levels(
            r["lev_y"], r["lev_u"], r["lev_v"])
        r["_lev_pend"] = (l16_y, l16_u, l16_v)
        r["nz_y"] = nzy.cpu().numpy()
        r["nz_u"] = nzu.cpu().numpy()
        r["nz_v"] = nzv.cpu().numpy()
        if "modes_sel" in r:
            r["modes_sel"] = r["modes_sel"].cpu().numpy()
        if "nr_stats" in r:
            r["nr_stats"] = tuple(a.cpu().numpy() for a in r["nr_stats"])

    def _force_levels(self, r: dict) -> None:
        pend = r.pop("_lev_pend", None)
        if pend is None:
            return
        r["lev_y"], r["lev_u"], r["lev_v"] = (a.cpu().numpy() for a in pend)

    def _finalize_recon(self, r: dict) -> None:
        """Bring the final recon to the host in one packed transfer,
        keeping the device int32 planes attached for the DPB."""
        dy = r.get("recon_y")
        if not isinstance(dy, torch.Tensor):
            return
        du, dv = r["recon_u"], r["recon_v"]
        host = pack_recon(dy, du, dv, self.sps.bit_depth).cpu().numpy()
        if host.dtype == np.int16:
            host = host.view(np.uint16)
        o1 = dy.shape[0] * dy.shape[1]
        o2 = o1 + du.shape[0] * du.shape[1]
        r["recon_y"] = attach_dev(host[:o1].reshape(dy.shape),
                                  dy.contiguous())
        r["recon_u"] = attach_dev(host[o1:o2].reshape(du.shape),
                                  du.contiguous())
        r["recon_v"] = attach_dev(host[o2:].reshape(dv.shape),
                                  dv.contiguous())

    def _publish_est(self, slice_type: int, states) -> None:
        """Publish end-of-slice CABAC states for the adaptive rate
        tables; they take effect at the next mini-GOP boundary."""
        self._est_pending[slice_type] = states

    def _ebits_for(self, init_type: int, qp: int,
                   per_row: bool = False):
        """Rate table(s) for this frame's RD estimates from the
        previous same-type slice's context states (one-frame-lag analog
        of the reference's EstBitsSbac refresh, entropy.cpp:2624);
        slice-start states before the first frame of a type.

        per_row=False: (C, 2) from the end-of-stream states.
        per_row=True: (nby+1, C, 2) block-row tables from the per-WPP-
        row start states (broadcast of the single table when row states
        are unavailable) — shape is FIXED either way so the wavefront
        keeps one trace per mode."""
        from ..entropy.est_bits import bits_table_from_states
        got = self._adapt_states.get(init_type)
        rows = None
        if isinstance(got, dict):
            rows, got = got.get("rows"), got["end"]
        if got is None:
            got = init_states(init_type, int(qp))
        if not per_row:
            return bits_table_from_states(got)
        nby = self.recon.nby
        if rows is None:
            tab = bits_table_from_states(got)[None]
        else:
            tab = np.stack([bits_table_from_states(s) for s in rows])
            bpc = self.recon.bpc
            tab = np.repeat(tab, bpc, axis=0)
        if tab.shape[0] < nby + 1:
            tab = np.concatenate(
                [tab, np.repeat(tab[-1:], nby + 1 - tab.shape[0], 0)], 0)
        return tab[:nby + 1]

    def _inter_recon_fn(self, y, u, v, modes, mc, inter_mask,
                        init_type: int, mvs, mvs1, dirs, ref_sel,
                        rect_info, ref_sel1=None, ebits=None):
        """Wavefront runner for P/B frames with the inter TU32 pre-pass
        (frame/inter_tu32.py)."""
        recon = self.recon
        i32_mask = None
        if (self.p.var_cu_tree and inter_mask is not None
                and self._nr_offsets() is None):
            from ..frame.inter_tu32 import region_uniform_mask
            part_map = rect_info[0] if rect_info is not None else None
            m = region_uniform_mask(
                np.asarray(inter_mask, bool), np.asarray(mvs), mvs1, dirs,
                ref_sel, part_map, self.sps.width, self.sps.height,
                ref_sel1=ref_sel1)
            if m.any():
                i32_mask = m
        eb_rows, eb_flat = ebits if ebits is not None else (None, None)

        def fn(qpm):
            i32 = None
            if i32_mask is not None:
                from ..frame.inter_tu32 import prepare_inter_tu32
                with trace.scope("inter_tu32"):
                    i32 = prepare_inter_tu32(y, u, v, mc, i32_mask, qpm,
                                             recon, init_type,
                                             ebits=eb_flat)
            dev_ok = self.p.deblock
            if i32 is None:
                r = recon.run(y, u, v, modes, mc, inter_mask, qp=qpm,
                              init_type=init_type, nr=self._nr_offsets(),
                              ebits=eb_rows, materialize=not dev_ok)
            else:
                y2, u2, v2, mc2 = i32["spliced"]
                r = recon.run(y2, u2, v2, modes, mc2, inter_mask, qp=qpm,
                              init_type=init_type, nr=self._nr_offsets(),
                              ebits=eb_rows, materialize=not dev_ok)
                r["inter32"] = i32
            return r
        return fn

    def _deblock(self, r: dict, inter_mask, mvs, mvs1, dirs, ref_pocs, qp,
                 recon, ref_sel=None, split_map=None, split32=None,
                 rect_info=None, ref_sel1=None) -> None:
        if not self.p.deblock:
            return
        p = self.p
        w, h = self.sps.width, self.sps.height
        if inter_mask is not None and inter_mask.any():
            nbx, nby = recon.nbx, recon.nby
            cbf = r.get("nz_y")
            if cbf is None:
                lv = np.asarray(r["lev_y"])
                cbf = (lv.reshape(lv.shape[0], lv.shape[1], -1)
                       != 0).any(-1)
            cbf = np.asarray(cbf[:nby, :nbx]).copy()
            tu32_use = None
            i32 = r.get("inter32")
            if i32 is not None:
                tu32_use = i32["use"]
                cbf32 = np.repeat(np.repeat(i32["nzy"], 2, 0), 2, 1)
                use_b = np.repeat(np.repeat(tu32_use, 2, 0), 2, 1)
                h2, w2 = use_b.shape
                cbf[:h2, :w2] = np.where(use_b, cbf32, cbf[:h2, :w2])
            if dirs is None:
                dirs_m = np.where(inter_mask, 1, 0).astype(np.int32)
                mvs1_m = np.zeros_like(mvs)
            else:
                dirs_m = np.where(inter_mask, dirs, 0).astype(np.int32)
                mvs1_m = mvs1
            p0, p1 = (
                np.asarray(ref_pocs[lst], np.int64)[
                    np.clip(sel, 0, len(ref_pocs[lst]) - 1)]
                if sel is not None and ref_pocs[lst] else
                np.full((nby, nbx), ref_pocs[lst][0] if ref_pocs[lst]
                        else 0, np.int64)
                for lst, sel in ((0, ref_sel), (1, ref_sel1)))
            part16 = pu1 = None
            if rect_info is not None:
                part_map, mvs_b = rect_info[0], rect_info[1]
                part16 = np.where(inter_mask, part_map, 0)
                if len(rect_info) > 2:
                    # B rect: PU1 has its own list (uni-pred per PU)
                    d_b = np.where(part16 > 0, rect_info[3],
                                   0).astype(np.int32)
                    pu1 = (d_b, mvs_b.astype(np.int32),
                           rect_info[2].astype(np.int32),
                           np.where((d_b & 1) > 0, p0, 0),
                           np.where((d_b & 2) > 0, p1, 0))
                else:
                    # P: PU1 shares the CU's list-0 ref
                    pu1 = (np.where(part16 > 0, 1, 0).astype(np.int32),
                           mvs_b.astype(np.int32),
                           np.zeros_like(mvs_b),
                           np.where(part16 > 0, p0, 0),
                           np.zeros_like(p0))
            bs_v, bs_h = inter_bs_maps(~inter_mask, mvs, cbf, w, h, 16,
                                       dirs_m, mvs1_m, p0, p1, split_map,
                                       part_map=part16, pu1=pu1,
                                       tu32_mask=tu32_use)
        else:
            merge32 = ~split32 if split32 is not None else None
            bs_v, bs_h = intra_bs_maps(w, h, 16, split_map, merge32)
        csp = p.internal_csp
        on_v, on_h = chroma_on_maps(bs_v, bs_h, h >> self.cshift_y,
                                    w >> self.cshift, csp=csp)
        dev = self.device
        keep_dev = isinstance(r["recon_y"], torch.Tensor)
        dy, du, dv = deblock_frame_batch(
            dev_i32(r["recon_y"], dev), dev_i32(r["recon_u"], dev),
            dev_i32(r["recon_v"], dev), bs_v, bs_h, on_v, on_h, qp,
            p.cb_qp_offset if not np.isscalar(qp)
            else chroma_qp(qp, p.cb_qp_offset, csp),
            p.cr_qp_offset if not np.isscalar(qp)
            else chroma_qp(qp, p.cr_qp_offset, csp),
            p.deblock_beta_offset, p.deblock_tc_offset,
            self.sps.bit_depth, csp, self.sps.log2_ctu_size)
        if keep_dev:
            r["recon_y"], r["recon_u"], r["recon_v"] = dy, du, dv
        else:
            r["recon_y"] = dy.cpu().numpy().astype(self.pix_dtype)
            r["recon_u"] = du.cpu().numpy().astype(self.pix_dtype)
            r["recon_v"] = dv.cpu().numpy().astype(self.pix_dtype)

    def _sao(self, r: dict, oy, ou, ov, qp: int):
        """SAO decide + apply on the deblocked recon (stats/apply on the
        device, per-CTU RDO on the host).  Returns the per-plane maps for
        the syntax."""
        from ..ops.sao import (sao_apply_batch, sao_decide,
                               sao_decide_chroma, sao_merge_pass,
                               sao_stats_batch)
        sps = self.sps
        dev = self.device
        ctu = 1 << sps.log2_ctu_size
        cctu = ctu >> self.cshift if not self.is422 \
            else (ctu, ctu >> 1)      # 4:2:2: rectangular chroma tiles
        lam2 = lambda_qp(qp)[1]
        keep_dev = isinstance(r["recon_y"], torch.Tensor)

        def padded(pl, tile):
            th, tw = (tile, tile) if isinstance(tile, int) else tile
            d = dev_i32(pl, dev)
            h, w = d.shape
            ph = -(-h // th) * th
            pw = -(-w // tw) * tw
            if (ph, pw) == (h, w):
                return d
            return torch.nn.functional.pad(d, (0, pw - w, 0, ph - h))

        h, w = sps.height, sps.width
        hc = h >> self.cshift_y
        wc = w >> self.cshift
        bd = sps.bit_depth
        host = lambda st: tuple(a.cpu().numpy() for a in st)
        st_y = host(sao_stats_batch(padded(oy, ctu),
                                    padded(r["recon_y"], ctu), ctu, h, w,
                                    bd))
        *maps_y, cost_y = sao_decide(*st_y, lam2, bd)
        st_cb = host(sao_stats_batch(padded(ou, cctu),
                                     padded(r["recon_u"], cctu), cctu, hc,
                                     wc, bd))
        st_cr = host(sao_stats_batch(padded(ov, cctu),
                                     padded(r["recon_v"], cctu), cctu, hc,
                                     wc, bd))
        maps_cb, maps_cr, cost_c = sao_decide_chroma(st_cb, st_cr, lam2, bd)
        maps_y = [np.asarray(m) for m in maps_y]
        maps_cb = [np.asarray(m) for m in maps_cb]
        maps_cr = [np.asarray(m) for m in maps_cr]
        merge_map = sao_merge_pass(
            (st_y, st_cb, st_cr), (maps_y, maps_cb, maps_cr),
            np.asarray(cost_y) + np.asarray(cost_c), lam2,
            slice_top_rows=tuple(r0 for (r0, _r1) in self._slice_bands
                                 if r0 > 0))
        for key, maps, tile, ph, pw in (("recon_y", maps_y, ctu, h, w),
                                        ("recon_u", maps_cb, cctu, hc, wc),
                                        ("recon_v", maps_cr, cctu, hc, wc)):
            out = sao_apply_batch(padded(r[key], tile), maps[0], maps[1],
                                  maps[2], maps[3], tile, ph, pw, bd)
            if keep_dev:
                r[key] = out[:ph, :pw]
            else:
                r[key] = out[:ph, :pw].cpu().numpy().astype(self.pix_dtype)
        return maps_y, maps_cb, maps_cr, merge_map

    def _pad(self, plane: np.ndarray, comp_shift: int) -> np.ndarray:
        """Pad a source plane to the coded (min-CU aligned) size by edge
        replication (reference PicYuv padding, picyuv.cpp)."""
        sy = comp_shift if not self.is422 else 0
        th = self.sps.height >> sy
        tw = self.sps.width >> comp_shift
        h, w = plane.shape
        if (h, w) == (th, tw):
            return plane
        out = np.empty((th, tw), plane.dtype)
        out[:h, :w] = plane
        out[:h, w:] = plane[:, w - 1:w]
        out[h:, :] = out[h - 1:h, :]
        return out

    def _native_intra_rows(self, lvy, lvu, lvv, nzy, nzu, nzv, modes,
                           split32, mode32, qp, qp_map, sao_maps,
                           use_wpp, tree):
        """Run the native intra walker (one C call per slice / WPP
        row).  Returns [(bins, ctx, mark), ...] or None when the native
        library is unavailable."""
        from ..entropy.residual import _native_setup, _merge_tables
        from ..entropy.contexts import OFF
        if not _native_setup():
            return None
        nat, blob, offs, roff = _merge_tables()
        sps, pps = self.sps, self.pps
        nby, nbx = nzy.shape
        n_ctu_x, n_ctu_y = sps.pic_width_in_ctus, sps.pic_height_in_ctus
        coff = np.array(
            [OFF["SPLIT_FLAG"], OFF["PART_SIZE"], OFF["ADI"],
             OFF["CHROMA_PRED"], OFF["DELTA_QP"], OFF["QT_CBF"],
             OFF["TRANS_SUBDIV"], OFF["SAO_MERGE"], OFF["SAO_TYPE"]],
            np.int32)
        lvy = np.ascontiguousarray(lvy, np.int32)
        lvu = np.ascontiguousarray(lvu, np.int32)
        lvv = np.ascontiguousarray(lvv, np.int32)
        nzy8 = np.ascontiguousarray(nzy, np.uint8)
        nzu8 = np.ascontiguousarray(nzu, np.uint8)
        nzv8 = np.ascontiguousarray(nzv, np.uint8)
        modes_c = np.ascontiguousarray(modes, np.int32)
        dqp = pps.cu_qp_delta_enabled
        qpm = None
        if dqp and qp_map is not None and not np.isscalar(qp_map):
            qpm = np.ascontiguousarray(qp_map, np.int32)
        sao_pack = merge_pack = None
        if sao_maps is not None:
            sao_pack = np.zeros((n_ctu_y, n_ctu_x, 3, 7), np.int32)
            for c, m in enumerate(sao_maps[:3]):
                sao_pack[:, :, c, 0] = m[0]
                sao_pack[:, :, c, 1] = m[1]
                sao_pack[:, :, c, 2] = m[2]
                sao_pack[:, :, c, 3:] = m[3]
            merge_pack = np.ascontiguousarray(np.asarray(sao_maps[3]),
                                              np.int32)
        s32 = None if split32 is None else \
            np.ascontiguousarray(np.asarray(split32), np.uint8)
        m32 = None if mode32 is None else \
            np.ascontiguousarray(np.asarray(mode32), np.int32)
        ranges = [(cy, cy + 1) for cy in range(n_ctu_y)] if use_wpp \
            else [(0, n_ctu_y)]
        cap = (1 << 20) if use_wpp else max(1 << 21, 256 * nbx * nby)
        for _attempt in range(4):
            mode16 = np.full((nby, nbx), -1, np.int8)
            depth16 = np.full((nby, nbx), -1, np.int8)
            state = np.array([qp], np.int32)
            rows = []
            ok = True
            for (cy0, cy1) in ranges:
                out_bins = np.empty(cap, np.uint8)
                out_ctx = np.empty(cap, np.int32)
                mark = np.zeros(1, np.int64)
                prm = np.array(
                    [sps.width, sps.height, nbx, nby, n_ctu_x, n_ctu_y,
                     sps.log2_ctu_size, sps.log2_max_tu_size,
                     sps.max_transform_hierarchy_depth_intra,
                     1 if tree else 0, 1 if dqp else 0, qp,
                     1 if pps.entropy_coding_sync else 0, cy0, cy1,
                     sps.bit_depth, 1 if pps.sign_hide else 0,
                     0 if tree else 1, 1 if use_wpp else 0,
                     sps.log2_min_cu_size], np.int32)
                n = nat.intra_slice_bins(
                    prm, modes_c, s32, m32, nzy8, nzu8, nzv8, lvy, lvu,
                    lvv, qpm, sao_pack, merge_pack, blob, offs, roff,
                    coff, mode16, depth16, state, out_bins, out_ctx,
                    mark)
                if n < 0:
                    ok = False
                    break
                rows.append((out_bins[:n], out_ctx[:n], int(mark[0])))
            if ok:
                return rows
            cap *= 2
        return None

    def _encode_slice(self, modes, inter_mask, mvs, mvs1, dirs, r: dict,
                      ftype: str, poc: int, qp: int, ref_pocs, sao_maps,
                      ref_sel, keep_pocs, qp_map, wp_l0, split32, mode32,
                      wp_chroma, nal, rect_info=None, ref_sel1=None,
                      wp_b_l1=None, split_map=None, modes8=None,
                      tu4_map=None):
        """Slice data of one picture: the rbsp bytes, or one rbsp per
        slice when the picture is cut into several."""
        sps, pps = self.sps, self.pps
        slice_type = {"I": SLICE_I, "P": SLICE_P, "B": SLICE_B}[ftype]
        sh = SliceHeader(slice_type=slice_type, nal_type=nal, poc=poc,
                         qp=qp,
                         deblocking_disabled=pps.deblocking_disabled,
                         five_minus_max_num_merge_cand=5 - MAX_MERGE,
                         sao_luma=sao_maps is not None,
                         sao_chroma=sao_maps is not None)
        num_refs = (0, 0)
        if ftype == "P":
            n_l0 = len(ref_pocs[0])
            num_refs = (n_l0, 0)
            sh.num_ref_idx = (n_l0, 0)
            sh.st_rps_neg = tuple((rp - poc, True) for rp in ref_pocs[0])
            if wp_l0 is not None:
                sh.wp_l0 = tuple(wp_l0)
                if wp_chroma is not None:
                    sh.wp_l0_chroma = tuple(wp_chroma)
        elif ftype == "B":
            n_l0 = max(1, len(ref_pocs[0]))
            n_l1 = max(1, len(ref_pocs[1]))
            num_refs = (n_l0, n_l1)
            sh.num_ref_idx = (n_l0, n_l1)
            if self.pps.weighted_bipred:
                if wp_l0 is not None:
                    sh.wp_l0 = tuple(wp_l0)
                if wp_b_l1 is not None:
                    sh.wp_l1 = tuple(wp_b_l1)
            # RPS: every list ref (used_by_curr = 1) plus pictures kept
            # for later frames of the mini-GOP (used_by_curr = 0),
            # sorted per spec order.  The decoder rebuilds L0 = neg+pos
            # and L1 = pos+neg from the used entries in this order
            # (spec 8.3.4), which matches the analysis list order
            # because both lists are closest-first.
            neg = [(rp - poc, True) for rp in ref_pocs[0]] + \
                [(kp - poc, False) for kp in keep_pocs if kp < poc]
            pos = [(rp - poc, True) for rp in ref_pocs[1]] + \
                [(kp - poc, False) for kp in keep_pocs if kp > poc]
            sh.st_rps_neg = tuple(sorted(set(neg), reverse=True))
            sh.st_rps_pos = tuple(sorted(set(pos)))
        col = None
        if sps.temporal_mvp and ftype != "I" and ref_pocs[0]:
            col = self._col_store.get(ref_pocs[0][0])
        sh.temporal_mvp = sps.temporal_mvp and ftype != "I" and \
            col is not None
        syn = SliceSyntaxEncoder(sps, pps, qp, slice_type, MAX_MERGE,
                                 num_refs=num_refs, ref_pocs=ref_pocs,
                                 cur_poc=poc,
                                 col_motion=col if sh.temporal_mvp
                                 else None)
        n_ctu_x, n_ctu_y = sps.pic_width_in_ctus, sps.pic_height_in_ctus
        use_wpp = pps.entropy_coding_sync and n_ctu_y > 1
        rec = self.recon
        bpc = rec.bpc
        nbx, nby = rec.nbx, rec.nby
        tree = self.p.var_cu_tree

        # Per-4x4/8x8/TB nonzero maps, one vectorized reduction each
        # (the coeffs dicts must only hold nonzero TBs — see CodedCU
        # invariant).
        lvy = np.asarray(r["lev_y"])
        lvu = np.asarray(r["lev_u"])
        lvv = np.asarray(r["lev_v"])
        i32 = r.get("inter32")
        nz4y = lvy.reshape(nby, nbx, 4, 4, 4, 4).any((3, 5))
        nz8y = nz4y.reshape(nby, nbx, 2, 2, 2, 2).any((3, 5))
        nz16y = nz8y.any((2, 3))
        nzu = lvu.any((2, 3))
        nzv = lvv.any((2, 3))
        if self.p.internal_csp == 1:
            nz4u = lvu.reshape(nby, nbx, 2, 4, 2, 4).any((3, 5))
            nz4v = lvv.reshape(nby, nbx, 2, 4, 2, 4).any((3, 5))

        # native fast path: for the common all-intra configuration the
        # whole phase-1 walk (quadtree + CU syntax + residual bins) runs
        # in one C call per slice/WPP row (entropy_kernels.c
        # intra_slice_bins); parity vs the python walker is enforced by
        # tests/test_intra_walker.py
        fast_rows = None
        if (ftype == "I" and self.p.internal_csp == 1
                and split_map is None and tu4_map is None
                and not pps.transquant_bypass
                and sps.log2_min_cu_size in (3, 4)
                and (use_wpp or len(self._slice_bands) == 1)):
            fast_rows = self._native_intra_rows(
                lvy, lvu, lvv, nz16y, nzu, nzv, modes, split32, mode32,
                qp, qp_map, sao_maps, use_wpp, tree)

        def build16(bx, by, tqb):
            x0, y0 = bx * 16, by * 16
            if inter_mask is not None and inter_mask[by, bx]:
                d = 1 if dirs is None else int(dirs[by, bx])
                rsel = int(ref_sel[by, bx]) if ref_sel is not None else 0
                rsel1 = int(ref_sel1[by, bx]) \
                    if ref_sel1 is not None else 0
                pm = 0
                if rect_info is not None:
                    pm = int(rect_info[0][by, bx])
                cu = CodedCU(
                    x0, y0, 4, (1,), 4, {}, is_inter=True,
                    mv=(int(mvs[by, bx, 0]),
                        int(mvs[by, bx, 1])),
                    ref_idx=rsel,
                    inter_dir=d,
                    mv1=(int(mvs1[by, bx, 0]),
                         int(mvs1[by, bx, 1]))
                    if mvs1 is not None else (0, 0),
                    ref_idx1=rsel1, part_mode=pm)
                if pm:
                    cu.mv_b = (int(rect_info[1][by, bx, 0]),
                               int(rect_info[1][by, bx, 1]))
                    cu.ref_idx_b = rsel
                    if len(rect_info) > 2:
                        # B rect: PU1 carries its own list choice
                        cu.inter_dir_b = int(rect_info[3][by, bx])
                        cu.mv1_b = (int(rect_info[2][by, bx, 0]),
                                    int(rect_info[2][by, bx, 1]))
                        cu.ref_idx1_b = 0
                    else:
                        cu.inter_dir_b = d
            elif split_map is not None and split_map[by, bx]:
                # NxN intra: 4 PUs + forced TU8 split; the luma
                # level store holds the 4 TU8s as quadrants (or, with
                # a voluntary TU4 split, four 4x4 DST TBs as
                # sub-quadrants)
                cu = CodedCU(x0, y0, 4,
                             tuple(int(m) for m in modes8[by, bx]), 4)
                if tu4_map is not None:
                    cu.tu_split8 = tuple(bool(t)
                                         for t in tu4_map[by, bx])
                lvq = lvy[by, bx]
                for k, (dx8, dy8) in enumerate(
                        ((0, 0), (8, 0), (0, 8), (8, 8))):
                    sub = lvq[dy8:dy8 + 8, dx8:dx8 + 8]
                    if cu.tu_split8 is not None and cu.tu_split8[k]:
                        for (dx4, dy4) in ((0, 0), (4, 0), (0, 4),
                                           (4, 4)):
                            if nz4y[by, bx, (dy8 + dy4) >> 2,
                                    (dx8 + dx4) >> 2]:
                                cu.coeffs[(0, x0 + dx8 + dx4,
                                           y0 + dy8 + dy4, 2)] = \
                                    sub[dy4:dy4 + 4, dx4:dx4 + 4]
                    elif nz8y[by, bx, dy8 >> 3, dx8 >> 3]:
                        cu.coeffs[(0, x0 + dx8, y0 + dy8, 3)] = sub
                for c_idx, lvc_f, nz4c in ((1, lvu, nz4u),
                                           (2, lvv, nz4v)):
                    lvc = lvc_f[by, bx]
                    cx0, cy0 = x0 >> 1, y0 >> 1
                    for (dx4, dy4) in ((0, 0), (4, 0), (0, 4), (4, 4)):
                        if nz4c[by, bx, dy4 >> 2, dx4 >> 2]:
                            cu.coeffs[(c_idx, cx0 + dx4, cy0 + dy4, 2)] \
                                = lvc[dy4:dy4 + 4, dx4:dx4 + 4]
                cu.tq_bypass = tqb
                return cu
            else:
                cu = CodedCU(x0, y0, 4, (int(modes[by, bx]),), 4)
            if self.is422:
                if nz16y[by, bx]:
                    cu.coeffs[(0, x0, y0, 4)] = lvy[by, bx]
                for c_idx, lvc, nzc in ((1, lvu, nzu), (2, lvv, nzv)):
                    for j in (0, 1):
                        if nzc[2 * by + j, bx]:
                            cu.coeffs[(c_idx, x0 >> 1, y0 + 8 * j, 3)] \
                                = lvc[2 * by + j, bx]
            else:
                for c_idx, lvc, nzc, clog2 in (
                        (0, lvy, nz16y, 4),
                        (1, lvu, nzu, 4 - self.cshift),
                        (2, lvv, nzv, 4 - self.cshift)):
                    if nzc[by, bx]:
                        cx0 = x0 >> (self.cshift if c_idx else 0)
                        cy0 = y0 >> (self.cshift if c_idx else 0)
                        cu.coeffs[(c_idx, cx0, cy0, clog2)] = lvc[by, bx]
            cu.tq_bypass = tqb
            return cu

        def build_region(rx, ry, tqb):
            """CUs of one 32x32 region (z-order): a true 32 CU (tree
            intra TU32, or a same-motion inter merge with TU16 quads),
            else the region's 16x16 CUs."""
            x0, y0 = rx * 32, ry * 32
            full = (x0 + 32 <= sps.width and y0 + 32 <= sps.height)
            if (tree and full and split32 is not None
                    and not split32[ry, rx]):
                # true 32x32 intra CU: TU32 luma assembled from the 4
                # quadrant slots, TU16 chroma likewise
                cu = CodedCU(x0, y0, 5, (int(mode32[ry, rx]),), 4)
                by0, bx0 = 2 * ry, 2 * rx
                if nz16y[by0:by0 + 2, bx0:bx0 + 2].any():
                    cu.coeffs[(0, x0, y0, 5)] = np.block(
                        [[lvy[by0, bx0], lvy[by0, bx0 + 1]],
                         [lvy[by0 + 1, bx0], lvy[by0 + 1, bx0 + 1]]])
                for c_idx, lvc, nzc in ((1, lvu, nzu), (2, lvv, nzv)):
                    if nzc[by0:by0 + 2, bx0:bx0 + 2].any():
                        cu.coeffs[(c_idx, x0 >> 1, y0 >> 1, 4)] = \
                            np.block([[lvc[by0, bx0], lvc[by0, bx0 + 1]],
                                      [lvc[by0 + 1, bx0],
                                       lvc[by0 + 1, bx0 + 1]]])
                return [cu]
            cus = []
            for (zy, zx) in ((0, 0), (0, 1), (1, 0), (1, 1)):
                bx, by = 2 * rx + zx, 2 * ry + zy
                if bx < nbx and by < nby:
                    cus.append(build16(bx, by, tqb))
            # merge 4 identical-motion inter CUs into one 32x32 CU
            # (TU16 residual quads; with log2_max_tu 5 this needs the
            # voluntary TU split)
            if (self.p.internal_csp == 1 and full and len(cus) == 4 and
                    all(c.is_inter and c.part_mode == 0 for c in cus) and
                    len({_motion_key(c) for c in cus}) == 1):
                c0 = cus[0]
                if i32 is not None and i32["use"][ry, rx]:
                    # inter TU32: one 32x32 luma TB + 16x16 chroma TBs
                    # from the pre-pass (frame/inter_tu32.py); the
                    # wavefront was forced to this exact recon, so the
                    # per-16 level stores are all-zero here
                    merged = {}
                    if i32["nzy"][ry, rx]:
                        merged[(0, x0, y0, 5)] = i32["levy"][(ry, rx)]
                    if i32["nzu"][ry, rx]:
                        merged[(1, x0 >> 1, y0 >> 1, 4)] = \
                            i32["levu"][(ry, rx)]
                    if i32["nzv"][ry, rx]:
                        merged[(2, x0 >> 1, y0 >> 1, 4)] = \
                            i32["levv"][(ry, rx)]
                    return [CodedCU(x0, y0, 5, (1,), 4, merged,
                                    is_inter=True, mv=c0.mv,
                                    ref_idx=c0.ref_idx,
                                    inter_dir=c0.inter_dir, mv1=c0.mv1,
                                    ref_idx1=c0.ref_idx1,
                                    tq_bypass=tqb, tu_split=False)]
                merged = {}
                for c in cus:
                    merged.update(c.coeffs)
                return [CodedCU(x0, y0, 5, (1,), 4, merged,
                                is_inter=True, mv=c0.mv,
                                ref_idx=c0.ref_idx,
                                inter_dir=c0.inter_dir, mv1=c0.mv1,
                                ref_idx1=c0.ref_idx1, tq_bypass=tqb,
                                tu_split=tree and bool(merged))]
            # merge 4 same-mode intra CUs into one 32x32 intra CU
            # (legacy max_tu=16 forced-split form; superseded by true
            # TU32 CUs in tree mode)
            if (not tree and self.p.internal_csp == 1 and full and
                    len(cus) == 4 and
                    all((not c.is_inter) and not c.part_nxn
                        for c in cus) and
                    len({(c.luma_modes[0], c.chroma_idx)
                         for c in cus}) == 1):
                merged = {}
                for c in cus:
                    merged.update(c.coeffs)
                return [CodedCU(x0, y0, 5, (cus[0].luma_modes[0],),
                                cus[0].chroma_idx, merged,
                                tq_bypass=tqb)]
            return cus

        def build_cus(cx, cy):
            tqb = self.p.lossless
            if bpc == 1:
                bx, by = cx, cy
                if bx >= nbx or by >= nby:
                    return []
                return [build16(bx, by, tqb)]
            cus: List[CodedCU] = []
            rpc = bpc // 2
            for q in range(rpc * rpc):
                qx = ((q >> 0) & 1) | (((q >> 2) & 1) << 1)
                qy = ((q >> 1) & 1) | (((q >> 3) & 1) << 1)
                rx, ry = cx * rpc + qx, cy * rpc + qy
                if rx * 32 >= sps.width or ry * 32 >= sps.height:
                    continue
                cus.extend(build_region(rx, ry, tqb))
            # merge 4 identical-motion 32x32 inter CUs into one 64x64
            # CU (the coded-residual analog of x265's upper-depth
            # 2Nx2N/skip RDO, analysis.cpp:2368 compressInterCU).  Two
            # forms share this path:
            #  - all four zero-residual -> a skip/merge CU with no
            #    transform tree (the original 64-skip merge);
            #  - any subregion TU32-coded (tu_split False, coeffs at
            #    luma log2 5 / chroma log2 4) -> a coded 64 CU whose
            #    forced depth-0 TT split yields the SAME four TU32
            #    nodes the separate CUs would code — identical TBs,
            #    recon and deblock BS, minus three CU headers.  TU16-
            #    layout subregions (tu_split True) can't merge: a
            #    voluntary depth-1 split needs tu-inter-depth 3
            #    (spec 7.3.8.8 MaxTrafoDepth).
            if (bpc == 4 and len(cus) == 4 and
                    cx * 64 + 64 <= sps.width and
                    cy * 64 + 64 <= sps.height and
                    all(c.log2_size == 5 and c.is_inter and
                        c.part_mode == 0 and not c.tu_split
                        for c in cus) and
                    len({_motion_key(c) for c in cus}) == 1):
                c0 = cus[0]
                merged = {}
                for c in cus:
                    merged.update(c.coeffs)
                return [CodedCU(cx * 64, cy * 64, 6, (1,), 4, merged,
                                is_inter=True, mv=c0.mv,
                                ref_idx=c0.ref_idx,
                                inter_dir=c0.inter_dir, mv1=c0.mv1,
                                ref_idx1=c0.ref_idx1, tq_bypass=tqb)]
            return cus

        def encode_ctu_at(syn_, ir_, cx, cy, last, sao_top=0):
            cus = build_cus(cx, cy)
            sao = None
            merge = 0
            if sao_maps is not None:
                from ..ops.sao import SaoParams
                sao = tuple(
                    SaoParams(int(m[0][cy, cx]), int(m[1][cy, cx]),
                              int(m[2][cy, cx]),
                              tuple(int(o) for o in m[3][cy, cx]))
                    for m in sao_maps[:3])
                merge = int(sao_maps[3][cy, cx])
            ctu_qp = None if (qp_map is None or np.isscalar(qp_map)) \
                else int(qp_map[cy, cx])
            syn_.encode_ctu(ir_, cus, cx, cy, last, sao, ctu_qp,
                            sao_merge=merge, sao_top=sao_top)

        n_slices = len(self._slice_bands) if not use_wpp else 1
        if n_slices > 1:
            import dataclasses
            out_rbsps: List[bytes] = []
            for bi, (r0, r1) in enumerate(self._slice_bands):
                syn_b = SliceSyntaxEncoder(sps, pps, qp, slice_type,
                                           MAX_MERGE, num_refs=num_refs,
                                           ref_pocs=ref_pocs, cur_poc=poc,
                                           col_motion=syn.col)
                ir_b = BinIR(1 << 18)
                for cy in range(r0, r1):
                    for cx in range(n_ctu_x):
                        encode_ctu_at(syn_b, ir_b, cx, cy,
                                      cy == r1 - 1 and cx == n_ctu_x - 1,
                                      sao_top=r0)
                sh_b = dataclasses.replace(
                    sh, first_slice=(bi == 0),
                    segment_address=r0 * n_ctu_x)
                bw = write_slice_header(sh_b, sps, pps)
                states = init_states(slice_type, qp)
                bins, ctx = ir_b.arrays()
                encode_ir_to_writer(bw, bins, ctx, states)
                bw.rbsp_trailing_bits()
                out_rbsps.append(bw.get_bytes())
            self._publish_est(slice_type, states.copy())
            return out_rbsps

        row_irs: List = []
        sync_marks: List = []   # IR mark after the row's 2nd CTU
        if fast_rows is not None:
            row_irs = [_RawIR(b, c, m) for (b, c, m) in fast_rows]
            sync_marks = [None] * len(row_irs)
        else:
            ir = BinIR(1 << 18)
            for cy in range(n_ctu_y):
                if use_wpp and cy > 0:
                    row_irs.append(ir)
                    ir = BinIR(1 << 18)
                for cx in range(n_ctu_x):
                    last = (cy == n_ctu_y - 1) and (cx == n_ctu_x - 1)
                    encode_ctu_at(syn, ir, cx, cy, last)
                    if use_wpp and cx == min(1, n_ctu_x - 1):
                        # WPP context-sync point: after the 2nd CTU of
                        # the row (reference CTURow::bufferedEntropy
                        # handoff, frameencoder.cpp:1666-1685);
                        # deferred-TB-safe mark
                        sync_marks.append(ir.mark())
                    if use_wpp and cx == n_ctu_x - 1 and not last:
                        ir.term(1)         # end_of_subset_one_bit
            row_irs.append(ir)

        if not use_wpp:
            self._last_row_bits = None
            bw = write_slice_header(sh, sps, pps)
            states = init_states(slice_type, qp)
            bins, ctx = row_irs[0].arrays()
            encode_ir_to_writer(bw, bins, ctx, states)
            bw.rbsp_trailing_bits()
            # end-of-slice context states feed the NEXT same-type
            # frame's rate-estimation tables (entropy.cpp:2624 estBit
            # refresh, one-frame-lag batched form); published at
            # mini-GOP boundaries so frame-parallel B stays
            # deterministic
            self._publish_est(slice_type, states.copy())
            return bw.get_bytes()

        # WPP: compute each row's initial contexts by advancing the state
        # machine over the previous row's IR prefix, then arithmetic-code
        # every substream independently (the parallel-CABAC-lanes design,
        # SURVEY.md §7)
        from ..entropy.cabac import advance_states_over_ir
        substreams: List[bytes] = []
        row_start_states: List[np.ndarray] = []
        row_states = init_states(slice_type, qp)
        for k, rir in enumerate(row_irs):
            states = row_states.copy()     # this row's initial contexts
            row_start_states.append(states.copy())
            if k + 1 < len(row_irs):
                nxt = row_states.copy()
                b, c = rir.arrays()
                off = rir.resolve_mark(sync_marks[k])
                advance_states_over_ir(b[:off], c[:off], nxt)
                row_states = nxt
            sub_bw = BitWriter()
            b, c = rir.arrays()
            encode_ir_to_writer(sub_bw, b, c, states)
            sub_bw.rbsp_trailing_bits()    # byte_alignment: 1 + zero bits
            substreams.append(sub_bw.get_bytes())

        sh.entry_points = tuple(len(s) for s in substreams[:-1])
        # per-row refresh for the adaptive rate tables: next same-type
        # frame's row k estimates with THIS frame's row-k start states
        # (batched analog of the reference's per-CTU EstBitsSbac
        # refresh, entropy.cpp:2624-2688)
        self._publish_est(slice_type,
                          {"end": states.copy(),
                           "rows": np.stack(row_start_states)})
        self._last_row_bits = [len(s) * 8 for s in substreams]
        bw = write_slice_header(sh, sps, pps)
        for s in substreams:
            bw.write_bytes(s)
        return bw.get_bytes()


def encode_sequence(params: EncoderParams, frames,
                    device="cuda") -> tuple:
    """Encode an iterable of (y, u, v) frames on `device` (the card
    unless the caller asks for "cpu"; no fallback when it is missing).

    Returns (annexb bytestream in decode order, [EncodedFrame...])."""
    enc = Encoder(params, device)
    stream = b""
    encoded = []
    for (y, u, v) in frames:
        for f in enc.encode_frame(y, u, v):
            stream += f.bitstream
            encoded.append(f)
    for f in enc.flush():
        stream += f.bitstream
        encoded.append(f)
    return stream, encoded
