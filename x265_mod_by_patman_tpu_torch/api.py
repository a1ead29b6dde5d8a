"""Public API layer — the x265 C-API analog (port of
x265_mod_by_patman_tpu/api.py on an explicit torch device).

Mirrors the reference's public entry points (x265.h, encoder/api.cpp:
75 x265_encoder_open, :309 x265_encoder_reconfig, :365
x265_encoder_intra_refresh, :423 x265_encoder_encode, :533
x265_encoder_get_stats, :600 x265_encoder_close; param system
common/param.cpp:461/1519) with Python-native calling conventions:
x265_param is EncoderParams, x265_picture is Picture, x265_nal is Nal,
and `api_get(bit_depth)` is the multilib bit-depth dispatch analog
(api.cpp x265_api_get: one namespace per compiled bit depth; here one
namespace whose param factories pin internal_bit_depth).

Reconfig semantics follow Encoder::reconfigureParam
(encoder.cpp:2582): a whitelisted set of analysis knobs plus the RC
targets can change mid-stream; anything that would change the written
headers is rejected.

The encoder runs on the device given to encoder_open ("cuda" unless the
caller asks for "cpu"; no fallback when the card is missing).  api_get()
returns a namespace for 8, 10 and 12 bits, the depths the encoder takes.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .params import EncoderParams, default_params, PRESETS
from .encoder.top import Encoder, EncodedFrame, _unsupported

VERSION = "0.2-tpu"
MAX_BIT_DEPTH = 12

# NAL unit types (spec 7.4.2.2)
NAL_UNIT_CODED_SLICE_TRAIL = 1
NAL_UNIT_CODED_SLICE_IDR = 19
NAL_UNIT_VPS, NAL_UNIT_SPS, NAL_UNIT_PPS = 32, 33, 34
NAL_UNIT_PREFIX_SEI, NAL_UNIT_SUFFIX_SEI = 39, 40


@dataclass
class Nal:
    """x265_nal analog: one Annex-B unit (start code included)."""
    type: int
    payload: bytes

    @property
    def size_bytes(self) -> int:
        return len(self.payload)


@dataclass
class Picture:
    """x265_picture analog (input and output sides)."""
    planes: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    pts: int = 0
    dts: int = 0
    poc: int = 0
    slice_type: str = ""            # out: "I"/"P"/"B"
    force_qp: int = 0               # in: nonzero forces this frame QP
    bit_depth: int = 8
    user_data: object = None


@dataclass
class EncoderStats:
    """x265_stats analog (the aggregate subset)."""
    encoded_picture_count: int = 0
    accum_bits: int = 0
    total_frames_by_type: dict = field(default_factory=dict)
    avg_qp: float = 0.0
    bitrate_kbps: float = 0.0
    elapsed_video_time: float = 0.0


def _split_annexb(data: bytes) -> List[Nal]:
    """Split an Annex-B byte string into Nal records."""
    out: List[Nal] = []
    i = 0
    n = len(data)
    starts = []
    while i < n - 3:
        if data[i:i + 3] == b"\x00\x00\x01":
            starts.append(i)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = starts[k + 1] if k + 1 < len(starts) else n
        # start may be 4-byte (leading zero belongs to this NAL)
        s0 = s - 1 if s > 0 and data[s - 1] == 0 else s
        hdr = data[s + 3]
        out.append(Nal((hdr >> 1) & 0x3F, data[s0:e]))
    return out


# -- param system -----------------------------------------------------------

def param_alloc() -> EncoderParams:
    return EncoderParams()


def param_default(p: EncoderParams) -> None:
    """Reset to defaults in place (x265_param_default)."""
    d = EncoderParams()
    for f in dataclasses.fields(d):
        setattr(p, f.name, getattr(d, f.name))


def param_default_preset(preset: str = "medium",
                         tune: str = "") -> EncoderParams:
    p = EncoderParams()
    if preset:
        p.apply_preset(preset)
    if tune:
        p.apply_tune(tune)
    return p


def param_parse(p: EncoderParams, name: str, value: str = "1") -> int:
    """Returns 0 ok / negative error like x265_param_parse."""
    try:
        p.parse(name, value)
        return 0
    except (KeyError, ValueError):
        return -1


def param_apply_profile(p: EncoderParams, profile: str) -> int:
    """x265_param_apply_profile: pins bit depth / chroma format."""
    prof = profile.lower()
    if prof in ("main", "main-intra", "mainstillpicture"):
        p.profile, p.internal_bit_depth = "main", 8
    elif prof in ("main10", "main10-intra"):
        p.profile, p.internal_bit_depth = "main10", 10
    else:
        return -1
    return 0


def picture_alloc() -> Picture:
    return Picture()


def picture_init(p: EncoderParams, pic: Picture) -> None:
    pic.bit_depth = p.internal_bit_depth
    pic.planes = None
    pic.pts = pic.dts = pic.poc = 0


# -- encoder ----------------------------------------------------------------

class ApiEncoder:
    """x265_encoder handle: wraps the pipeline Encoder and adapts the
    push/pull framing of x265_encoder_encode (one input picture per
    call, 0/1 output picture per call, drain with pic_in=None)."""

    def __init__(self, params: EncoderParams, device="cuda") -> None:
        self.param = params
        self.enc = Encoder(params, device)
        self._out: List[EncodedFrame] = []
        self._flushed = False
        self._stats = EncoderStats()
        self._qp_sum = 0.0

    def _absorb(self, frames: List[EncodedFrame]) -> None:
        self._out.extend(frames)

    def _pop(self) -> Tuple[List[Nal], Optional[Picture]]:
        if not self._out:
            return [], None
        f = self._out.pop(0)
        st = self._stats
        st.encoded_picture_count += 1
        st.accum_bits += f.bits
        st.total_frames_by_type[f.slice_type] = \
            st.total_frames_by_type.get(f.slice_type, 0) + 1
        self._qp_sum += f.qp
        st.avg_qp = self._qp_sum / st.encoded_picture_count
        fps = self.param.fps_num / max(1, self.param.fps_denom)
        st.elapsed_video_time = st.encoded_picture_count / fps
        st.bitrate_kbps = (st.accum_bits * fps /
                           max(1, st.encoded_picture_count) / 1000.0)
        pic = Picture(planes=f.recon, poc=f.poc, slice_type=f.slice_type,
                      pts=f.disp, bit_depth=self.param.internal_bit_depth)
        return _split_annexb(f.bitstream), pic


def encoder_open(params: EncoderParams, device="cuda") -> ApiEncoder:
    params.validate()
    return ApiEncoder(params, device)


def encoder_headers(enc: ApiEncoder) -> List[Nal]:
    """VPS/SPS/PPS (+ stream-level SEI) as Nal records."""
    return _split_annexb(enc.enc.headers())


def encoder_encode(enc: ApiEncoder, pic_in: Optional[Picture]
                   ) -> Tuple[int, List[Nal], Optional[Picture]]:
    """Returns (num_pics_out, nals, pic_out).  pic_in=None drains the
    encoder (returns queued frames one per call until 0)."""
    if pic_in is not None:
        y, u, v = pic_in.planes
        if pic_in.force_qp:
            enc.enc._qpfile.setdefault(
                enc.enc.frame_count, ("", pic_in.force_qp))
        enc._absorb(enc.enc.encode_frame(y, u, v))
    elif not self_flushed(enc):
        enc._absorb(enc.enc.flush())
        enc._flushed = True
    nals, pic = enc._pop()
    return (1 if pic is not None else 0), nals, pic


def self_flushed(enc: ApiEncoder) -> bool:
    return enc._flushed


# Reconfigurable mid-stream knobs (Encoder::reconfigureParam whitelist,
# encoder.cpp:2582; header-affecting fields are rejected)
_RECONFIG_OK = {
    "max_num_references", "fast_intra", "search_method", "search_range",
    "subpel_refine", "rdoq_level", "rd_level", "rect", "amp",
    "max_merge", "intra_in_bframes", "aq_mode", "aq_strength",
    "psy_rd", "psy_rdoq",
}
_RECONFIG_RC = {"qp", "crf", "bitrate_kbps", "vbv_maxrate",
                "vbv_bufsize"}


def encoder_reconfig(enc: ApiEncoder, **changes) -> int:
    """Apply a mid-stream parameter change.  Returns 0 on success,
    -1 when any requested field cannot be changed mid-stream."""
    p = enc.param
    e = enc.enc
    unknown = set(changes) - _RECONFIG_OK - _RECONFIG_RC
    if unknown:
        return -1
    trial = copy.copy(p)
    for k, v in changes.items():
        setattr(trial, k, type(getattr(p, k))(v))
    bad = _unsupported(trial)
    if bad:
        raise NotImplementedError("not ported: " + ", ".join(bad))
    rebuild_recon = False
    for k, v in changes.items():
        if k == "search_range":
            # never grow past the opened range (scratch-buffer rule)
            v = min(int(v), p.search_range)
        elif k == "subpel_refine" and p.subpel_refine == 0:
            continue                    # can't switch out of subme=0
        elif k == "max_num_references":
            v = min(int(v), p.max_num_references)
            e.max_refs = max(1, min(v, 4))
        elif k in ("vbv_maxrate", "vbv_bufsize"):
            if p.vbv_maxrate <= 0 or p.vbv_bufsize <= 0:
                return -1               # VBV can't be turned on/off
            if p.hrd:
                return -1               # HRD pins VBV parameters
        if k == "rdoq_level" and bool(v) != (p.rdoq_level > 0):
            rebuild_recon = True
        setattr(p, k, type(getattr(p, k))(v))
    if "qp" in changes:
        e.rc.base_qp = p.qp
    if "crf" in changes:
        e.rc.crf = p.crf
    if "bitrate_kbps" in changes:
        fps = p.fps_num / max(1, p.fps_denom)
        e.rc.target_bpf = p.bitrate_kbps * 1000.0 / max(fps, 1e-3)
    if "search_range" in changes:
        e._me_range = min(p.search_range, e._me_range)
    if rebuild_recon:
        from .frame.recon_intra import IntraReconstructor
        e.recon = IntraReconstructor(
            e.sps, e.device, p.cb_qp_offset, p.cr_qp_offset, p.sign_hide,
            p.rdoq_level > 0, (), p.nxn_intra, p.lossless,
            tree=p.var_cu_tree, psy_rd=p.psy_rd, psy_rdoq=p.psy_rdoq)
    return 0


def encoder_reconfig_zone(enc: ApiEncoder, start: int, end: int,
                          qp: int = 0, bitrate_factor: float = 0.0
                          ) -> int:
    """x265_encoder_reconfig_zone analog: append a zone that starts at
    a not-yet-ingested frame."""
    if start < enc.enc.frame_count:
        return -1
    if qp:
        enc.enc._zones.append((start, end, int(qp), None))
    elif bitrate_factor > 0:
        enc.enc._zones.append((start, end, None, float(bitrate_factor)))
    else:
        return -1
    return 0


def encoder_intra_refresh(enc: ApiEncoder) -> int:
    """Force the next ingested frame to start a new IDR."""
    enc.enc._force_idr_next = True
    return 0


def encoder_get_stats(enc: ApiEncoder) -> EncoderStats:
    return copy.deepcopy(enc._stats)


def encoder_parameters(enc: ApiEncoder) -> EncoderParams:
    """Snapshot of the encoder's live parameters."""
    return copy.deepcopy(enc.param)


def encoder_close(enc: ApiEncoder) -> List[Tuple[List[Nal], Picture]]:
    """Flush everything still queued; returns [(nals, pic)...]."""
    out = []
    while True:
        n, nals, pic = encoder_encode(enc, None)
        if not n:
            break
        out.append((nals, pic))
    return out


def cleanup() -> None:
    """x265_cleanup analog (process-global caches)."""


def version_str() -> str:
    return VERSION


def max_bit_depth() -> int:
    return MAX_BIT_DEPTH


class _Api:
    """x265_api analog: entry-point namespace pinned to a bit depth."""

    def __init__(self, bit_depth: int) -> None:
        self.bit_depth = bit_depth
        self.version_str = VERSION
        for name in ("param_alloc", "param_default", "param_parse",
                     "param_apply_profile", "picture_alloc",
                     "picture_init", "encoder_open", "encoder_headers",
                     "encoder_encode", "encoder_reconfig",
                     "encoder_reconfig_zone", "encoder_intra_refresh",
                     "encoder_get_stats", "encoder_parameters",
                     "encoder_close", "cleanup"):
            setattr(self, name, globals()[name])

    def param_default_preset(self, preset="medium", tune=""):
        p = param_default_preset(preset, tune)
        p.internal_bit_depth = self.bit_depth
        return p


def api_get(bit_depth: int = 8) -> _Api:
    """Multilib dispatch analog (x265_api_get): returns the API bound
    to the requested internal bit depth (8, 10 or 12, the depths the
    encoder takes), or None if unsupported."""
    if bit_depth not in (8, 10, 12):
        return None
    return _Api(bit_depth)
