"""Rate control: CQP / CRF / single-pass ABR / 2-pass, with VBV.

Analog of the reference's RateControl (x265 source/encoder/ratecontrol.cpp
rateEstimateQscale:2101 + ABR feedback tuneAbrQScaleFromFeedback:2036 +
clipQscale/updateVbv:2786,3233 + 2-pass analyseABR2Pass:971): a
complexity-power law maps frame complexity to qscale, with an online
bits-model estimate, an ABR overflow feedback loop, frame-level VBV
buffer clipping, and a closed-form 2-pass allocation from a pass-1
stats file.  (The reference's row-level mid-frame VBV re-quantization,
rowVbvRateControl:3034, is subsumed by per-CTU AQ/cuTree deltas here —
frame-level VBV only.)

qscale convention matches x265: qscale = 0.85 * 2^((qp-12)/6).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional


def qp_to_qscale(qp: float) -> float:
    return 0.85 * (2.0 ** ((qp - 12.0) / 6.0))


def qscale_to_qp(qs: float) -> float:
    return 12.0 + 6.0 * math.log2(max(qs, 1e-6) / 0.85)


QCOMPRESS = 0.6
QP_STEP = 4.0                    # max per-frame QP swing
# I/P/referenced-B/non-ref-b offsets (reference ipratio/pbratio analog;
# non-ref bs sit one step above referenced Bs like the reference's
# qpOffset[1])
TYPE_OFFSET = {"I": -3.0, "P": 0.0, "B": 1.0, "b": 2.0}


@dataclass
class FrameStats:
    ftype: str
    qp: float
    bits: int
    complexity: float


def write_stats_file(path: str, stats: List[FrameStats]) -> None:
    """Pass-1 stats file (x265 --pass 1 --stats analog; own format)."""
    with open(path, "w") as f:
        f.write("#x265-tpu-stats-v1\n")
        for i, st in enumerate(stats):
            f.write(f"{i} {st.ftype} {st.qp:.2f} {st.bits} "
                    f"{st.complexity:.2f}\n")


def read_stats_file(path: str) -> List[FrameStats]:
    out: List[FrameStats] = []
    with open(path) as f:
        hdr = f.readline()
        assert hdr.startswith("#x265-tpu-stats"), "bad stats file"
        for line in f:
            _, ftype, qp, bits, cplx = line.split()
            out.append(FrameStats(ftype, float(qp), int(bits),
                                  float(cplx)))
    return out


class RateControl:
    """One instance per encode (reference RateControl per Encoder)."""

    def __init__(self, mode: str, qp: int, crf: float, bitrate_kbps: int,
                 fps: float, width: int, height: int,
                 qp_min: int = 0, qp_max: int = 51,
                 cu_tree: bool = False,
                 lookahead_units: bool = False,
                 bframes: int = 0) -> None:
        self.mode = mode
        self.base_qp = qp
        self.crf = crf
        self.cu_tree = bool(cu_tree)
        self.fps = max(fps, 1e-3)
        self.target_bpf = bitrate_kbps * 1000.0 / self.fps
        self.qp_min, self.qp_max = qp_min, qp_max
        self.npix = width * height
        # online bits model: bits ~= coef * complexity^(1-qcompress) / qscale
        self.coef = 1.0
        self.coef_weight = 0.1
        self.total_bits = 0.0
        self.wanted_bits = 0.0
        self.frames = 0
        # ABR cold start: bpp-derived initial QP (reference ABR_INIT_QP,
        # ratecontrol.cpp) instead of the CQP base
        if mode == "abr" and self.target_bpf > 0:
            bpp = self.target_bpf / max(self.npix, 1)
            self.base_qp = int(min(max(
                round(24 - 6 * math.log2(max(bpp, 1e-4) / 0.1)),
                qp_min), qp_max))
        self.last_qscale = qp_to_qscale(self.base_qp)
        # CRF anchoring: complexity that maps to exactly `crf`.  When
        # frame complexities come from the slicetype lookahead lattice
        # (lowres-satd units), mirror the reference's rate-factor base
        # complexity ncu * (bframes ? 120 : 80) (ratecontrol.cpp:190
        # baseCplx); else the legacy stand-in's per-pixel calibration.
        if lookahead_units:
            self.crf_cplx0 = (self.npix / 256.0) * (120.0 if bframes
                                                    else 80.0)
        else:
            self.crf_cplx0 = 0.04 * self.npix
        # VBV (disabled until set_vbv)
        self.vbv_buffer = 0.0
        self.vbv_rate = 0.0                  # bits entering per frame
        self.vbv_fullness = 0.0
        self.vbv_underflows = 0
        self.history: List[FrameStats] = []  # pass-1 recording
        self._plan: Optional[List[FrameStats]] = None   # pass-2 playback
        self._plan_scale = 1.0
        self._plan_spent = 0.0
        self._plan_actual = 0.0

    # -- VBV ---------------------------------------------------------------------
    def set_vbv(self, bufsize_kbit: int, maxrate_kbps: int,
                init: float = 0.9) -> None:
        """Frame-level VBV (reference clipQscale/updateVbv)."""
        if bufsize_kbit <= 0 or maxrate_kbps <= 0:
            return
        self.vbv_buffer = bufsize_kbit * 1000.0
        self.vbv_rate = maxrate_kbps * 1000.0 / self.fps
        self.vbv_fullness = init * self.vbv_buffer

    def row_vbv_plan(self, rbsps, row_bits, retry: int):
        """Intra-frame VBV check on the CODED frame (reference
        rowVbvRateControl, ratecontrol.cpp:3034, adapted to the batched
        design: instead of adapting QP row-by-row during a sequential
        encode, the coded size is checked against the CPB and the frame
        re-encoded with higher QP from the first over-budget CTU row).

        rbsps: list of coded slice payloads; row_bits: per-CTU-row bit
        sizes (WPP substream sizes) or None.  Returns (row0, dqp) to
        apply, or None when the frame fits."""
        if self.vbv_buffer <= 0:
            return None
        bits = sum(len(rb) for rb in rbsps) * 8
        # hard CPB constraint at this AU's removal time: coded bits must
        # not exceed the current fullness (underflow otherwise)
        limit = self.vbv_fullness * 0.97
        if bits <= limit:
            return None
        if row_bits:
            import numpy as _np
            cum = _np.cumsum(row_bits)
            nrows = len(row_bits)
            budget = limit * (_np.arange(1, nrows + 1) / nrows)
            over = _np.nonzero(cum > budget)[0]
            r0 = int(over[0]) if len(over) else 0
        else:
            r0 = 0
        # QP step from the overshoot ratio (bits ~halve per +6 QP),
        # escalating with each retry
        dq = max(2, int(math.ceil(6 * math.log2(bits / max(limit, 1.0)))))
        return r0, dq << retry

    def _predict_bits(self, qs: float, cplx_pow: float) -> float:
        coef = self.coef / self.coef_weight
        return coef * cplx_pow / max(qs, 1e-6)

    def _clip_qscale_vbv(self, qs: float, cplx_pow: float) -> float:
        """Raise qscale until the predicted frame fits the decoder buffer
        (keep >= 0.5 frame-slots of headroom), lower it when the buffer
        is about to overflow past 80%% fullness."""
        if self.vbv_buffer <= 0:
            return qs
        space = self.vbv_fullness - 0.5 * self.vbv_rate
        for _ in range(8):
            if self._predict_bits(qs, cplx_pow) <= max(space, 1.0):
                break
            qs *= 1.3
        # anti-overflow: encode at least what leaks past the brim
        over = self.vbv_fullness + self.vbv_rate - self.vbv_buffer
        if over > 0 and self._predict_bits(qs, cplx_pow) < over:
            qs = max(self.coef / self.coef_weight * cplx_pow / over, 1e-6)
        return qs

    # -- 2-pass ------------------------------------------------------------------
    def load_pass1(self, stats: List[FrameStats]) -> None:
        """Closed-form 2-pass allocation: desired qscale_i ~
        K * cplx_i^(1-qcomp) with K chosen so the inverse-proportional
        bits model hits the target exactly (reference analyseABR2Pass)."""
        assert self.target_bpf > 0, "2-pass needs --bitrate"
        self._plan = stats
        num = 0.0
        for st in stats:
            qs_rec = qp_to_qscale(st.qp - TYPE_OFFSET.get(st.ftype, 0.0))
            cpow = max(st.complexity, 1.0) ** (1.0 - QCOMPRESS)
            num += st.bits * qs_rec / cpow
        target_total = self.target_bpf * len(stats)
        self._plan_scale = num / max(target_total, 1.0)

    # -- per-frame decision ----------------------------------------------------
    def _vbv_lookahead_clip(self, qs: float, cplx_pow: float,
                            upcoming) -> float:
        """VBV lookahead (reference ratecontrol.cpp:2739): project the
        CPB over this frame plus the lookahead window's frames at the
        candidate qscale; raise qscale until no projected underflow
        (keeping >= 0.3 buffer of headroom).  upcoming: raw complexity
        estimates of the queued future frames."""
        if self.vbv_buffer <= 0 or not upcoming:
            return qs
        pows = [cplx_pow] + [max(c, 1.0) ** (1.0 - QCOMPRESS)
                             for c in upcoming]
        for _ in range(10):
            fill = self.vbv_fullness
            ok = True
            for cp in pows:
                fill += self.vbv_rate - self._predict_bits(qs, cp)
                if fill < 0.3 * self.vbv_buffer:
                    ok = False
                    break
                fill = min(fill, self.vbv_buffer)
            if ok:
                break
            qs *= 1.1
        return qs

    def frame_qp(self, ftype: str, complexity: float,
                 upcoming=None) -> int:
        if self.mode == "cqp":
            q = self.base_qp + TYPE_OFFSET[ftype]
            return int(min(max(round(q), self.qp_min), self.qp_max))
        cplx = max(complexity, 1.0) ** (1.0 - QCOMPRESS)
        if self._plan is not None:
            i = min(self.frames, len(self._plan) - 1)
            st = self._plan[i]
            cpow = max(st.complexity, 1.0) ** (1.0 - QCOMPRESS)
            qs = self._plan_scale * cpow
            # feedback: steer by the accumulated prediction error
            if self._plan_spent > 0:
                err = self._plan_actual / self._plan_spent
                qs *= min(max(err, 0.7), 1.4)
            qs = self._clip_qscale_vbv(qs, cpow)
            qs = self._vbv_lookahead_clip(qs, cpow, upcoming)
            qp = qscale_to_qp(qs) + TYPE_OFFSET.get(st.ftype, 0.0)
            qp = min(max(qp, self.qp_min), self.qp_max)
            return int(round(qp))
        if self.mode == "crf":
            if self.cu_tree:
                # reference CRF + cuTree calibration (ratecontrol.cpp:
                # 223/2119): the rate factor shifts by the mbtree
                # offset (1 - qcomp) * 13.5 QP and the frame-level
                # complexity term goes ~flat (qComp 0.99) — the
                # lookahead's per-CTU offsets do the distribution,
                # always downward from this raised base.
                qs = qp_to_qscale(self.crf + (1.0 - QCOMPRESS) * 13.5)
            else:
                base = qp_to_qscale(self.crf)
                ref = max(self.crf_cplx0, 1.0) ** (1.0 - QCOMPRESS)
                qs = base * cplx / ref
        else:                                   # abr
            if self.frames == 0:
                qs = qp_to_qscale(self.base_qp)
            else:
                coef = self.coef / self.coef_weight
                qs = coef * cplx / self.target_bpf
                # overflow compensation vs the ideal bit trajectory
                buffer_bits = max(self.target_bpf * self.fps, 1.0)  # ~1s
                overflow = 1.0 + (self.total_bits - self.wanted_bits) \
                    / buffer_bits
                qs *= min(max(overflow, 0.5), 2.0)
        qs = self._clip_qscale_vbv(qs, cplx)
        qs = self._vbv_lookahead_clip(qs, cplx, upcoming)
        # frame-type modulation + swing clamp (free swing while the bits
        # model is still cold)
        qp = qscale_to_qp(qs) + TYPE_OFFSET[ftype]
        last_qp = qscale_to_qp(self.last_qscale)
        if self.frames >= 3:
            qp = min(max(qp, last_qp - QP_STEP), last_qp + QP_STEP)
        qp = min(max(qp, self.qp_min), self.qp_max)
        return int(round(qp))

    # -- feedback ----------------------------------------------------------------
    def update(self, ftype: str, qp: int, bits: int,
               complexity: float) -> None:
        qs = qp_to_qscale(qp - TYPE_OFFSET[ftype])   # normalize to P scale
        cplx = max(complexity, 1.0) ** (1.0 - QCOMPRESS)
        # EMA of the bits model coefficient (x265 cplxrSum analog)
        self.coef *= 0.9
        self.coef_weight *= 0.9
        self.coef += bits * qs / cplx
        self.coef_weight += 1.0
        self.total_bits += bits
        self.wanted_bits += self.target_bpf
        self.history.append(FrameStats(ftype, qp, bits, complexity))
        if self._plan is not None and self.frames < len(self._plan):
            st = self._plan[self.frames]
            qs_rec = qp_to_qscale(st.qp - TYPE_OFFSET.get(st.ftype, 0.0))
            cpow = max(st.complexity, 1.0) ** (1.0 - QCOMPRESS)
            self._plan_spent += st.bits * qs_rec / \
                (self._plan_scale * cpow)
            self._plan_actual += bits
        if self.vbv_buffer > 0:
            self.vbv_fullness += self.vbv_rate - bits
            if self.vbv_fullness < 0:
                self.vbv_underflows += 1
                self.vbv_fullness = 0.0
            self.vbv_fullness = min(self.vbv_fullness, self.vbv_buffer)
        self.frames += 1
        if ftype != "B":                              # anchors steer qscale
            self.last_qscale = qs


def _lowres8(y: "np.ndarray") -> "np.ndarray":
    import numpy as np
    h, w = y.shape
    h8, w8 = h // 8, w // 8
    return y[:h8 * 8, :w8 * 8].astype(np.int32) \
        .reshape(h8, 8, w8, 8).mean(axis=(1, 3))


def frame_complexity(y: "np.ndarray", prev_y=None) -> float:
    """Cheap pre-analysis complexity (lookahead stand-in): 1/8-res
    motion-searched SAD vs the previous source (global ±2 lowres search —
    the coarse tier of the reference's lowres costEst, slicetype.cpp), or
    spatial gradient energy for the first/intra case."""
    import numpy as np
    if prev_y is not None:
        a = _lowres8(y)
        b = _lowres8(prev_y)
        h8, w8 = a.shape
        best = None
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                aa = a[max(dy, 0):h8 + min(dy, 0),
                       max(dx, 0):w8 + min(dx, 0)]
                bb = b[max(-dy, 0):h8 + min(-dy, 0),
                       max(-dx, 0):w8 + min(-dx, 0)]
                sad = float(np.abs(aa - bb).mean())
                if best is None or sad < best:
                    best = sad
        return best * y.size / 16.0
    yv = y.astype(np.int32)
    gx = np.abs(np.diff(yv, axis=1)).mean()
    gy = np.abs(np.diff(yv, axis=0)).mean()
    # gradient energy runs ~4x hotter than the temporal lowres-SAD scale
    # used for P/B frames; normalize so the CRF/ABR complexity power law
    # sees consistent units (the reference keeps both in lowres-satd
    # units via its lookahead — this is the calibration stand-in)
    return float(gx + gy) * y.size / 128.0
