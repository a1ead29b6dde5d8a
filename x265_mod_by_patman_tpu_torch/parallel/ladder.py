"""ABR-ladder multi-encode: one source, N rungs (port of
x265_mod_by_patman_tpu/parallel/ladder.py on a torch device).

Analog of the reference's abrEncApp (abrEncApp.cpp AbrEncoder: shared
Reader thread + per-encode PassEncoder threads + Scaler).  Here the
shared read + downscale happen once per source frame and every rung's
encoder consumes the scaled copy; rung device work is serialized onto
the one card (the reference serializes onto shared thread pools the
same way).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..params import EncoderParams, default_params
from ..encoder.top import Encoder, EncodedFrame
from ..utils.scaler import scale_frame


@dataclass
class Rung:
    width: int
    height: int
    qp: int = 32
    rc_mode: str = "cqp"
    bitrate_kbps: int = 0
    name: str = ""


def parse_rung(spec: str) -> Rung:
    """"WxH:qp28" or "WxH:1500k" (bitrate ABR rung)."""
    res, _, rate = spec.partition(":")
    w, h = (int(t) for t in res.lower().split("x"))
    r = Rung(w, h, name=spec)
    if rate.endswith("k"):
        r.rc_mode = "abr"
        r.bitrate_kbps = int(rate[:-1])
    elif rate.startswith("qp"):
        r.qp = int(rate[2:])
    elif rate:
        r.qp = int(rate)
    return r


class AbrLadder:
    """Feed display-order frames once; every rung returns its own
    decode-order EncodedFrames."""

    def __init__(self, rungs: Sequence[Rung],
                 base: Optional[EncoderParams] = None,
                 share_cutree: bool = False, device="cuda", **kw) -> None:
        """share_cutree: rung 0 (drive it at the top quality/resolution)
        computes the lookahead once and publishes its cuTree offsets
        over a RingMem shm ring; the other rungs consume them instead
        of running their own lowres lookahead (the reference ABR-ladder
        cuTree share, ratecontrol.cpp:380).  Every rung encodes and
        scales on `device`."""
        import os
        self.rungs = list(rungs)
        self.device = device
        self.encoders: List[Encoder] = []
        ring = f"x265tpu_ct_{os.getpid()}" if share_cutree else ""
        for i, r in enumerate(self.rungs):
            p = default_params(r.width, r.height, qp=r.qp,
                               rc_mode=r.rc_mode,
                               bitrate_kbps=r.bitrate_kbps, **kw)
            if base is not None:
                p.fps_num, p.fps_denom = base.fps_num, base.fps_denom
            if ring:
                if i == 0:
                    p.cutree_share_write = ring
                else:
                    p.cutree_share_read = ring
            self.encoders.append(Encoder(p, device))

    def encode_frame(self, y, u, v) -> List[List[EncodedFrame]]:
        """Returns one list of encoded frames per rung (same order as
        rungs; shared scale per rung resolution)."""
        out = []
        for r, enc in zip(self.rungs, self.encoders):
            fy, fu, fv = scale_frame((y, u, v), r.width, r.height,
                                     enc.p.internal_bit_depth, self.device)
            out.append(enc.encode_frame(fy, fu, fv))
        return out

    def flush(self) -> List[List[EncodedFrame]]:
        return [enc.flush() for enc in self.encoders]

    def close(self) -> None:
        """Close the cuTree share's ring (the master unlinks it)."""
        close_shares(self.encoders)


def close_shares(encoders) -> None:
    """Close the cuTree share rings of `encoders`: readers detach, the
    writer unlinks the shared memory and its lock file."""
    for enc in encoders:
        if enc._ctshare_r is not None:
            enc._ctshare_r.close()
            enc._ctshare_r = None
    for enc in encoders:
        if enc._ctshare_w is not None:
            enc._ctshare_w.close()
            enc._ctshare_w = None
