"""Cross-process cuTree sharing over the RingMem shm ring.

Analog of the reference's ABR-ladder cuTree share (ratecontrol.cpp:380
reads the master encode's qpCuTree offsets out of common/ringmem.cpp;
abrEncApp wires one ring per ladder): the highest-quality rung computes
the lookahead once and publishes each frame's per-CTU QP-offset map;
the other rungs consume it (rescaled to their own CTU grid) instead of
running their own lowres lookahead — the P9/P11 cross-encode analysis
reuse from SURVEY §2.3.

Record layout: int32 disp, int32 ncy, int32 ncx, then ncy*ncx int8
offsets.
"""
from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

from ..utils.ringmem import RingMem

_REC_HDR = struct.Struct("<iii")


def _rec_size(ncy: int, ncx: int) -> int:
    return _REC_HDR.size + ncy * ncx


class CuTreeShareWriter:
    """Master side: publish one offsets map per encoded frame."""

    def __init__(self, name: str, ncy: int, ncx: int,
                 capacity: int = 64) -> None:
        self.ring = RingMem(name, _rec_size(ncy, ncx), capacity,
                            create=True)

    def publish(self, disp: int, offsets: np.ndarray) -> bool:
        off = np.asarray(offsets, np.int8)
        rec = _REC_HDR.pack(disp, off.shape[0], off.shape[1]) + \
            off.tobytes()
        return self.ring.push(rec)

    def close(self, unlink: bool = True) -> None:
        if unlink:
            self.ring.unlink()
        self.ring.close()


class CuTreeShareReader:
    """Slave side: fetch the master's offsets for a display index and
    rescale them onto this encode's CTU grid (nearest CTU — ladder
    rungs differ in resolution, the reference rescales the same way)."""

    def __init__(self, name: str) -> None:
        self.ring = RingMem(name)
        self._seen: Dict[int, np.ndarray] = {}

    def _drain(self) -> None:
        while True:
            rec = self.ring.pop()
            if rec is None:
                return
            disp, ncy, ncx = _REC_HDR.unpack_from(rec, 0)
            off = np.frombuffer(rec, np.int8, ncy * ncx,
                                _REC_HDR.size).reshape(ncy, ncx)
            self._seen[disp] = off.astype(np.int32)

    def get(self, disp: int, ncy: int, ncx: int
            ) -> Optional[np.ndarray]:
        if disp not in self._seen:
            self._drain()
        off = self._seen.pop(disp, None)
        if off is None:
            return None
        if off.shape == (ncy, ncx):
            return off
        ys = np.minimum((np.arange(ncy) * off.shape[0]) // max(ncy, 1),
                        off.shape[0] - 1)
        xs = np.minimum((np.arange(ncx) * off.shape[1]) // max(ncx, 1),
                        off.shape[1] - 1)
        return off[np.ix_(ys, xs)]

    def close(self) -> None:
        self.ring.close()
