"""Bit-level writer for HEVC headers and raw byte sequence payloads.

Host-side component (the analog of x265 source/common/bitstream.cpp): a
bit FIFO with ue(v)/se(v) Exp-Golomb helpers, rbsp trailing bits, and
Annex-B NAL packaging with emulation prevention.
"""
from __future__ import annotations


class BitWriter:
    """MSB-first bit accumulator producing a bytes payload."""

    def __init__(self) -> None:
        self._bits: int = 0          # bit count
        self._buf = bytearray()
        self._cur = 0                # partial byte accumulator
        self._cur_bits = 0

    # -- raw bits -----------------------------------------------------------
    def u(self, value: int, nbits: int) -> None:
        assert 0 <= nbits <= 64
        assert 0 <= value < (1 << nbits) if nbits < 64 else True, (value, nbits)
        self._bits += nbits
        self._cur = (self._cur << nbits) | (value & ((1 << nbits) - 1))
        self._cur_bits += nbits
        while self._cur_bits >= 8:
            self._cur_bits -= 8
            self._buf.append((self._cur >> self._cur_bits) & 0xFF)
        self._cur &= (1 << self._cur_bits) - 1

    def flag(self, value) -> None:
        self.u(1 if value else 0, 1)

    # -- Exp-Golomb (spec 9.2) ---------------------------------------------
    def ue(self, value: int) -> None:
        assert value >= 0
        code = value + 1
        nbits = code.bit_length()
        self.u(0, nbits - 1)
        self.u(code, nbits)

    def se(self, value: int) -> None:
        # mapping: 0->0, 1->1, -1->2, 2->3, -2->4 ...
        self.ue((value << 1) - 1 if value > 0 else (-value) << 1)

    def write_byte(self, byte: int) -> None:
        """Byte-aligned fast path (used by the CABAC engine)."""
        if self._cur_bits == 0:
            self._buf.append(byte & 0xFF)
            self._bits += 8
        else:
            self.u(byte & 0xFF, 8)

    def write_bytes(self, data: bytes) -> None:
        """Bulk byte append (native CABAC engine output)."""
        assert self._cur_bits == 0, "bulk append requires byte alignment"
        self._buf.extend(data)
        self._bits += 8 * len(data)

    # -- alignment ----------------------------------------------------------
    @property
    def bit_count(self) -> int:
        return self._bits

    @property
    def byte_aligned(self) -> bool:
        return self._cur_bits == 0

    def rbsp_trailing_bits(self) -> None:
        self.u(1, 1)
        if self._cur_bits:
            self.u(0, 8 - self._cur_bits)

    def byte_align_zero(self) -> None:
        if self._cur_bits:
            self.u(0, 8 - self._cur_bits)

    def get_bytes(self) -> bytes:
        assert self._cur_bits == 0, "payload not byte aligned"
        return bytes(self._buf)


def anti_emulation(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (spec 7.4.2): any 00 00 0x
    (x<=3) pattern in the RBSP becomes 00 00 03 0x.  Uses the native C
    kernel when available (slice payloads are the bulk of every AU)."""
    from ..native import native_entropy
    ne = native_entropy()
    if ne.available:
        import ctypes
        import numpy as np
        n = len(rbsp)
        out = np.empty(n + n // 2 + 8, dtype=np.uint8)
        m = ne.lib.anti_emulation(rbsp, ctypes.c_long(n),
                                  out.ctypes.data_as(ctypes.c_void_p))
        return out[:m].tobytes()
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)
