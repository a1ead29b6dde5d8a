"""Bit-level reader for RBSP parsing (validation decoder side).

Mirror of bitwriter.py; the analog of a decoder's SyntaxElementParser."""
from __future__ import annotations


class BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0          # bit position

    def u(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def flag(self) -> bool:
        return bool(self.u(1))

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            assert zeros < 64, "corrupt ue(v)"
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    @property
    def byte_pos(self) -> int:
        return (self.pos + 7) >> 3

    def more_rbsp_data(self) -> bool:
        # true if any bit besides the final stop-one + zeros remains
        nbits = len(self.data) * 8
        last_one = -1
        for p in range(nbits - 1, -1, -1):
            byte = self.data[p >> 3]
            if (byte >> (7 - (p & 7))) & 1:
                last_one = p
                break
        return self.pos < last_one
