"""CABAC binary arithmetic coder (spec 9.3.4) — encoder and decoder.

Design: unlike x265's single stateful Entropy class interleaving syntax and
arithmetic (source/encoder/entropy.cpp:2861 encodeBin), this framework
splits entropy coding in two phases so the expensive per-TU binarization
can run vectorized/batched on TPU while only the tiny sequential
low/range recursion runs here:

  phase 1 (numpy/JAX, batchable): syntax -> "bin stream IR"
          arrays (bins[uint8], ctx[int32]) with ctx = context index,
          CTX_BYPASS for EP bins, CTX_TERM for terminate bins.
  phase 2 (this module / native): IR -> bytes.

The decoder is intentionally scalar Python — it exists for conformance
validation of our own streams (the testbench role, reference
source/test/), not for production speed.
"""
from __future__ import annotations

import numpy as np

from ..constants.hevc_tables import LPS_TABLE, NEXT_STATE, ENTROPY_BITS

CTX_BYPASS = -1
CTX_TERM = -2

_LPS = LPS_TABLE  # [64][4]
_NEXT = NEXT_STATE  # [128][2]


def init_context(qp: int, init_value: int) -> int:
    """Context initialization (spec 9.3.2.2) -> packed state
    (pStateIdx << 1) | valMps."""
    qp = min(51, max(0, qp))
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(1, ((slope * qp) >> 4) + offset), 126)
    mps = 1 if pre >= 64 else 0
    p_state = (pre - 64) if mps else (63 - pre)
    return (p_state << 1) | mps


def init_context_array(qp: int, init_values: np.ndarray) -> np.ndarray:
    return np.array([init_context(qp, int(v)) for v in init_values],
                    dtype=np.uint8)


class CabacEncoder:
    """Low/range arithmetic encoding engine with 0xFF-run carry buffering
    (HM-style register layout; arithmetic is spec 9.3.4.3)."""

    def __init__(self, out) -> None:
        self.out = out               # object with write_byte()
        self.low = 0
        self.range = 510
        self.bits_left = -12
        self.num_buffered = 0
        self.buffered_byte = 0xFF

    def encode_bin(self, bin_val: int, state: int) -> int:
        """Encode one context-coded bin; returns the updated context state."""
        new_state = _NEXT[state][bin_val]
        rng = self.range
        lps = int(_LPS[state >> 1][(rng >> 6) & 3])
        rng -= lps
        if (bin_val ^ state) & 1:    # LPS path
            num_bits = 9 - lps.bit_length()   # renorm shift to range>=256
            self.low = (self.low + rng) << num_bits
            self.range = lps << num_bits
            self.bits_left += num_bits
        else:                        # MPS path
            shift = 1 if rng < 256 else 0
            self.low <<= shift
            self.range = rng << shift
            self.bits_left += shift
        if self.bits_left >= 0:
            self._write_out()
        return int(new_state)

    def encode_bin_ep(self, bin_val: int) -> None:
        self.low = (self.low << 1) + (self.range if bin_val else 0)
        self.bits_left += 1
        if self.bits_left >= 0:
            self._write_out()

    def encode_bins_ep(self, value: int, num: int) -> None:
        while num > 8:
            num -= 8
            pattern = value >> num
            self.low = (self.low << 8) + self.range * pattern
            value -= pattern << num
            self.bits_left += 8
            if self.bits_left >= 0:
                self._write_out()
        self.low = (self.low << num) + self.range * value
        self.bits_left += num
        if self.bits_left >= 0:
            self._write_out()

    def encode_bin_trm(self, bin_val: int) -> None:
        self.range -= 2
        if bin_val:
            self.low = (self.low + self.range) << 7
            self.range = 2 << 7
            self.bits_left += 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left += 1
        if self.bits_left >= 0:
            self._write_out()

    def _write_out(self) -> None:
        lead = self.low >> (13 + self.bits_left)
        self.low &= (1 << (13 + self.bits_left)) - 1
        self.bits_left -= 8
        if lead == 0xFF:
            self.num_buffered += 1
        else:
            if self.num_buffered > 0:
                carry = lead >> 8
                self.out.write_byte((self.buffered_byte + carry) & 0xFF)
                for _ in range(self.num_buffered - 1):
                    self.out.write_byte((0xFF + carry) & 0xFF)
            self.num_buffered = 1
            self.buffered_byte = lead & 0xFF

    def finish(self) -> None:
        """Flush (x265 Entropy::finish semantics); caller then writes the
        rbsp stop bit via the outer BitWriter."""
        if self.low >> (21 + self.bits_left):
            self.out.write_byte((self.buffered_byte + 1) & 0xFF)
            for _ in range(self.num_buffered - 1):
                self.out.write_byte(0x00)
            self.low -= 1 << (21 + self.bits_left)
        else:
            if self.num_buffered > 0:
                self.out.write_byte(self.buffered_byte)
            for _ in range(self.num_buffered - 1):
                self.out.write_byte(0xFF)
        # remaining 13+bits_left bits of low>>8, MSB-first
        nbits = 13 + self.bits_left
        self.out.u(self.low >> 8, nbits)

    def encode_stream(self, bins: np.ndarray, ctx_idx: np.ndarray,
                      states: np.ndarray) -> None:
        """Encode a bin-stream IR against a context state array (mutated)."""
        for b, c in zip(bins.tolist(), ctx_idx.tolist()):
            if c == CTX_BYPASS:
                self.encode_bin_ep(b)
            elif c == CTX_TERM:
                self.encode_bin_trm(b)
            else:
                states[c] = self.encode_bin(b, int(states[c]))


def encode_ir_to_writer(bw, bins: np.ndarray, ctx: np.ndarray,
                        states: np.ndarray) -> None:
    """Serialize a bin-IR into a BitWriter (engine + finish), dispatching
    to the native C engine when available."""
    from ..native import native_entropy
    nat = native_entropy()
    if nat.available:
        data, tail_val, tail_n = nat.cabac_encode(bins, ctx, states)
        bw.write_bytes(data)
        bw.u(tail_val, tail_n)
        return
    enc = CabacEncoder(bw)
    enc.encode_stream(bins, ctx, states)
    enc.finish()


def advance_states_over_ir(bins: np.ndarray, ctx: np.ndarray,
                           states: np.ndarray) -> None:
    """Advance context states over a bin-IR without arithmetic coding
    (WPP context-sync derivation).  Mutates `states`."""
    from ..native import native_entropy
    nat = native_entropy()
    if nat.available:
        nat.advance_states(bins, ctx, states)
        return
    for b, c in zip(bins.tolist(), ctx.tolist()):
        if c >= 0:
            states[c] = _NEXT[states[c]][b]


def stream_frac_bits(bins: np.ndarray, ctx_idx: np.ndarray,
                     states: np.ndarray) -> int:
    """Estimate the cost of a bin-stream IR in 1/32768-bit units without
    arithmetic coding (the RDO 'counting mode', reference entropy.h:107-133).
    Mutates `states` like real encoding would."""
    total = 0
    for b, c in zip(bins.tolist(), ctx_idx.tolist()):
        if c == CTX_BYPASS:
            total += 32768
        elif c == CTX_TERM:
            total += int(ENTROPY_BITS[126 ^ b])
        else:
            s = int(states[c])
            total += int(ENTROPY_BITS[s ^ b])
            states[c] = _NEXT[s][b]
    return total


class CabacDecoder:
    """Conformance-validation arithmetic decoder (spec 9.3.4.3.2).

    Sliding-window layout: `value` holds the offset scaled so that
    comparisons are against ``range << 7``; `bits_needed` tracks how many
    bits of the window are consumed (byte refills at >= 0).
    """

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.range = 510
        self.value = (self._next_byte() << 8) | self._next_byte()
        self.bits_needed = -8

    def _next_byte(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def decode_bin(self, states: np.ndarray, c: int) -> int:
        state = int(states[c])
        rng = self.range
        lps = int(_LPS[state >> 1][(rng >> 6) & 3])
        rng -= lps
        scaled = rng << 7
        if self.value < scaled:
            bin_val = state & 1
            self.range = rng
            if scaled < (256 << 7):
                self.range = rng << 1
                self.value <<= 1
                self.bits_needed += 1
                if self.bits_needed == 0:
                    self.bits_needed = -8
                    self.value += self._next_byte()
        else:
            num = 9 - lps.bit_length()
            self.value = (self.value - scaled) << num
            self.range = lps << num
            bin_val = 1 - (state & 1)
            self.bits_needed += num
            if self.bits_needed >= 0:
                self.value += self._next_byte() << self.bits_needed
                self.bits_needed -= 8
        states[c] = _NEXT[state][bin_val]
        return bin_val

    def decode_bin_ep(self) -> int:
        self.value <<= 1
        self.bits_needed += 1
        if self.bits_needed >= 0:
            self.bits_needed = -8
            self.value += self._next_byte()
        scaled = self.range << 7
        if self.value >= scaled:
            self.value -= scaled
            return 1
        return 0

    def decode_bins_ep(self, num: int) -> int:
        v = 0
        for _ in range(num):
            v = (v << 1) | self.decode_bin_ep()
        return v

    def decode_bin_trm(self) -> int:
        self.range -= 2
        scaled = self.range << 7
        if self.value >= scaled:
            return 1
        if scaled < (256 << 7):
            self.range = scaled >> 6
            self.value <<= 1
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.bits_needed = -8
                self.value += self._next_byte()
        return 0
