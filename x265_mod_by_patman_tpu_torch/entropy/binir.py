"""Bin-stream intermediate representation (IR).

The framework's entropy phase 1 output: a flat stream of (bin, ctx) pairs
where ctx is a context index into the slice context array, CTX_BYPASS for
equiprobable bins, CTX_TERM for terminate bins.  Phase 2 (the native C
engine / CabacEncoder) turns the IR into bytes.

Backed by preallocated numpy buffers so the native residual kernel can
append in place with zero copies (the Python syntax walker writes its
comparatively few CU-level bins via cbin()).
"""
from __future__ import annotations

import numpy as np

from .cabac import CTX_BYPASS, CTX_TERM


class BinIR:
    """Growable bin-stream builder over numpy storage.

    Residual TBs can be DEFERRED (`defer_residual`): the syntax walker
    stages levels + a descriptor instead of binarizing inline, and ONE
    native call per slice/row (`finalize`, merge_residual_ir in
    native/entropy_kernels.c) interleaves all residual bins into the
    stream — removing the per-TU ctypes dispatch that dominated host
    entropy time (the TPU analog of the reference coding whole CTU rows
    inside one Entropy pass, entropy.cpp encodeCTU)."""

    __slots__ = ("_bins", "_ctx", "n", "_tud", "_lev", "_lev_n",
                 "tu_counts")

    def __init__(self, capacity: int = 1 << 16) -> None:
        self._bins = np.empty(capacity, dtype=np.uint8)
        self._ctx = np.empty(capacity, dtype=np.int32)
        self.n = 0
        self._tud: list = []          # (pos, lev_off, log2, c_idx, scan, sh)
        self._lev = np.empty(1 << 14, dtype=np.int32)
        self._lev_n = 0
        self.tu_counts = None         # per-TU bin counts after finalize

    def defer_residual(self, level: np.ndarray, log2_tb: int, c_idx: int,
                       scan_idx: int, sign_hide: bool) -> None:
        """Stage one TB's residual for the slice-level native merge."""
        n2 = 1 << (2 * log2_tb)
        need = self._lev_n + n2
        if need > len(self._lev):
            cap = len(self._lev)
            while cap < need:
                cap *= 2
            nl = np.empty(cap, dtype=np.int32)
            nl[:self._lev_n] = self._lev[:self._lev_n]
            self._lev = nl
        self._lev[self._lev_n:need] = level.ravel()
        self._tud.append((self.n, self._lev_n, log2_tb, c_idx, scan_idx,
                          1 if sign_hide else 0))
        self._lev_n = need

    def finalize(self) -> None:
        """Materialize deferred residual TBs into the stream (one native
        call).  Idempotent; no-op when nothing is deferred."""
        if not self._tud:
            return
        from .residual import _merge_tables
        nat, blob, offs, off_arr = _merge_tables()
        desc = np.array(self._tud, dtype=np.int32)
        bound = self.n + int(np.sum(48 + (40 << (2 * desc[:, 2].astype(
            np.int64)))))
        out_b = np.empty(bound, dtype=np.uint8)
        out_c = np.empty(bound, dtype=np.int32)
        counts = np.empty(len(self._tud), dtype=np.int32)
        total = nat.merge_residual_ir(
            self._bins, self._ctx, self.n, desc, len(self._tud),
            self._lev, blob, offs, off_arr, out_b, out_c, counts)
        self._bins, self._ctx, self.n = out_b, out_c, int(total)
        self.tu_counts = counts
        self._tud = []
        self._lev_n = 0

    def mark(self):
        """Position marker valid across deferred TBs (WPP sync points);
        resolve with resolve_mark() after finalize()."""
        return (self.n, len(self._tud))

    def resolve_mark(self, mark) -> int:
        pn, nt = mark
        if nt == 0 or self.tu_counts is None:
            return pn
        return pn + int(self.tu_counts[:nt].sum())

    def ensure(self, extra: int) -> None:
        need = self.n + extra
        cap = len(self._bins)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        nb = np.empty(cap, dtype=np.uint8)
        nc = np.empty(cap, dtype=np.int32)
        nb[:self.n] = self._bins[:self.n]
        nc[:self.n] = self._ctx[:self.n]
        self._bins, self._ctx = nb, nc

    def cbin(self, b: int, ctx: int) -> None:
        self.ensure(1)
        self._bins[self.n] = 1 if b else 0
        self._ctx[self.n] = ctx
        self.n += 1

    def bypass(self, b: int) -> None:
        self.cbin(b, CTX_BYPASS)

    def bypass_bits(self, value: int, n: int) -> None:
        """n bits of value, MSB first, all bypass."""
        self.ensure(n)
        for k in range(n - 1, -1, -1):
            self._bins[self.n] = (value >> k) & 1
            self._ctx[self.n] = CTX_BYPASS
            self.n += 1

    def term(self, b: int) -> None:
        self.cbin(b, CTX_TERM)

    def extend(self, other: "BinIR") -> None:
        self.ensure(other.n)
        self._bins[self.n:self.n + other.n] = other._bins[:other.n]
        self._ctx[self.n:self.n + other.n] = other._ctx[:other.n]
        self.n += other.n

    def extend_arrays(self, bins: np.ndarray, ctx: np.ndarray) -> None:
        k = len(bins)
        self.ensure(k)
        self._bins[self.n:self.n + k] = bins
        self._ctx[self.n:self.n + k] = ctx
        self.n += k

    # pointers for the native kernel to append in place (call ensure first)
    def tail_ptrs(self):
        return (self._bins[self.n:], self._ctx[self.n:])

    @property
    def bins(self):
        self.finalize()
        return self._bins[:self.n].tolist()

    @property
    def ctx(self):
        self.finalize()
        return self._ctx[:self.n].tolist()

    def __len__(self) -> int:
        return self.n

    def arrays(self):
        self.finalize()
        return (self._bins[:self.n], self._ctx[:self.n])
