"""Native (C) entropy kernels — build + ctypes bindings.

Compiled with the system C compiler at first use into the repository's
``build/native/`` tree (beside ``build/torch_kernels/``), under a name
keyed by a hash of the source, the flags and the machine type; falls
back to the pure-Python implementations when no compiler is available,
so the framework stays importable everywhere and the bytes do not
change.

Several processes may build at once (test workers): each compiles to
its own temporary name and moves the result into place with
``os.replace``, so no process ever sees another's half-written library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "entropy_kernels.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
CFLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cc() -> Optional[str]:
    for name in (os.environ.get("CC"), "cc", "gcc"):
        path = name and shutil.which(name)
        if path:
            return path
    return None


def library_path() -> str:
    """Where the library for this source, flags and machine lives."""
    h = hashlib.sha256(" ".join((platform.machine(), *CFLAGS)).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libx265_torch_entropy_{h.hexdigest()[:16]}.so")


def _build() -> Optional[str]:
    so = library_path()
    if os.path.exists(so):
        return so
    cc = _cc()
    if cc is None:
        return None
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [cc, *CFLAGS, _SRC, "-o", tmp]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("X265TPU_NO_NATIVE"):
        return None
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.cabac_encode.restype = ctypes.c_long
    lib.cabac_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.enc_residual.restype = ctypes.c_long
    lib.enc_residual.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.advance_states.restype = None
    lib.advance_states.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.intra_slice_bins.restype = ctypes.c_long
    lib.intra_slice_bins.argtypes = [ctypes.c_void_p] * 22 + \
        [ctypes.c_long, ctypes.c_void_p]
    lib.anti_emulation.restype = ctypes.c_long
    lib.anti_emulation.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p]
    lib.merge_residual_ir.restype = ctypes.c_long
    lib.merge_residual_ir.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeEntropy:
    """High-level wrappers; constructed once per process."""

    def __init__(self) -> None:
        from ..constants.hevc_tables import LPS_TABLE, NEXT_STATE
        self.lib = get_lib()
        self.lps = np.ascontiguousarray(LPS_TABLE, dtype=np.uint8)
        self.next_state = np.ascontiguousarray(NEXT_STATE, dtype=np.uint8)

    @property
    def available(self) -> bool:
        return self.lib is not None

    def cabac_encode(self, bins: np.ndarray, ctx: np.ndarray,
                     states: np.ndarray):
        """Returns (bytes, tail_value, tail_nbits); states mutated."""
        n = len(bins)
        out = np.empty(n // 4 + 4096, dtype=np.uint8)
        tail = np.zeros(2, dtype=np.int64)
        bins = np.ascontiguousarray(bins, dtype=np.uint8)
        ctx = np.ascontiguousarray(ctx, dtype=np.int32)
        out_len = self.lib.cabac_encode(
            _ptr(bins), _ptr(ctx), ctypes.c_long(n), _ptr(states),
            _ptr(self.lps), _ptr(self.next_state), _ptr(out), _ptr(tail))
        return out[:out_len].tobytes(), int(tail[0]), int(tail[1])

    def advance_states(self, bins: np.ndarray, ctx: np.ndarray,
                       states: np.ndarray) -> None:
        bins = np.ascontiguousarray(bins, dtype=np.uint8)
        ctx = np.ascontiguousarray(ctx, dtype=np.int32)
        self.lib.advance_states(_ptr(bins), _ptr(ctx),
                                ctypes.c_long(len(bins)), _ptr(states),
                                _ptr(self.next_state))

    def enc_residual(self, level: np.ndarray, log2_tb: int, c_idx: int,
                     scan_idx: int, sign_hide: bool, scan_xy: np.ndarray,
                     cg_xy: np.ndarray, off: np.ndarray,
                     bins_buf: np.ndarray, ctx_buf: np.ndarray) -> int:
        level = np.ascontiguousarray(level, dtype=np.int32)
        return self.lib.enc_residual(
            _ptr(level), log2_tb, c_idx, scan_idx,
            1 if sign_hide else 0, _ptr(scan_xy), _ptr(cg_xy), _ptr(off),
            _ptr(bins_buf), _ptr(ctx_buf))

    def intra_slice_bins(self, prm, modes, split32, mode32, nzy, nzu,
                         nzv, lvy, lvu, lvv, qp_map, sao, sao_merge,
                         scan_blob, scan_offs, roff, coff, mode16,
                         depth16, state, out_bins, out_ctx,
                         out_mark) -> int:
        """Native intra-slice phase-1 walker (entropy_kernels.c
        intra_slice_bins): emits the complete (bins, ctx) IR for a CTU
        row range, residual bins inline.  Returns the bin count or -1
        when out_bins is too small."""
        def vp(a):
            return None if a is None else \
                a.ctypes.data_as(ctypes.c_void_p)
        return self.lib.intra_slice_bins(
            vp(prm), vp(modes), vp(split32), vp(mode32), vp(nzy),
            vp(nzu), vp(nzv), vp(lvy), vp(lvu), vp(lvv), vp(qp_map),
            vp(sao), vp(sao_merge), vp(scan_blob), vp(scan_offs),
            vp(roff), vp(coff), vp(mode16), vp(depth16), vp(state),
            vp(out_bins), vp(out_ctx), ctypes.c_long(len(out_bins)),
            vp(out_mark))

    def merge_residual_ir(self, py_bins: np.ndarray, py_ctx: np.ndarray,
                          n_py: int, tu_desc: np.ndarray, ntu: int,
                          levels: np.ndarray, scan_blob: np.ndarray,
                          scan_offs: np.ndarray, off: np.ndarray,
                          out_bins: np.ndarray, out_ctx: np.ndarray,
                          tu_counts: np.ndarray) -> int:
        """One call per slice/row: interleave python syntax bins with
        natively-encoded residual TU bins (see entropy_kernels.c)."""
        return self.lib.merge_residual_ir(
            py_bins.ctypes.data, py_ctx.ctypes.data, n_py,
            tu_desc.ctypes.data, ntu, levels.ctypes.data,
            scan_blob.ctypes.data, scan_offs.ctypes.data, off.ctypes.data,
            out_bins.ctypes.data, out_ctx.ctypes.data,
            tu_counts.ctypes.data)


_native: Optional[NativeEntropy] = None


def native_entropy() -> NativeEntropy:
    global _native
    if _native is None:
        _native = NativeEntropy()
    return _native
