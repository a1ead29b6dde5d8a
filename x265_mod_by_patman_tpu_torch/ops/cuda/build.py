"""Build and load the port's CUDA kernels.

All sources under ``x265_mod_by_patman_tpu_torch/csrc/*.cu`` are compiled
by ``nvcc`` for sm_90a (one process per source, in parallel) into ONE
shared library with a plain C interface, loaded through ctypes.  The
build happens at first use, into ``build/torch_kernels/<hash>/`` at the
repository root, keyed by a hash of the sources and flags, so an edited
kernel rebuilds and an unchanged one is reused.  Nothing is compiled
when the module is imported."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of the last build (None: not built)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _key(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _key(_sources()) / "libx265_torch_kernels.so"


def build(force: bool = False) -> Path:
    """Compile the kernels (unless a library for these sources exists)
    and return the library path.  One nvcc per source, all started
    together, then one link."""
    global build_seconds
    srcs = _sources()
    out = library_path()
    if out.exists() and not force:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    t0 = time.perf_counter()
    nvcc = _nvcc()
    objs = [out.parent / f"{s.stem}.{os.getpid()}.o" for s in srcs]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = [subprocess.Popen([nvcc, *compile_flags, "-c", "-o", str(o),
                               str(s)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("nvcc failed:\n" + "".join(logs))
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load_library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.full_search_launch.argtypes = [p, p, i, i, p, p, p, p, p, p,
                                               i, p, p, p, i, i, i, p]
            lib.full_search_launch.restype = i
            lib.window_gather_launch.argtypes = [p, p, p, p, i, i, i, i, p]
            lib.window_gather_launch.restype = i
            q = ctypes.c_longlong
            lib.ordered_sum_launch.argtypes = [p, p, p, p]
            lib.ordered_sum_launch.restype = i
            lib.ordered_sum_lanes_launch.argtypes = [p, p, i, i, q, q, q, p]
            lib.ordered_sum_lanes_launch.restype = i
            lib.ordered_sum_chain_launch.argtypes = [p, p, i, i, i, i, q, q,
                                                     q, p]
            lib.ordered_sum_chain_launch.restype = i
            _lib = lib
    return _lib


_count_lock = threading.Lock()


def count_launch(fn, key) -> None:
    """Add one launch at shape `key` to kernel wrapper `fn`'s counts
    (encoders may launch from several threads)."""
    with _count_lock:
        fn.launches += 1
        fn.launches_by_shape[key] = fn.launches_by_shape.get(key, 0) + 1


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {rc}")
