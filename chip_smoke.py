#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (x265_mod_by_patman_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc), a C compiler and this
checkout; imports neither JAX nor the JAX package.  Phases:

0. environment: card name and power limit, SM clock, torch/CUDA
   versions, and the native C entropy engine (required: a timing of the
   pure-Python entropy path must never pass for the port's);
1. build: compiles the port's CUDA kernels from csrc/ (timed);
2. kernels vs their plain PyTorch versions on the card, exact equality:
   K1 `full_search` on real 1080p park planes (the reference weighted as
   weightp weights it) at the main path's shape, at r = 63 and r = 4,
   and on a constant plane where every SAD ties; K2 `window_gather` at
   every main-path window size (11, 16, 23, 25) on the frame plane and on
   the stacked-reference plane the merge/AMVP MC reads.  For each kernel
   its device time per call (CUDA-graph replays; also one call with
   its Python wrapper between CUDA events), its bound (the least time the card could
   take for the same work, from the published peak rates and the card's
   own SM clock and SM count), the share of the bound reached, the plain
   version's time and, for K2, one PyTorch advanced-indexing call's time;
3. main path: a 6-frame 1920x1080 8-bit 4:2:0 clip (the `park`
   generator of tools/make_clips.py) through the port's encode_sequence
   on the card at the default parameters with bframes=0 (I P P P P P);
   checks the slice types, that both kernels launched during the
   encode, and the recon quality; prints per-frame times and bits;
4. the same 3-frame 416x240 clip encoded on "cuda" and on "cpu" must
   give byte-identical streams (the CPU path is what the test suite
   holds to the JAX reference encoder and the in-repo decoder).

Prints the kernels' JSON line, the card line, and as its last line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is
then non-zero and no result line is printed.
"""
from __future__ import annotations

import sys

sys.modules["jax"] = None           # the port must run without JAX ...
sys.modules["x265_mod_by_patman_tpu"] = None    # ... and its package

import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "x265_mod_by_patman_tpu_torch"
FRAME_HW = (1088, 1920)     # 1080p luma, edge-padded to whole 16x16 blocks
# K2 window sizes of the main path: chroma MC (on the 544x960 chroma
# planes), source blocks, luma MC, subpel's superset window
K2_SIZES = (11, 16, 23, 25)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peak
FP32_LANES_PER_SM = 128


def _load_clips():
    path = os.path.join(ROOT, "tools", "make_clips.py")
    spec = importlib.util.spec_from_file_location("make_clips", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def park_frames(w: int, h: int, n: int):
    """uint8 (y, u, v) frames of the park profile (as the y4m writer
    stores them)."""
    frames = _load_clips().make_park(w, h, n)
    return [tuple(p.astype(np.uint8) for p in f) for f in frames]


def call_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Median CUDA-event time of one fn() call in ms, after warm-up: the
    device time plus whatever of the host's launch work (the Python
    wrapper) the device waits for."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def time_ms(fn, per_graph: int = 10, reps: int = 5) -> float:
    """Device time of one fn() call in ms: fn is captured `per_graph`
    times into a CUDA graph, and the median over `reps` replays of the
    graph's CUDA-event time is divided by `per_graph`.  No host work
    sits between the launches, so a kernel that takes less time than
    its Python wrapper is measured, not the wrapper."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / per_graph)
    return statistics.median(ts)


def sm_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def k1_bound_ms(b: int, n: int, r: int, clock_hz: float) -> float:
    """Operations bound of the full search: every candidate's n^2
    absolute differences, each a subtract and an add of the absolute
    value, two fp32 instructions that cannot fuse into an FMA, on the
    128 fp32 lanes of every SM at the SM clock (the 67 TFLOP/s fp32 peak
    counts an FMA as two operations; its instruction rate is this one).
    The bytes (two planes read once, three (B,) int32 written) take far
    less."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops = 2.0 * b * (2 * r + 1) ** 2 * n * n
    return 1e3 * ops / (FP32_LANES_PER_SM * sms * clock_hz)


def k2_bound_ms(b: int, size: int, plane_hw) -> float:
    """Bytes bound of the window gather: the int32 output written once,
    the plane and the (B,) starts read once, at the HBM peak."""
    nbytes = 4 * (b * size * size + plane_hw[0] * plane_hw[1] + 2 * b)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def _report(name, shape, ms, call, bound, plain, card, library=None):
    lib = "" if library is None else f", library {library:.4f} ms"
    print(f"{name} time {shape}: kernel {ms:.4f} ms (one call with its "
          f"wrapper {call:.4f} ms), bound {bound:.4f} ms (share "
          f"{bound / ms:.3f}), plain {plain:.4f} ms{lib} (device time per "
          f"call, CUDA-graph replays; {card})")


def _check_k2(plane, ys, xs, size, what, res):
    from x265_mod_by_patman_tpu_torch.ops.cuda.gather import (
        window_gather, window_gather_plain)
    got = window_gather(plane, ys, xs, size)
    ref = window_gather_plain(plane, ys, xs, size)
    err = int((got.long() - ref.long()).abs().max())
    h, w = plane.shape
    print(f"K2 window_gather {what} plane={h}x{w} B={ys.shape[0]} "
          f"size={size}: max_abs_err={err}")
    if not torch.equal(got, ref):
        raise AssertionError(f"window_gather differs: {what} size {size}")
    res["max_abs_err"] = max(res["max_abs_err"], err)


def _check_k1(args, what, res):
    from x265_mod_by_patman_tpu_torch.ops.cuda.full_search import (
        full_search, full_search_plain)
    got = full_search(*args)
    ref = full_search_plain(*args)
    err = max(int((g.long() - e.long()).abs().max()) for g, e in
              zip(got, ref))
    print(f"K1 full_search {what} B={args[2].shape[0]} n={args[7]} "
          f"r={args[8]} lambda_x256={args[6]}: max_abs_err={err}")
    if not all(torch.equal(g, e) for g, e in zip(got, ref)):
        raise AssertionError(f"full_search differs: {what}")
    res["max_abs_err"] = max(res["max_abs_err"], err)


def phase_k1(dev, rng, card: str, clock_hz: float):
    """K1 against its plain chain; times at the main path's shape."""
    from x265_mod_by_patman_tpu_torch.analysis.inter_mode import lambda_qp
    from x265_mod_by_patman_tpu_torch.analysis.weightp import weighted_plane
    from x265_mod_by_patman_tpu_torch.ops.cuda.full_search import (
        full_search, full_search_plain)
    res = {"max_abs_err": 0}
    h, w = FRAME_HW
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    f = park_frames(w, 1080, 2)
    pad = lambda p: np.pad(p, ((0, h - p.shape[0]), (0, 0)), mode="edge")
    orig = t(pad(f[1][0]).astype(np.int32))
    ref = weighted_plane(t(pad(f[0][0]).astype(np.int32)), 58, 9)
    n, r = 16, 16
    lam = int(round(lambda_qp(32)[0] * 256))    # lambda_x256 at QP 32
    bys, bxs = np.mgrid[0:h // n, 0:w // n]
    x0 = t((bxs.ravel() * n).astype(np.int32))
    y0 = t((bys.ravel() * n).astype(np.int32))
    zero = torch.zeros_like(x0)
    main = (ref, orig, x0, y0, zero, zero, lam, n, r)
    _check_k1(main, "1080p park, weighted ref, main path", res)
    b = x0.shape[0]
    res["ms"] = time_ms(lambda: full_search(*main))
    res["plain_ms"] = time_ms(lambda: full_search_plain(*main), per_graph=2,
                              reps=3)
    res["bound_ms"] = k1_bound_ms(b, n, r, clock_hz)
    res["bound_by"] = "operations"
    res["library_ms"] = None
    _report("K1", f"B={b} n={n} r={r}", res["ms"],
            call_ms(lambda: full_search(*main)), res["bound_ms"],
            res["plain_ms"], card)
    pm = lambda k: t(rng.integers(-300, 300, k, dtype=np.int32))
    _check_k1((ref, orig, x0, y0, pm(b), pm(b), lam, n, r),
              "1080p park, random predictors", res)
    for (bb, nn, rr) in ((64, 16, 63), (257, 8, 4)):
        xs = t(rng.integers(-nn, w, bb, dtype=np.int32))
        ys = t(rng.integers(-nn, h, bb, dtype=np.int32))
        _check_k1((ref, orig, xs, ys, pm(bb), pm(bb), lam, nn, rr),
                  "1080p park, origins in and around the plane", res)
    flat = t(np.full((h, w), 77, np.int32))
    for lam_t in (0, lam):
        _check_k1((flat, flat, x0, y0, pm(b), pm(b), lam_t, n, r),
                  "constant plane (ties)", res)
    return res


def phase_k2(dev, rng, card: str):
    """K2 against its plain version at every main-path size, on the frame
    plane (chroma sizes on the chroma plane) and on stacked references."""
    from x265_mod_by_patman_tpu_torch.analysis.inter_mode import _stack_refs
    from x265_mod_by_patman_tpu_torch.ops.cuda.gather import (
        window_gather, window_gather_plain)
    res = {"max_abs_err": 0}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    nb = 8160
    for size in K2_SIZES:
        h, w = (FRAME_HW[0] // 2, FRAME_HW[1] // 2) if size == 11 \
            else FRAME_HW
        plane = t(rng.integers(0, 256, (h, w), dtype=np.int32))
        # starts up to 80 px outside the plane
        ys = t(rng.integers(-80, h + 80 - size // 2, nb, dtype=np.int32))
        xs = t(rng.integers(-80, w + 80 - size // 2, nb, dtype=np.int32))
        _check_k2(plane, ys, xs, size, "frame", res)
        ar = torch.arange(size, device=dev)
        gy = torch.clip(ys.long()[:, None, None] + ar[None, :, None], 0,
                        h - 1)
        gx = torch.clip(xs.long()[:, None, None] + ar[None, None, :], 0,
                        w - 1)
        k2 = lambda: window_gather(plane, ys, xs, size)
        ms = time_ms(k2)
        plain = time_ms(lambda: window_gather_plain(plane, ys, xs, size))
        lib = time_ms(lambda: plane[gy, gx])
        bound = k2_bound_ms(nb, size, (h, w))
        _report("K2", f"B={nb} size={size} plane={h}x{w}", ms, call_ms(k2),
                bound, plain, card, lib)
        if size == 23:
            res.update(ms=ms, plain_ms=plain, bound_ms=bound,
                       bound_by="bytes", library_ms=lib)
    # the merge/AMVP MC plane: the 3 references of a 1080p P frame stacked
    # with 28-row pads (analysis/inter_mode._stack_refs at r=16), windows
    # started as mc_batch starts them for 16x16 luma blocks
    fh, fw, m, n, nref = 1080, 1920, 16 + 12, 16, 3
    refs = [t(rng.integers(0, 256, (fh, fw), dtype=np.int32))
            for _ in range(nref)]
    tall, strip = _stack_refs(refs, m)
    bys, bxs = np.mgrid[0:fh // n, 0:fw // n]
    rsel = rng.integers(0, nref, bys.size)
    mvx = rng.integers(-160, 161, bys.size)
    mvy = rng.integers(-160, 161, bys.size)
    ys = bys.ravel() * n + rsel * strip + m + (mvy >> 2) - 3
    xs = bxs.ravel() * n + (mvx >> 2) - 3
    _check_k2(tall, t(ys.astype(np.int32)), t(xs.astype(np.int32)), n + 7,
              "stacked refs", res)
    return res


def encode(frames, w, h, dev, per_frame=False):
    """Encode through the port's encode_sequence; with per_frame, also
    returns each frame's wall time (the time until the next frame is
    pulled, synchronised)."""
    from x265_mod_by_patman_tpu_torch.encoder.top import encode_sequence
    from x265_mod_by_patman_tpu_torch.params import default_params
    params = default_params(w, h, bframes=0)
    stamps = []

    def feed():
        for f in frames:
            if per_frame and dev != "cpu":
                torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield f

    t0 = time.perf_counter()
    stream, enc = encode_sequence(params, feed(), dev)
    if per_frame and dev != "cpu":
        torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    secs = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    return stream, enc, secs, time.perf_counter() - t0


def psnr(a, b) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float((d * d).mean())
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def phase_main(dev, w=1920, h=1080, n=6):
    """The 1080p I P P P P P encode on the card; returns launch counts."""
    from x265_mod_by_patman_tpu_torch.ops import cuda as kernels
    frames = park_frames(w, h, n)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    stream, enc, secs, total = encode(frames, w, h, dev, per_frame=True)
    counts = kernels.counts()
    types = [f.slice_type for f in enc]
    print(f"main path {w}x{h}: slice types {' '.join(types)}")
    if types != ["I"] + ["P"] * (n - 1):
        raise AssertionError(f"unexpected slice types {types}")
    for i, (f, s) in enumerate(zip(enc, secs)):
        q = psnr(frames[i][0], f.recon[0][:h, :w])
        print(f"frame {i} {f.slice_type}: {s:.3f} s, {f.bits} bits, "
              f"PSNR-Y {q:.2f} dB")
        if not q > 28.0:
            raise AssertionError(f"frame {i}: recon PSNR {q:.2f} dB")
    for t in ("I", "P"):
        ss = [s for f, s in zip(enc, secs) if f.slice_type == t]
        print(f"seconds per {t} frame: {statistics.mean(ss):.3f}")
    print(f"fps: {n / total:.3f}; bits per frame: "
          f"{8 * len(stream) / n:.0f}; max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    print(f"kernel launches during the encode: {counts}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    return counts


def phase_agree(w=416, h=240, n=3):
    """The same clip on cuda and on cpu must give identical bytes."""
    frames = park_frames(w, h, n)
    s_gpu, e_gpu, _, t_gpu = encode(frames, w, h, "cuda")
    s_cpu, e_cpu, _, t_cpu = encode(frames, w, h, "cpu")
    print(f"agree {w}x{h} x{n}: cuda {len(s_gpu)} B in {t_gpu:.2f} s, "
          f"cpu {len(s_cpu)} B in {t_cpu:.2f} s")
    if s_gpu != s_cpu:
        for i, (a, b) in enumerate(zip(e_gpu, e_cpu)):
            if a.bitstream != b.bitstream:
                k = next((j for j, (x, y) in enumerate(
                    zip(a.bitstream, b.bitstream)) if x != y),
                    min(len(a.bitstream), len(b.bitstream)))
                print(f"first difference: frame {i} ({a.slice_type}) "
                      f"byte {k}")
                break
        raise AssertionError("cuda and cpu streams differ")
    print("cuda and cpu streams are byte-identical")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from x265_mod_by_patman_tpu_torch import native
    from x265_mod_by_patman_tpu_torch.ops.cuda import build
    from x265_mod_by_patman_tpu_torch.utils.device import capability_line
    cap = capability_line()
    kind = torch.cuda.get_device_name(0)
    clock = sm_clock_hz()
    print(f"card: {cap}; max SM clock {clock / 1e6:.0f} MHz, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"devices {torch.cuda.device_count()}")
    if not native.native_entropy().available:
        raise RuntimeError("the native C entropy engine did not build: "
                           "the encode would time the pure-Python path")
    print("native entropy engine: loaded "
          f"({os.path.relpath(native.library_path(), ROOT)})")
    t0 = time.perf_counter()
    build.build(force=True)
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({build.library_path().relative_to(ROOT)})")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2026)
    res = {"full_search": phase_k1(dev, rng, cap, clock),
           "window_gather": phase_k2(dev, rng, cap)}
    counts = phase_main(dev)
    phase_agree()
    src = {"full_search": ("full_search.cu", "x265_mod_by_patman_tpu/ops/"
                           "pallas/sad.py:67"),
           "window_gather": ("window_gather.cu", "x265_mod_by_patman_tpu/"
                             "ops/pallas/gather.py:82")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{cu}",
         "replaces": rep, "launches": counts[name], **res[name]}
        for name, (cu, rep) in src.items()]}
    print(json.dumps(line))
    print(cap)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
