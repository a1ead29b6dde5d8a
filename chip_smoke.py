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
   weightp weights it) at the analysis shape (n = 16, r = 16), on the
   544x960 lowres planes of two park frames at the lookahead lattice's
   shape (n = 8, r = 16), at r = 63 and r = 4, and on a constant plane
   where every SAD ties; K2 `window_gather` at every main-path window
   size: 11, 16, 23, 25 on the frame plane, 8 (lattice source blocks),
   15 (lattice MC) and 17 (lattice subpel) on the lowres plane, and on
   the stacked-reference plane the merge/AMVP MC reads.  For each kernel and shape its device
   time per call (CUDA-graph replays; also one call with its Python
   wrapper between CUDA events), its bound (the least time the card
   could take for the same work, from the published peak rates and the
   card's own SM clock and SM count), the share of the bound reached,
   the plain version's time and, for K2, one PyTorch advanced-indexing
   call's time;
3. main path: a 6-frame 1920x1080 8-bit 4:2:0 clip (the `park`
   generator of tools/make_clips.py) through the port's Encoder on the
   card at the repo defaults (CQP 32, 4 B-frames with b-adapt 2 and the
   pyramid, open GOP, scenecut); checks that the decode order holds B
   pictures and a referenced B in every mini-GOP of 3 or more B's, that
   both kernels launched during the encode, and the recon quality;
   prints seconds per I, P and B picture, the lookahead's trace spans,
   each kernel's launches split into lookahead and analysis, bits per
   frame and peak device memory, and whether the lowres intra-cost sums
   (float32, fixed pairwise order) stayed exact;
4. the 416x240 park clip encoded on "cuda" and on "cpu" must give
   byte-identical streams, as I P P (bframes=0, 3 frames) and at the
   repo defaults (6 frames); the CPU path is what the test suite holds
   to the JAX reference encoder and the in-repo decoder.

Each phase prints its seconds.

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
# the encoder's trace spans record only when this is set before the
# port's trace module is imported (phase 3 reads the lookahead's spans)
os.environ.setdefault("X265TPU_TRACE",
                      os.path.join(ROOT, "build", "smoke_trace.json"))
PKG = "x265_mod_by_patman_tpu_torch"
FRAME_HW = (1088, 1920)     # 1080p luma, edge-padded to whole 16x16 blocks
# K2 window sizes of the main path: chroma MC (on the 544x960 chroma
# planes), source blocks, luma MC, subpel's superset window
K2_SIZES = (11, 16, 23, 25)
# K2 window sizes of the lookahead lattice on the 544x960 lowres plane:
# 8x8 source blocks, 8x8 MC, 8x8 subpel superset window
K2_LOWRES_SIZES = (8, 15, 17)
LOWRES_HW = (FRAME_HW[0] // 2, FRAME_HW[1] // 2)
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
    # the lookahead lattice: 8x8 blocks of the 544x960 lowres planes,
    # +-16 around zero, the lookahead's lambda (analysis/slicetype.py)
    from x265_mod_by_patman_tpu_torch.analysis.lookahead import (
        LOOKAHEAD_LAMBDA_X256, N, SEARCH_RANGE, lowres_plane)
    lo_cur = t(lowres_plane(pad(f[1][0])))
    lo_ref = t(lowres_plane(pad(f[0][0])))
    lh, lw = lo_cur.shape
    lys, lxs = np.mgrid[0:lh // N, 0:lw // N]
    lx0 = t((lxs.ravel() * N).astype(np.int32))
    ly0 = t((lys.ravel() * N).astype(np.int32))
    lz = torch.zeros_like(lx0)
    lat = (lo_ref, lo_cur, lx0, ly0, lz, lz, LOOKAHEAD_LAMBDA_X256, N,
           SEARCH_RANGE)
    _check_k1(lat, "544x960 lowres park, lookahead lattice", res)
    lb = lx0.shape[0]
    lat_ms = time_ms(lambda: full_search(*lat))
    _report("K1", f"lattice B={lb} n={N} r={SEARCH_RANGE} plane={lh}x{lw}",
            lat_ms, call_ms(lambda: full_search(*lat)),
            k1_bound_ms(lb, N, SEARCH_RANGE, clock_hz),
            time_ms(lambda: full_search_plain(*lat), per_graph=2, reps=3),
            card)
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
    # the lookahead lattice's windows on the 544x960 lowres plane: the
    # source blocks (size 8) at the block origins, MC (15) and subpel
    # (17) reads at blocks displaced by up to +-17 px, as mc_batch /
    # subpel_refine_batch start them
    h, w = LOWRES_HW
    plane = t(rng.integers(0, 256, (h, w), dtype=np.int32))
    bys, bxs = np.mgrid[0:h // 8, 0:w // 8]
    for size in K2_LOWRES_SIZES:
        reach, half = {8: (0, 0), 15: (17, 3), 17: (17, 4)}[size]
        d = lambda: rng.integers(-reach, reach + 1, bys.size) - half
        ys = t((bys.ravel() * 8 + d()).astype(np.int32))
        xs = t((bxs.ravel() * 8 + d()).astype(np.int32))
        _check_k2(plane, ys, xs, size, "lowres", res)
        ar = torch.arange(size, device=dev)
        gy = torch.clip(ys.long()[:, None, None] + ar[None, :, None], 0,
                        h - 1)
        gx = torch.clip(xs.long()[:, None, None] + ar[None, None, :], 0,
                        w - 1)
        k2 = lambda: window_gather(plane, ys, xs, size)
        _report("K2", f"B={ys.shape[0]} size={size} plane={h}x{w}",
                time_ms(k2), call_ms(k2),
                k2_bound_ms(ys.shape[0], size, (h, w)),
                time_ms(lambda: window_gather_plain(plane, ys, xs, size)),
                card, time_ms(lambda: plane[gy, gx]))
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


def encode(frames, w, h, dev, **kw):
    """Encode through the port's encode_sequence; returns the stream,
    the encoded frames and the wall seconds."""
    from x265_mod_by_patman_tpu_torch.encoder.top import encode_sequence
    from x265_mod_by_patman_tpu_torch.params import default_params
    t0 = time.perf_counter()
    stream, enc = encode_sequence(default_params(w, h, **kw), frames, dev)
    if dev != "cpu":
        torch.cuda.synchronize()
    return stream, enc, time.perf_counter() - t0


def psnr(a, b) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float((d * d).mean())
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def vcl_nal_type(au: bytes) -> int:
    """NAL unit type of the first slice NAL of an access unit."""
    i = au.find(b"\x00\x00\x01")
    while i >= 0:
        t = (au[i + 3] >> 1) & 0x3F
        if t < 32:
            return t
        i = au.find(b"\x00\x00\x01", i + 3)
    raise AssertionError("access unit without a slice NAL")


REFERENCED = (1, 3, 9)      # TRAIL_R, TSA_R, RASL_R


def check_minigops(enc) -> None:
    """Decode order must hold B pictures, and every mini-GOP of 3 or
    more B's a referenced one (the pyramid's middle B)."""
    groups, cur = [], None
    for f in enc:
        if f.slice_type == "B":
            cur.append(f)
        else:
            cur = []
            groups.append(cur)
    if not any(groups):
        raise AssertionError("no B picture in the decode order")
    for g in groups:
        if len(g) >= 3 and not any(vcl_nal_type(f.bitstream) in REFERENCED
                                   for f in g):
            raise AssertionError(f"mini-GOP of {len(g)} B's without a "
                                 "referenced B")


def lowres_sums_exact(frames, dev) -> None:
    """The lookahead sums each frame's 8160 lowres intra costs in float32
    (fixed pairwise order); below 2**24 that sum is exact in any order,
    so the card, the CPU and the reference agree.  Prints each frame's
    sum against the exact integer sum."""
    from x265_mod_by_patman_tpu_torch.analysis.lookahead import LowresStore
    from x265_mod_by_patman_tpu_torch.frame.planes import as_devplane
    h, w = FRAME_HW
    st = LowresStore(w, h, dev)
    rows = []
    for d, (y, _u, _v) in enumerate(frames):
        st.ensure(d, as_devplane(np.pad(y, ((0, h - y.shape[0]), (0, 0)),
                                        mode="edge")))
        exact = int(st.intra_dev(d).sum(dtype=torch.int64))
        rows.append((st.intra_sum(d), exact))
    print("lowres intra-cost sums (float32 / exact): "
          + ", ".join(f"{a:.0f}/{b}" for a, b in rows)
          + f"; below 2**24: {all(b < 2 ** 24 for _, b in rows)}; "
          f"float32 sum exact: {all(a == b for a, b in rows)}")


def phase_main(dev, w=1920, h=1080, n=6):
    """The 1080p default encode on the card; returns launch counts."""
    from x265_mod_by_patman_tpu_torch.analysis.slicetype import \
        SlicetypeLookahead
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    from x265_mod_by_patman_tpu_torch.ops import cuda as kernels
    from x265_mod_by_patman_tpu_torch.params import default_params
    from x265_mod_by_patman_tpu_torch.utils import trace
    frames = park_frames(w, h, n)
    enc = Encoder(default_params(w, h), dev)
    pic_secs = []
    la_counts = dict.fromkeys(kernels.KERNELS, 0)
    encode_picture = Encoder._encode_picture
    eval_triples = SlicetypeLookahead._eval_triples

    def timed_picture(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = encode_picture(self, *a, **k)
        torch.cuda.synchronize()
        pic_secs.append(time.perf_counter() - t0)
        return f

    def counted_triples(self, triples):
        before = kernels.counts()
        eval_triples(self, triples)
        for name, c in kernels.counts().items():
            la_counts[name] += c - before[name]

    Encoder._encode_picture = timed_picture
    SlicetypeLookahead._eval_triples = counted_triples
    try:
        ev0 = len(trace._events)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = []
        for y, u, v in frames:
            out.extend(enc.encode_frame(y, u, v))
        out.extend(enc.flush())
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = kernels.counts()
        spans = trace._events[ev0:]
    finally:
        Encoder._encode_picture = encode_picture
        SlicetypeLookahead._eval_triples = eval_triples
    print(f"main path {w}x{h} at the repo defaults: decode order "
          + " ".join(f"{f.slice_type}{f.disp}" for f in out))
    check_minigops(out)
    for i, (f, s) in enumerate(zip(out, pic_secs)):
        q = psnr(frames[f.disp][0], f.recon[0][:h, :w])
        print(f"picture {i} {f.slice_type} (display {f.disp}, NAL "
              f"{vcl_nal_type(f.bitstream)}, QP {f.qp}): {s:.3f} s, "
              f"{f.bits} bits, PSNR-Y {q:.2f} dB")
        if not q > 28.0:
            raise AssertionError(f"picture {i}: recon PSNR {q:.2f} dB")
    for t in ("I", "P", "B"):
        ss = [s for f, s in zip(out, pic_secs) if f.slice_type == t]
        if ss:
            print(f"seconds per {t} picture: {statistics.mean(ss):.3f} "
                  f"(n={len(ss)}, range {min(ss):.3f}-{max(ss):.3f})")
    agg, phases = {}, {}
    for e in spans:
        if e.get("ph") != "X":
            continue
        if e["name"].startswith("la_") or e["name"] == "slicetype_push":
            c, d = agg.get(e["name"], (0, 0.0))
            agg[e["name"]] = (c + 1, d + e["dur"] / 1e6)
        elif "type" in e["args"]:
            key = (e["args"]["type"], e["name"])
            phases[key] = phases.get(key, 0.0) + e["dur"] / 1e6
    for t in ("I", "P", "B"):
        k = sum(f.slice_type == t for f in out)
        if k:
            print(f"{t} picture spans, mean seconds: " + ", ".join(
                f"{name} {d / k:.3f}" for (tt, name), d in phases.items()
                if tt == t))
    print("lookahead spans: " + ", ".join(
        f"{k} {c}x {d:.3f} s" for k, (c, d) in sorted(agg.items())))
    print(f"lookahead total {sum(d for _, d in agg.values()):.3f} s of "
          f"{total:.3f} s; fps {n / total:.3f}; bits per frame "
          f"{8 * sum(len(f.bitstream) for f in out) / n:.0f}; "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    print("kernel launches during the encode: "
          + ", ".join(f"{k} {c} (lookahead {la_counts[k]}, analysis "
                      f"{c - la_counts[k]})" for k, c in counts.items()))
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    lowres_sums_exact(frames, dev)
    return counts


def phase_agree(w=416, h=240):
    """The same clip on cuda and on cpu must give identical bytes."""
    for n, kw in ((3, dict(bframes=0)), (6, {})):
        frames = park_frames(w, h, n)
        s_gpu, e_gpu, t_gpu = encode(frames, w, h, "cuda", **kw)
        s_cpu, e_cpu, t_cpu = encode(frames, w, h, "cpu", **kw)
        what = f"{w}x{h} x{n} " + (" ".join(f.slice_type for f in e_gpu))
        print(f"agree {what}: cuda {len(s_gpu)} B in {t_gpu:.2f} s, "
              f"cpu {len(s_cpu)} B in {t_cpu:.2f} s")
        if s_gpu != s_cpu:
            for i, (a, b) in enumerate(zip(e_gpu, e_cpu)):
                if a.bitstream != b.bitstream:
                    k = next((j for j, (x, y) in enumerate(
                        zip(a.bitstream, b.bitstream)) if x != y),
                        min(len(a.bitstream), len(b.bitstream)))
                    print(f"first difference: picture {i} "
                          f"({a.slice_type}) byte {k}")
                    break
            raise AssertionError(f"cuda and cpu streams differ: {what}")
        if not kw and "B" not in what:
            raise AssertionError("the default encode made no B picture")
        print(f"cuda and cpu streams are byte-identical: {what}")


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
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
          f"({build.library_path().relative_to(ROOT)})")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2026)
    t0 = time.perf_counter()
    res = {"full_search": phase_k1(dev, rng, cap, clock),
           "window_gather": phase_k2(dev, rng, cap)}
    print(f"phase 2 kernels: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    counts = phase_main(dev)
    print(f"phase 3 main path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_agree()
    print(f"phase 4 agreement: {time.perf_counter() - t0:.2f} s")
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
