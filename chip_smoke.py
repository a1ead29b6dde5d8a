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
   the stacked-reference plane the merge/AMVP MC reads, and at the
   chroma MC windows of the 4:2:2 and 4:4:4 paths (11 on the full-height
   1088x960 4:2:2 chroma plane, 19 on the 1088x1920 4:4:4 plane;
   phase_k2_chroma).  For each kernel and shape its device
   time per call (CUDA-graph replays; also one call with its Python
   wrapper between CUDA events), its bound (the least time the card
   could take for the same work, from the published peak rates and the
   card's own SM clock and SM count), the share of the bound reached,
   the plain version's time and, for K2, one PyTorch advanced-indexing
   call's time.  K1 again at both shapes on park at 10 and 12 bits
   (times 4 or 16, dithered) and K2 (size 23) on a 12-bit plane, exact,
   with their device times beside the 8-bit ones.  K1 at the --preset
   slow --hme shapes (phase_k1_slow): the analysis search at r = 32 on
   1080p and on a 2160p row band around HME window centres, the rect
   PUs' 8x8 sub-block search on the band's stacked references, the HME
   tier on quarter-res planes and the lookahead's hme_seeds on the
   quarter-of-lowres planes, each exact and timed against its bound.
   The SEA-pruned search of --me sea (torch ops, not a kernel;
   phase_sea) at the 1080p analysis shape (n = 16, r = 32, k = 64):
   exact against its numpy golden on sampled blocks and against K1
   when k covers every candidate, timed beside K1's dense search.
   MCSTF's shapes (phase_mcstf_kernels): K1 over every 16x16 block of
   park's luma cut to 1072x1920 (B = 8040, r = 12, lambda 0) and K2's
   16x16 gather of the aligned blocks, each exact and timed with its
   bound, plain and library times; mcstf._align_and_error on the card
   equal to its CPU run; the ladder's scale_frame 1080p -> 720p and
   -> 360p on the card equal to the CPU, timed.  The latency of one
   dependent float32 add (csrc/bench/fadd_chain.cu, built beside the
   kernels in phase 1: one thread's __fadd_rn chain between clock64()
   reads), printed on a line of its own.  K3 `ordered_sum` (phase_k3)
   at its call sites in the layouts their callers hand it, read in
   place (the lookahead's 32x32 windows of the 544x960 lowres plane and
   of the 68x120 intra costs, then their window sums; the g = 2 and 4
   region groups, and 2160p's g = 2 crop, a slice; the batched intra
   decision's CTU groups of two 1080p frames), on compact (K, M) terms
   (the TU16 / TU32 terms in row-major order, for information, and
   ragged sizes: K = 0, K = 1, M not a multiple of 32, K across
   staging chunks): exact against its plain version, with its device time, one
   whole osum call with its wrapper, its bound (the larger of the bytes
   and the chain of dependent adds at the measured latency; "chain" in
   the kernels line where that is larger), the plain version's,
   fsum's and torch.sum's times; then, exact and untimed, every sum
   the lookahead's _lowres_scalars hands K3 and the analysis' g x g
   group sums at each frame size the smoke codes (1080p, 2160p with its
   row bands, the ladder's 720p and 360p rungs; K3_FRAMES), the card's
   two lookahead scalars equal to the CPU's; K3's lane mode at the TU
   costs of tu_rd_levels (n = 32, 16, 8, 4 at 1080p block counts) in
   lsum's (M, n, n) layout, on every other block, on transposed blocks
   and at ragged M, against lanes_sum_plain, exact, and timed the same
   way at the path's shapes.  K1 and K2 at the tile-row
   path's shapes (phase_k_tiles): one band's 384x1920 slab of 1080p
   park at mesh_tile_rows 4, the analysis search (n = 16, r = 16) and
   the rect 8x8 sub-block search on the band's stacked reference, exact
   and timed, and K2 at sizes 23 and 11 on the slab, exact;
3. main path: a 2-frame (I P) 1920x1080 8-bit
   4:2:0 clip (the `park` generator of tools/make_clips.py) through the
   port's Encoder on the card at the repo defaults (CQP 32, 4 B-frames
   with b-adapt 2 and the pyramid, open GOP, scenecut); checks the
   decode order I0 P1, that both kernels launched during the encode,
   and the recon quality;
   prints seconds per I and P picture, the lookahead's trace spans,
   each kernel's launches split into lookahead, cuTree and analysis,
   bits per frame and peak device memory, and whether the lowres
   intra-cost sums (float32, the reference's order) stayed exact;
4. the 416x240 park clip encoded on "cuda" and on "cpu" must give
   byte-identical streams: CQP as I P P (bframes=0, 3 frames) and at the
   repo defaults (5 frames; a referenced B in every mini-GOP of 3 or
   more B's), CRF 28 with AQ 2 and cuTree (rc_lookahead
   4, 6 frames, so cuTree pops inside the stream) and
   ABR 300 kb/s with
   AQ 1 (4 frames); the CPU path is what the test suite holds to the
   JAX reference encoder and the in-repo decoder.  The CRF case is also
   written as y4m under build/ and encoded by the port's CLI
   (`python -m x265_mod_by_patman_tpu_torch.cli`) in a subprocess on
   the card: its .hevc must equal the in-process cuda bytes.  Then, at
   10 and 12 bits: Main10 at the repo defaults (4 frames) with HDR10
   signalling, HDR10+ metadata and a Dolby Vision RPU file written
   under build/; Main10 CRF 28 + AQ 2 + cuTree under a 150 kbit /
   150 kb/s VBV with HRD (6 frames; a picture must re-encode, and the
   CPB model holds on the parsed timing SEIs), also through the CLI on
   a 10-bit y4m; 12-bit I P P.  Then BASELINE config 3 at 416x240 (10
   bits, --preset medium --bitrate 300 --rdoq-level 2 --b-pyramid,
   HDR10; 4 frames) and --preset slow --hme --crf 24 --rc-lookahead 8
   under a 70/70 VBV that binds (5 frames; a picture must re-encode and
   rect PUs occur).  Then the quarter-strip scene of the reference's AMP
   test with rect, AMP and 2 B-frames (4 frames, I P B B; AMP PUs must
   occur in a P and in a B picture), the park fade under --weightb --me
   sea --no-scenecut and --preset veryslow --crf 24 on park (3 frames
   each), the last also through the CLI on the card.  Then this
   slice's residual-side options, 3 frames each: 9a's options; the
   CU-tree route with --nxn-intra, a custom scaling-list file written
   under build/ and --rdoq-level 2, saving its analysis; that case
   loading the card's analysis file (its bytes must equal the saving
   run's); --lossless with 2 B-frames (recon equal to the source).
   Then park with its chroma brought to 4:2:2 or 4:4:4 (park_chroma), 4
   frames each: 4:2:2 at 10 bits under CRF 28 + AQ 2 + cuTree, also
   through the CLI on a C422p10 y4m; 4:4:4 at 8 bits at the repo
   defaults (a B picture must occur).  Then an ABR ladder through the
   port's CLI (--abr-ladder, agree_ladder) on the card and on the CPU:
   a 416x240 master under CRF 28 + AQ 2 + --mcstf writing the cuTree
   share and a 208x120 slave reading it, 10 frames (MCSTF at display 0
   and 8); each rung's file must be byte-identical.  Then the batched
   and parallel entry points (agree_batched): bench.py's own point
   (416x240, QP 32, keyint 1, CTU 32, rd 2, SAO off), 16 frames through
   encode_intra_batched in batches of 8 (its fps printed for
   information); MultiStreamIntraEncoder with 4 streams x 2 steps, also
   equal to the four streams encoded one by one; MultiStreamEncoder
   with 2 streams of 3 frames at the repo defaults, also equal to the
   two encoded alone (K1 / K2 launches by shape printed);
   encode_gop_parallel on 8 frames in chunks of 4, and
   ElasticGopEncoder with one injected WorkerFailure equal to it.
   Then frame-parallel B, the tile-row analysis and the mesh layer
   (agree_parallel): CRF 28 + AQ 2 + cuTree with --bframes 3 (pyramid,
   b-adapt 0) and --frame-threads 3 over 8 frames; CQP I P P with rect at mesh_tile_rows 4; and
   parallel/mesh.py's sharded_encode_step on a 4-shard mesh over 4
   frames (modes, levels and the two totals).
   The frame counts keep the script inside its time limit.  Each
   case's card encode runs in one of three card worker processes and
   its CPU encode in one of three one-thread CPU worker processes, six
   groups of cases at once, and the CLI subprocesses run beside the
   cases that follow them.  The phase runs in a thread beside phases 7
   and 8a, whose host thread leaves the other cores idle; their
   seconds per picture include its load;
5. the rate-control path (in the third worker, below): the same 1080p
   clip as phase 3, cut to 2
   frames (I P), under CRF 28 with AQ 2 and the cuTree
   lookahead (rc_lookahead at its default); prints, besides what phase
   3 prints, each picture's frame QP and the min/mean/max of the
   per-CTU QP map it coded, the aq_map, cutree_push and cutree_pop
   spans and the launches split into lookahead, cuTree and analysis;
   checks the recon quality, the decode order I0 P1 and that the
   per-CTU QP map varies on at least one picture;
6. the Main10 delivery path (last in the phase worker): phase 3's 2 frames
   (I P) at 10 bits
   (park times 4 plus a seeded dither in [-2, 2])
   under CRF 28 + AQ 2 + cuTree, a
   1000 kbit / 1000 kb/s VBV at 25 fps, HRD and HDR10 signalling
   (colour description, mastering display, content light level);
   prints per picture its seconds, bits, frame QP, per-CTU QP range,
   pipeline runs (more than one where the row-level VBV re-encoded it),
   VBV fullness and PSNR-Y at peak 1023, the launches split as above
   and the peak device memory; fails on a VBV underflow, an AU that
   misses its CPB removal time, a decode order other than I0 P1, or a
   per-CTU QP map that never varies;
7. the UHD slow path (run beside phase 4): 3 frames (I
   P B) of 3840x2160 park as BASELINE config 4, parameters built as the
   CLI builds them (--preset slow --hme --rc-lookahead 40 --crf 24
   --vbv-bufsize 25000 --vbv-maxrate 25000, 60 fps): row-banded
   analysis, rect PUs, HME, RDOQ with sign hiding, --me star; prints
   what phase 6 prints, the analysis bands, the share of inter 16x16
   blocks coded as rect PUs and the launches with the HME tier counted;
   fails on a decode order other than I0 P2 B1, a VBV underflow, no
   rect PU on any picture or a recon below 28 dB;
8. the inter tools at full width (8a after phase 7, 8b after 10b),
   1920x1080 park: 8a, 3 frames (I P B), `--preset
   veryslow --crf 24` as the CLI builds it (AMP, rect, star r = 32, 4
   references, subme 4, 8 B-frames, rc-lookahead 40), with each
   picture's AMP and rect shares; 8b, 3 frames (I P B), park under
   a luma fade (x0.82 a frame) with `--weightb --me sea --no-scenecut`
   (weighted P and B, the SEA search), with the slices' explicit
   weights and the analysis span.  Each prints what phase 3 prints and
   fails on a decode order other than I0 P2 B1 or a recon below 28 dB;
   8b also fails when the B slice carries no
   explicit weight;
9. the residual-side options at full width (9b after 10a, 9a first in
   the third worker): 9b 1080p park, 2 frames (I P), --lossless
   (transquant bypass, no loop filters), with bits per picture; fails
   unless the card's recon equals the source in all three planes.  9a
   1080p park, 3 frames (I P B), --crf 24 --aq-mode 2 --nxn-intra
   --tu-intra-depth 2 --scaling-list default --nr-intra 200 --nr-inter
   400 as the CLI builds it, with the I picture's shares of NxN blocks
   and of TU4-split 8x8 TUs and each picture's mean NR offsets; fails
   without an NxN block on the I picture, with all-zero NR offsets
   from the second picture on, without the SPS scaling-list flag, on a
   decode order other than I0 P2 B1 or a recon below 28 dB.  Each
   prints what phase 3 prints;
10. the 4:2:2 and 4:4:4 paths at full width (10a after phase 4, 10b
   after 9b), 1080p park with its chroma brought to the format (rows,
   or rows and columns, repeated plus a seeded sigma = 1 noise), on the
   fixed-grid wavefront: 10a Main 4:2:2 10, 3 frames (I P B), --crf 24
   --aq-mode 2 with cuTree as the CLI builds it for a C422p10 y4m; 10b
   Main 4:4:4 at 8 bits, 2 frames (I P), the repo defaults.  Each
   prints what phase 3 prints and per picture PSNR-Y/Cb/Cr and the
   `wavefront` and `entropy` span shares, the per-CTU QP maps and each
   kernel's launches by shape (the wrappers' own counts); fails unless
   the SPS carries chroma_format_idc 2 / 3 and the RExt profile (4), on a
   decode order other than I0 P2 B1 / I0 P1, a recon below 28 dB, or
   when K2 never ran at the format's chroma MC window;
11. the ABR ladder at full width (started after phase 4, in a card
   worker process beside the other workers and this process): the
   port's CLI
   with --abr-ladder on a 3-frame 1080p park y4m, three rungs:
   1920x1080 --crf 24 --aq-mode 2 --mcstf writing the cuTree share,
   1280x720 --crf 26 and 640x360 --crf 28 without AQ reading it (each
   scaled on the card).  Prints per rung its seconds per picture, fps,
   bits, PSNR-Y and per-CTU QP maps; fails unless each SPS has the
   rung's size, the slaves ran no cuTree lookahead, the first slave
   took the master's offsets on every picture and its QPs vary on some
   picture while the second took none (the reference's one-consumer
   ring), and K1 and K2 ran at MCSTF's shapes;
12. the batched all-intra path at full width (first in the phase
   worker): 4 frames of 1080p park at bench.py's operating point (QP
   32, keyint 1, CTU 32, rd 2, SAO off, deblock on) through
   encode_intra_batched(batch=2), whose second batch runs on the card
   while the first one's entropy runs on the host, and through
   encode_intra_pipelined.  Prints each run's seconds per frame, fps,
   `wavefront` spans, bits, PSNR-Y and peak memory, and the torch
   operations the batched wavefront dispatches on two frames against
   one; fails when the two streams differ, on a recon below 28 dB, when
   two frames dispatch more than 1.5x one frame's operations, or when K3
   never ran;
13. frame-parallel B and the tile-row analysis at full width (in the
   phase worker, after 12): 4 frames (I P b b) of 1080p park
   under phase 5's CRF 28 + AQ 2 + cuTree with --bframes 2 (no pyramid,
   b-adapt 0), --frame-threads 3 and mesh_tile_rows 4: the P picture's
   analysis runs as 4 row bands, the two non-referenced B pictures as
   one frame-parallel window (in turn, rate control deferred).  Prints what
   phase 3 prints, the window's wall time beside the sum of its two
   jobs' _encode_picture times, the tiled P analysis span beside phase
   5's whole-frame one and beside the same picture analysed as one
   whole-frame call, and each kernel's launches by shape; fails on a
   decode order other than I0 P3 B1 B2, a recon below 28 dB, when
   no window of two jobs ran or the tile-row analysis did not.

After phase 4 three card worker processes start: phase 11's, the
phase worker (12, 13 and 6 in turn) and a third (9a, then 5); their
output is printed when they all end.  This process meanwhile runs 10a,
9b, 10b and 8b.  Each holds one host thread and leaves the card mostly
idle, so the four overlap on the 8-core host; their seconds per
picture include the others' load.

Every stream of phases 3-13 is decoded with the port's own decoder in
three worker processes on the host as each phase ends, while the card
runs the next phases; each picture must equal the card's recon and
carry a matching MD5 SEI.

Phases 3 and 5-13 (each in its process) set the kernel counts to 0
just before their encode and read them just after.  Each
phase prints its seconds.

Prints SEA's time beside K1's, the kernels' JSON line (launches from
phase 9a, the residual-side path, and per path; K1's times at the analysis
shape n = 16, r = 32, every slow-path shape and MCSTF's under "shapes";
K2's at size 23, its two chroma shapes and MCSTF's under "shapes", each
with its launches; K3's at the lowres windows, every shape under
"shapes"), the card
line, and as its last line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is
then non-zero and no result line is printed.
"""
from __future__ import annotations

import sys

sys.modules["jax"] = None           # the port must run without JAX ...
sys.modules["x265_mod_by_patman_tpu"] = None    # ... and its package

import functools  # noqa: E402
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
# K2's chroma MC windows of the 4:2:2 and 4:4:4 paths (phase 10): the
# 11x11 window of each stacked 8x8 chroma TB on the full-height 1088x960
# 4:2:2 chroma plane (two launches per reference, one per half), and the
# 19x19 window of a 16x16 chroma block on the 1088x1920 4:4:4 plane
K2_CHROMA_SHAPES = ((11, (FRAME_HW[0], FRAME_HW[1] // 2), "4:2:2"),
                    (19, FRAME_HW, "4:4:4"))
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


def quarter_strip_frames(w: int, h: int, n: int):
    """The quarter-strip scene of the reference's AMP test
    (tests/test_amp_pu.py quarter_strip_scene, horizontal boundary),
    copied: two textures panning differently with their boundary at
    y = 36, a quarter inside a 16-block row, where AMP pays."""
    rng = np.random.default_rng(11)
    big = rng.integers(0, 255, (h + 128, w + 128)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, (1, 1), (0, 1))) // 4
    frames = []
    for i in range(n):
        y = np.array(big[16 + 2 * i:16 + 2 * i + h, 16:16 + w])
        y[:36] = big[16:52, 16 + 3 * i:16 + 3 * i + w]
        u = np.full((h // 2, w // 2), 120, np.uint8)
        v = np.full((h // 2, w // 2), 132, np.uint8)
        frames.append((np.clip(y, 0, 255).astype(np.uint8), u, v))
    return frames


def fade_frames(frames, fade: float = 0.82):
    """Each frame's luma times fade^i (a fade to black, as the reference's
    tests/test_weightb.py makes it), chroma as it is."""
    return [((y.astype(np.float64) * fade ** i).astype(np.uint8), u, v)
            for i, (y, u, v) in enumerate(frames)]


def park_chroma(frames, csp: int, seed: int):
    """park's 4:2:0 frames with the chroma brought to 4:2:2 (rows
    repeated) or 4:4:4 (rows and columns repeated), plus a seeded
    sigma = 1 noise, as park adds to its chroma, so that no two samples
    are copies; uint8."""
    rng = np.random.default_rng(seed)

    def up(p):
        q = np.repeat(p, 2, axis=0)
        if csp == 3:
            q = np.repeat(q, 2, axis=1)
        q = q.astype(np.float64) + rng.normal(0, 1.0, q.shape)
        return np.clip(np.rint(q), 0, 255).astype(np.uint8)
    return [(y, up(u), up(v)) for y, u, v in frames]


def deep(plane, bd: int, rng):
    """An 8-bit plane at bit depth bd: times 2^(bd-8), plus a seeded
    integer dither in [-2^(bd-9), 2^(bd-9)] ([-2, 2] at 10 bits),
    clipped to [0, 2^bd - 1].  It stands in for real deep content."""
    d = 1 << (bd - 9)
    v = plane.astype(np.int32) * (1 << (bd - 8)) + rng.integers(
        -d, d + 1, plane.shape)
    return np.clip(v, 0, (1 << bd) - 1).astype(np.uint16)


def deep_frames(frames, bd: int, seed: int):
    rng = np.random.default_rng(seed)
    return [tuple(deep(p, bd, rng) for p in f) for f in frames]


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
    # the same two shapes on 10- and 12-bit samples (park times 4 or 16,
    # dithered): the kernel's fp32 sums stay exact while n^2 * max < 2^24
    times = {8: (res["ms"], lat_ms)}
    for bd in (10, 12):
        o_d, r_d = (t(pad(deep(f[k][0], bd, rng)).astype(np.int32))
                    for k in (1, 0))
        big = (r_d, o_d, x0, y0, zero, zero, lam << (bd - 8), n, r)
        _check_k1(big, f"1080p park at {bd} bits, main path", res)
        lo = (t(lowres_plane(r_d.cpu().numpy())),
              t(lowres_plane(o_d.cpu().numpy())), lx0, ly0, lz, lz,
              LOOKAHEAD_LAMBDA_X256, N, SEARCH_RANGE)
        _check_k1(lo, f"544x960 lowres park at {bd} bits, lattice", res)
        times[bd] = (time_ms(lambda: full_search(*big)),
                     time_ms(lambda: full_search(*lo)))
    print("K1 device time per call by sample depth (8 / 10 / 12 bits): "
          f"B={b} n={n} r={r} " + " / ".join(
              f"{times[k][0]:.4f}" for k in (8, 10, 12)) + " ms; lattice "
          f"B={lb} n={N} " + " / ".join(
              f"{times[k][1]:.4f}" for k in (8, 10, 12)) + f" ms ({card})")
    return res


UHD_HW = (2160, 3840)


@functools.lru_cache(maxsize=None)
def uhd_frames(n: int):
    """The first n frames of the 3840x2160 park clip (phases 2 and 7)."""
    return park_frames(UHD_HW[1], UHD_HW[0], n)


def _k1_shape(name, args, card, clock_hz, res, centers=None):
    """Check K1 at one shape (exact, with and without window centres),
    time it and report it beside its bound and its plain version."""
    from x265_mod_by_patman_tpu_torch.ops.cuda.full_search import (
        full_search, full_search_plain)
    kw = {} if centers is None else dict(center_x=centers[0],
                                         center_y=centers[1])
    _check_k1(args, name, res)
    if centers is not None:
        got = full_search(*args, **kw)
        ref = full_search_plain(*args, **kw)
        err = max(int((g.long() - e.long()).abs().max())
                  for g, e in zip(got, ref))
        print(f"K1 full_search {name}, HME window centres: max_abs_err="
              f"{err}")
        if not all(torch.equal(g, e) for g, e in zip(got, ref)):
            raise AssertionError(f"full_search differs: {name} centres")
        res["max_abs_err"] = max(res["max_abs_err"], err)
    b, n, r = args[2].shape[0], args[7], args[8]
    ms = time_ms(lambda: full_search(*args, **kw))
    plain = time_ms(lambda: full_search_plain(*args, **kw), per_graph=1,
                    reps=3)
    bound = k1_bound_ms(b, n, r, clock_hz)
    h, w = args[0].shape
    shape = f"{name} B={b} n={n} r={r} plane={h}x{w}"
    _report("K1", shape, ms, call_ms(lambda: full_search(*args, **kw)),
            bound, plain, card)
    return dict(shape=shape, ms=ms, bound_ms=bound, plain_ms=plain,
                share=bound / ms)


def phase_k1_slow(dev, rng, card: str, clock_hz: float):
    """K1 at the shapes of the --preset slow --hme path at 2160p, against
    its plain version (exact) and timed: the analysis search (n = 16,
    r = 32 of --me star) on a 1080p and on a 2160p row band, around HME
    window centres; the rect PUs' 8x8 sub-block search (n = 8, r = 32)
    on a 2160p band's references stacked with the HME pads; the HME
    tier (n = 8, r = 32) on the band's quarter-res planes; the
    lookahead's hme_seeds (n = 8, r = 16) on the quarter-of-lowres
    planes.  Returns the analysis shape's numbers and every shape's."""
    from x265_mod_by_patman_tpu_torch.analysis import inter_mode as im
    from x265_mod_by_patman_tpu_torch.analysis.lookahead import (
        LOOKAHEAD_LAMBDA_X256, N, SEARCH_RANGE, lowres_plane)
    from x265_mod_by_patman_tpu_torch.ops.me import half_res
    res = {"max_abs_err": 0}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lam = int(round(im.lambda_qp(32)[0] * 256))
    shapes = []
    # one 2160p row band as _banded_analysis cuts it (halo included)
    f = uhd_frames(3)
    sr = 32
    r0, r1, ht, hb = im._analysis_bands(_UhdSps(), 16, sr)[1]
    y0, y1 = (r0 - ht) * 16, (r1 + hb) * 16
    band = lambda k: t(f[k][0][y0:y1].astype(np.int32))
    cur, ref0, ref1 = band(1), band(0), band(2)
    bh, bw = cur.shape
    grid = lambda hh, ww, n: im._grid(hh // n, ww // n, n, dev)
    # the analysis search at 1080p and on the band, zero centres, then
    # around the band's HME centres
    h1, w1 = FRAME_HW
    f1 = park_frames(w1, 1080, 2)
    pad = lambda p: np.pad(p, ((0, h1 - p.shape[0]), (0, 0)), mode="edge")
    o1, q1 = t(pad(f1[1][0]).astype(np.int32)), t(pad(f1[0][0])
                                                  .astype(np.int32))
    x0, y0_ = grid(h1, w1, 16)
    z = torch.zeros_like(x0)
    shapes.append(_k1_shape("1080p park, analysis --me star",
                            (q1, o1, x0, y0_, z, z, lam, 16, sr), card,
                            clock_hz, res))
    main = shapes[-1]
    bx, by = grid(bh, bw, 16)
    zb = torch.zeros_like(bx)
    ctr = im._hme_center_fullres(ref0, cur, bh // 16, bw // 16, lam, sr)
    shapes.append(_k1_shape("2160p band, analysis --me star --hme",
                            (ref0, cur, bx, by, zb, zb, lam, 16, sr), card,
                            clock_hz, res, ctr))
    # rect: 8x8 sub-blocks on two references stacked with the HME pads
    m_pad = 6 * sr + 12
    tall, strip = im._stack_refs([ref0, ref1], m_pad)
    otall = im._stack_refs([cur, cur], m_pad)[0]
    sx4, sy4 = im._sub4(bx, by)
    rsel4 = t(rng.integers(0, 2, sx4.shape[0]).astype(np.int32))
    z4 = torch.zeros_like(sx4)
    shapes.append(_k1_shape("2160p band, rect 8x8 sub-blocks, stacked refs",
                            (tall, otall, sx4, sy4 + rsel4 * strip + m_pad,
                             z4, z4, lam, 8, sr), card, clock_hz, res))
    # the HME tier on the band's quarter-res planes
    q = half_res
    rq, oq = q(q(ref0)), q(q(cur))
    qx, qy = grid(bh // 32 * 8, bw // 32 * 8, 8)
    zq = torch.zeros_like(qx)
    shapes.append(_k1_shape("2160p band, HME tier on 1/4-res planes",
                            (rq, oq, qx, qy, zq, zq, lam, 8, sr), card,
                            clock_hz, res))
    # the lookahead's hme_seeds on the quarter-of-lowres planes of 2160p
    lo = [t(lowres_plane(np.pad(f[k][0], ((0, 16), (0, 0)), mode="edge")))
          for k in (0, 1)]
    lq = [q(a) for a in lo]
    lh, lw = lo[0].shape
    sx, sy = grid(lh // N // 2 * N, lw // N // 2 * N, N)
    zs = torch.zeros_like(sx)
    shapes.append(_k1_shape("2160p lowres, lookahead hme_seeds",
                            (lq[0], lq[1], sx, sy, zs, zs,
                             LOOKAHEAD_LAMBDA_X256, N, SEARCH_RANGE), card,
                            clock_hz, res))
    return res, main, shapes


def phase_k_tiles(dev, rng, card: str, clock_hz: float):
    """K1 and K2 at the tile-row path's shapes (phase 13: 1080p at
    mesh_tile_rows 4): one band's slab of park (20 block rows and the
    2-row halo above and below, 384x1920), the analysis search (n = 16,
    r = 16) and the rect PUs' 8x8 sub-block search on the band's
    reference stacked with its pads, each exact and timed; K2 at the MC
    window sizes 23 and 11 on the slab, exact.  Returns K1's numbers per
    shape and the largest error of each kernel."""
    from x265_mod_by_patman_tpu_torch.analysis import inter_mode as im
    from x265_mod_by_patman_tpu_torch.parallel.tiles import (HALO_BLOCKS,
                                                             _slab)
    res = {"max_abs_err": 0}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    h1, w1 = FRAME_HW
    per_band = -(-(h1 // 16) // TILE_ROWS)
    per_band = -(-per_band // 4) * 4
    rows = TILE_ROWS * per_band * 16
    f = park_frames(w1, 1080, 2)
    pad = lambda p: np.pad(p, ((0, rows - p.shape[0]), (0, 0)),
                           mode="edge").astype(np.int32)
    halo = HALO_BLOCKS * 16
    cur, ref = (_slab(t(pad(f[k][0])), 1, per_band * 16, halo)
                for k in (1, 0))
    bx, by = im._grid(per_band, w1 // 16, 16, dev)
    by = by + halo
    z = torch.zeros_like(bx)
    lam = int(round(im.lambda_qp(28)[0] * 256))
    sr = 16
    shapes = [_k1_shape(f"1080p tile-row band 2 of {TILE_ROWS}, analysis",
                        (ref, cur, bx, by, z, z, lam, 16, sr), card,
                        clock_hz, res)]
    m_pad = sr + 12
    tall, _strip = im._stack_refs([ref], m_pad)
    otall = im._stack_refs([cur], m_pad)[0]
    sx4, sy4 = im._sub4(bx, by)
    z4 = torch.zeros_like(sx4)
    shapes.append(_k1_shape(f"1080p tile-row band 2 of {TILE_ROWS}, rect "
                            "8x8 sub-blocks", (tall, otall, sx4,
                                               sy4 + m_pad, z4, z4, lam, 8,
                                               sr), card, clock_hz, res))
    k2 = {"max_abs_err": 0}
    mv = lambda: t(rng.integers(-20, 21, bx.shape[0]).astype(np.int32))
    for size in (23, 11):
        _check_k2(ref, by - 3 + mv(), bx - 3 + mv(), size,
                  "tile-row band slab", k2)
    return shapes, res["max_abs_err"], k2["max_abs_err"]


def phase_sea(dev, rng, card: str, k1_ms: float):
    """The SEA-pruned search of --me sea (ops/sea.py, torch ops, no hand
    kernel) at the 1080p analysis shape (n = 16, r = 32, k = 64) on park:
    exact against its numpy golden on a sample of blocks, exact against
    K1 when k covers every candidate (r = 4, random predictors), and its
    device time per call beside K1's dense search at the same shape
    (k1_ms).  Returns its numbers."""
    from x265_mod_by_patman_tpu_torch.analysis import inter_mode as im
    from x265_mod_by_patman_tpu_torch.ops.cuda.full_search import \
        full_search
    from x265_mod_by_patman_tpu_torch.ops.sea import (sea_search_batch,
                                                      sea_search_ref)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    h, w = FRAME_HW
    f = park_frames(w, 1080, 2)
    pad = lambda p: np.pad(p, ((0, h - p.shape[0]), (0, 0)), mode="edge")
    ref_np, org_np = (pad(f[k][0]).astype(np.int32) for k in (0, 1))
    ref, org = t(ref_np), t(org_np)
    x0, y0 = im._grid(h // 16, w // 16, 16, dev)
    b = x0.shape[0]
    z = torch.zeros_like(x0)
    lam = int(round(im.lambda_qp(32)[0] * 256))
    n, r, k = 16, 32, 64
    mx, my, cost = sea_search_batch(ref, org, x0, y0, z, z, lam, n, r, k=k)
    sample = rng.choice(b, 6, replace=False)
    for i in sample:
        gold = sea_search_ref(ref_np, org_np, int(x0[i]), int(y0[i]),
                              (0, 0), lam, n, r, k=k)
        got = (int(mx[i]), int(my[i]), int(cost[i]))
        if got != gold:
            raise AssertionError(f"SEA block {i}: {got}, golden {gold}")
    pm = lambda: t(rng.integers(-300, 300, b, dtype=np.int32))
    px, py = pm(), pm()
    dense = full_search(ref, org, x0, y0, px, py, lam, n, 4)
    sea_all = sea_search_batch(ref, org, x0, y0, px, py, lam, n, 4, k=81)
    err = max(int((a.long() - e.long()).abs().max())
              for a, e in zip(sea_all, dense))
    if not all(torch.equal(a, e) for a, e in zip(sea_all, dense)):
        raise AssertionError("SEA at k = all differs from K1")
    ms = time_ms(lambda: sea_search_batch(ref, org, x0, y0, z, z, lam, n,
                                          r, k=k), per_graph=2, reps=3)
    print(f"SEA sea_search_batch 1080p park B={b} n={n} r={r} k={k}: "
          f"equals its golden on {len(sample)} sampled blocks and K1 at "
          f"k = all (r = 4, max_abs_err {err}); device time {ms:.4f} ms "
          f"per call (CUDA-graph replays), K1 dense search at the same "
          f"shape {k1_ms:.4f} ms, SEA / K1 {ms / k1_ms:.2f} ({card})")
    return dict(ms=ms, k1_ms=k1_ms)


class _UhdSps:
    """The geometry _analysis_bands reads of a 3840x2160 picture."""
    width, height = UHD_HW[1], UHD_HW[0]


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
            p12 = t(rng.integers(0, 4096, (h, w), dtype=np.int32))
            _check_k2(p12, ys, xs, size, "frame, 12-bit samples", res)
            ms12 = time_ms(lambda: window_gather(p12, ys, xs, size))
            print(f"K2 device time per call by sample depth (8 / 12 "
                  f"bits): B={nb} size={size} {ms:.4f} / {ms12:.4f} ms "
                  f"({card})")
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
    res["shapes"] = phase_k2_chroma(dev, rng, card, res)
    return res


def phase_k2_chroma(dev, rng, card: str, res):
    """K2 at the chroma MC shapes of the 4:2:2 and 4:4:4 paths, started as
    the final MC starts them (analysis/inter_mode._p_mc): each 16x16
    luma block's chroma window at its chroma origin displaced by an MV
    within +-16 px (4:2:2: the two stacked 8x8 halves, the vertical MV
    doubled; 4:4:4: both components doubled into the eighth-pel chroma
    filter), exact against the plain version and timed with its bound
    and the library call.  Returns one entry per shape for the kernels
    line."""
    from x265_mod_by_patman_tpu_torch.ops.cuda.gather import (
        window_gather, window_gather_plain)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    bys, bxs = np.mgrid[0:FRAME_HW[0] // 16, 0:FRAME_HW[1] // 16]
    bx, by = bxs.ravel() * 16, bys.ravel() * 16
    out = []
    for size, (h, w), fmt in K2_CHROMA_SHAPES:
        plane = t(rng.integers(0, 1024, (h, w), dtype=np.int32))
        mvx = rng.integers(-64, 65, bx.size)
        mvy = rng.integers(-64, 65, bx.size)
        if fmt == "4:2:2":
            # the lower halves (j = 1); the upper ones differ by 8 rows
            xs, ys = (bx >> 1) + (mvx >> 3) - 1, by + 8 + (2 * mvy >> 3) - 1
        else:
            xs, ys = bx + (2 * mvx >> 3) - 1, by + (2 * mvy >> 3) - 1
        ys, xs = t(ys.astype(np.int32)), t(xs.astype(np.int32))
        _check_k2(plane, ys, xs, size, f"{fmt} chroma MC (10-bit samples)",
                  res)
        ar = torch.arange(size, device=dev)
        gy = torch.clip(ys.long()[:, None, None] + ar[None, :, None], 0,
                        h - 1)
        gx = torch.clip(xs.long()[:, None, None] + ar[None, None, :], 0,
                        w - 1)
        k2 = lambda: window_gather(plane, ys, xs, size)
        e = dict(shape=f"{fmt} chroma MC: B={ys.shape[0]} size={size} "
                 f"plane={h}x{w}", format=fmt, ms=time_ms(k2),
                 plain_ms=time_ms(lambda: window_gather_plain(
                     plane, ys, xs, size)),
                 bound_ms=k2_bound_ms(ys.shape[0], size, (h, w)),
                 bound_by="bytes", library_ms=time_ms(lambda: plane[gy, gx]))
        _report("K2", e["shape"], e["ms"], call_ms(k2), e["bound_ms"],
                e["plain_ms"], card, e["library_ms"])
        out.append(e)
    return out


# the ladder's rungs below the 1080p master (phase 11)
LADDER_RUNGS = ((1280, 720), (640, 360))


def phase_mcstf_kernels(dev, card: str, clock_hz: float, sw=1920, sh=1080,
                        rungs=LADDER_RUNGS):
    """K1 and K2 at MCSTF's shapes, on park frames 1 (source) and 0
    (neighbour) cut to 1072x1920: K1's search of every 16x16 block at
    r = 12, lambda 0, zero predictors; K2's 16x16 gather of the aligned
    reference blocks at K1's MVs (clamped per coordinate).  Each exact
    against its plain version and timed with its bound, its plain time
    and, for K2, the library call.  Then mcstf._align_and_error on the
    card against its CPU run (aligned plane, errors, MVs equal), and the
    ladder's scale_frame 1080p -> 720p and -> 360p on the card against
    the CPU (exact), timed.  Returns the two kernels' shape entries and
    their errors."""
    from x265_mod_by_patman_tpu_torch.analysis.mcstf import (
        N, SEARCH, _align_and_error)
    from x265_mod_by_patman_tpu_torch.ops.cuda.full_search import \
        full_search
    from x265_mod_by_patman_tpu_torch.ops.cuda.gather import (
        window_gather, window_gather_plain)
    from x265_mod_by_patman_tpu_torch.utils.scaler import (
        scale_frame, scale_plane_tensor)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    f = park_frames(sw, sh, 2)
    h, w = sh & ~15, sw & ~15
    cur = t(f[1][0][:h, :w].astype(np.int32))
    ref = t(f[0][0][:h, :w].astype(np.int32))
    nby, nbx = h // N, w // N
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    x0 = t((bxs.ravel() * N).astype(np.int32))
    y0 = t((bys.ravel() * N).astype(np.int32))
    z = torch.zeros_like(x0)
    k1_res, k2_res = {"max_abs_err": 0}, {"max_abs_err": 0}
    args = (ref, cur, x0, y0, z, z, 0, N, SEARCH)
    k1 = _k1_shape(f"{sw}x{sh} park, MCSTF alignment", args, card, clock_hz,
                   k1_res)
    k1.update(bound_by="operations", library_ms=None)
    mvx, mvy, _ = full_search(*args)
    ys, xs = (y0 + (mvy >> 2)).contiguous(), (x0 + (mvx >> 2)).contiguous()
    _check_k2(ref, ys, xs, N, "MCSTF aligned blocks", k2_res)
    ar = torch.arange(N, device=dev)
    gy = torch.clip(ys.long()[:, None, None] + ar[None, :, None], 0, h - 1)
    gx = torch.clip(xs.long()[:, None, None] + ar[None, None, :], 0, w - 1)
    k2f = lambda: window_gather(ref, ys, xs, N)
    b = ys.shape[0]
    k2 = dict(shape=f"{sw}x{sh} park, MCSTF aligned blocks: B={b} size={N} "
              f"plane={h}x{w}", ms=time_ms(k2f),
              plain_ms=time_ms(lambda: window_gather_plain(ref, ys, xs, N)),
              bound_ms=k2_bound_ms(b, N, (h, w)), bound_by="bytes",
              library_ms=time_ms(lambda: ref[gy, gx]))
    k2["share"] = k2["bound_ms"] / k2["ms"]
    _report("K2", k2["shape"], k2["ms"], call_ms(k2f), k2["bound_ms"],
            k2["plain_ms"], card, k2["library_ms"])
    # the whole alignment (K1, two K2 gathers, the block errors)
    got = _align_and_error(cur, ref, nby, nbx)
    want = _align_and_error(cur.cpu(), ref.cpu(), nby, nbx)
    for name, g, e in zip(("aligned", "err", "fx", "fy"), got, want):
        if not torch.equal(g.cpu(), e):
            raise AssertionError(f"_align_and_error {name}: card and CPU "
                                 "differ")
    moved = float((got[2] != 0).float().mean() + (got[3] != 0).float()
                  .mean()) / 2
    print(f"MCSTF _align_and_error {sw}x{sh} park frames 0 -> 1 ({nby}x{nbx} "
          f"blocks): card equals CPU (aligned, err, fx, fy); mean error "
          f"{float(got[1].mean()):.2f}, blocks moved {moved:.3f}; "
          f"{call_ms(lambda: _align_and_error(cur, ref, nby, nbx)):.4f} ms "
          f"per call with its host work ({card})")
    # the ladder's scaler: two float64 products per plane
    y_dev = t(f[0][0].astype(np.int32))
    for wo, ho in rungs:
        on_card = scale_frame(f[0], wo, ho, 8, dev)
        on_cpu = scale_frame(f[0], wo, ho, 8, "cpu")
        if not all(np.array_equal(a, c) for a, c in zip(on_card, on_cpu)):
            raise AssertionError(f"scale_frame to {wo}x{ho}: card and CPU "
                                 "differ")
        dev_ms = call_ms(lambda: scale_plane_tensor(y_dev, wo, ho, 8))
        frame_ms = call_ms(lambda: scale_frame(f[0], wo, ho, 8, dev),
                           iters=5, warm=1)
        print(f"scale_frame {sw}x{sh} -> {wo}x{ho}: card equals CPU; luma "
              f"plane on the card {dev_ms:.4f} ms, whole frame from and "
              f"to the host {frame_ms:.4f} ms ({card})")
    return k1, k2, k1_res["max_abs_err"], k2_res["max_abs_err"]


def psnr(a, b, peak: int = 255) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float((d * d).mean())
    return 99.0 if mse == 0 else 10 * np.log10(float(peak) ** 2 / mse)


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


def k3_bound_ms(k: int, m: int) -> float:
    """Bytes bound of the ordered sum: each float32 term read once and
    each row sum written once, at the HBM peak (one add per term is far
    below the fp32 rate)."""
    return 1e3 * 4 * (k * m + m) / HBM_BYTES_PER_S


# K3 at the call sites, each in the layout its caller hands osum (the
# terms read where they lie, no copy): (what, shape made, (slice, view)
# or None, reduced dims, on the main path).  The lookahead's sums of the
# 544x960 lowres plane (17 x 30 windows of 32 x 32, then the 510 window
# sums) and of the 68x120 intra costs (3 x 4 windows of the plane padded
# to 96x128, then 12), _region_uniform's g x g group sums of the 68x120
# 16x16-block map (g = 2: 34 x 60 groups, g = 4: 17 x 30), and the
# batched intra decision's 2x2 CTU group sums of phase 12's two-frame
# 1080p batch at CTU 32 (per mode: 2 x 34 x 60 x 35 sums, views of the
# (2, 68, 120, 35) totals; of the chosen totals: 2 x 34 x 60), and the
# g = 2 groups of 2160p's 135x240 map, whose crop to 134 rows is a
# slice.  The first entry's numbers go into the kernels line.
_CTU = (slice(None), slice(0, 68), slice(0, 120))
K3_SITES = (
    ("intra CTU groups per mode, 2 frames", (2, 68, 120, 35),
     (_CTU, (2, 34, 2, 60, 2, 35)), (2, 4), True),
    ("lowres plane window sums", (17, 30), None, (0, 1), True),
    ("intra-cost windows", (96, 128), (None, (3, 32, 4, 32)), (1, 3), True),
    ("intra-cost window sums", (3, 4), None, (0, 1), True),
    ("region groups g=2", (68, 120), (None, (34, 2, 60, 2)), (1, 3), True),
    ("region groups g=4", (68, 120), (None, (17, 4, 30, 4)), (1, 3), True),
    ("intra CTU groups of the chosen modes", (2, 68, 120),
     (_CTU, (2, 34, 2, 60, 2)), (2, 4), True),
    ("region groups g=2 at 2160p, a slice", (135, 240),
     ((slice(0, 134), slice(None)), (67, 2, 120, 2)), (1, 3), True),
    ("lowres plane windows (int64 sums now)", (544, 960),
     (None, (17, 32, 30, 32)), (1, 3), False))
# K3 on compact (K, M) terms, reduced axis first: the TU16 / TU32 terms
# in row-major order (the lane mode runs there), ragged sizes (M not a
# multiple of 32, K = 1; K past one staging chunk of 2048 terms: 10000 at
# M = 1 is four chunks and one of 1808 terms, 2100 at M = 12 one chunk
# and one of 52)
K3_SHAPES = ((256, 8160, "TU16 terms row-major (lane mode runs there)"),
             (1024, 2040, "TU32 terms row-major (lane mode runs there)"),
             (1, 1001, "ragged: K = 1, M = 1001"),
             (7, 100003, "ragged: K = 7, M = 100003"),
             (10000, 1, "ragged: five staging chunks, M = 1"),
             (2100, 12, "ragged: two staging chunks, M = 12"),
             (0, 7, "no terms: K = 0"))
# K3's lane mode at the TU sums of tu_rd_levels (n x n blocks, M of them,
# as lsum hands them: (M, n, n)): the I pictures' CU-tree costs at 1080p
# (TU32, TU16, TU8 per 8x8 of the NxN candidate) and the TU4 split's DST
# blocks (9a); then ragged M
K3_LANE_SHAPES = ((32, 2040, "TU32 costs"), (16, 8160, "TU16 costs"),
                  (8, 32640, "TU8 costs"), (4, 130560, "TU4 DST costs"))
K3_LANE_RAGGED = ((32, 37, "ragged M"), (16, 1, "one block"),
                  (8, 1001, "ragged M"), (4, 999, "ragged M"))
# The frames whose sums K3 takes in the smoke's phases, at the size the
# encoder codes them (padded to 16): 1080p (phases 3-6, 8-10, 12, 13 and
# the ladder's first rung), 2160p (phase 7, whose analysis runs in row
# bands: its star search's r = 32), the ladder's 720p and 360p rungs
# (phase 11).  (what, width, height, search range of the bands)
K3_FRAMES = (("1080p", 1920, 1088, 16), ("2160p", 3840, 2160, 32),
             ("720p rung", 1280, 720, 16), ("360p rung", 640, 368, 16))
FADD_LATENCY = {}       # "cycles": the measured dependent-add latency
FADD_BUILD = None       # set by main(): (nvcc process, library path)


def fadd_build_start():
    """Start nvcc on the add-latency microbenchmark (csrc/bench/
    fadd_chain.cu, not part of the kernel library) beside the library's
    own build; returns (process, library path)."""
    so = os.path.join(ROOT, "build", "fadd_chain.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    from x265_mod_by_patman_tpu_torch.ops.cuda import build
    src = os.path.join(ROOT, PKG, "csrc", "bench", "fadd_chain.cu")
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", so,
                             src], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so


def fadd_latency_cycles(built) -> float:
    """One thread's chain of dependent __fadd_rn between two clock64()
    reads, at 2,048 and 16,384 adds (the least of 5 runs each): the
    extra cycles over the extra adds, so the clock reads and the loop
    cancel out."""
    import ctypes
    proc, so = built
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on fadd_chain.cu:\n" + log)
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.fadd_chain_launch.argtypes = [p, ctypes.c_int, p, p, p]
    lib.fadd_chain_launch.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    step = torch.tensor([1.0, 0.5], device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, device=dev)
    best = {}
    for n in (2048, 16384) * 5:
        rc = lib.fadd_chain_launch(step.data_ptr(), n, cycles.data_ptr(),
                                   sink.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fadd_chain launch failed: {rc}")
        torch.cuda.synchronize()
        best[n] = min(best.get(n, 1 << 62), int(cycles.item()))
    lat = (best[16384] - best[2048]) / (16384 - 2048)
    print(f"fadd latency: {lat:.3f} cycles a dependent __fadd_rn (one "
          f"thread, clock64; {best[2048]} cycles for 2048 adds, "
          f"{best[16384]} for 16384)")
    if not 1.0 <= lat <= 64.0:
        raise AssertionError(f"implausible add latency {lat}")
    FADD_LATENCY["cycles"] = lat
    return lat


def k3_chain_ms(adds: int, clock_hz: float) -> float:
    """The least time of `adds` dependent float32 adds in one thread: the
    count times the measured add latency at the SM clock (a bound the
    bytes do not see)."""
    return 1e3 * adds * FADD_LATENCY["cycles"] / clock_hz


def lane_chain_adds(n: int) -> int:
    """The dependent adds of one lane-mode block: at n <= 8 a row of n
    adds then the log2(n) tree; at n >= 16 only lane 0 waits on the
    running sum, n / 8 + 3 adds a row."""
    if n <= 8:
        return n + n.bit_length() - 1
    return n * (n // 8 + 3)


def _k3_bound(bytes_ms: float, chain_ms: float):
    return (chain_ms, "chain") if chain_ms > bytes_ms else (bytes_ms,
                                                           "bytes")


def _k3_terms(rng, shape, dev, scale=(1.0, 1e3, 4e4)):
    return torch.from_numpy((rng.random(shape) * rng.choice(
        scale, shape)).astype(np.float32)).to(dev)


def _k3_permuted(x, dims):
    """The (K, M) terms of a sum of x over dims, reduced dims first: what
    osum_plain takes (a copy where x's layout needs one)."""
    keep = [d for d in range(x.dim()) if d not in dims]
    return x.permute(*dims, *keep).reshape(
        int(np.prod([x.shape[d] for d in dims])), -1)


def k3_frame_sums(w: int, h: int, search_range: int, dev, rng):
    """(what, terms, dims) of every sum K3 takes for a w x h coded frame:
    those the lookahead's _lowres_scalars hands osum (recorded as its
    _tree_sum hands them, on random lowres samples and intra costs of
    the frame's sizes), and the analysis' g x g group sums (g = 2, 4)
    of the 16x16 block map cropped to whole groups, as _region_uniform
    takes them, for the whole frame and for each row band with its halo
    rows (_analysis_bands).  Checks that the card's two lookahead
    scalars equal the CPU's."""
    from types import SimpleNamespace
    from x265_mod_by_patman_tpu_torch.analysis import lookahead
    from x265_mod_by_patman_tpu_torch.analysis.inter_mode import \
        _analysis_bands
    from x265_mod_by_patman_tpu_torch.ops.numeric import osum
    sums = []

    def recorded(x, dims):
        sums.append((f"lookahead {tuple(x.shape)}", x, tuple(dims)))
        return osum(x, dims)

    low = rng.integers(0, 4096, (h // 2, w // 2)).astype(np.int32)
    intra = rng.integers(800, 4200, (h // 16, w // 16)).astype(np.int32)
    lookahead.osum = recorded
    try:
        card = lookahead._lowres_scalars(torch.from_numpy(low).to(dev),
                                         torch.from_numpy(intra).to(dev))
    finally:
        lookahead.osum = osum
    cpu = lookahead._lowres_scalars(torch.from_numpy(low),
                                    torch.from_numpy(intra))
    if not torch.equal(card.cpu(), cpu):
        raise AssertionError(f"lookahead scalars at {w}x{h}: card "
                             f"{card.tolist()} != CPU {cpu.tolist()}")
    nby, nbx = h // 16, w // 16
    bands = _analysis_bands(SimpleNamespace(width=w, height=h), 16,
                            search_range) or []
    heights = sorted({nby} | {r1 - r0 + ht + hb
                              for r0, r1, ht, hb in bands})
    for rows in heights:
        for g in (2, 4):
            gh, gw = rows // g, nbx // g
            a = torch.from_numpy(rng.random((rows, nbx)).astype(
                np.float32) * 1e4).to(dev)
            sums.append((f"group sums g={g} of a {rows}x{nbx} map",
                         a[:gh * g, :gw * g].reshape(gh, g, gw, g), (1, 3)))
    return sums


def phase_k3(dev, rng, card: str, clock_hz: float):
    """K3 against its plain version, exact (torch.equal), at the call
    sites in the layouts their callers hand osum (strided views, read in
    place), on compact (K, M) terms (ragged sizes among them), at every
    sum of the lookahead and the analysis' group sums at each frame size
    of K3_FRAMES (exact only), and in the lane mode at the TU-cost shapes
    in lsum's (M, n, n) layout (also block-strided, transposed and at
    ragged M).  For each timed shape: the kernel's device time
    (CUDA-graph replays) and one whole call with its wrapper, the bytes
    bound and the chain bound (the dependent adds at the measured add
    latency), the plain version's, fsum's (the pairwise order) and one
    torch.sum's (the library call) time.  A mismatch fails the run."""
    from x265_mod_by_patman_tpu_torch.ops.cuda.ordered_sum import (
        ordered_sum, ordered_sum_lanes)
    from x265_mod_by_patman_tpu_torch.ops.numeric import (fsum,
                                                          lanes_sum_plain,
                                                          lsum, osum,
                                                          osum_plain)
    res = {"max_abs_err": 0.0, "shapes": []}

    def held(what, got, ref):
        err = float((got.double() - ref.double()).abs().max()) \
            if got.numel() else 0.0
        print(f"K3 {what}: max_abs_err={err}")
        if not torch.equal(got, ref):
            raise AssertionError(f"ordered_sum differs: {what}")
        res["max_abs_err"] = max(res["max_abs_err"], err)

    def timed(what, k3, whole, plain, pairwise, lib, nbytes_ms, adds,
              on_path):
        ms = time_ms(k3)
        # the plain version is timed where the path runs K3 (a graph of
        # its thousands of launches costs seconds to capture)
        plain_ms = time_ms(plain, per_graph=2) if on_path else None
        fsum_ms = time_ms(pairwise)
        lib_ms = time_ms(lib)
        chain = k3_chain_ms(adds, clock_hz)
        bound, by = _k3_bound(nbytes_ms, chain)
        call = call_ms(whole)
        _report("K3", what, ms, call, bound,
                float("nan") if plain_ms is None else plain_ms, card, lib_ms)
        print(f"K3 at {what}: whole call {call:.4f} ms, fsum "
              f"{fsum_ms:.4f} ms, torch.sum {lib_ms:.4f} ms; bytes bound "
              f"{nbytes_ms:.6f} ms, chain bound {chain:.6f} ms ({adds} "
              f"dependent adds at {FADD_LATENCY['cycles']:.3f} cycles); "
              f"bound by {by}, share {bound / ms:.3f}")
        entry = dict(shape=what, ms=ms, call_ms=call, plain_ms=plain_ms,
                     bound_ms=bound, bound_by=by, bytes_bound_ms=nbytes_ms,
                     chain_bound_ms=chain, library_ms=lib_ms,
                     fsum_ms=fsum_ms, on_path=on_path)
        if not res["shapes"]:
            res.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=by, library_ms=lib_ms, shape=what)
        res["shapes"].append(entry)

    for what, shape, view, dims, on_path in K3_SITES:
        x = _k3_terms(rng, shape, dev)
        if view is not None:
            sl, rs = view
            x = (x[sl] if sl is not None else x).reshape(rs)
        k = int(np.prod([x.shape[d] for d in dims]))
        m = x.numel() // k
        terms = lambda x=x, dims=dims: _k3_permuted(x, dims)
        label = (f"{what} K={k} M={m} (strides "
                 f"{tuple(x.stride())}, dims {dims})")
        held(label, ordered_sum(x, dims).reshape(-1), osum_plain(terms()))
        timed(label, lambda x=x, dims=dims: ordered_sum(x, dims),
              lambda x=x, dims=dims: osum(x, dims),
              lambda terms=terms: osum_plain(terms()),
              lambda x=x, dims=dims: fsum(x, dims),
              lambda x=x, dims=dims: x.sum(dims), k3_bound_ms(k, m), k,
              on_path)
    for k, m, what in K3_SHAPES:
        xt = _k3_terms(rng, (k, m), dev)
        label = f"{what} K={k} M={m} (compact)"
        held(label, ordered_sum(xt, 0), osum_plain(xt))
        timed(label, lambda xt=xt: ordered_sum(xt, 0),
              lambda xt=xt: osum(xt, 0), lambda xt=xt: osum_plain(xt),
              lambda xt=xt: fsum(xt, 0), lambda xt=xt: xt.sum(0),
              k3_bound_ms(k, m), k, False)
    for what, w, h, r in K3_FRAMES:
        for site, x, dims in k3_frame_sums(w, h, r, dev, rng):
            k = int(np.prod([x.shape[d] for d in dims]))
            held(f"{what} {site} K={k} M={x.numel() // k} (strides "
                 f"{tuple(x.stride())}, dims {dims})",
                 ordered_sum(x, dims).reshape(-1),
                 osum_plain(_k3_permuted(x, dims)))
    for n, m, what in K3_LANE_SHAPES + K3_LANE_RAGGED:
        x = _k3_terms(rng, (m, n, n), dev, (1.0, 1e2, 1e5))
        xt = x.reshape(m, n * n).T.contiguous()
        label = f"lane mode {what} n={n} M={m}"
        held(label + " (M, n, n)", ordered_sum_lanes(x, n),
             lanes_sum_plain(xt, n))
        # every other block of a (2M, n, n) tensor: block-strided; and
        # the blocks transposed: columns strided
        for how, v in (("every other block", _k3_terms(
                rng, (2 * m, n, n), dev, (1.0, 1e2, 1e5))[::2]),
                       ("transposed blocks", x.transpose(1, 2))):
            held(f"{label} {how}", ordered_sum_lanes(v, n),
                 lanes_sum_plain(v.reshape(m, n * n).T.contiguous(), n))
        if (n, m, what) not in K3_LANE_SHAPES:
            continue
        timed(label + " (M, n, n)", lambda x=x, n=n: ordered_sum_lanes(x, n),
              lambda x=x: lsum(x),
              lambda xt=xt, n=n: lanes_sum_plain(xt, n),
              lambda x=x: fsum(x, (1, 2)), lambda x=x: x.sum((1, 2)),
              k3_bound_ms(n * n, m), lane_chain_adds(n), True)
    return res


def lowres_sums_exact(frames, dev, hw=FRAME_HW) -> None:
    """The lookahead sums each frame's lowres intra costs (8160 at 1080p,
    32640 at 2160p) in float32 (the reference's order, through K3);
    below 2**24 that sum is exact in any order, so the card, the CPU
    and the reference agree.  Prints each frame's sum against the exact integer sum
    (informational: at 10 bits or 2160p the sums may pass 2**24, where
    only the order fixes the rounding).  hw: the CTU-padded luma size."""
    from x265_mod_by_patman_tpu_torch.analysis.lookahead import LowresStore
    from x265_mod_by_patman_tpu_torch.frame.planes import as_devplane
    h, w = hw
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


def drive(enc, frames):
    """Encode `frames` through `enc` on the card with the kernel counts
    set to 0 just before and read just after.  Times each picture (card
    synchronised around _encode_picture) and records the trace spans it
    ran, and splits each kernel's launches into the slicetype lookahead
    (SlicetypeLookahead._eval_triples), cuTree (CuTreeLookahead._cost_vs)
    and analysis (the rest).  Each encoded frame carries the per-CTU QP
    map it coded (`qp_map`, a scalar without AQ) and its pipeline runs
    (more than one where the row-level VBV re-encoded it)."""
    from x265_mod_by_patman_tpu_torch.analysis.lookahead import \
        CuTreeLookahead
    from x265_mod_by_patman_tpu_torch.analysis.slicetype import \
        SlicetypeLookahead
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    from x265_mod_by_patman_tpu_torch.ops import cuda as kernels
    from x265_mod_by_patman_tpu_torch.utils import trace
    from x265_mod_by_patman_tpu_torch.analysis import (inter_mode,
                                                       lookahead, slicetype)
    pics = []
    split = {k: dict.fromkeys(kernels.KERNELS, 0)
             for k in ("lookahead", "cutree", "hme_analysis",
                       "hme_lookahead")}
    originals = (Encoder._encode_picture, SlicetypeLookahead._eval_triples,
                 CuTreeLookahead._cost_vs)
    encode_picture, eval_triples, cost_vs = originals
    # the HME tier: the analysis' quarter-res search and the lookahead's
    # hme_seeds (the lattice and cuTree call it through their modules)
    hme_fns = ((inter_mode, "_hme_center_fullres", "hme_analysis"),
               (lookahead, "hme_seeds", "hme_lookahead"),
               (slicetype, "hme_seeds", "hme_lookahead"))
    hme_orig = [getattr(m, a) for m, a, _ in hme_fns]

    def timed_picture(self, *a, **k):
        torch.cuda.synchronize()
        ev0 = len(trace._events)
        t0 = time.perf_counter()
        f = encode_picture(self, *a, **k)
        torch.cuda.synchronize()
        pics.append((time.perf_counter() - t0, trace._events[ev0:]))
        return f

    def counted(what, fn):
        def wrapper(*a, **k):
            before = kernels.counts()
            got = fn(*a, **k)
            for name, c in kernels.counts().items():
                split[what][name] += c - before[name]
            return got
        return wrapper

    Encoder._encode_picture = timed_picture
    SlicetypeLookahead._eval_triples = counted("lookahead", eval_triples)
    CuTreeLookahead._cost_vs = counted("cutree", cost_vs)
    for (m, a, what), fn in zip(hme_fns, hme_orig):
        setattr(m, a, counted(what, fn))
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
        by_shape = kernels.counts_by_shape()
        spans = trace._events[ev0:]
    finally:
        (Encoder._encode_picture, SlicetypeLookahead._eval_triples,
         CuTreeLookahead._cost_vs) = originals
        for (m, a, _), fn in zip(hme_fns, hme_orig):
            setattr(m, a, fn)
    return dict(out=out, pics=pics, counts=counts, by_shape=by_shape,
                split=split, spans=spans, total=total,
                peak=torch.cuda.max_memory_allocated())


def report_drive(run, frames, w, h, what, peak=255):
    """Print a drive()'s pictures, spans, launches and memory; checks the
    recon quality and that both kernels launched."""
    out, pics, n = run["out"], run["pics"], len(frames)
    print(f"{what}: decode order "
          + " ".join(f"{f.slice_type}{f.disp}" for f in out))
    for i, (f, (s, _ev)) in enumerate(zip(out, pics)):
        q = psnr(frames[f.disp][0], f.recon[0][:h, :w], peak)
        qm = np.asarray(f.qp_map)
        aq = sum(e["dur"] for e in _ev if e.get("ph") == "X"
                 and e["name"] == "aq_map") / 1e3
        vbv = f.stats.get("vbv_fill_pct")
        print(f"picture {i} {f.slice_type} (display {f.disp}, NAL "
              f"{vcl_nal_type(f.bitstream)}, QP {f.qp}, CTU QP "
              f"min/mean/max {qm.min()}/{qm.mean():.2f}/{qm.max()}): "
              f"{s:.3f} s, {f.bits} bits, PSNR-Y {q:.2f} dB (peak "
              f"{peak}), aq_map {aq:.1f} ms, pipeline runs "
              f"{f.pipeline_runs}"
              + ("" if vbv is None else f", vbv_fill_pct {vbv}"))
        if not q > 28.0:
            raise AssertionError(f"picture {i}: recon PSNR {q:.2f} dB")
    for t in ("I", "P", "B"):
        ss = [s for f, (s, _ev) in zip(out, pics) if f.slice_type == t]
        if ss:
            print(f"seconds per {t} picture: {statistics.mean(ss):.3f} "
                  f"(n={len(ss)}, range {min(ss):.3f}-{max(ss):.3f})")
    agg, phases = {}, {}
    for e in run["spans"]:
        if e.get("ph") != "X":
            continue
        if e["name"].startswith(("la_", "cutree_")) or \
                e["name"] in ("slicetype_push", "aq_map"):
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
    print("lookahead and rate-control spans: " + ", ".join(
        f"{k} {c}x {d:.3f} s" for k, (c, d) in sorted(agg.items())))
    total = run["total"]
    print(f"lookahead total {sum(d for _, d in agg.values()):.3f} s of "
          f"{total:.3f} s; fps {n / total:.3f}; bits per frame "
          f"{8 * sum(len(f.bitstream) for f in out) / n:.0f}; "
          f"max_memory_allocated {run['peak'] / 2**20:.0f} MiB")
    sp = run["split"]
    la, ct = sp["lookahead"], sp["cutree"]
    hme = lambda k: "" if not (sp["hme_analysis"][k] or
                               sp["hme_lookahead"][k]) else \
        (f"; HME tier: analysis {sp['hme_analysis'][k]}, lookahead and "
         f"cuTree {sp['hme_lookahead'][k]}")
    print("kernel launches during the encode: " + ", ".join(
        f"{k} {c} (lookahead {la[k]}, cuTree {ct[k]}, analysis "
        f"{c - la[k] - ct[k]}{hme(k)})" for k, c in run["counts"].items()))
    for name, c in run["counts"].items():
        if c <= 0:
            raise AssertionError(f"{name} never launched on the path: "
                                 f"{what}")


def phase_main(dev, w=1920, h=1080, n=2):
    """The 1080p default encode on the card (I P; phase 4's defaults case
    holds the B pyramid); returns launch counts."""
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    from x265_mod_by_patman_tpu_torch.params import default_params
    frames = park_frames(w, h, n)
    run = drive(Encoder(default_params(w, h), dev), frames)
    report_drive(run, frames, w, h,
                 f"main path {w}x{h} at the repo defaults")
    decode_later(f"phase 3, {w}x{h} defaults", run["out"])
    order = [(f.slice_type, f.disp) for f in run["out"]]
    if order != [("I", 0), ("P", 1)]:
        raise AssertionError(f"decode order {order}, not I0 P1")
    lowres_sums_exact(frames, dev)
    return run["counts"]


def phase_rc(dev, w=1920, h=1080, n=2):
    """The 1080p rate-control path on the card: the repo defaults under
    CRF 28 with AQ 2 and the cuTree lookahead (rc_lookahead at its
    default, so every cuTree pop of this clip runs in the flush), cut to
    2 frames (I, P) to keep the script's time; returns launch counts."""
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    from x265_mod_by_patman_tpu_torch.params import default_params
    frames = park_frames(w, h, n)
    enc = Encoder(default_params(w, h, rc_mode="crf", crf=28.0, aq_mode=2),
                  dev)
    if enc._cutree is None or not enc.pps.cu_qp_delta_enabled:
        raise AssertionError("CRF + AQ 2 did not enable cuTree and "
                             "cu_qp_delta")
    run = drive(enc, frames)
    report_drive(run, frames, w, h,
                 f"rate-control path {w}x{h}, CRF 28, AQ 2, cuTree "
                 f"(rc_lookahead {enc.p.rc_lookahead})")
    decode_later(f"phase 5, {w}x{h} CRF + AQ 2 + cuTree", run["out"])
    P_ANALYSIS_SPANS["5"] = p_analysis_span(run)
    order = [(f.slice_type, f.disp) for f in run["out"]]
    if order != [("I", 0), ("P", 1)]:
        raise AssertionError(f"decode order {order}, not I0 P1")
    if not any(np.min(f.qp_map) < np.max(f.qp_map) for f in run["out"]):
        raise AssertionError("the per-CTU QP map never varied")
    return run["counts"]


def phase_main10(dev, w=1920, h=1080, n=2):
    """The Main10 delivery path at full width on the card: 1080p park at
    10 bits (times 4, dithered), cut to 2 frames (I P), CRF 28 + AQ 2 +
    cuTree under a 1000 kbit / 1000 kb/s VBV at 25 fps with HRD timing
    SEIs and HDR10 signalling, with parameters built as the CLI builds
    them.  Checks no VBV underflow, the CPB model on the parsed timing
    SEIs, the decode order I0 P1, and a per-CTU QP map that varies;
    returns launch counts."""
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    frames = deep_frames(park_frames(w, h, n), 10, 2026)
    opts = (("crf", "28"), ("aq-mode", "2"), ("vbv-bufsize", "1000"),
            ("vbv-maxrate", "1000"), ("hrd", "")) + HDR10_OPTS
    params = cli_params(w, h, n, opts, 10)
    enc = Encoder(params, dev)
    if enc._cutree is None or not enc.sps.hrd or enc.rc.vbv_buffer <= 0:
        raise AssertionError("the delivery path lacks cuTree, HRD or VBV")
    run = drive(enc, frames)
    report_drive(run, frames, w, h, f"Main10 delivery path {w}x{h}, CRF "
                 "28, AQ 2, cuTree, VBV 1000/1000, HRD, HDR10", peak=1023)
    out = run["out"]
    decode_later(f"phase 6, {w}x{h} Main10 delivery", out)
    print(f"pipeline runs per picture: {[f.pipeline_runs for f in out]}; "
          f"VBV underflows {enc.rc.vbv_underflows}")
    if enc.rc.vbv_underflows:
        raise AssertionError(f"{enc.rc.vbv_underflows} VBV underflows")
    check_hrd(b"".join(f.bitstream for f in out), out,
              cli_params(w, h, n, opts, 10))
    order = [(f.slice_type, f.disp) for f in out]
    if order != [("I", 0), ("P", 1)]:
        raise AssertionError(f"decode order {order}, not I0 P1")
    if not any(np.min(f.qp_map) < np.max(f.qp_map) for f in out):
        raise AssertionError("the per-CTU QP map never varied")
    lowres_sums_exact(frames, dev)
    return run["counts"]


# BASELINE config 4 (tools/bench_configs.py make_params(4)) as CLI options
UHD_OPTS = (("hme", ""), ("rc-lookahead", "40"), ("crf", "24"),
            ("vbv-bufsize", "25000"), ("vbv-maxrate", "25000"))


def phase_uhd(dev, w=UHD_HW[1], h=UHD_HW[0], n=3):
    """The UHD slow path at full width on the card: 2160p park, 3 frames
    (I P B), with parameters built as the CLI builds them for BASELINE
    config 4 (--preset slow --hme --rc-lookahead 40 --crf 24 --vbv-bufsize
    25000 --vbv-maxrate 25000) at 60 fps.  Prints what phase 6 prints,
    the analysis bands, each picture's share of inter 16x16 blocks coded
    as rect PUs, and the launches with the HME tier counted; fails on a
    decode order other than I0 P2 B1, a VBV underflow, no rect PU on any
    picture or a recon below 28 dB.  Returns launch counts."""
    from x265_mod_by_patman_tpu_torch.analysis.inter_mode import \
        _analysis_bands
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    frames = uhd_frames(n)
    params = cli_params(w, h, n, UHD_OPTS, preset="slow", fps=60)
    enc = Encoder(params, dev)
    p = enc.p
    bands = _analysis_bands(enc.sps, 16, enc._me_range)
    print(f"UHD slow path: rd {p.rd_level}, rdoq {p.rdoq_level}, sign hide "
          f"{p.sign_hide}, psy-rdoq {p.psy_rdoq}, rect {p.rect}, amp "
          f"{p.amp}, hme {p.hme}, --me {p.search_method} (r = "
          f"{enc._me_range}), subme {p.subpel_refine}, refs {enc.max_refs}, "
          f"bframes {p.bframes}, rc-lookahead {p.rc_lookahead}, cuTree "
          f"{enc._cutree is not None}, VBV {p.vbv_bufsize}/{p.vbv_maxrate} "
          f"at {p.fps_num} fps; analysis bands "
          f"{0 if bands is None else len(bands)} {bands}")
    if not (p.rect and p.hme and bands and enc._me_range == 32
            and p.rdoq_level == 2 and p.sign_hide and enc.rc.vbv_buffer > 0):
        raise AssertionError("the UHD slow path lacks rect, HME, bands, "
                             "star search, RDOQ + sign hiding or the VBV")
    run = drive(enc, frames)
    report_drive(run, frames, w, h, f"UHD slow path {w}x{h}, --preset slow "
                 "--hme, CRF 24, VBV 25000/25000 at 60 fps")
    out = run["out"]
    decode_later(f"phase 7, {w}x{h} --preset slow --hme", out)
    rect = [f.stats.get("cu_rect_pct", 0.0) for f in out]
    inter = [f.stats.get("cu_inter_pct", 0.0) for f in out]
    print("share of inter 16x16 blocks coded as rect PUs per picture: "
          + ", ".join(f"{f.slice_type}{f.disp} "
                      f"{(r / i if i else 0.0):.4f}"
                      for f, r, i in zip(out, rect, inter)))
    print(f"pipeline runs per picture: {[f.pipeline_runs for f in out]}; "
          f"VBV underflows {enc.rc.vbv_underflows}")
    order = [(f.slice_type, f.disp) for f in out]
    if order != [("I", 0), ("P", 2), ("B", 1)]:
        raise AssertionError(f"decode order {order}, not I0 P2 B1")
    if enc.rc.vbv_underflows:
        raise AssertionError(f"{enc.rc.vbv_underflows} VBV underflows")
    if not any(r > 0 for r in rect):
        raise AssertionError("no rect PU on any picture")
    lowres_sums_exact(frames, dev, (h + (-h) % 64, w))
    return run["counts"]


VERYSLOW_OPTS = (("crf", "24"),)
# the weighted-B / SEA path: the repo defaults otherwise, scenecut off so
# that the fade does not turn the B into an I (as the reference's weightb
# test turns it off)
WEIGHTB_SEA_OPTS = (("weightb", ""), ("me", "sea"), ("no-scenecut", ""))


def phase_veryslow(dev, w=1920, h=1080, n=3):
    """8a: 1080p park, 3 frames (I P B), `--preset veryslow --crf 24` with
    the parameters built as the CLI builds them: AMP in P and B, rect,
    star r = 32, 4 references, subme 4, 8 B-frames, rc-lookahead 40.
    Prints what phase 3 prints and each picture's AMP and rect shares
    (AMP rarely pays on park: informational); fails on a decode order
    other than I0 P2 B1 or a recon below 28 dB.  Returns launch counts."""
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    frames = park_frames(w, h, n)
    enc = Encoder(cli_params(w, h, n, VERYSLOW_OPTS, preset="veryslow"),
                  dev)
    p = enc.p
    print(f"veryslow path: rd {p.rd_level}, amp {p.amp}, rect {p.rect}, "
          f"--me {p.search_method} (r = {enc._me_range}), subme "
          f"{p.subpel_refine}, refs {enc.max_refs}, bframes {p.bframes}, "
          f"rc-lookahead {p.rc_lookahead}, rdoq {p.rdoq_level}")
    if not (p.amp and p.rect and enc._me_range == 32 and enc.max_refs == 4
            and p.subpel_refine == 4 and p.bframes == 8
            and p.rc_lookahead == 40):
        raise AssertionError("the veryslow path lacks AMP, rect, star "
                             "r = 32, 4 refs, subme 4 or 8 B-frames")
    run = drive(enc, frames)
    report_drive(run, frames, w, h, f"veryslow path {w}x{h}, --preset "
                 "veryslow --crf 24")
    out = run["out"]
    decode_later(f"phase 8a, {w}x{h} --preset veryslow", out)
    print("AMP / rect share of 16x16 blocks per picture (cu_amp_pct / "
          "cu_rect_pct): " + ", ".join(
              f"{f.slice_type}{f.disp} {f.stats.get('cu_amp_pct', 0.0)} / "
              f"{f.stats.get('cu_rect_pct', 0.0)}" for f in out))
    order = [(f.slice_type, f.disp) for f in out]
    if order != [("I", 0), ("P", 2), ("B", 1)]:
        raise AssertionError(f"decode order {order}, not I0 P2 B1")
    return run["counts"]


def phase_weightb_sea(dev, w=1920, h=1080, n=3):
    """8b: 1080p park under a luma fade (x0.82 per frame), 3 frames (I P
    B), `--weightb --me sea --no-scenecut` at the repo defaults
    otherwise: weighted P and B, the SEA-pruned search in both analyses
    (AMP stays off: no rect).  Prints what phase 3 prints, the P and B
    slices' explicit luma weights and the analysis span per picture
    type; fails on a decode order other than I P B, a recon below 28
    dB or a B slice without an explicit weight.  Returns launch
    counts."""
    from x265_mod_by_patman_tpu_torch.encoder import top
    frames = fade_frames(park_frames(w, h, n))
    enc = top.Encoder(cli_params(w, h, n, WEIGHTB_SEA_OPTS), dev)
    p = enc.p
    if not (p.weightb and p.weightp and p.search_method == "sea"
            and not p.scenecut and enc._me_range == 32):
        raise AssertionError("the weightb/SEA path lacks --weightb, "
                             "weightp or --me sea (r = 32)")
    seen = {"P": [], "B": []}
    ana = (top.analyse_p_frame, top.analyse_b_frame)

    def on_p(*a, **k):
        seen["P"].append(k.get("weights"))
        return ana[0](*a, **k)

    def on_b(*a, **k):
        seen["B"].append(k.get("weights_b"))
        return ana[1](*a, **k)

    top.analyse_p_frame, top.analyse_b_frame = on_p, on_b
    try:
        run = drive(enc, frames)
    finally:
        top.analyse_p_frame, top.analyse_b_frame = ana
    report_drive(run, frames, w, h, f"weightb/SEA path {w}x{h}, luma fade "
                 "0.82, --weightb --me sea --no-scenecut")
    out = run["out"]
    decode_later(f"phase 8b, {w}x{h} --weightb --me sea fade", out)
    print(f"explicit luma weights (w, o) per list, denominator 6: P L0 "
          f"{seen['P']}; B (L0, L1) {seen['B']}")
    span = {}
    for e in run["spans"]:
        if e.get("ph") == "X" and e["name"] == "analysis":
            span.setdefault(e["args"]["type"], []).append(e["dur"] / 1e6)
    print("analysis span (SEA search in P and B) seconds: " + ", ".join(
        f"{k} {' '.join(f'{d:.3f}' for d in v)}" for k, v in span.items()))
    order = [(f.slice_type, f.disp) for f in out]
    if order != [("I", 0), ("P", 2), ("B", 1)]:
        raise AssertionError(f"decode order {order}, not I0 P2 B1")
    if not any(wp is not None for wb in seen["B"] if wb for wp in wb):
        raise AssertionError("the B slice carries no explicit weight")
    return run["counts"]


# the residual-side path (phase 9a and phase 4's first residual case):
# denoise and quantisation matrices on a CRF encode with NxN intra PUs
# and TU4 (DST) splits, the repo defaults otherwise
RESIDUAL_OPTS = (("crf", "24"), ("aq-mode", "2"), ("nxn-intra", ""),
                 ("tu-intra-depth", "2"), ("scaling-list", "default"),
                 ("nr-intra", "200"), ("nr-inter", "400"))


def sps_of(stream: bytes):
    """The stream's SPS as the port's decoder parses it."""
    from x265_mod_by_patman_tpu_torch.bitstream.nal import (
        remove_emulation, split_annexb)
    from x265_mod_by_patman_tpu_torch.decoder.decoder import parse_sps
    for u in split_annexb(stream):
        if u and (u[0] >> 1) & 0x3F == 33:
            return parse_sps(remove_emulation(u[2:]))
    raise AssertionError("no SPS in the stream")


def sps_scaling_list_flag(stream: bytes) -> bool:
    """scaling_list_enabled_flag of the stream's SPS, as the port's
    decoder parses it."""
    return bool(sps_of(stream).scaling_list_enabled)


def phase_residual(dev, w=1920, h=1080, n=3):
    """9a: 1080p park, 3 frames (I P B), `--crf 24 --aq-mode 2 --nxn-intra
    --tu-intra-depth 2 --scaling-list default --nr-intra 200 --nr-inter
    400` as the CLI builds it (rd 3, CTU 64, 4 B-frames, b-adapt 2,
    cuTree, --me hex).  Prints what phase 3 prints and per picture the
    share of 16x16 blocks coded NxN, the share of their 8x8 TUs split
    to TU4 and the mean NR offsets (luma intra, luma inter) it coded
    with; fails without an NxN block on the I picture, with all-zero NR
    offsets from the second picture in coding order on, without the
    SPS scaling-list flag, on a decode order other than I0 P2 B1 or a
    recon below 28 dB.  Returns launch counts."""
    from x265_mod_by_patman_tpu_torch.encoder import top
    frames = park_frames(w, h, n)
    enc = top.Encoder(cli_params(w, h, n, RESIDUAL_OPTS), dev)
    p = enc.p
    print(f"residual path: rd {p.rd_level}, CTU {p.ctu_size}, min CU "
          f"{p.min_cu_size}, bframes {p.bframes}, b-adapt {p.b_adapt}, "
          f"cuTree {enc._cutree is not None}, --me {p.search_method}, "
          f"nxn {p.nxn_intra}, tu-intra-depth {p.tu_intra_depth}, scaling "
          f"list {p.scaling_list}, nr {p.nr_intra}/{p.nr_inter}, "
          f"var_cu_tree {p.var_cu_tree}")
    if not (p.nxn_intra and p.tu_intra_depth == 2 and enc.recon.tu4
            and enc.recon.mats is not None and enc._nr is not None
            and enc._cutree is not None):
        raise AssertionError("the residual path lacks NxN, TU4, scaling "
                             "lists, NR or cuTree")
    seen = {"split": [], "tu4": [], "nr": []}
    funcs = (top.decide_modes_split, top.decide_tu4_split)
    run_orig = enc.recon.run

    def on_split(*a, **k):
        got = funcs[0](*a, **k)
        seen["split"].append(got[1])
        return got

    def on_tu4(*a, **k):
        got = funcs[1](*a, **k)
        seen["tu4"].append(got)
        return got

    def on_run(*a, **k):
        seen["nr"].append(k.get("nr"))
        return run_orig(*a, **k)

    top.decide_modes_split, top.decide_tu4_split = on_split, on_tu4
    enc.recon.run = on_run
    try:
        run = drive(enc, frames)
    finally:
        top.decide_modes_split, top.decide_tu4_split = funcs
        del enc.recon.run
    report_drive(run, frames, w, h, f"residual path {w}x{h}, " + " ".join(
        f"--{k} {v}".strip() for k, v in RESIDUAL_OPTS))
    out = run["out"]
    decode_later(f"phase 9a, {w}x{h} NxN + TU4 + lists + NR", out)
    order = [(f.slice_type, f.disp) for f in out]
    if order != [("I", 0), ("P", 2), ("B", 1)]:
        raise AssertionError(f"decode order {order}, not I0 P2 B1")
    split, tu4 = seen["split"][0], seen["tu4"][0]
    nxn_share = float(np.mean(split))
    tu4_share = float(np.sum(tu4) / max(1, 4 * np.sum(split)))
    print(f"I picture: NxN on {nxn_share:.4f} of the 16x16 blocks; TU4 on "
          f"{tu4_share:.4f} of their 8x8 TUs")
    if not nxn_share > 0:
        raise AssertionError("no NxN block on the I picture")
    if len(seen["nr"]) != len(out):
        raise AssertionError(f"{len(seen['nr'])} wavefront runs for "
                             f"{len(out)} pictures")
    for i, (f, nr) in enumerate(zip(out, seen["nr"])):
        ly = np.asarray(nr[0])
        print(f"picture {i} {f.slice_type}{f.disp}: mean NR offset luma "
              f"intra {ly[0].mean():.3f}, luma inter {ly[1].mean():.3f}; "
              f"chroma intra {np.asarray(nr[1])[0].mean():.3f}, inter "
              f"{np.asarray(nr[1])[1].mean():.3f}")
        if i and not (ly.any() or np.asarray(nr[1]).any()):
            raise AssertionError(f"picture {i}: NR offsets all zero")
    if not sps_scaling_list_flag(out[0].bitstream):
        raise AssertionError("the SPS does not enable scaling lists")
    print("SPS scaling_list_enabled_flag 1 (default lists)")
    return run["counts"]


def phase_lossless(dev, w=1920, h=1080, n=2):
    """9b: 1080p park, 2 frames (I P), `--lossless` as the CLI builds it:
    transquant bypass, deblock and SAO off, the recon fetched whole.
    Prints what phase 3 prints (bits per picture among it); fails unless
    the card's recon equals the source sample for sample in all three
    planes.  Returns launch counts."""
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    frames = park_frames(w, h, n)
    enc = Encoder(cli_params(w, h, n, (("lossless", ""),)), dev)
    p = enc.p
    if not (p.lossless and enc.pps.transquant_bypass and not p.deblock
            and not p.sao):
        raise AssertionError("the lossless path lacks transquant bypass "
                             "or keeps a loop filter")
    run = drive(enc, frames)
    report_drive(run, frames, w, h, f"lossless path {w}x{h}, --lossless")
    out = run["out"]
    decode_later(f"phase 9b, {w}x{h} lossless", out)
    if [f.slice_type for f in out] != ["I", "P"]:
        raise AssertionError("decode order is not I P")
    for f in out:
        for k, (a, b) in enumerate(zip(f.recon, frames[f.disp])):
            if not np.array_equal(np.asarray(a)[:b.shape[0], :b.shape[1]],
                                  b):
                raise AssertionError(f"picture {f.disp} plane {k}: the "
                                     "recon differs from the source")
    print("lossless: bits per picture " + ", ".join(
        f"{f.slice_type}{f.disp} {f.bits}" for f in out)
        + "; the card's recon equals the source in all three planes")
    return run["counts"]


def shapes_line(by_shape) -> str:
    """Each kernel's launches by shape, from the wrappers' own counts: K1
    by block size n, range r and plane, K2 by window size and plane, K3
    by (K, M) or, in its lane mode, by block size n and block count M."""
    fmt = lambda d, f: ", ".join(f"{f(*k)}: {v}"
                                 for k, v in sorted(d.items()))
    k3 = lambda k: ("lane mode n=%d M=%d" % k[1:] if k[0] == "lanes"
                    else "K=%d M=%d" % k)
    return ("K1 launches by shape: " + fmt(
        by_shape["full_search"],
        lambda n, r, h, w: f"n={n} r={r} plane={h}x{w}") +
        "; K2 launches by window: " + fmt(
        by_shape["window_gather"],
        lambda size, h, w: f"size={size} plane={h}x{w}") +
        "; K3 launches by shape: " + ", ".join(
            f"{k3(k)}: {v}" for k, v in
            sorted(by_shape["ordered_sum"].items(), key=str)))


# K2's launches at each format's chroma MC window in phase 10 (the
# kernels line gives them beside the shapes' times)
K2_CHROMA_LAUNCHES = {}
# phase 10a's options, as the CLI takes them on a C422p10 y4m (cuTree is
# on by default under CRF)
CHROMA422_OPTS = (("crf", "24"), ("aq-mode", "2"))


def phase_chroma(dev, csp: int, bd: int, opts, n: int, order, what: str,
                 w=1920, h=1080):
    """Phase 10: 1080p park with its chroma brought to 4:2:2 or 4:4:4
    (park_chroma), at `bd` bits, `n` frames, parameters built as the CLI
    builds them for a C422 / C444 y4m with `opts`.  Prints what phase 3
    prints and per picture the PSNR of Y, Cb and Cr, the `wavefront` and
    `entropy` span shares, and each kernel's launches by shape; fails
    unless the SPS signals the format (chroma_format_idc, RExt profile
    4), on a decode order other than `order`, a recon below 28 dB, or
    when K2 never ran at the format's chroma MC window.  Returns the
    launch counts."""
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    frames = park_frames(w, h, n)
    frames = park_chroma(frames, csp, 10 * csp + bd)
    peak = (1 << bd) - 1
    if bd > 8:
        frames = deep_frames(frames, bd, 2026 + csp)
    enc = Encoder(cli_params(w, h, n, opts, bd, csp=csp), dev)
    p = enc.p
    print(f"{what}: chroma planes {frames[0][1].shape}, rd {p.rd_level}, "
          f"var_cu_tree {p.var_cu_tree}, rect {p.rect}, amp {p.amp}, "
          f"cuTree {enc._cutree is not None}, AQ {p.aq_mode}, rc "
          f"{p.rc_mode}")
    run = drive(enc, frames)
    report_drive(run, frames, w, h, what, peak=peak)
    out = run["out"]
    decode_later(f"phase 10, {what}", out)
    got = [(f.slice_type, f.disp) for f in out]
    if got != order:
        raise AssertionError(f"decode order {got}, not {order}")
    for f, (sec, ev) in zip(out, run["pics"]):
        span = lambda name: sum(e["dur"] for e in ev if e.get("ph") == "X"
                                and e["name"] == name) / 1e6
        q = [psnr(src, np.asarray(rec)[:src.shape[0], :src.shape[1]], peak)
             for src, rec in zip(frames[f.disp], f.recon)]
        print(f"picture {f.slice_type}{f.disp}: PSNR Y/Cb/Cr "
              f"{q[0]:.2f}/{q[1]:.2f}/{q[2]:.2f} dB (peak {peak}); "
              f"wavefront {span('wavefront'):.3f} s "
              f"({span('wavefront') / sec:.3f}), entropy "
              f"{span('entropy'):.3f} s ({span('entropy') / sec:.3f}) of "
              f"{sec:.3f} s")
    qm = [np.asarray(f.qp_map) for f in out]
    print("per-CTU QP maps (min/mean/max): " + ", ".join(
        f"{f.slice_type}{f.disp} {m.min()}/{m.mean():.2f}/{m.max()}"
        for f, m in zip(out, qm)))
    print(shapes_line(run["by_shape"]))
    sps = sps_of(out[0].bitstream)
    print(f"SPS: chroma_format_idc {sps.chroma_format_idc}, bit depth "
          f"{sps.bit_depth}, general_profile_idc {sps.ptl.profile_idc}")
    if sps.chroma_format_idc != csp or sps.ptl.profile_idc != 4:
        raise AssertionError("the SPS does not signal the format")
    size, (ph, pw), fmt = [k for k in K2_CHROMA_SHAPES
                           if k[2] == {2: "4:2:2", 3: "4:4:4"}[csp]][0]
    got = run["by_shape"]["window_gather"].get((size, ph, pw), 0)
    if not got:
        raise AssertionError(f"K2 never ran at the chroma window {size} "
                             f"on the {ph}x{pw} plane")
    K2_CHROMA_LAUNCHES[fmt] = got
    return run["counts"]


def phase_chroma422(dev):
    """10a: Main 4:2:2 10 (broadcast contribution and mezzanine encodes):
    1080p park in 4:2:2 at 10 bits, 3 frames (I P B), --crf 24 --aq-mode
    2 with cuTree, the repo defaults otherwise."""
    return phase_chroma(dev, 2, 10, CHROMA422_OPTS, 3,
                        [("I", 0), ("P", 2), ("B", 1)],
                        "4:2:2 10-bit path 1920x1080, --crf 24 --aq-mode 2")


def phase_chroma444(dev):
    """10b: Main 4:4:4 (screen content, graphics, RGB-sourced masters):
    1080p park in 4:4:4 at 8 bits, 2 frames (I P), the repo defaults
    (CQP 32)."""
    return phase_chroma(dev, 3, 8, (), 2, [("I", 0), ("P", 1)],
                        "4:4:4 8-bit path 1920x1080, CQP defaults")


class _OpCount:
    """Counts the torch operations dispatched inside a `with` block (each
    a device launch, views aside): the wavefront's launch count without
    a profiler over its hundreds of thousands of kernels."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


# phase 12: bench.py's all-intra operating point (QP 32, keyint 1, CTU
# 32, rd 2, SAO off; deblock on), scaled from its 416x240 to 1080p
BENCH_KW = dict(qp=32, keyframe_max=1, ctu_size=32, rd_level=2, sao=False,
                deblock=True)


def phase_intra_batched(dev, w=1920, h=1080, n=4):
    """Phase 12: the batched all-intra path at full width.  The same n
    park frames through encode_intra_batched(batch=2) (two batches: the
    first batch's entropy runs while the second is on the card) and
    through encode_intra_pipelined (frame by frame); the two streams must
    be byte-identical.  Prints each run's seconds per frame, fps,
    `wavefront` spans and peak memory, and the torch operations the
    batched wavefront dispatches on two frames against one; fails on a
    byte difference, a recon below 28 dB, or two frames that dispatch
    more than 1.5x one frame's operations (the frames would be
    looping)."""
    from x265_mod_by_patman_tpu_torch.analysis.intra_mode import \
        decide_modes_rd_multi
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    from x265_mod_by_patman_tpu_torch.ops import cuda as kernels
    from x265_mod_by_patman_tpu_torch.params import default_params
    from x265_mod_by_patman_tpu_torch.utils import trace
    frames = park_frames(w, h, n)
    runs = {}
    for name, call in (
            ("batched", lambda e: e.encode_intra_batched(frames, batch=2)),
            ("pipelined", lambda e: e.encode_intra_pipelined(frames))):
        enc = Encoder(default_params(w, h, **BENCH_KW), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        ev0 = len(trace._events)
        t0 = time.perf_counter()
        out = call(enc)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        wf = [e["dur"] / 1e6 for e in trace._events[ev0:]
              if e.get("ph") == "X" and e["name"] == "wavefront"]
        runs[name] = dict(out=out, total=total, wf=wf,
                          counts=kernels.counts(),
                          by_shape=kernels.counts_by_shape(),
                          peak=torch.cuda.max_memory_allocated())
        q = [psnr(frames[i][0], f.recon[0][:h, :w]) for i, f in
             enumerate(out)]
        print(f"phase 12 {name}: {n} frames in {total:.3f} s, "
              f"{total / n:.3f} s per frame, fps {n / total:.3f}; "
              f"wavefront spans " + ", ".join(f"{d:.3f}" for d in wf)
              + f" s; bits " + ", ".join(str(f.bits) for f in out)
              + "; PSNR-Y " + ", ".join(f"{x:.2f}" for x in q)
              + f" dB; max_memory_allocated {runs[name]['peak'] / 2**20:.0f}"
              f" MiB; kernel launches {runs[name]['counts']}")
        if not all(x > 28.0 for x in q):
            raise AssertionError(f"phase 12 {name}: recon PSNR {q}")
    sb = b"".join(f.bitstream for f in runs["batched"]["out"])
    sp = b"".join(f.bitstream for f in runs["pipelined"]["out"])
    if sb != sp:
        raise AssertionError("phase 12: batched and pipelined streams "
                             "differ")
    print(f"phase 12: batched and pipelined streams are byte-identical "
          f"({len(sb)} B; the host decode of the batched one covers both)")
    decode_later("phase 12 1080p all-intra batched", runs["batched"]["out"])
    b, p_ = runs["batched"], runs["pipelined"]
    print(f"phase 12 wavefront span per batch of 2 (mean) "
          f"{statistics.mean(b['wf']):.3f} s against per frame (mean) "
          f"{statistics.mean(p_['wf']):.3f} s; fps batched "
          f"{n / b['total']:.3f}, pipelined {n / p_['total']:.3f}")
    # the batched wavefront on one frame against it on two, the torch
    # operations each dispatches counted (one path: run() also builds
    # the zero MC planes and runs the skip test that run_batch leaves out)
    enc = Encoder(default_params(w, h, **BENCH_KW), dev)
    pad = enc._pad_yuv(frames[:2])
    ys, us, vs = (np.stack([f[c] for f in pad]) for c in range(3))
    modes = decide_modes_rd_multi(ys, enc.sps, 32, dev)
    with _OpCount() as frame:
        enc.recon.run(ys[0], us[0], vs[0], modes[0].cpu().numpy(), qp=32,
                      materialize=False)
    torch.cuda.synchronize()
    with _OpCount() as one:
        enc.recon.run_batch(ys[:1], us[:1], vs[:1], modes[:1], qp=32,
                            materialize=False)
    torch.cuda.synchronize()
    with _OpCount() as two:
        enc.recon.run_batch(ys, us, vs, modes, qp=32, materialize=False)
    torch.cuda.synchronize()
    print(f"phase 12 wavefront torch operations: run_batch on one frame "
          f"{one.n}, on two frames {two.n} ({two.n / one.n:.3f}x); run() "
          f"on one frame {frame.n}")
    if two.n > 1.5 * one.n:
        raise AssertionError("phase 12: the batched wavefront dispatches "
                             f"{two.n / one.n:.2f}x one frame's operations")
    if b["counts"]["ordered_sum"] <= 0:
        raise AssertionError("K3 never launched on the batched path")
    return b["counts"]


# phase 4's frame-parallel case as the CLI takes it (b-adapt 0: the fixed
# 3-B pyramid, whose two non-referenced B pictures form the window)
PARALLEL_AGREE_OPTS = (("crf", "28"), ("aq-mode", "2"), ("bframes", "3"),
                       ("b-adapt", "0"), ("frame-threads", "3"),
                       ("rc-lookahead", "4"))
# phase 13's: I P b b, two B pictures without the pyramid (both in the
# window); mesh_tile_rows and the pyramid are library parameters
PARALLEL_OPTS = (("crf", "28"), ("aq-mode", "2"), ("bframes", "2"),
                 ("b-adapt", "0"), ("frame-threads", "3"))
TILE_ROWS = 4
# the P analysis spans of phases 5 and 13 (whole-frame; tiled, beside the
# same picture as one whole-frame call), which run in different worker
# processes: each worker hands its entries back and the main process
# prints them side by side once both have ended
P_ANALYSIS_SPANS = {}


def p_analysis_span(run):
    """Mean seconds of the `analysis` span of a drive()'s P pictures."""
    d = [e["dur"] / 1e6 for e in run["spans"] if e.get("ph") == "X"
         and e["name"] == "analysis" and e["args"].get("type") == "P"]
    return statistics.mean(d) if d else None


def phase_parallel(dev, w=1920, h=1080, n=4):
    """Frame-parallel B under CRF and the tile-row P analysis at full
    width: 1080p park, 4 frames (I P b b), phase 5's CRF 28 + AQ 2 +
    cuTree with --bframes 2 (no pyramid, b-adapt 0) and --frame-threads
    3, and mesh_tile_rows 4.  Prints what phase 3 prints, the B window's
    wall time beside the sum of its two jobs' _encode_picture times, the
    tiled P analysis span beside phase 5's and beside the whole-frame
    analysis of the same P picture (timed here after the encode), and
    the launches by shape; fails on a decode order other than I0 P3 B1
    B2, when no window of two jobs ran or the tile-row analysis did not
    run."""
    from x265_mod_by_patman_tpu_torch.analysis.inter_mode import \
        analyse_p_frame
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    from x265_mod_by_patman_tpu_torch.utils import trace
    if trace._path is None:            # the spans are read below
        trace._path = os.path.join(ROOT, "build", "smoke_trace_13.json")
    frames = park_frames(w, h, n)
    p = cli_params(w, h, n, PARALLEL_OPTS)
    p.b_pyramid = False
    p.mesh_tile_rows = TILE_ROWS
    enc = Encoder(p, dev)
    windows, tiled = [], []
    b_jobs, tiled_p = Encoder._encode_b_jobs, Encoder._tiled_p_analysis

    def watched(self, jobs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = b_jobs(self, jobs)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0, [f.poc for f in got]))
        return got

    def watched_tiles(self, *a):
        got = tiled_p(self, *a)
        # the decisions as they left the analysis (the MC planes, 4, are
        # not compared), copied before the encode goes on with them
        tiled.append((a, [x.clone() if torch.is_tensor(x) else
                          np.array(x, copy=True)
                          for x in got[:4] + got[5:]]))
        return got

    Encoder._encode_b_jobs, Encoder._tiled_p_analysis = watched, \
        watched_tiles
    try:
        run = drive(enc, frames)
    finally:
        Encoder._encode_b_jobs, Encoder._tiled_p_analysis = b_jobs, tiled_p
    report_drive(run, frames, w, h,
                 f"frame-parallel and tile-row path {w}x{h}, CRF 28, AQ 2, "
                 f"cuTree, --bframes 2 --no-b-pyramid --frame-threads 3, "
                 f"mesh_tile_rows "
                 f"{TILE_ROWS}")
    print("frame-parallel and tile-row path " + shapes_line(run["by_shape"]))
    decode_later(f"phase 13, {w}x{h} frame-parallel B + tile rows",
                 run["out"])
    order = [(f.slice_type, f.disp) for f in run["out"]]
    if order != [("I", 0), ("P", 3), ("B", 1), ("B", 2)]:
        raise AssertionError(f"decode order {order}, not I0 P3 B1 B2")
    secs = {f.poc: t for f, (t, _ev) in zip(run["out"], run["pics"])}
    window = [(wall, pocs) for wall, pocs in windows if len(pocs) == 2]
    if not window:
        raise AssertionError(f"no frame-parallel window of two B jobs: "
                             f"{windows}")
    for wall, pocs in window:
        jobs = [secs[q] for q in pocs]
        print(f"B window (jobs in turn, rate control deferred): wall "
              f"{wall:.3f} s for its {len(jobs)} jobs, whose "
              f"_encode_picture times sum to {sum(jobs):.3f} s ("
              + " + ".join(f"{t:.3f}" for t in jobs)
              + f"; wall / sum {wall / sum(jobs):.3f})")
    if len(tiled) != 1 or enc._tiles_mesh.size != TILE_ROWS:
        raise AssertionError("the tile-row analysis did not run once")
    # the same P picture's analysis as one whole-frame call (the options
    # the tiled path takes), on the card, after the encode
    (y, u, v, refs, qp, wp_l0, rect, col, rp_p, poc), got = tiled[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = analyse_p_frame(y, u, v, refs, enc.sps, qp, dev,
                            search_range=enc._me_range, weights=wp_l0,
                            subme=p.subpel_refine, rect=rect, col=col,
                            ref_pocs=rp_p, cur_poc=poc)
    torch.cuda.synchronize()
    t_whole = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip(
        whole[:4] + whole[5:], got))
    P_ANALYSIS_SPANS["13"] = (p_analysis_span(run), t_whole, same)
    return run["counts"]


def print_p_analysis_spans(spans):
    """Phase 13's tiled P analysis span beside the same picture as one
    whole-frame call and beside phase 5's whole-frame P analysis span."""
    span, t_whole, same = spans["13"]
    print(f"tiled P analysis span ({TILE_ROWS} bands, phase 13): {span:.3f}"
          f" s; the same picture as one whole-frame call: {t_whole:.3f} s "
          f"(decisions {'equal' if same else 'differ'}); phase 5's "
          f"whole-frame P analysis span: {spans['5']:.3f} s")


def cli_params(w: int, h: int, n: int, opts, bit_depth: int = 8,
               preset=None, fps: int = 25, csp: int = 1):
    """Parameters built as the CLI builds them for an n-frame y4m at
    `fps` (cli.py: defaults, the y4m's rate, length, chroma format (csp
    2 for C422, 3 for C444) and bit depth, the --preset, --qp 32, CQP,
    then each option through EncoderParams.parse)."""
    from x265_mod_by_patman_tpu_torch.params import default_params
    p = default_params(w, h)
    p.fps_num, p.fps_denom, p.total_frames = fps, 1, n
    if csp != 1:
        p.internal_csp = csp
    if bit_depth > 8:
        p.internal_bit_depth = bit_depth
    if preset:
        p.apply_preset(preset)
    p.qp, p.rc_mode = 32, "cqp"
    for k, v in opts:
        p.parse(k, v or "1")
    return p


# the rate-control agreement cases: (frames, CLI options); the first is
# also run through the CLI on the card
RC_AGREE = ((6, (("crf", "28"), ("aq-mode", "2"), ("rc-lookahead", "4"))),
            (4, (("bitrate", "300"), ("aq-mode", "1"))))
# the Main10 delivery case at 416x240: CRF + AQ 2 + cuTree under a VBV cap
# low enough that the I picture re-encodes, with HRD timing; also run
# through the CLI on a 10-bit y4m on the card
MAIN10_AGREE = (6, (("crf", "28"), ("aq-mode", "2"), ("rc-lookahead", "4"),
                    ("vbv-bufsize", "150"), ("vbv-maxrate", "150"),
                    ("hrd", "")))
# HDR10 signalling (phases 4 and 6)
HDR10_OPTS = (("colorprim", "9"), ("transfer", "16"), ("colormatrix", "9"),
              ("master-display", "G(13250,34500)B(7500,3000)R(34000,16000)"
                                 "WP(15635,16450)L(10000000,1)"),
              ("max-cll", "1000,400"))
# one HDR10+ record in the JSON format the --dhdr10-info option reads
HDR10PLUS_RECORD = {
    "NumberOfWindows": 1,
    "TargetedSystemDisplayMaximumLuminance": 400,
    "LuminanceParameters": {
        "AverageRGB": 1200,
        "MaxScl": [12000, 11000, 9000],
        "LuminanceDistributions": {
            "DistributionIndex": [1, 5, 10, 25, 50, 75, 90, 95, 99],
            "DistributionValues": [10, 300, 900, 2000, 4000, 6000,
                                   8000, 9000, 9900]}},
    "BezierCurveData": {
        "KneePointX": 100, "KneePointY": 200,
        "Anchors": [102, 205, 307, 410, 512, 614, 717, 819, 922]},
}


# phase 4's worker processes: the card side of several cases runs at
# once (each card encode at 416x240 is bound by its one host thread),
# beside as many one-thread CPU-side encodes; with the main process's
# encode and the decode workers they fill the card host's 8 cores
CARD_WORKERS = 3
CPU_WORKERS = 3


def _cpu_worker_init():
    """Phase 4's CPU encoder processes: one thread each, no trace."""
    from x265_mod_by_patman_tpu_torch.utils import trace
    trace._path = None
    torch.set_num_threads(1)


def _card_worker_init():
    """Phase 4's card encoder processes: the kernels built in phase 1,
    one host thread, no trace."""
    from x265_mod_by_patman_tpu_torch.ops.cuda import build
    from x265_mod_by_patman_tpu_torch.utils import trace
    trace._path = None
    torch.set_num_threads(1)
    build.load_library()


class _Pic:
    """What phase 4's checks and the decode workers read of an
    EncodedFrame, as plain host data a worker process can return."""

    def __init__(self, f):
        for k in ("poc", "disp", "slice_type", "qp", "bits", "bitstream",
                  "md5", "stats", "pipeline_runs", "qp_map"):
            setattr(self, k, getattr(f, k))
        self.recon = tuple(np.array(p, copy=True).view(np.ndarray)
                           for p in f.recon)


def _card_encode(params, frames, count_replay=False):
    """One encode on the card (in a card worker process): the stream,
    its pictures, the seconds it took and, with count_replay, the K2
    launches made inside the analysis-load replay's MC."""
    from x265_mod_by_patman_tpu_torch.encoder import top
    from x265_mod_by_patman_tpu_torch.ops import cuda as kernels
    replay = [0]
    mcs = (top.mc_for_p, top.mc_for_b)

    def counted(fn):
        def wrapper(*a, **k):
            before = kernels.counts()["window_gather"]
            got = fn(*a, **k)
            replay[0] += kernels.counts()["window_gather"] - before
            return got
        return wrapper

    if count_replay:
        top.mc_for_p, top.mc_for_b = counted(mcs[0]), counted(mcs[1])
    try:
        t0 = time.perf_counter()
        s, e = encode_closed(params, frames, "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
    finally:
        top.mc_for_p, top.mc_for_b = mcs
    return s, [_Pic(f) for f in e], t, replay[0]


def encode_closed(params, frames, device):
    """encode_sequence, then the encoder's write_stats(), which closes an
    analysis file the encode saved."""
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    enc = Encoder(params, device)
    out = []
    for y, u, v in frames:
        out.extend(enc.encode_frame(y, u, v))
    out.extend(enc.flush())
    enc.write_stats()
    return b"".join(f.bitstream for f in out), out


def _cpu_encode(params, frames):
    """One encode on the CPU (in the worker process): the stream, each
    picture's bytes and the seconds it took."""
    t0 = time.perf_counter()
    s, e = encode_closed(params, frames, "cpu")
    return s, [f.bitstream for f in e], time.perf_counter() - t0


def _decode_worker_init():
    """A decode process: one thread, no trace."""
    from x265_mod_by_patman_tpu_torch.utils import trace
    trace._path = None
    torch.set_num_threads(1)


def _decode_check(what, stream, expected):
    """In a decode process: decode `stream` with the port's decoder;
    every picture must equal the card's recon (expected: (poc, md5, y, u,
    v) per picture) and carry a matching MD5 SEI."""
    from x265_mod_by_patman_tpu_torch.decoder.decoder import Decoder
    t0 = time.perf_counter()
    pics = Decoder().decode(stream)
    if len(pics) != len(expected):
        raise AssertionError(f"{what}: decoded {len(pics)} pictures of "
                             f"{len(expected)}")
    by_poc = {e[0]: e for e in expected}
    # an all-intra stream of IDRs numbers every picture POC 0: take those
    # in decode order
    in_order = len(by_poc) < len(expected)
    for i, pic in enumerate(pics):
        _poc, md5, *planes = expected[i] if in_order else by_poc[pic.poc]
        if not pic.sei_md5 == pic.md5 == md5:
            raise AssertionError(f"{what}: picture {pic.poc} MD5 mismatch")
        for a, b in zip((pic.y, pic.u, pic.v), planes):
            if not np.array_equal(a, b):
                raise AssertionError(f"{what}: picture {pic.poc} differs "
                                     "from the card's recon")
    return (f"decoded on the host: {what}: {len(pics)} pictures equal the "
            f"card's recon, MD5 SEIs match ({time.perf_counter() - t0:.1f}"
            " s)")


# the host decode's worker processes: one stays on phase 7's 2160p stream
# for minutes while the others keep up with the 1080p phases' streams
DECODE_WORKERS = 3


class Decodes:
    """Every stream of the run, decoded with the port's decoder in
    DECODE_WORKERS worker processes on the host while the card runs the
    next phases (a 2160p picture takes over a minute there)."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=DECODE_WORKERS,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_decode_worker_init)
        self.pending = []

    def submit(self, what, stream, frames):
        expected = [(f.poc, f.md5) + tuple(
            np.array(p, copy=True).view(np.ndarray) for p in f.recon)
            for f in frames]
        self.pending.append(self.pool.submit(_decode_check, what, stream,
                                             expected))

    def finish(self):
        t0 = time.perf_counter()
        for fut in self.pending:
            print(fut.result())
        print(f"host decodes: {len(self.pending)} streams; waited "
              f"{time.perf_counter() - t0:.2f} s after the last phase")


DECODES = None          # set by main(): every phase submits its streams


def decode_later(what, out):
    """Queue the stream of `out` (EncodedFrames in decode order)."""
    DECODES.submit(what, b"".join(f.bitstream for f in out), out)


class Pools:
    """Phase 4's worker processes: CARD_WORKERS encoding on the card and
    CPU_WORKERS on the CPU; the case groups of agree_all run in threads
    of the main process that submit to both."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self.card = concurrent.futures.ProcessPoolExecutor(
            max_workers=CARD_WORKERS, mp_context=ctx,
            initializer=_card_worker_init)
        self.cpu = concurrent.futures.ProcessPoolExecutor(
            max_workers=CPU_WORKERS, mp_context=ctx,
            initializer=_cpu_worker_init)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for pool in (self.card, self.cpu):
            pool.shutdown(cancel_futures=True)


def _agree(pools, frames, what, p_gpu, p_cpu, count_replay=False):
    """One phase-4 case: the card's and the CPU's streams must be
    byte-identical.  Returns the card's (stream, pictures), with the
    replay's K2 launches when count_replay."""
    pending = pools.cpu.submit(_cpu_encode, p_cpu, frames)
    s_gpu, e_gpu, t_gpu, replay = pools.card.submit(
        _card_encode, p_gpu, frames, count_replay).result()
    s_cpu, b_cpu, t_cpu = pending.result()
    what += " " + " ".join(f"{f.slice_type}{f.qp}" for f in e_gpu)
    print(f"agree {what}: cuda {len(s_gpu)} B in {t_gpu:.2f} s, "
          f"cpu {len(s_cpu)} B in {t_cpu:.2f} s (in parallel)")
    if s_gpu != s_cpu:
        for i, (a, b) in enumerate(zip(e_gpu, b_cpu)):
            if a.bitstream != b:
                k = next((j for j, (x, y) in enumerate(
                    zip(a.bitstream, b)) if x != y),
                    min(len(a.bitstream), len(b)))
                print(f"first difference: picture {i} "
                      f"({a.slice_type}, display {a.disp}) byte {k}")
                break
        raise AssertionError(f"cuda and cpu streams differ: {what}")
    print(f"cuda and cpu streams are byte-identical: {what}")
    DECODES.submit(what, s_gpu, e_gpu)
    if count_replay:
        return s_gpu, e_gpu, replay
    return s_gpu, e_gpu


def phase_agree(w=416, h=240) -> float:
    """Phase 4; returns its seconds."""
    t0 = time.perf_counter()
    with Pools() as pools:
        agree_all(pools, w, h)
    return time.perf_counter() - t0


def agree_all(pools, w: int, h: int):
    """The same clip on cuda and on cpu must give identical bytes.  Nine
    groups of cases run at once, each in a thread (within a group the
    cases run in turn): agree_rc (CQP, CRF, ABR), agree_deep,
    agree_slow, agree_inter_tools, agree_residual, agree_chroma,
    agree_ladder, agree_batched and agree_parallel."""
    import concurrent.futures
    checks = []
    groups = (agree_rc, agree_deep, agree_slow, agree_inter_tools,
              agree_residual, agree_chroma, agree_ladder, agree_batched,
              agree_parallel)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(groups)) as ex:
            futs = [ex.submit(g, pools, w, h, checks) for g in groups]
            for fut in futs:
                fut.result()
    finally:
        for check in checks:
            check()


def _entry_encode(kind, params, frames, device):
    """One of phase 4's batched and parallel entry points on `device` (in
    a worker process): the streams it gives (one per stream), the
    pictures of each (card side only), its seconds and the kernels'
    launches by shape.  kinds: "intra_batched" (batches of 8),
    "multistream_intra" (frames: per step one frame per stream),
    "multistream" (frames: per stream its frames), "single" (frames: per
    stream its frames, each encoded alone), "gop" (chunks of 4) and
    "elastic" (chunks of 4, two workers, the first dispatch of a later
    chunk preempted); and "sharded_step" (parallel/mesh.py's step on a
    4-shard mesh: its modes, levels and two totals in place of
    streams)."""
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    from x265_mod_by_patman_tpu_torch.ops import cuda as kernels
    from x265_mod_by_patman_tpu_torch.parallel import (elastic, gop, mesh,
                                                       streams)
    kernels.reset_counts()
    t0 = time.perf_counter()
    if kind == "sharded_step":
        # params: the QP; frames: (B, H, W) luma on a 4-shard mesh
        step = mesh.sharded_encode_step(mesh.make_mesh(4, "gop", device),
                                        params)
        got = [a.cpu().numpy() for a in step(torch.from_numpy(frames))]
        return [a.tobytes() for a in got], None, \
            time.perf_counter() - t0, kernels.counts_by_shape()
    if kind == "intra_batched":
        outs = [Encoder(params, device).encode_intra_batched(frames,
                                                             batch=8)]
    elif kind == "multistream_intra":
        ms = streams.MultiStreamIntraEncoder(params, len(frames[0]),
                                             device=device)
        steps = [ms.encode_step(fr) for fr in frames]
        outs = [[st[i] for st in steps] for i in range(len(frames[0]))]
    elif kind == "multistream":
        ms = streams.MultiStreamEncoder(params, len(frames), device=device)
        outs = [[] for _ in frames]
        for t in range(len(frames[0])):
            for i, o in enumerate(ms.encode_step([f[t] for f in frames])):
                outs[i].extend(o)
        for i, o in enumerate(ms.flush()):
            outs[i].extend(o)
    elif kind == "single":
        outs = [encode_closed(params, f, device)[1] for f in frames]
    elif kind == "gop":
        outs = [gop.encode_gop_parallel(params, frames, 4, device)[1]]
    else:
        failed = []

        def preempted(p, chunk, first):
            if not first and not failed:
                failed.append(1)
                raise elastic.WorkerFailure("worker preempted (injected)")
            return elastic.default_worker(p, chunk, first, device)

        data, report = elastic.ElasticGopEncoder(
            params, chunk_len=4, workers=2, max_retries=2,
            worker_fn=preempted).encode(frames)
        if sum(report["retries"].values()) != 1:
            raise AssertionError(f"elastic: retries {report['retries']}")
        return [data], None, time.perf_counter() - t0, \
            kernels.counts_by_shape()
    if device != "cpu":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pics = [[_Pic(f) for f in o] for o in outs] if device != "cpu" else None
    return ([b"".join(f.bitstream for f in o) for o in outs], pics, secs,
            kernels.counts_by_shape())


def _agree_entry(pools, kind, params, frames, what):
    """Card against CPU for one entry point: byte-identical streams.
    Returns the card's streams, pictures and launches by shape."""
    pending = pools.cpu.submit(_entry_encode, kind, params, frames, "cpu")
    s_gpu, pics, t_gpu, by_shape = pools.card.submit(
        _entry_encode, kind, params, frames, "cuda").result()
    s_cpu, _p, t_cpu, _b = pending.result()
    print(f"agree {what}: cuda {sum(map(len, s_gpu))} B in {t_gpu:.2f} s, "
          f"cpu {sum(map(len, s_cpu))} B in {t_cpu:.2f} s")
    if s_gpu != s_cpu:
        raise AssertionError(f"cuda and cpu streams differ: {what}")
    print(f"cuda and cpu streams are byte-identical: {what}")
    return s_gpu, pics, by_shape, t_gpu


def agree_batched(pools, w: int, h: int, checks):
    """The batched all-intra path and the stream- and GOP-level entry
    points, card against CPU: bench.py's own point (416x240, QP 32,
    keyint 1, CTU 32, rd 2, SAO off) over 16 frames in batches of 8;
    MultiStreamIntraEncoder with 4 streams x 2 steps, equal to the four
    streams encoded one by one; MultiStreamEncoder with 2 streams of 3
    frames at the repo defaults, equal to the two encoded alone;
    encode_gop_parallel on 8 frames in chunks of 4, and
    ElasticGopEncoder with one injected WorkerFailure equal to it."""
    from x265_mod_by_patman_tpu_torch.params import default_params
    bench = default_params(w, h, **BENCH_KW)
    frames = park_frames(w, h, 16)
    s, pics, _b, t = _agree_entry(pools, "intra_batched", bench, frames,
                                  f"{w}x{h} x16 encode_intra_batched(8)")
    print(f"bench.py's point on the card (information): {16 / t:.2f} fps "
          f"over the 16 frames, the first batch's warm-up included")
    DECODES.submit("bench point, encode_intra_batched", s[0], pics[0])
    per_stream = [park_frames(w, h, 2 + i)[i:] for i in range(4)]
    steps = [[ps[t] for ps in per_stream] for t in range(2)]
    s_ms, pics, _b, _t = _agree_entry(pools, "multistream_intra", bench,
                                      steps, f"{w}x{h} 4 streams x 2 "
                                      "MultiStreamIntraEncoder")
    single = pools.card.submit(_entry_encode, "single", bench, per_stream,
                               "cuda").result()[0]
    if s_ms != single:
        raise AssertionError("MultiStreamIntraEncoder differs from the "
                             "streams encoded one by one")
    print("MultiStreamIntraEncoder equals the 4 streams encoded one by one")
    for i in range(4):
        DECODES.submit(f"multistream intra stream {i}", s_ms[i], pics[i])
    dflt = default_params(w, h)
    two = [park_frames(w, h, 3 + 2 * i)[2 * i:] for i in range(2)]
    s_m, pics, by_shape, _t = _agree_entry(pools, "multistream", dflt, two,
                                           f"{w}x{h} 2 streams x 3 "
                                           "MultiStreamEncoder")
    print("MultiStreamEncoder " + shapes_line(by_shape))
    alone = pools.card.submit(_entry_encode, "single", dflt, two,
                              "cuda").result()[0]
    if s_m != alone:
        raise AssertionError("MultiStreamEncoder differs from the streams "
                             "encoded alone")
    print("MultiStreamEncoder equals the 2 streams encoded alone")
    for i in range(2):
        DECODES.submit(f"multistream stream {i}", s_m[i], pics[i])
    gop_p = default_params(w, h, bframes=2)
    frames = park_frames(w, h, 8)
    s_g, pics, _b, _t = _agree_entry(pools, "gop", gop_p, frames,
                                     f"{w}x{h} x8 encode_gop_parallel(4)")
    DECODES.submit("encode_gop_parallel", s_g[0], pics[0])
    s_e = pools.card.submit(_entry_encode, "elastic", gop_p, frames,
                            "cuda").result()[0]
    if s_e != s_g:
        raise AssertionError("ElasticGopEncoder differs from the chunked "
                             "stream")
    print("ElasticGopEncoder (one preempted dispatch, retried) equals the "
          "chunked stream")


def agree_parallel(pools, w: int, h: int, checks):
    """Frame-parallel B under CRF, the tile-row analysis and the mesh's
    sharded step, card against CPU: CRF 28 + AQ 2 + cuTree with
    --bframes 3 (pyramid) and --frame-threads 3 (8 frames); CQP I P P with rect at mesh_tile_rows 4;
    sharded_encode_step on a 4-shard mesh over 4 frames (modes, levels
    and totals)."""
    from x265_mod_by_patman_tpu_torch.params import default_params
    opts = PARALLEL_AGREE_OPTS
    frames = park_frames(w, h, 8)
    _s, e = _agree(pools, frames, f"{w}x{h} x8 " + " ".join(
        f"--{k} {v}" for k, v in opts), cli_params(w, h, 8, opts),
        cli_params(w, h, 8, opts))
    if sum(f.slice_type == "B" for f in e) < 3:
        raise AssertionError("no frame-parallel window: too few B")
    tiles = default_params(w, h, bframes=0, rect=True,
                           mesh_tile_rows=TILE_ROWS)
    _agree(pools, park_frames(w, h, 3), f"{w}x{h} x3 CQP rect "
           f"mesh_tile_rows {TILE_ROWS}", tiles, tiles)
    luma = np.stack([f[0] for f in park_frames(w, h, 4)]).astype(np.int32)
    got, _p, by_shape, _t = _agree_entry(
        pools, "sharded_step", 32, luma,
        f"{w}x{h} x4 sharded_encode_step, 4 shards")
    print("sharded_encode_step totals: SATD "
          f"{int(np.frombuffer(got[2], np.int32)[0])}, non-zero levels "
          f"{int(np.frombuffer(got[3], np.int32)[0])}")


def agree_rc(pools, w: int, h: int, checks):
    """CQP (I P P, and the repo defaults), CRF with AQ 2 and cuTree, ABR
    with AQ 1.  The CRF case is also run through the CLI in a
    subprocess on the card, whose .hevc must equal the card's bytes."""
    from x265_mod_by_patman_tpu_torch.params import default_params
    for n, kw in ((3, dict(bframes=0)), (5, {})):
        frames = park_frames(w, h, n)
        _s, e = _agree(pools, frames, f"{w}x{h} x{n} CQP",
                       default_params(w, h, **kw), default_params(w, h, **kw))
        if not kw:
            # the B pyramid (phase 3 runs only I P)
            check_minigops(e)
    streams = []
    for n, opts in RC_AGREE:
        frames = park_frames(w, h, n)
        s, e = _agree(pools, frames, f"{w}x{h} x{n} " + " ".join(
            f"--{k} {v}" for k, v in opts), cli_params(w, h, n, opts),
            cli_params(w, h, n, opts))
        if not any(f.slice_type == "B" for f in e):
            raise AssertionError("no B picture under rate control")
        streams.append((frames, s))
    (n, opts), (frames, s_gpu) = RC_AGREE[0], streams[0]
    checks.append(cli_on_card(frames, opts, s_gpu, f"smoke_{w}x{h}"))


def cli_on_card(frames, opts, s_gpu, name: str, bit_depth: int = 8,
                preset=None, csp: str = "420"):
    """Write `frames` as a y4m (chroma format `csp`: "420", "422" or
    "444") under build/ and start the port's CLI on it
    (with `--preset preset` when given) in a subprocess on the card,
    which runs beside the phase's next cases.  Returns the check to call
    later: it waits for the CLI, whose .hevc must equal `s_gpu`."""
    n = len(frames)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, f"{name}.y4m")
    dst = os.path.join(build, f"{name}_cli.hevc")
    write_y4m(src, frames, bit_depth, csp)
    cmd = [sys.executable, "-m", f"{PKG}.cli", "--input", src, "-o", dst,
           "--frames", str(n), "--no-progress"]
    if preset:
        cmd += ["--preset", preset]
    for k, v in opts:
        cmd += [f"--{k}"] + ([v] if v else [])
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("X265TPU_TRACE", None)        # the CLI records no trace
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def check():
        try:
            _out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        print(f"CLI on the card ({' '.join(cmd[1:])}): exit "
              f"{proc.returncode} after {time.perf_counter() - t0:.2f} s "
              f"(beside the cases that followed); "
              f"{err.strip().splitlines()[-1] if err else ''}")
        if proc.returncode != 0:
            raise AssertionError("the CLI failed: " + err[-2000:])
        with open(dst, "rb") as f:
            got = f.read()
        if got != s_gpu:
            raise AssertionError(f"the CLI's .hevc ({len(got)} B) differs "
                                 f"from the in-process cuda bytes "
                                 f"({len(s_gpu)} B)")
        print(f"the CLI's .hevc equals the in-process cuda bytes "
              f"({len(got)} B)")
    return check


def timing_seis(stream: bytes):
    """(initial_cpb_removal_delay, offset) of each buffering-period SEI
    and (au_cpb_removal_delay_minus1, pic_dpb_output_delay) of each
    picture-timing SEI, in stream order."""
    from x265_mod_by_patman_tpu_torch.bitstream.bitreader import BitReader
    from x265_mod_by_patman_tpu_torch.bitstream.headers import (
        HRD_AU_LEN, HRD_DPB_LEN, HRD_INIT_LEN)
    from x265_mod_by_patman_tpu_torch.bitstream.nal import (
        remove_emulation, split_annexb)
    from x265_mod_by_patman_tpu_torch.bitstream.sei import parse_sei
    bps, pts = [], []
    for u in split_annexb(stream):
        if not u or (u[0] >> 1) & 0x3F != 39:       # prefix SEI
            continue
        for ptype, payload in parse_sei(remove_emulation(u[2:])):
            br = BitReader(payload)
            if ptype == 0:
                br.ue()
                br.flag()
                br.flag()
                br.u(HRD_AU_LEN)
                bps.append((br.u(HRD_INIT_LEN), br.u(HRD_INIT_LEN)))
            elif ptype == 1:
                pts.append((br.u(HRD_AU_LEN), br.u(HRD_DPB_LEN)))
    return bps, pts


def check_hrd(stream: bytes, out, params) -> None:
    """The CPB model of the repo's HRD test on the parsed buffering-
    period / picture-timing values: one buffering period, one picture
    timing per AU, and every AU's last bit arriving (at the signalled
    bit rate) before its removal time."""
    from x265_mod_by_patman_tpu_torch.bitstream.headers import (
        build_sps_info, hrd_signaled)
    bps, pts = timing_seis(stream)
    if len(bps) != 1 or len(pts) != len(out):
        raise AssertionError(f"HRD SEIs: {len(bps)} buffering periods, "
                             f"{len(pts)} picture timings for {len(out)} "
                             "AUs")
    rate, _cpb = hrd_signaled(build_sps_info(params.validate()))
    fps = params.fps_num / params.fps_denom
    arrival, removal_bp, worst = 0.0, bps[0][0] / 90000.0, float("inf")
    for i, f in enumerate(out):
        arrival += f.bits / rate
        removal = removal_bp if i == 0 else removal_bp + (pts[i][0] + 1) / fps
        worst = min(worst, removal - arrival)
        if arrival > removal + 1e-9:
            raise AssertionError(f"CPB underflow at AU {i}: arrival "
                                 f"{arrival:.6f} s > removal {removal:.6f} s")
    print(f"HRD: CPB arrival/removal holds for {len(out)} AUs (least "
          f"slack {worst * 1e3:.3f} ms; signalled {rate} bit/s; initial "
          f"removal delay {bps[0][0]} / 90 kHz)")


def nal_types(stream: bytes):
    from x265_mod_by_patman_tpu_torch.bitstream.nal import split_annexb
    return [(u[0] >> 1) & 0x3F for u in split_annexb(stream) if u]


def hdr_side_files(n: int):
    """An HDR10+ JSON (n records) and a Dolby Vision RPU file (n Annex-B
    UNSPECIFIED(62) NALs) under build/, in the formats --dhdr10-info and
    --dolby-vision-rpu read."""
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    jf = os.path.join(build, "smoke_hdr10plus.json")
    with open(jf, "w") as f:
        json.dump({"SceneInfo": [HDR10PLUS_RECORD] * n}, f)
    rpu = os.path.join(build, "smoke_dovi.rpu")
    with open(rpu, "wb") as f:
        f.write(b"".join(b"\x00\x00\x00\x01\x7c\x01"
                         + bytes([0x10 + i, 0xAA, i]) for i in range(n)))
    return jf, rpu


def agree_deep(pools, w: int, h: int, checks):
    """Phase 4's 10- and 12-bit cases, cuda against cpu: Main10 at the
    repo defaults (CQP, 4 frames) with HDR10 signalling, HDR10+ metadata
    and a Dolby Vision RPU file written under build/; Main10 CRF 28 +
    AQ 2 + cuTree under a 150 kbit / 150 kb/s VBV with HRD (6 frames;
    a picture must re-encode), also through the CLI on a 10-bit y4m;
    and 12-bit I P P."""
    from x265_mod_by_patman_tpu_torch.params import default_params
    n = 4
    jf, rpu = hdr_side_files(n)
    opts = HDR10_OPTS + (("dhdr10-info", jf), ("dolby-vision-rpu", rpu),
                         ("dolby-vision-profile", "8.1"))
    frames = deep_frames(park_frames(w, h, n), 10, 10)
    s, e = _agree(pools, frames, f"{w}x{h} x{n} Main10 CQP, HDR10 + HDR10+ "
                  "+ Dolby Vision RPU", cli_params(w, h, n, opts, 10),
                  cli_params(w, h, n, opts, 10))
    if "B" not in [f.slice_type for f in e]:
        raise AssertionError("the Main10 default encode made no B picture")
    types = nal_types(s)
    print(f"HDR stream: {types.count(62)} RPU NALs, "
          f"{len(timing_seis(s)[1])} picture timings, NAL types {types}")
    if types.count(62) != n:
        raise AssertionError(f"expected {n} RPU NALs, got "
                             f"{types.count(62)}")
    n, opts = MAIN10_AGREE
    frames = deep_frames(park_frames(w, h, n), 10, 10)
    s_vbv, e = _agree(pools, frames, f"{w}x{h} x{n} Main10 " + " ".join(
        f"--{k} {v}" for k, v in opts), cli_params(w, h, n, opts, 10),
        cli_params(w, h, n, opts, 10))
    runs = [f.pipeline_runs for f in e]
    print(f"pipeline runs per picture (Main10 VBV + HRD, decode order): "
          f"{runs}; vbv_fill_pct "
          f"{[f.stats.get('vbv_fill_pct') for f in e]}")
    if max(runs) < 2:
        raise AssertionError("no picture re-encoded under the VBV cap")
    check_hrd(s_vbv, e, cli_params(w, h, n, opts, 10))
    checks.append(cli_on_card(frames, opts, s_vbv,
                              f"smoke_{w}x{h}_main10", 10))
    frames = deep_frames(park_frames(w, h, 3), 12, 12)
    _agree(pools, frames, f"{w}x{h} x3 12-bit I P P",
           default_params(w, h, bframes=0, internal_bit_depth=12),
           default_params(w, h, bframes=0, internal_bit_depth=12))


# BASELINE config 3 at 416x240 (ABR scaled to the size) and the slow
# preset with HME under CRF and a VBV that binds (phase 4)
CONFIG3_AGREE = (4, (("bitrate", "300"), ("rdoq-level", "2"),
                     ("b-pyramid", "")) + HDR10_OPTS, "medium")
SLOW_AGREE = (5, (("hme", ""), ("crf", "24"), ("rc-lookahead", "8"),
                  ("vbv-bufsize", "70"), ("vbv-maxrate", "70")), "slow")


def agree_slow(pools, w: int, h: int, checks):
    """Phase 4's cases of this slice's options, cuda against cpu: BASELINE
    config 3 at 10 bits (--preset medium: sign hiding under RDOQ 2, the
    B pyramid, ABR 300 kb/s, HDR10) and --preset slow --hme under CRF 24
    with a 5-frame VBV that binds (a picture must re-encode); each
    stream must use the tools it names."""
    n, opts, preset = CONFIG3_AGREE
    frames = deep_frames(park_frames(w, h, n), 10, 3)
    p3 = lambda: cli_params(w, h, n, opts, 10, preset=preset)
    if not (p3().validate().sign_hide and p3().rdoq_level == 2):
        raise AssertionError("config 3 lacks sign hiding under RDOQ")
    _s, e = _agree(pools, frames, f"{w}x{h} x{n} Main10 --preset {preset} "
                   + " ".join(f"--{k} {v}" for k, v in opts[:3]) + " HDR10",
                   p3(), p3())
    if "B" not in [f.slice_type for f in e]:
        raise AssertionError("config 3 made no B picture")
    n, opts, preset = SLOW_AGREE
    frames = park_frames(w, h, n)
    ps = lambda: cli_params(w, h, n, opts, preset=preset)
    _s, e = _agree(pools, frames, f"{w}x{h} x{n} --preset {preset} "
                   + " ".join(f"--{k} {v}" for k, v in opts), ps(), ps())
    runs = [f.pipeline_runs for f in e]
    rect = [f.stats.get("cu_rect_pct", 0.0) for f in e]
    print(f"slow preset: pipeline runs {runs}, cu_rect_pct {rect}")
    if max(runs) < 2:
        raise AssertionError("no picture re-encoded under the VBV cap")
    if not any(r > 0 for r in rect):
        raise AssertionError("no rect PU in the slow-preset stream")


def agree_inter_tools(pools, w: int, h: int, checks):
    """Phase 4's cases of this slice's inter tools, cuda against cpu: the
    quarter-strip scene with rect, AMP and 2 B-frames (AMP PUs must occur
    in a P and in a B picture), the park fade under --weightb --me sea,
    and --preset veryslow --crf 24 on park, also through the CLI on the
    card."""
    from x265_mod_by_patman_tpu_torch.params import default_params
    frames = quarter_strip_frames(w, h, 4)
    pq = lambda: default_params(w, h, qp=30, keyframe_max=250, bframes=2,
                                b_adapt=0, rect=True, amp=True, sao=False,
                                scenecut=False, cu_tree=False, aq_mode=0)
    _s, e = _agree(pools, frames, f"{w}x{h} x4 quarter-strip scene, rect + "
                   "AMP, 2 B-frames", pq(), pq())
    amp = {f"{f.slice_type}{f.disp}": f.stats.get("cu_amp_pct", 0.0)
           for f in e if f.slice_type != "I"}
    print(f"AMP share of 16x16 blocks per picture: {amp}")
    for t in ("P", "B"):
        if not any(v > 0 for k, v in amp.items() if k[0] == t):
            raise AssertionError(f"no AMP PU in a {t} picture")
    n = 3
    frames = fade_frames(park_frames(w, h, n))
    _s, e = _agree(pools, frames, f"{w}x{h} x{n} park fade --weightb --me "
                   "sea --no-scenecut", cli_params(w, h, n, WEIGHTB_SEA_OPTS),
                   cli_params(w, h, n, WEIGHTB_SEA_OPTS))
    if "B" not in [f.slice_type for f in e]:
        raise AssertionError("the fade made no B picture")
    frames = park_frames(w, h, n)
    pv = lambda: cli_params(w, h, n, VERYSLOW_OPTS, preset="veryslow")
    s, e = _agree(pools, frames, f"{w}x{h} x{n} --preset veryslow --crf 24",
                  pv(), pv())
    print("veryslow AMP / rect share per picture: " + ", ".join(
        f"{f.slice_type}{f.disp} {f.stats.get('cu_amp_pct', 0.0)} / "
        f"{f.stats.get('cu_rect_pct', 0.0)}" for f in e))
    checks.append(cli_on_card(frames, VERYSLOW_OPTS, s,
                              f"smoke_{w}x{h}_veryslow", preset="veryslow"))


def write_scaling_list_file(path: str) -> str:
    """A custom scaling-list file in the x265/HM format --scaling-list
    <file> reads: every list a ramp 16 + k * (x + y) in raster order,
    k larger for chroma (Cb and Cr share one list) and for inter, DC
    16."""
    names = ("INTRA{}_LUMA", "INTRA{}_CHROMAU", "INTRA{}_CHROMAV",
             "INTER{}_LUMA", "INTER{}_CHROMAU", "INTER{}_CHROMAV")
    with open(path, "w") as f:
        for sid, size in enumerate(("4X4", "8X8", "16X16", "32X32")):
            n = 4 if sid == 0 else 8
            yy, xx = np.mgrid[0:n, 0:n]
            for lid in range(0, 6, 3 if sid == 3 else 1):
                k = 2 + (lid % 3 > 0) + (lid >= 3)
                name = names[lid].format(size)
                f.write(f"{name} =\n" + ",".join(
                    str(int(v)) for v in (16 + k * (xx + yy)).ravel())
                    + "\n")
                if sid >= 2:
                    f.write(f"{name}_DC =\n16\n")
    return path


def agree_residual(pools, w: int, h: int, checks):
    """Phase 4's cases of the residual-side options, cuda against
    cpu, 3 frames each: 9a's options; the CU-tree route with NxN, a
    custom scaling-list file and --rdoq-level 2, saving its analysis;
    that case again loading the card's analysis file (its bytes must
    equal the saving run's); --lossless with B pictures, whose recon
    must equal the source.  The info SEI is off in the save/load cases,
    since it prints the analysis file's path."""
    n = 3
    frames = park_frames(w, h, n)
    _s, e = _agree(pools, frames, f"{w}x{h} x{n} " + " ".join(
        f"--{k} {v}".strip() for k, v in RESIDUAL_OPTS),
        cli_params(w, h, n, RESIDUAL_OPTS), cli_params(w, h, n,
                                                       RESIDUAL_OPTS))
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    lists = write_scaling_list_file(os.path.join(build, "smoke_lists.txt"))
    tree = (("nxn-intra", ""), ("scaling-list", lists),
            ("rdoq-level", "2"), ("info", "0"))
    files = [os.path.join(build, f"smoke_analysis_{d}.bin")
             for d in ("cuda", "cpu")]
    pt = lambda f: cli_params(w, h, n, tree + (("analysis-save", f),))
    s_save, e = _agree(pools, frames, f"{w}x{h} x{n} --nxn-intra "
                       "--scaling-list <file> --rdoq-level 2 "
                       "--analysis-save", pt(files[0]), pt(files[1]))
    if not pt(files[0]).validate().var_cu_tree:
        raise AssertionError("the save case does not take the CU-tree "
                             "route")
    pl = lambda: cli_params(w, h, n, tree + (("analysis-load", files[0]),))
    s_load, _e, replay = _agree(pools, frames, f"{w}x{h} x{n} --nxn-intra "
                                "--scaling-list <file> --rdoq-level 2 "
                                "--analysis-load (the card's file)", pl(),
                                pl(), count_replay=True)
    if s_load != s_save:
        raise AssertionError("the analysis-load stream differs from the "
                             "saving run's")
    print("analysis load reproduces the saving run's bytes "
          f"({len(s_load)} B); the replay's MC launched window_gather "
          f"{replay} times on the card")
    if not replay:
        raise AssertionError("the replay's MC did not run K2 on the card")
    pll = lambda: cli_params(w, h, n, (("lossless", ""), ("bframes", "2"),
                                       ("b-adapt", "0")))
    _s, e = _agree(pools, frames, f"{w}x{h} x{n} --lossless --bframes 2",
                   pll(), pll())
    if "B" not in [f.slice_type for f in e]:
        raise AssertionError("the lossless case made no B picture")
    for f in e:
        for a, b in zip(f.recon, frames[f.disp]):
            if not np.array_equal(np.asarray(a)[:b.shape[0], :b.shape[1]],
                                  b):
                raise AssertionError("lossless recon differs from the "
                                     "source")


# phase 4's 4:2:2 case: Main 4:2:2 10 under CRF 28 + AQ 2 + cuTree
# (rc_lookahead 4, so cuTree pops inside the stream), also through the
# CLI on a C422p10 y4m
CHROMA422_AGREE = (4, (("crf", "28"), ("aq-mode", "2"),
                       ("rc-lookahead", "4")))


def agree_chroma(pools, w: int, h: int, checks):
    """Phase 4's 4:2:2 and 4:4:4 cases, cuda against cpu, 4 frames each:
    4:2:2 at 10 bits under CRF 28 + AQ 2 + cuTree, also through the CLI
    on a C422p10 y4m on the card; 4:4:4 at 8 bits at the repo defaults
    (a B picture must occur)."""
    n, opts = CHROMA422_AGREE
    frames = deep_frames(park_chroma(park_frames(w, h, n), 2, 422), 10, 422)
    pc = lambda: cli_params(w, h, n, opts, 10, csp=2)
    s, e = _agree(pools, frames, f"{w}x{h} x{n} 4:2:2 10-bit " + " ".join(
        f"--{k} {v}" for k, v in opts), pc(), pc())
    if sps_of(s).chroma_format_idc != 2:
        raise AssertionError("the 4:2:2 stream's SPS is not 4:2:2")
    checks.append(cli_on_card(frames, opts, s, f"smoke_{w}x{h}_422p10", 10,
                              csp="422"))
    frames = park_chroma(park_frames(w, h, n), 3, 444)
    p4 = lambda: cli_params(w, h, n, (), csp=3)
    _s, e = _agree(pools, frames, f"{w}x{h} x{n} 4:4:4 8-bit defaults",
                   p4(), p4())
    if "B" not in [f.slice_type for f in e]:
        raise AssertionError("the 4:4:4 default encode made no B picture")


def _ladder_cli(conf: str):
    """In a worker process: the port's CLI on an --abr-ladder config
    (cli.main(["--abr-ladder", conf])), with the kernel counts set to 0
    just before and read just after.  Returns per rung (in the config's
    order) its size, output file, pictures, sources' luma (the rung's
    input before any MCSTF), seconds per picture (the card synchronised
    around each _encode_picture), whether it ran its own cuTree
    lookahead, wrote or read the share, and which pictures took the
    master's offsets; and the run's seconds, launches and launches by
    shape."""
    from x265_mod_by_patman_tpu_torch import cli
    from x265_mod_by_patman_tpu_torch.analysis.cutree_share import \
        CuTreeShareReader
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    from x265_mod_by_patman_tpu_torch.ops import cuda as kernels
    rungs, by_enc, by_reader = [], {}, {}
    orig = (Encoder.__init__, Encoder.encode_frame, Encoder.flush,
            Encoder._encode_picture, CuTreeShareReader.get)
    init, encode_frame, flush, encode_picture, get = orig

    def sync(enc):
        if enc.device.type == "cuda":
            torch.cuda.synchronize()

    def w_init(self, *a, **k):
        init(self, *a, **k)
        r = dict(w=self.p.source_width, h=self.p.source_height,
                 own_cutree=self._cutree is not None,
                 writes=self._ctshare_w is not None,
                 reads=self._ctshare_r is not None, pics=[], srcs=[],
                 secs=[], offsets=[])
        rungs.append(r)
        by_enc[id(self)] = r
        if self._ctshare_r is not None:
            by_reader[id(self._ctshare_r)] = r

    def w_encode_frame(self, y, u, v):
        by_enc[id(self)]["srcs"].append(np.array(y, copy=True))
        out = encode_frame(self, y, u, v)
        by_enc[id(self)]["pics"].extend(_Pic(f) for f in out)
        return out

    def w_flush(self):
        out = flush(self)
        by_enc[id(self)]["pics"].extend(_Pic(f) for f in out)
        return out

    def w_encode_picture(self, *a, **k):
        sync(self)
        t0 = time.perf_counter()
        f = encode_picture(self, *a, **k)
        sync(self)
        by_enc[id(self)]["secs"].append(time.perf_counter() - t0)
        return f

    def w_get(reader, disp, ncy, ncx):
        off = get(reader, disp, ncy, ncx)
        by_reader[id(reader)]["offsets"].append((disp, off is not None))
        return off

    (Encoder.__init__, Encoder.encode_frame, Encoder.flush,
     Encoder._encode_picture, CuTreeShareReader.get) = (
        w_init, w_encode_frame, w_flush, w_encode_picture, w_get)
    try:
        kernels.reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["--abr-ladder", conf])
        total = time.perf_counter() - t0
        counts, by_shape = kernels.counts(), kernels.counts_by_shape()
    finally:
        (Encoder.__init__, Encoder.encode_frame, Encoder.flush,
         Encoder._encode_picture, CuTreeShareReader.get) = orig
    if rc != 0:
        raise AssertionError(f"--abr-ladder {conf}: exit {rc}")
    return dict(rungs=rungs, total=total, counts=counts, by_shape=by_shape)


def ladder_conf(path: str, src: str, rungs, device: str, ring: str,
                extra: str = "") -> list:
    """Write an --abr-ladder config: one line per rung (width, height,
    output, options), rung 0 writing the cuTree share `ring` and the
    others reading it, all on `device`.  Returns the outputs."""
    lines, outs = [], []
    for i, (w, h, out, opts) in enumerate(rungs):
        side = "write" if i == 0 else "read"
        lines.append(f"--input {src} -o {out} --input-res {w}x{h} {opts} "
                     f"--device {device} --no-progress {extra} "
                     f"cutree-share-{side}={ring}")
        outs.append(out)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return outs


def write_y4m(path: str, frames, bit_depth: int = 8,
              csp: str = "420") -> None:
    """`frames` as a 25 fps y4m (chroma format "420", "422" or "444")."""
    from x265_mod_by_patman_tpu_torch.io.y4m import VideoInfo, Y4MWriter
    h, w = frames[0][0].shape
    wr = Y4MWriter(path, VideoInfo(w, h, 25, 1, bit_depth=bit_depth,
                                   total_frames=len(frames), csp=csp))
    for f in frames:
        wr.write(*f)
    wr.close()


# phase 4's ladder: the master's and the slave's size and options
LADDER_AGREE = (10, ((416, 240, "--crf 28 --aq-mode 2 --mcstf"),
                     (208, 120, "--crf 28 --aq-mode 0")))


def agree_ladder(pools, w: int, h: int, checks):
    """Phase 4's ABR ladder through the port's CLI (--abr-ladder), on the
    card and on the CPU in worker processes: park at 416x240, 10 frames
    (MCSTF at strength 1.5 on display 0 and 0.95 on display 8), the
    master under CRF 28 + AQ 2 + --mcstf writing the cuTree share, a
    208x120 slave under CRF 28 reading it.  Each rung's .hevc must be
    byte-identical between cuda and cpu.  Each side has its own ring;
    the info SEI, which would print the ring's name, is off."""
    n, rungs = LADDER_AGREE
    build = os.path.join(ROOT, "build", "ladder_agree")
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, f"park_{w}x{h}.y4m")
    write_y4m(src, park_frames(w, h, n))
    runs = {}
    for device, pool in (("cpu", pools.cpu), ("cuda", pools.card)):
        outs = [(rw, rh, os.path.join(build, f"{device}_{rw}x{rh}.hevc"),
                 opts) for rw, rh, opts in rungs]
        conf = os.path.join(build, f"{device}.conf")
        ladder_conf(conf, src, outs, device,
                    f"x265tpu_smoke_{os.getpid()}_{device}", "--no-info")
        runs[device] = (pool.submit(_ladder_cli, conf), outs)
    got = {d: (fut.result(), outs) for d, (fut, outs) in runs.items()}
    card = got["cuda"][0]
    for i, (rw, rh, _opts) in enumerate(rungs):
        a, b = (open(got[d][1][i][2], "rb").read() for d in ("cuda", "cpu"))
        r = card["rungs"][i]
        what = f"ladder rung {i} {rw}x{rh} x{n} " + " ".join(
            f"{f.slice_type}{f.qp}" for f in r["pics"])
        print(f"agree {what}: cuda {len(a)} B, cpu {len(b)} B (the ladder "
              f"{card['total']:.2f} s on the card, "
              f"{got['cpu'][0]['total']:.2f} s on the CPU, in parallel)")
        if a != b:
            raise AssertionError(f"cuda and cpu streams differ: {what}")
        print(f"cuda and cpu streams are byte-identical: {what}")
        DECODES.submit(what, a, r["pics"])
    slave = card["rungs"][1]
    if slave["own_cutree"] or not slave["reads"]:
        raise AssertionError("the ladder's slave ran its own lookahead")


def phase_ladder_start(ex, w=1920, h=1080, rungs=LADDER_RUNGS):
    """Phase 11: the port's CLI with --abr-ladder on the card, in a card
    worker process (`ex`), beside the in-process phases.  Park at 1080p,
    3 frames, as an 8-bit 4:2:0 y4m under build/; three rungs: 1920x1080
    --crf 24 --aq-mode 2 --mcstf writing the cuTree share, 1280x720
    --crf 26 and 640x360 --crf 28 without AQ reading it (per-CTU QP
    variation in them can only come from the master's offsets).
    Returns the future and the rungs."""
    build = os.path.join(ROOT, "build", "ladder")
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, f"park_{w}x{h}.y4m")
    write_y4m(src, park_frames(w, h, 3))
    rungs = [(w, h, "--crf 24 --aq-mode 2 --mcstf")] + [
        (rw, rh, f"--crf {c} --aq-mode 0")
        for (rw, rh), c in zip(rungs, (26, 28))]
    outs = [(rw, rh, os.path.join(build, f"rung_{rw}x{rh}.hevc"), opts)
            for rw, rh, opts in rungs]
    conf = os.path.join(build, "ladder.conf")
    ladder_conf(conf, src, outs, "cuda", f"x265tpu_smoke_{os.getpid()}")
    with open(conf) as f:
        print("phase 11 --abr-ladder config:\n" + f.read().rstrip())
    return ex.submit(_ladder_cli, conf), outs, (h & ~15, w & ~15)


def phase_ladder_finish(fut, outs, mc_hw):
    """Phase 11's checks once its worker is done: each rung's stream is
    queued for the host decode (MD5 SEIs, the card's recon), its SPS
    has the rung's size, the slaves ran no cuTree lookahead, the first
    slave took the master's offsets on every picture and its per-CTU
    QPs vary on some picture, the second took none (the reference's
    one-consumer ring), and K1 and K2 ran at MCSTF's shapes.  Prints each
    rung's seconds per picture, fps, bits and PSNR-Y.  Returns the
    launch counts and the launches at MCSTF's shapes."""
    from x265_mod_by_patman_tpu_torch.analysis.mcstf import N, SEARCH
    run = fut.result()
    total = run["total"]
    for i, (r, (w, h, out, opts)) in enumerate(zip(run["rungs"], outs)):
        with open(out, "rb") as f:
            stream = f.read()
        what = f"phase 11, ladder rung {i} {w}x{h} {opts}"
        DECODES.submit(what, stream, r["pics"])
        sps = sps_of(stream)
        cw = sps.width - 2 * (getattr(sps, "conf_win_left", 0)
                              + getattr(sps, "conf_win_right", 0))
        ch = sps.height - 2 * (getattr(sps, "conf_win_top", 0)
                               + getattr(sps, "conf_win_bottom", 0))
        if (cw, ch) != (w, h) or (r["w"], r["h"]) != (w, h):
            raise AssertionError(f"{what}: SPS {cw}x{ch}")
        q = [psnr(r["srcs"][f.disp], f.recon[0][:h, :w]) for f in r["pics"]]
        qm = [np.asarray(f.qp_map) for f in r["pics"]]
        print(f"{what}: decode order " + " ".join(
            f"{f.slice_type}{f.disp}" for f in r["pics"]) + "; seconds "
            "per picture " + ", ".join(f"{f.slice_type}{f.disp} {s:.3f}"
                                       for f, s in zip(r["pics"],
                                                       r["secs"]))
            + f"; fps {len(r['pics']) / total:.3f} over the ladder's "
            f"{total:.2f} s; bits {sum(f.bits for f in r['pics'])} ("
            + ", ".join(str(f.bits) for f in r["pics"]) + "); PSNR-Y "
            + ", ".join(f"{x:.2f}" for x in q) + " dB; per-CTU QP "
            "min/mean/max " + ", ".join(
                f"{m.min()}/{m.mean():.2f}/{m.max()}" for m in qm)
            + f"; SPS {cw}x{ch}; own cuTree lookahead {r['own_cutree']}, "
            f"share writer {r['writes']}, reader {r['reads']}; pictures "
            f"with the master's offsets {sum(o for _, o in r['offsets'])}"
            f" of {len(r['offsets'])}")
        if not all(x > 28.0 for x in q):
            raise AssertionError(f"{what}: recon PSNR {q}")
        if i == 0:
            if not (r["own_cutree"] and r["writes"]):
                raise AssertionError(f"{what}: the master writes no share")
            continue
        if r["own_cutree"] or not r["reads"]:
            raise AssertionError(f"{what}: the slave ran its own lookahead")
        # the share's ring has one consumer, as in the reference (ROADMAP
        # §3): the first slave drains every record, the second gets none
        if [o for _, o in r["offsets"]] != [i == 1] * len(r["pics"]):
            raise AssertionError(f"{what}: the master's offsets reached "
                                 f"{r['offsets']}")
        if i == 1 and not any(m.min() < m.max() for m in qm):
            raise AssertionError(f"{what}: the per-CTU QP map never varied")
    h, w = mc_hw
    k1 = run["by_shape"]["full_search"].get((N, SEARCH, h, w), 0)
    k2 = run["by_shape"]["window_gather"].get((N, h, w), 0)
    print(shapes_line(run["by_shape"]))
    print(f"phase 11 launches: {run['counts']}; at MCSTF's shapes K1 {k1}, "
          f"K2 {k2}")
    if not (k1 and k2):
        raise AssertionError("K1 / K2 never ran at MCSTF's shapes")
    for name, c in run["counts"].items():
        if c <= 0:
            raise AssertionError(f"{name} never launched on the ladder")
    return run["counts"], {"full_search": k1, "window_gather": k2}


def run_phases(dev, rng, cap: str, clock: float):
    """Phases 2-13.  Phase 4 runs in its worker processes, driven from a
    thread, beside phases 7 and 8a: their encode holds one host thread
    and the card is idle most of the time, so the two overlap on the
    8-core host.  Then phase 11, the phase worker (12, 13, 6) and a
    third worker (9a, 5) run so in their own processes beside 10a, 9b,
    10b and 8b.  Returns the
    launch counts per path, the kernels' numbers and SEA's."""
    import concurrent.futures
    t0 = time.perf_counter()
    k1, main_shape, shapes = phase_k1_slow(dev, rng, cap, clock)
    res = {"full_search": phase_k1(dev, rng, cap, clock),
           "window_gather": phase_k2(dev, rng, cap)}
    fs = res["full_search"]
    fs["max_abs_err"] = max(fs["max_abs_err"], k1["max_abs_err"])
    # the line's K1 numbers are this slice's analysis shape (n = 16,
    # r = 32), every shape's beside them
    fs.update(ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
              bound_ms=main_shape["bound_ms"], shape=main_shape["shape"],
              shapes=shapes)
    sea = phase_sea(dev, rng, cap, main_shape["ms"])
    tile_shapes, e1, e2 = phase_k_tiles(dev, rng, cap, clock)
    fs["shapes"].extend(tile_shapes)
    fs["max_abs_err"] = max(fs["max_abs_err"], e1)
    res["window_gather"]["max_abs_err"] = max(
        res["window_gather"]["max_abs_err"], e2)
    mc_k1, mc_k2, e1, e2 = phase_mcstf_kernels(dev, cap, clock)
    fs["shapes"].append(mc_k1)
    fs["max_abs_err"] = max(fs["max_abs_err"], e1)
    wg = res["window_gather"]
    wg["shapes"].append(mc_k2)
    wg["max_abs_err"] = max(wg["max_abs_err"], e2)
    fadd_latency_cycles(FADD_BUILD)
    res["ordered_sum"] = phase_k3(dev, rng, cap, clock)
    print(f"phase 2 kernels: {time.perf_counter() - t0:.2f} s")
    counts = {}
    t0 = time.perf_counter()
    counts["cqp_defaults"] = phase_main(dev)
    print(f"phase 3 main path: {time.perf_counter() - t0:.2f} s")
    t4 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        agree = ex.submit(phase_agree)
        t0 = time.perf_counter()
        counts["uhd_slow"] = phase_uhd(dev)
        print(f"phase 7 UHD slow path: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        counts["veryslow"] = phase_veryslow(dev)
        print(f"phase 8a veryslow path: {time.perf_counter() - t0:.2f} s")
        t_agree = agree.result()
    print(f"phase 4 agreement: {t_agree:.2f} s (beside phases 7 and 8a; "
          f"the three took {time.perf_counter() - t4:.2f} s)")
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    ladder_ex = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=ctx, initializer=_card_worker_init)
    phase_ex = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=ctx, initializer=_phase_worker_init)
    third_ex = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=ctx, initializer=_phase_worker_init,
        initargs=("third",))
    try:
        counts.update(run_beside_ladder(dev, ladder_ex, phase_ex, third_ex,
                                        res))
    finally:
        for ex in (ladder_ex, phase_ex, third_ex):
            ex.shutdown(cancel_futures=True)
    return counts, res, sea


# the phases after phase 4, in four processes that each hold one host
# thread and leave the card mostly idle: phase 11 in its own card worker,
# these two lists in two phase workers (each in turn) and MAIN_PHASES in
# this process, in about equal seconds.  Each phase hands its streams to
# the host decode as it ends, and the phase that ends each list is one
# whose decode is short.  (key in the kernels line's launches_by_path,
# function, label)
WORKER_PHASES = (("intra_batched", "phase_intra_batched",
                  "12 1080p all-intra batched path"),
                 ("frame_parallel_tiles", "phase_parallel",
                  "13 frame-parallel B and tile-row path"),
                 ("main10_vbv_hrd", "phase_main10",
                  "6 Main10 delivery path"))
THIRD_WORKER_PHASES = (("residual", "phase_residual", "9a residual path"),
                       ("crf_aq_cutree", "phase_rc",
                        "5 rate-control path"))
MAIN_PHASES = (("chroma422_10bit", "phase_chroma422", "10a 4:2:2 10-bit"),
               ("lossless", "phase_lossless", "9b lossless"),
               ("chroma444", "phase_chroma444", "10b 4:4:4"),
               ("weightb_sea", "phase_weightb_sea", "8b weightb/SEA"))


class _Queued:
    """In a worker process: the streams a phase queues for the host
    decode, kept as host data and handed to the main process's
    Decodes."""

    def __init__(self):
        self.items = []

    def submit(self, what, stream, frames):
        self.items.append((what, stream, [_Pic(f) for f in frames]))


def _phase_worker_init(name="worker"):
    """A phase worker: the kernels built in phase 1, one host thread,
    trace spans recorded (the phases print them) into its own file."""
    from x265_mod_by_patman_tpu_torch.ops.cuda import build
    from x265_mod_by_patman_tpu_torch.utils import trace
    trace._path = os.path.join(ROOT, "build", f"smoke_trace_{name}.json")
    torch.set_num_threads(1)
    build.load_library()


def _phases_in_worker(phases):
    """In the phase worker: run each phase of `phases` (WORKER_PHASES
    entries) in turn on the card, with its output captured.  Returns per
    phase (key, launch counts, output, seconds), the streams queued for
    the host decode and the K2 launches at the chroma MC windows."""
    import contextlib
    import io
    global DECODES
    DECODES = _Queued()
    dev = torch.device("cuda", 0)
    out = []
    for key, fn, label in phases:
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                counts = globals()[fn](dev)
        except BaseException:
            sys.stderr.write(buf.getvalue())
            raise
        out.append((key, counts, buf.getvalue() + f"phase {label}: "
                    f"{time.perf_counter() - t0:.2f} s (in the phase "
                    "worker)\n"))
    return (out, DECODES.items, dict(K2_CHROMA_LAUNCHES),
            dict(P_ANALYSIS_SPANS))


def _decode_worker_streams(fut):
    """Done-callback of the phase worker: queue its streams for the host
    decode as soon as it ends (its failure is raised where its result is
    read)."""
    if fut.exception() is None:
        for what, stream, pics in fut.result()[1]:
            DECODES.submit(what, stream, pics)


def run_beside_ladder(dev, ladder_ex, phase_ex, third_ex, res):
    """Phase 11 in one card worker process, WORKER_PHASES in a second and
    THIRD_WORKER_PHASES in a third (each in turn, one future per phase so
    that its streams go to the host decode as it ends), beside
    MAIN_PHASES in this process.  Returns the launch counts per path."""
    counts = {}
    t11 = time.perf_counter()
    ladder = phase_ladder_start(ladder_ex)
    workers = []
    for what, ex, phases in (("the phase worker", phase_ex, WORKER_PHASES),
                             ("the third worker", third_ex,
                              THIRD_WORKER_PHASES)):
        futs = [ex.submit(_phases_in_worker, (ph,)) for ph in phases]
        for fut in futs:
            fut.add_done_callback(_decode_worker_streams)
        workers.append((what, futs))

    def ladder_done():
        counts["abr_ladder"], at_mcstf = phase_ladder_finish(*ladder)
        print(f"phase 11 ABR ladder: {time.perf_counter() - t11:.2f} s "
              "with its checks (beside the phase workers and this "
              "process's phases)")
        for name in ("full_search", "window_gather"):
            res[name]["shapes"][-1]["launches"] = at_mcstf[name]

    for key, fn, label in MAIN_PHASES:
        t0 = time.perf_counter()
        counts[key] = globals()[fn](dev)
        print(f"phase {label} path: {time.perf_counter() - t0:.2f} s")
        if "abr_ladder" not in counts and ladder[0].done():
            ladder_done()       # its streams go to the host decode now
    if "abr_ladder" not in counts:
        ladder_done()
    spans = {}
    for what, futs in workers:
        t0 = time.perf_counter()
        done = [fut.result() for fut in futs]
        print(f"{what}'s phases; waited {time.perf_counter() - t0:.2f} s:")
        for out, _decodes, k2, sp in done:
            for key, c, text in out:
                print(text, end="")
                counts[key] = c
            K2_CHROMA_LAUNCHES.update(k2)
            spans.update(sp)
    print_p_analysis_spans(spans)
    for e in res["window_gather"]["shapes"][:-1]:
        e["launches"] = K2_CHROMA_LAUNCHES[e["format"]]
    return counts


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
    global FADD_BUILD
    FADD_BUILD = fadd_build_start()
    build.build(force=True)
    build.load_library()
    FADD_BUILD[0].wait()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
          f"({build.library_path().relative_to(ROOT)}, one nvcc a source, "
          "and the add-latency microbenchmark beside them)")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2026)
    global DECODES
    DECODES = Decodes()
    try:
        counts, res, sea = run_phases(dev, rng, cap, clock)
        DECODES.finish()
    finally:
        DECODES.pool.shutdown(cancel_futures=True)
    src = {"full_search": ("full_search.cu", "x265_mod_by_patman_tpu/ops/"
                           "pallas/sad.py:67"),
           "window_gather": ("window_gather.cu", "x265_mod_by_patman_tpu/"
                             "ops/pallas/gather.py:82"),
           # K3 ports no TPU kernel: it keeps the order of the reference's
           # float32 sums (its lookahead scalars, the region group sums,
           # the batched intra decision's CTU group sums)
           "ordered_sum": ("ordered_sum.cu", "none (no TPU kernel): the "
                           "order of x265_mod_by_patman_tpu/analysis/"
                           "lookahead.py:64-65, analysis/inter_mode.py:890, "
                           "analysis/intra_mode.py:284; lane mode: "
                           "ops/rdoq.py:428")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{cu}",
         "replaces": rep, "launches": counts["residual"][name],
         "launches_by_path": {k: c[name] for k, c in counts.items()},
         **res[name]}
        for name, (cu, rep) in src.items()]}
    print(f"SEA (--me sea; torch ops, no hand kernel) at 1080p n = 16, "
          f"r = 32, k = 64: {sea['ms']:.4f} ms per call against K1's dense "
          f"search {sea['k1_ms']:.4f} ms")
    print(json.dumps(line))
    print(cap)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
