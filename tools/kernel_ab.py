#!/usr/bin/env python3
"""Time the port's two hand kernels in two trees on one card, in turns.

    python3 tools/kernel_ab.py --base DIR [--out build/kernel_ab.json]

DIR holds another checkout of the repository (e.g. the parent commit,
unpacked with `git archive`).  Each turn is a fresh process that imports
the port from one tree, builds its kernels and times, at the 1080p main
path's shapes, each call's device time (CUDA-graph replays of 10 calls,
median of 5) and one call with its Python wrapper between CUDA events
(median of 20 after 3 warm-ups):

* K1: `ops.me.full_search_batch` on the card, for B = 8160 blocks of
  16x16 at r = 16 on 1088x1920 park planes with a weighted reference,
  whatever that tree's search is made of (a chain of kernels and torch
  ops, or one fused kernel);
* K2: `ops.cuda.gather.window_gather`, 8160 23x23 windows on a random
  1088x1920 plane, starts up to 80 px outside it.

Turns run base, this tree, this tree, base, so drift of the card shows.
Both trees must return the same outputs (compared by hash).  Prints one
line per turn and writes them all as JSON to --out.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(tree: str) -> dict:
    """One turn: import the port from `tree` and time its kernels."""
    sys.modules["jax"] = None
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from x265_mod_by_patman_tpu_torch.ops.cuda import build
    from x265_mod_by_patman_tpu_torch.ops.cuda.gather import window_gather
    from x265_mod_by_patman_tpu_torch.ops.me import full_search_batch
    build.load_library()
    dev = torch.device("cuda", 0)

    def call_ms(fn, iters=20, warm=3):
        """One call between CUDA events, Python wrapper included."""
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

    def device_ms(fn, per_graph=10, reps=5):
        """Device time per call: CUDA-graph replays of per_graph calls."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
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

    spec = importlib.util.spec_from_file_location(
        "make_clips", os.path.join(HERE, "tools", "make_clips.py"))
    clips = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(clips)
    h, w, n, r, lam = 1088, 1920, 16, 16, 2379     # lambda_x256 at QP 32
    f = clips.make_park(w, 1080, 2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    pad = lambda p: np.pad(p.astype(np.uint8).astype(np.int32),
                           ((0, h - 1080), (0, 0)), mode="edge")
    # the weighted reference of weightp at (58, 9), denominator 6
    ref = t(np.clip(((pad(f[0][0]) * 58 + 32) >> 6) + 9, 0, 255)
            .astype(np.int32))
    orig = t(pad(f[1][0]))
    bys, bxs = np.mgrid[0:h // n, 0:w // n]
    x0 = t((bxs.ravel() * n).astype(np.int32))
    y0 = t((bys.ravel() * n).astype(np.int32))
    zero = torch.zeros_like(x0)
    k1 = lambda: full_search_batch(ref, orig, x0, y0, zero, zero, lam, n, r)
    rng = np.random.default_rng(2026)
    plane = t(rng.integers(0, 256, (h, w), dtype=np.int32))
    nb, size = 8160, 23
    ys = t(rng.integers(-80, h + 80 - size // 2, nb, dtype=np.int32))
    xs = t(rng.integers(-80, w + 80 - size // 2, nb, dtype=np.int32))
    k2 = lambda: window_gather(plane, ys, xs, size)
    return {"tree": tree, "card": torch.cuda.get_device_name(0),
            "k1_ms": device_ms(k1), "k2_ms": device_ms(k2),
            "k1_call_ms": call_ms(k1), "k2_call_ms": call_ms(k2),
            "k1_out": _digest(*k1()), "k2_out": _digest(k2())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", help="the other tree (e.g. the parent)")
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "kernel_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker)))
        return 0
    if not a.base:
        ap.error("--base is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    turns = []
    for tree in (a.base, HERE, HERE, a.base):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", tree], check=True,
                             stdout=subprocess.PIPE, text=True, cwd=HERE)
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        turn["tree"] = "base" if tree == a.base else "this"
        print(json.dumps(turn))
        turns.append(turn)
    for key in ("k1_out", "k2_out"):
        if len({t_[key] for t_ in turns}) != 1:
            raise AssertionError(f"the trees disagree on {key}")
    med = lambda who, key: statistics.median(
        t_[key] for t_ in turns if t_["tree"] == who)
    summary = {"card": card, "turns": turns}
    for key in ("k1_ms", "k2_ms", "k1_call_ms", "k2_call_ms"):
        summary[key.replace("ms", "speedup")] = med("base", key) / med(
            "this", key)
    print("speed-up of this tree over base (median of two turns each): "
          + ", ".join(f"{k} {v:.2f}x" for k, v in summary.items()
                      if k.endswith("speedup")) + f" ({card})")
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
