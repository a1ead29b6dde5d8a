#!/usr/bin/env python3
"""Time K3's whole calls in two trees on one card, in turns.

    python3 tools/k3_ab.py --base DIR [--out build/k3_ab.json]

DIR holds another checkout of the repository (e.g. the parent commit,
unpacked with `git archive`).  Each turn is a fresh process that imports
the port from one tree, builds its kernels under this checkout's
build/, and calls the front ends the encoder calls,
`ops.numeric.osum(x, dims)` and `ops.numeric.lsum(x)`, at chip_smoke's
K3 call sites (K3_SITES, in the layout each caller hands them, and
K3_LANE_SHAPES), with chip_smoke's timing helpers: the device time of
the whole call (`time_ms`: whatever copy a tree makes before its kernel
is inside it) and one call with its Python wrapper between CUDA events
(`call_ms`).  In the base tree it also times its kernel alone on the
compact terms its wrapper takes (`ordered_sum` on the contiguous (K, M)
terms, `ordered_sum_lanes` on the contiguous (n*n, M) terms: how
PERF.md's K3 rows were timed before the kernel read the callers'
layouts).  Every result is checked against the plain version
(`osum_plain` / `lanes_sum_plain` on the permuted terms) bit for bit.
Turns run base, this tree, this tree, base; both trees must return the
same bits (compared by hash).
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


def _smoke():
    """This checkout's chip_smoke.py (the base tree has its own)."""
    spec = importlib.util.spec_from_file_location(
        "k3_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sites(smoke):
    """(name, terms maker, dims or None for lsum) of every timed site."""
    out = []
    for what, shape, view, dims, _on_path in smoke.K3_SITES:
        def make(rng, dev, shape=shape, view=view):
            x = smoke._k3_terms(rng, shape, dev)
            if view is not None:
                sl, rs = view
                x = (x[sl] if sl is not None else x).reshape(rs)
            return x
        out.append((what, make, dims))
    for n, m, what in smoke.K3_LANE_SHAPES:
        out.append((f"lane mode {what} n={n} M={m}",
                    lambda rng, dev, n=n, m=m: smoke._k3_terms(
                        rng, (m, n, n), dev, (1.0, 1e2, 1e5)), None))
    return out


def worker(tree: str, base: bool) -> dict:
    """One turn: import the port from `tree` and time K3's calls."""
    sys.modules["jax"] = None
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from pathlib import Path
    from x265_mod_by_patman_tpu_torch.ops.cuda import build
    from x265_mod_by_patman_tpu_torch.ops.cuda.ordered_sum import (
        ordered_sum, ordered_sum_lanes)
    from x265_mod_by_patman_tpu_torch.ops.numeric import (
        lanes_sum_plain, lsum, osum, osum_plain)
    smoke = _smoke()
    build.BUILD_ROOT = Path(HERE) / "build" / (
        "k3_ab_base" if base else "torch_kernels")
    build.load_library()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2026)
    rows = []
    for name, make, dims in _sites(smoke):
        x = make(rng, dev)
        if dims is None:
            n = x.shape[-1]
            fn = lambda x=x: lsum(x)
            xt = x.reshape(-1, n * n).T.contiguous()
            ref = lanes_sum_plain(xt, n)
            compact = lambda xt=xt, n=n: ordered_sum_lanes(xt, n)
        else:
            fn = lambda x=x, dims=dims: osum(x, dims)
            xt = smoke._k3_permuted(x, dims).contiguous()
            ref = osum_plain(xt)
            compact = lambda xt=xt: ordered_sum(xt)
        got = fn()
        exact = bool(torch.equal(got.reshape(-1), ref.reshape(-1)))
        row = {"site": name, "ms": smoke.time_ms(fn),
               "call_ms": smoke.call_ms(fn),
               "out": hashlib.sha256(got.cpu().numpy().tobytes())
               .hexdigest()[:16]}
        if base:
            exact = exact and bool(torch.equal(compact(), ref))
            row["compact_ms"] = smoke.time_ms(compact)
        row["exact"] = exact
        rows.append(row)
    return {"tree": tree, "card": torch.cuda.get_device_name(0),
            "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", help="the other tree (e.g. the parent)")
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "k3_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--worker-is-base", action="store_true",
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker, a.worker_is_base)))
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
        is_base = tree == a.base
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", tree]
                             + (["--worker-is-base"] if is_base else []),
                             check=True, stdout=subprocess.PIPE, text=True,
                             cwd=HERE)
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        turn["tree"] = "base" if is_base else "this"
        turns.append(turn)
    names = [r["site"] for r in turns[0]["rows"]]
    bad = [(t_["tree"], r["site"]) for t_ in turns for r in t_["rows"]
           if not r["exact"]]
    for i, name in enumerate(names):
        if len({t_["rows"][i]["out"] for t_ in turns}) != 1:
            bad.append(("trees disagree", name))
    med = lambda who, i, key: statistics.median(
        t_["rows"][i][key] for t_ in turns if t_["tree"] == who)
    summary = {"card": card, "turns": turns, "sites": []}
    for i, name in enumerate(names):
        row = {"site": name, "base_compact_ms": med("base", i, "compact_ms")}
        for key in ("ms", "call_ms"):
            row[f"base_{key}"] = med("base", i, key)
            row[f"this_{key}"] = med("this", i, key)
        summary["sites"].append(row)
        print(f"K3 whole call at {name}: device {row['base_ms']:.4f} -> "
              f"{row['this_ms']:.4f} ms, with its wrapper "
              f"{row['base_call_ms']:.4f} -> {row['this_call_ms']:.4f} ms; "
              f"the base kernel on compact terms "
              f"{row['base_compact_ms']:.4f} ms (base -> this tree, median "
              f"of two turns each; {card})")
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(summary, f, indent=1)
    if bad:
        print(f"K3 results differ: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
