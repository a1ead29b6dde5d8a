"""Where the time of the port's main path goes, on a CUDA card.

    python -m x265_mod_by_patman_tpu_torch.utils.profile \
        [--w 1920 --h 1080 --frames 3] [--out build/profile]

Encodes the `park` clip (tools/make_clips.py) I P P... with bframes=0 on
"cuda" and prints, per frame, the encoder's phase spans (host clock; the
phases end in device->host copies, so they include the device work
queued inside them), then a torch.profiler pass (device activity only)
over the last P frame: device busy time, the device's idle share of the
frame's wall time, the number of kernel launches, and the kernels that
take the most device time.  Writes a JSON summary under --out."""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from collections import defaultdict


def _park(root, w, h, n):
    import numpy as np
    spec = importlib.util.spec_from_file_location(
        "make_clips", os.path.join(root, "tools", "make_clips.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [tuple(p.astype(np.uint8) for p in f)
            for f in mod.make_park(w, h, n)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--w", type=int, default=1920)
    ap.add_argument("--h", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", default="build/profile")
    a = ap.parse_args()
    os.makedirs(a.out, exist_ok=True)
    # phase spans: the encoder's trace scopes record only when this is set
    # before the trace module is imported
    os.environ.setdefault("X265TPU_TRACE",
                          os.path.join(a.out, "spans.json"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from x265_mod_by_patman_tpu_torch.utils import trace
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    from x265_mod_by_patman_tpu_torch.params import default_params
    from x265_mod_by_patman_tpu_torch.utils.device import capability_line
    if not torch.cuda.is_available():
        print("profile: torch.cuda is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    print(f"card: {capability_line()}")
    frames = _park(root, a.w, a.h, a.frames)
    enc = Encoder(default_params(a.w, a.h, bframes=0))    # on the card
    for i, (y, u, v) in enumerate(frames):
        last = i == len(frames) - 1
        n0 = len(trace._events)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if last:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = enc.encode_frame(y, u, v)
                torch.cuda.synchronize()
        else:
            out = enc.encode_frame(y, u, v)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = defaultdict(float)
        for ev in trace._events[n0:]:
            if ev.get("ph") == "X":
                spans[ev["name"]] += ev["dur"] / 1e6
        print(f"frame {i} {out[0].slice_type}: {wall:.3f} s wall; spans "
              + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items()))
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    launches = sum(e.count for e in kern)
    print(f"profiled P frame: wall {wall:.3f} s, device busy {busy:.3f} s, "
          f"device idle share {1 - busy / wall:.3f}, kernel launches "
          f"{launches}")
    kern.sort(key=lambda e: -e.self_device_time_total)
    for e in kern[:15]:
        print(f"  {e.self_device_time_total / 1e3:10.2f} ms {e.count:8d}x "
              f" {e.key[:90]}")
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump({"wall_s": wall, "busy_s": busy, "launches": launches,
                   "top": [(e.key, e.count, e.self_device_time_total)
                           for e in kern[:40]]}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
