"""VMAF scoring gate (reference ENABLE_LIBVMAF integration,
x265.cpp --vmaf / encoder.cpp x265_calculate_vmafscore).

The reference links libvmaf at build time; here we shell out to a
`vmaf` CLI when one is on PATH, and raise a clear error otherwise —
the scoring contract (aggregate VMAF over source vs recon) matches."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile

import numpy as np


def vmaf_available() -> bool:
    return shutil.which("vmaf") is not None


def _write_y4m(path, frames, w, h, bit_depth=8):
    csp = "420" if bit_depth == 8 else f"420p{bit_depth}"
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C{csp}\n".encode())
        for (y, u, v) in frames:
            f.write(b"FRAME\n")
            for pl in (y, u, v):
                f.write(np.ascontiguousarray(pl).tobytes())


def compute_vmaf(src_frames, rec_frames, width: int, height: int,
                 bit_depth: int = 8) -> float:
    """Aggregate VMAF of recon vs source.  Raises RuntimeError when no
    vmaf binary is available (the analog of the reference being built
    without ENABLE_LIBVMAF)."""
    if not vmaf_available():
        raise RuntimeError(
            "vmaf binary not found on PATH; install libvmaf's CLI "
            "(the reference likewise requires ENABLE_LIBVMAF)")
    with tempfile.TemporaryDirectory() as td:
        ref = os.path.join(td, "ref.y4m")
        dis = os.path.join(td, "dis.y4m")
        outj = os.path.join(td, "o.json")
        _write_y4m(ref, src_frames, width, height, bit_depth)
        _write_y4m(dis, rec_frames, width, height, bit_depth)
        subprocess.run(["vmaf", "-r", ref, "-d", dis, "--json",
                        "-o", outj], check=True, capture_output=True)
        data = json.load(open(outj))
        return float(data["pooled_metrics"]["vmaf"]["mean"])
