"""Device check and capability report (counterpart of the reference's
utils/device.py).  Nothing here falls back: a CUDA device that is asked
for and missing raises."""
from __future__ import annotations

import subprocess

import torch


def resolve(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and is not
    available (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def capability_line() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them; raises when nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
