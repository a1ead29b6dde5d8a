"""Polyphase plane resampler (ABR-ladder downscale), port of
x265_mod_by_patman_tpu/utils/scaler.py on a torch device.

Analog of the reference's swscale-derived Scaler (common/scaler.cpp
ScalerFilterManager, driven by the ABR-ladder app's Scaler thread,
abrEncApp.cpp:1034): separable polyphase resampling with a bicubic
kernel, fixed-point 14-bit coefficients, as two matrix products
(H_out x H_in) @ plane @ (W_in x W_out).

The products run in float64: CUDA has no integer matmul, and float64
is exact here, since every product and partial sum is an integer far
below 2^53 (|coefficients| sum to about 1.2 * 2^14, samples are at most
12 bits).  floor((t + 2^13) / 2^14) is the reference's arithmetic shift,
negative intermediates (the kernel's negative lobes) included.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

SHIFT = 14
TAPS = 4


def _bicubic(x: float, a: float = -0.6) -> float:
    x = abs(x)
    if x < 1.0:
        return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
    if x < 2.0:
        return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
    return 0.0


@functools.lru_cache(maxsize=None)
def _filter_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) int32 polyphase matrix, rows sum to 1<<SHIFT."""
    m = np.zeros((n_out, n_in), np.int64)
    scale = n_in / n_out
    support = max(1.0, scale)             # widen kernel when downscaling
    for o in range(n_out):
        center = (o + 0.5) * scale - 0.5
        lo = int(np.floor(center - 2 * support)) + 1
        hi = int(np.ceil(center + 2 * support))
        xs = np.arange(lo, hi + 1)
        w = np.array([_bicubic((x - center) / support) for x in xs])
        w = w / w.sum()
        wq = np.rint(w * (1 << SHIFT)).astype(np.int64)
        wq[len(wq) // 2] += (1 << SHIFT) - wq.sum()    # exact row sum
        for x, q in zip(xs, wq):
            m[o, min(max(x, 0), n_in - 1)] += q
    return m.astype(np.int32)


def _rshift(t: torch.Tensor) -> torch.Tensor:
    """(t + 2^(SHIFT-1)) >> SHIFT on integer-valued float64."""
    return torch.floor((t + float(1 << (SHIFT - 1))) / float(1 << SHIFT))


@functools.lru_cache(maxsize=None)
def _filters(h_in: int, w_in: int, h_out: int, w_out: int, device):
    """The vertical (H_out x H_in) and horizontal (W_in x W_out) float64
    matrices on `device`, uploaded once per geometry (as the
    reference's jitted scaler holds them as constants)."""
    f64 = dict(dtype=torch.float64, device=device)
    return (torch.as_tensor(_filter_matrix(h_in, h_out), **f64),
            torch.as_tensor(_filter_matrix(w_in, w_out).T, **f64))


def scale_plane_tensor(plane: torch.Tensor, w_out: int, h_out: int,
                       bit_depth: int = 8) -> torch.Tensor:
    """(h_in, w_in) integer plane on a device -> (h_out, w_out) int32
    on that device: vertical pass, round, horizontal pass, round,
    clip to [0, 2^bit_depth - 1]."""
    h_in, w_in = plane.shape
    fv, fh = _filters(h_in, w_in, h_out, w_out, plane.device)
    t = _rshift(fv @ plane.to(torch.float64))               # vertical
    t = _rshift(t @ fh)                                     # horizontal
    return torch.clip(t, 0, (1 << bit_depth) - 1).to(torch.int32)


def scale_plane(plane: np.ndarray, w_out: int, h_out: int,
                bit_depth: int = 8, device="cuda") -> np.ndarray:
    h_in, w_in = plane.shape
    if (h_in, w_in) == (h_out, w_out):
        return np.asarray(plane)
    src = torch.from_numpy(np.ascontiguousarray(plane, np.int32)) \
        .to(device)
    dt = np.uint8 if bit_depth <= 8 else np.uint16
    return scale_plane_tensor(src, w_out, h_out, bit_depth).cpu().numpy() \
        .astype(dt)


def scale_frame(frame, w_out: int, h_out: int, bit_depth: int = 8,
                device="cuda"):
    """(y, u, v) 4:2:0 frame -> new resolution; raises on chroma planes
    that are not half the luma in both dimensions (the reference scales
    them to 4:2:0 shapes all the same)."""
    y, u, v = frame
    if any(c.shape != (y.shape[0] // 2, y.shape[1] // 2) for c in (u, v)):
        raise NotImplementedError(
            "scale_frame: the scaler takes 4:2:0 frames only")
    return (scale_plane(y, w_out, h_out, bit_depth, device),
            scale_plane(u, w_out // 2, h_out // 2, bit_depth, device),
            scale_plane(v, w_out // 2, h_out // 2, bit_depth, device))
