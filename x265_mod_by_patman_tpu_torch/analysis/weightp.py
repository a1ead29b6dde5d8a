"""Weighted-prediction analysis (reference weightPrediction.cpp
weightAnalyse:222): frame-level luma (weight, offset) fit per reference,
enabled only when it measurably lowers the lowres SAD.

TPU note: the fit is two moments over 1/8-res planes (host numpy); the
exact spec weighting (8.5.4.3.2) is applied on the 14-bit interpolated
prediction in the MC path (ops.interp.wp_apply_*), while ME runs on a
pixel-domain pre-weighted reference (analysis-only approximation,
mirroring the reference's lowres weight trial).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..rc.ratecontrol import _lowres8

LUMA_DENOM = 6                 # reference default log2 luma weight denom


def analyse_weightp(cur_y: np.ndarray, ref_y: np.ndarray,
                    denom: int = LUMA_DENOM
                    ) -> Optional[Tuple[int, int]]:
    """Returns (weight, offset) in 1<<denom scale, or None when weighting
    does not help (reference requires a clear SAD win before enabling).

    The planes are globally aligned on the lowres grid first (the cheap
    analog of the reference weighting the lookahead-MC'd reference,
    weightPrediction.cpp:222 mcWeight): without alignment, a pure pan
    decorrelates the planes and fabricates a bogus weight, which both
    hurts quality and needlessly forces the weighted (rect/AMP-free)
    analysis path."""
    a = _lowres8(cur_y).astype(np.float64)
    b = _lowres8(ref_y).astype(np.float64)
    r = 4
    h8, w8 = a.shape
    if h8 > 2 * r + 2 and w8 > 2 * r + 2:
        best = None
        ac = a[r:-r, r:-r]
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                bc = b[r + dy:h8 - r + dy, r + dx:w8 - r + dx]
                s = np.abs(ac - bc).mean()
                if best is None or s < best[0]:
                    best = (s, dy, dx)
        _, dy, dx = best
        a = ac
        b = b[r + dy:h8 - r + dy, r + dx:w8 - r + dx]
    var = b.var()
    if var < 1e-3:
        return None
    # weight guess exactly as the reference (weightPrediction.cpp:274,
    # 301): scale = sqrt(varCur/varRef), offset = meanCur - meanRef *
    # scale, with the mean/scale early-out.  This estimator only
    # responds to real luminance changes (fades), never to motion
    # misalignment — a pan preserves mean and variance.
    w = float(np.sqrt(a.var() / var))
    if abs(a.mean() - b.mean()) < 0.5 and abs(1.0 - w) < 0.01:
        return None
    wq = int(np.clip(round(w * (1 << denom)), -128, 127))
    o = int(np.clip(round(a.mean() - (wq / (1 << denom)) * b.mean()),
                    -128, 127))
    if wq == (1 << denom) and o == 0:
        return None
    sad_plain = np.abs(a - b).mean()
    bw = np.clip((b * wq / (1 << denom)) + o, 0, 255)
    sad_w = np.abs(a - bw).mean()
    if sad_w >= sad_plain * 0.95:       # demand a >=5% improvement
        return None
    return (wq, o)


def weighted_plane(ref: torch.Tensor, w: int, o: int,
                   denom: int = LUMA_DENOM,
                   bit_depth: int = 8) -> torch.Tensor:
    """Pixel-domain weighted reference for motion SEARCH only, on the
    tensor's device (the torch counterpart of the reference's numpy
    weighted_plane and weighted_plane_jnp)."""
    maxv = (1 << bit_depth) - 1
    r = ref.to(torch.int32)
    return torch.clip(((r * w + (1 << (denom - 1))) >> denom) + o,
                      0, maxv).to(torch.int32)


def analyse_weightp_chroma(cur_u: np.ndarray, ref_u: np.ndarray,
                           cur_v: np.ndarray, ref_v: np.ndarray,
                           denom: int = LUMA_DENOM):
    """Chroma (weight, offset) fit per component (reference
    weightAnalyse's chroma planes loop, weightPrediction.cpp:268
    plane 1/2 with the same guessScale estimator).  Returns
    ((w_cb, o_cb), (w_cr, o_cr)) or None when both are identity."""
    out = []
    nontrivial = False
    for cur, ref in ((cur_u, ref_u), (cur_v, ref_v)):
        a = cur.astype(np.float64)
        b = ref.astype(np.float64)
        var = b.var()
        if var < 1e-3:
            # flat plane: offset-only fit (DC shift fades)
            w = 1.0
        else:
            w = float(np.sqrt(a.var() / var))
        if abs(a.mean() - b.mean()) < 0.5 and abs(1.0 - w) < 0.01:
            out.append(((1 << denom), 0))
            continue
        wq = int(np.clip(round(w * (1 << denom)), -128, 127))
        o = int(np.clip(round(a.mean() - (wq / (1 << denom)) * b.mean()),
                        -128, 127))
        if wq == (1 << denom) and o == 0:
            out.append((wq, 0))
            continue
        bw = np.clip((b * wq / (1 << denom)) + o, 0, 255)
        if np.abs(a - bw).mean() >= np.abs(a - b).mean() * 0.95:
            out.append(((1 << denom), 0))
            continue
        out.append((wq, o))
        nontrivial = True
    return tuple(out) if nontrivial else None
