"""Block cost metrics: SAD, SATD, SA8D, SSE, variance, psy energy
(port of x265_mod_by_patman_tpu/ops/cost.py); (..., H, W) int inputs,
int32 outputs."""
from __future__ import annotations

import functools

import numpy as np
import torch

from .numeric import fsqrt, ieinsum

I32 = torch.int32


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


H4 = _hadamard(4)
H8 = _hadamard(8)


@functools.lru_cache(maxsize=None)
def _hmat(n: int, device) -> torch.Tensor:
    return torch.from_numpy(_hadamard(n)).to(device)


def _tiles(d, t: int):
    *lead, h, w = d.shape
    return d.reshape(*lead, h // t, t, w // t, t).movedim(-3, -2)


def _had(t, n: int):
    hm = _hmat(n, t.device)
    return ieinsum("ij,...jk,kl->...il", hm, t, hm)


def sad_batch(a, b):
    d = torch.abs(a.to(I32) - b.to(I32))
    return d.sum((-2, -1), dtype=I32)


def sse_batch(a, b):
    d = a.to(I32) - b.to(I32)
    return (d * d).sum((-2, -1), dtype=I32)


def satd_batch(a, b):
    """SATD over 4x4 Hadamard tiles (x265 scale: (sum + 1) >> 1 per tile)."""
    d = a.to(I32) - b.to(I32)
    ht = _had(_tiles(d, 4), 4)
    tile = (torch.abs(ht).sum((-2, -1), dtype=I32) + 1) >> 1
    return tile.sum((-2, -1), dtype=I32)


def sa8d_batch(a, b):
    d = a.to(I32) - b.to(I32)
    ht = _had(_tiles(d, 8), 8)
    tile = (torch.abs(ht).sum((-2, -1), dtype=I32) + 2) >> 2
    return tile.sum((-2, -1), dtype=I32)


def variance_batch(a):
    x = a.to(I32)
    n = x.shape[-1] * x.shape[-2]
    s = x.sum((-2, -1), dtype=I32)
    ss = (x * x).sum((-2, -1), dtype=I32)
    return ss - (s * s) // n


def _tile_energy(x):
    *lead, h, w = x.shape
    x = x.to(I32)
    if h >= 8 and w >= 8:
        t = _tiles(x, 8)
        sa = (torch.abs(_had(t, 8)).sum((-2, -1), dtype=I32) + 2) >> 2
    else:
        t = _tiles(x, 4)
        sa = (torch.abs(_had(t, 4)).sum((-2, -1), dtype=I32) + 1) >> 1
    dc = t.sum((-2, -1), dtype=I32) >> 2
    return sa - dc


def psy_cost_batch(a, b):
    """Summed per-tile |AC energy(a) - AC energy(b)| (x265 psyCost_pp)."""
    return torch.abs(_tile_energy(a) - _tile_energy(b)).sum((-2, -1),
                                                             dtype=I32)


_SLICE_SCALE = (300.0 / 256.0, 1.0, 96.0 / 256.0)     # B, P, I
# sliceTypeScale * 256 times float32(0.33 / 256), rounded to float32: the
# inter TU32 pre-pass's program folds 0.33 into sliceTypeScale's / 256
_SLICE_SCALE_033 = tuple(float(np.float32(v) * np.float32(0.33 / 256.0))
                         for v in (300.0, 256.0, 96.0))


def psy_weight(lam2, psy256: int, init_type: int, qp, folded: bool = False):
    """float32 psy-rd weight sqrt(lam2) * psyRd * 0.33 * sliceTypeScale *
    rolloff (x265 rdcost.h:57-65, :115) in the order of float32
    operations of the reference's wavefront, or with folded (its inter
    TU32 pre-pass) sqrt(lam2) * psyRd * (sliceTypeScale * 0.33) *
    rolloff, the middle factor one float32 product (_SLICE_SCALE_033)."""
    qpf = qp.to(torch.float32)
    roll = torch.where(qpf >= 40.0,
                       torch.clip((51.0 - qpf) * 23.0 / 256.0, 0.0, 1.0),
                       1.0)
    it = min(max(init_type, 0), 2)
    if folded:
        return fsqrt(lam2) * (psy256 / 256.0) * _SLICE_SCALE_033[it] * roll
    return fsqrt(lam2) * (psy256 / 256.0) * 0.33 * _SLICE_SCALE[it] * roll
