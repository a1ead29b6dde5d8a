"""Lowres lookahead store: per-frame half-res luma and 8x8 intra costs
(port of the lowres half of x265_mod_by_patman_tpu/analysis/lookahead.py).

Each display frame is decimated once and its lowres intra costs are
computed once on the device; the slicetype decision reads both, and the
host downloads only the two per-frame scalars (luma mean, intra-cost
sum) and, on request, the small intra block map.

The reference module's cuTree half (CuTreeLookahead, _inter_costs) and
its --hme tier (hme_seeds) are not ported: CQP turns cuTree off and
--hme is rejected by the encoder.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..frame.planes import dev_i32
from ..frame.zscan import s_vector_coords
from ..ops.numeric import fsum
from .intra_mode import _mode_costs

LOG2N = 3                      # 8x8 lowres blocks == 16x16 source pixels
N = 1 << LOG2N
LOOKAHEAD_LAMBDA_X256 = 218    # lambda at the reference X265_LOOKAHEAD_QP
SEARCH_RANGE = 16


def lowres_plane(y: np.ndarray) -> np.ndarray:
    """Half-res luma by 2x2 mean (reference frameInitLowres analog).
    Input is the CTU-padded plane, so the result is a multiple of N."""
    a = np.asarray(y, dtype=np.int32)
    h, w = a.shape
    a = a[: h & ~1, : w & ~1]
    return (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2]
            + a[1::2, 1::2] + 2) >> 2


def _lowres_dev(y: torch.Tensor) -> torch.Tensor:
    """Device-side half-res decimation (same math as lowres_plane)."""
    a = y.to(torch.int32)
    h, w = a.shape
    a = a[: h & ~1, : w & ~1]
    return ((a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2]
             + a[1::2, 1::2] + 2) >> 2).contiguous()


def _lowres_scalars(low: torch.Tensor, intra: torch.Tensor) -> torch.Tensor:
    """[mean(lowres), sum(intra)] in float32 — the two per-frame scalars
    the host decision logic reads (fade DC walk + whole-frame intra
    cost).  The sums run in ops.numeric.fsum's fixed pairwise order, so
    the card and the CPU agree; below 2**24 they are exact in any
    order.  The mean multiplies by the float32 reciprocal of the pixel
    count, as XLA compiles the reference's division by a constant."""
    recip = torch.tensor(np.float32(1.0) / np.float32(low.numel()),
                         device=low.device)
    mean = fsum(low.to(torch.float32), (0, 1)) * recip
    return torch.stack([mean, fsum(intra.to(torch.float32), (0, 1))])


def _raster_avail(h: int, w: int) -> np.ndarray:
    """S-vector availability for raster-scan 8x8 blocks (lookahead
    estimate: everything above, and left within the row, is available)."""
    nby, nbx = h // N, w // N
    masks = np.zeros((nby * nbx, 4 * N + 1), dtype=bool)
    i = 0
    for by in range(nby):
        for bx in range(nbx):
            x0, y0 = bx * N, by * N
            xs, ys = s_vector_coords(x0, y0, N)
            inside = (xs >= 0) & (ys >= 0) & (xs < w) & (ys < h)
            masks[i] = inside & ((ys < y0) | ((xs < x0) & (ys < y0 + N)))
            i += 1
    return masks


def _intra_costs(low, avail, nby: int, nbx: int) -> torch.Tensor:
    """(nby, nbx) int32 best 35-mode SATD of every 8x8 lowres block."""
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    t = lambda a: torch.from_numpy(a.ravel().astype(np.int32)).to(low.device)
    costs = _mode_costs(low, avail, t(bxs), t(bys), LOG2N, 8)
    return costs.amin(1).reshape(nby, nbx)


class LowresStore:
    """Per-display-frame lowres plane + intra-cost store on one device.

    ensure() decimates a frame and sweeps its intra costs once; results
    stay on the device.  The host reads the two per-frame scalars lazily
    (cached).  release() drops every entry below the watermarks of all
    registered consumers."""

    def __init__(self, pad_w: int, pad_h: int, device) -> None:
        self.device = torch.device(device)
        self.w, self.h = pad_w // 2, pad_h // 2
        self.nbx, self.nby = self.w // N, self.h // N
        self._avail = torch.from_numpy(
            _raster_avail(self.h, self.w)).to(self.device)
        self._e: Dict[int, tuple] = {}     # disp -> (low, intra, scal)
        self._host: Dict[int, tuple] = {}  # disp -> (intra_np, dc, isum)
        self._marks: Dict[str, int] = {}   # consumer -> watermark

    def ensure(self, disp: int, y_padded) -> None:
        if disp in self._e:
            return
        low = _lowres_dev(dev_i32(y_padded, self.device))
        intra = _intra_costs(low, self._avail, self.nby, self.nbx)
        self._e[disp] = (low, intra, _lowres_scalars(low, intra))

    def __contains__(self, disp: int) -> bool:
        return disp in self._e

    def low(self, disp: int) -> torch.Tensor:
        return self._e[disp][0]

    def intra_dev(self, disp: int) -> torch.Tensor:
        return self._e[disp][1]

    def _host_vals(self, disp: int):
        got = self._host.get(disp)
        if got is None:
            _low, intra, scal = self._e[disp]
            s = scal.cpu().numpy()
            got = (intra.cpu().numpy(), float(s[0]), float(s[1]))
            self._host[disp] = got
        return got

    def intra_host(self, disp: int) -> np.ndarray:
        return self._host_vals(disp)[0]

    def dc(self, disp: int) -> float:
        return self._host_vals(disp)[1]

    def intra_sum(self, disp: int) -> float:
        return self._host_vals(disp)[2]

    def release(self, consumer: str, before_disp: int) -> None:
        """Consumer is done with every entry below before_disp; entries
        below ALL registered consumers' watermarks are dropped."""
        self._marks[consumer] = max(self._marks.get(consumer, 0),
                                    before_disp)
        cut = min(self._marks.values())
        for d in [d for d in self._e if d < cut]:
            del self._e[d]
            self._host.pop(d, None)

    def register(self, consumer: str) -> None:
        self._marks.setdefault(consumer, 0)
