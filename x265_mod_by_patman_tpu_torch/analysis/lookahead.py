"""Lowres lookahead store and cuTree (port of
x265_mod_by_patman_tpu/analysis/lookahead.py).

Each display frame is decimated once and its lowres intra costs are
computed once on the device; the slicetype decision and cuTree read
both, and the host downloads only the two per-frame scalars (luma mean,
intra-cost sum) and, on request, the small intra block map.

cuTree (CuTreeLookahead) measures each lowres frame against its anchors
on the device (_inter_costs: K1 at n = 8, r = 16, then K2 windows of 8
for the prediction and the source blocks, then SATD), brings the
(cost, mv) maps to the host in one transfer, and propagates there in
float64 numpy; the host half is a copy of the reference's.  The
reference's --hme tier (hme_seeds) is not ported: --hme raises.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional

import numpy as np
import torch

from ..frame.planes import dev_i32
from ..frame.zscan import s_vector_coords
from ..ops.cost import satd_batch
from ..ops.cuda.gather import window_gather
from ..ops.me import _org_blocks, full_search_batch
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


def _inter_costs(low, prev, nby: int, nbx: int):
    """Integer full search vs the previous lowres + SATD at the best MV.
    Returns (satd_cost, mv_x, mv_y) int32 (nby, nbx) on the planes'
    device, MVs in lowres fullpel units."""
    dev = low.device
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    x0 = torch.from_numpy((bxs.ravel() * N).astype(np.int32)).to(dev)
    y0 = torch.from_numpy((bys.ravel() * N).astype(np.int32)).to(dev)
    zero = torch.zeros_like(x0)
    mvx, mvy, _ = full_search_batch(prev, low, x0, y0, zero, zero,
                                    LOOKAHEAD_LAMBDA_X256, N,
                                    SEARCH_RANGE)
    fx, fy = mvx >> 2, mvy >> 2
    # the prediction at the chosen MV, each coordinate clamped to the
    # plane (the reference's prev[clip(gy), clip(gx)])
    pred = window_gather(prev, (y0 + fy).contiguous(),
                         (x0 + fx).contiguous(), N)
    cost = satd_batch(_org_blocks(low, x0, y0, N), pred)
    return (cost.reshape(nby, nbx), fx.reshape(nby, nbx),
            fy.reshape(nby, nbx))


class _Entry:
    __slots__ = ("disp", "store", "_intra", "prop", "costs")

    def __init__(self, disp, store, nby, nbx):
        self.disp = disp
        self.store = store
        self._intra = None             # host copy, downloaded lazily
        self.prop = np.zeros((nby, nbx))
        self.costs = {}                # ref_disp -> (inter, mvx, mvy)

    @property
    def low(self):                     # device lowres plane
        return self.store.low(self.disp)

    @property
    def intra(self) -> np.ndarray:
        if self._intra is None:
            self._intra = self.store.intra_host(self.disp).astype(
                np.float64)
        return self._intra


class CuTreeLookahead:
    """Sliding-window cuTree.  push() lowres-analyses a new display-order
    frame; pop() runs propagation over the buffered window and returns the
    per-CTU QP offset map of the oldest frame.

    Propagation follows the GOP structure (reference
    estimateCUPropagate, slicetype.cpp:3752): anchors every
    (bframes + 1) display frames propagate to the previous anchor; B
    frames measure BOTH their anchors and hand their contribution to
    whichever predicts each block better, processed in reverse coding
    order so a future anchor's received share flows onward.  (The
    anchor cadence is the structural bframes grid — adaptive-GOP /
    scenecut deviations degrade toward the old predecessor-chain
    behavior rather than mis-crediting.)"""

    def __init__(self, pad_w: int, pad_h: int, ctu_size: int,
                 qcomp: float = 0.6, bframes: int = 0,
                 hme: bool = False,
                 store: Optional[LowresStore] = None,
                 device="cuda") -> None:
        if hme:
            raise NotImplementedError("--hme: hierarchical ME is not "
                                      "ported")
        self.store = store if store is not None \
            else LowresStore(pad_w, pad_h, device)
        self.store.register("cutree")
        self.w, self.h = self.store.w, self.store.h
        self.nbx, self.nby = self.store.nbx, self.store.nby
        self.bpc = max(1, ctu_size // (2 * N))   # lowres blocks per CTU
        self.strength = 5.0 * (1.0 - qcomp)      # reference cuTreeStrength
        self.g = max(1, bframes + 1)             # anchor cadence
        self._next_disp = 0
        self.entries: Deque[_Entry] = deque()

    def push(self, y_padded: np.ndarray) -> None:
        self.store.ensure(self._next_disp, y_padded)
        self.entries.append(_Entry(self._next_disp, self.store,
                                   self.nby, self.nbx))
        self._next_disp += 1

    def __len__(self) -> int:
        return len(self.entries)

    def _cost_vs(self, e: _Entry, ref: _Entry):
        """(inter, mvx, mvy) of e measured against ref (cached); the
        three maps come to the host in one transfer."""
        got = e.costs.get(ref.disp)
        if got is None:
            c, fx, fy = torch.stack(_inter_costs(
                e.low, ref.low, self.nby, self.nbx)).cpu().numpy()
            got = (c.astype(np.float64), fx, fy)
            e.costs[ref.disp] = got
        return got

    def _scatter(self, ref: _Entry, amount, mvx, mvy, mask) -> None:
        """Bilinear scatter of `amount` (masked) into ref's block grid
        at the positions e's MVs point at (reference propagateCost)."""
        bys, bxs = np.mgrid[0:self.nby, 0:self.nbx]
        px = bxs * N + mvx                     # lowres pixel coords
        py = bys * N + mvy
        bx0, fx = px >> LOG2N, px & (N - 1)
        by0, fy = py >> LOG2N, py & (N - 1)
        amt = np.where(mask, amount, 0.0)
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = ((fx if dx else N - fx)
                       * (fy if dy else N - fy)) / float(N * N)
                tx = np.clip(bx0 + dx, 0, self.nbx - 1)
                ty = np.clip(by0 + dy, 0, self.nby - 1)
                np.add.at(ref.prop, (ty.ravel(), tx.ravel()),
                          (amt * wgt).ravel())

    def _propagate(self) -> None:
        for e in self.entries:
            e.prop[:] = 0.0
        es = list(self.entries)
        if len(es) < 2:
            return
        by_disp = {e.disp: i for i, e in enumerate(es)}
        g = self.g

        def gop_key(d):
            # the gop an entry belongs to, named by its FUTURE anchor
            # (an anchor closes its own gop)
            return d if d % g == 0 else (d // g) * g + g

        # reverse coding order: newest mini-GOP first, its B frames
        # before its anchor (so an anchor forwards what its Bs gave it)
        order = sorted(
            range(len(es)),
            key=lambda i: (-gop_key(es[i].disp),
                           0 if es[i].disp % g else 1))
        for i in order:
            e = es[i]
            d = e.disp
            a0 = (d - g) if d % g == 0 else (d // g) * g
            a1 = a0 + g
            p0 = es[by_disp[a0]] if a0 in by_disp else None
            if d % g == 0 or a1 not in by_disp or a1 == d:
                # anchor (or tail frame without a future anchor yet):
                # single-ref propagation to the previous anchor
                if p0 is None:
                    continue
                inter, mvx, mvy = self._cost_vs(e, p0)
                intra = np.maximum(e.intra, 1.0)
                inter = np.minimum(inter, e.intra)
                amount = (e.intra + e.prop) * (intra - inter) / intra
                self._scatter(p0, amount, mvx, mvy,
                              np.ones_like(amount, bool))
            else:
                # B: measure both anchors, hand each block's share to
                # the better predictor (the reference splits by list
                # usage; argmin is the uni-list analog)
                p1 = es[by_disp[a1]]
                c0, m0x, m0y = self._cost_vs(e, p0) if p0 is not None \
                    else (None, None, None)
                c1, m1x, m1y = self._cost_vs(e, p1)
                if c0 is None:
                    c0 = np.full_like(c1, np.inf)
                    m0x = m0y = np.zeros_like(m1x)
                inter = np.minimum(np.minimum(c0, c1), e.intra)
                intra = np.maximum(e.intra, 1.0)
                amount = (e.intra + e.prop) * (intra - inter) / intra
                use0 = c0 <= c1
                if p0 is not None:
                    self._scatter(p0, amount, m0x, m0y, use0)
                self._scatter(p1, amount, m1x, m1y, ~use0)

    def pop(self) -> np.ndarray:
        """Per-CTU QP offsets of the oldest frame (ints <= 0), computed
        against the full forward window (reference cuTreeFinish).  B
        frames receive no propagation; their offsets interpolate the
        surrounding anchors' (the x264/x265 non-ref treatment)."""
        self._propagate()
        e = self.entries.popleft()
        ratio = lambda en: (np.maximum(en.intra, 1.0) + en.prop) \
            / np.maximum(en.intra, 1.0)
        if e.disp % self.g == 0:
            r = ratio(e)
            self._last_anchor_ratio = r
        else:
            a1 = (e.disp // self.g) * self.g + self.g
            nxt = next((en for en in self.entries if en.disp == a1),
                       None)
            parts = [p for p in (getattr(self, "_last_anchor_ratio",
                                         None),
                                 ratio(nxt) if nxt is not None
                                 else None) if p is not None]
            r = sum(parts) / len(parts) if parts else ratio(e)
        self.store.release("cutree", e.disp + 1)
        off16 = -self.strength * np.log2(r)
        bpc = self.bpc
        ncy = -(-self.nby // bpc)
        ncx = -(-self.nbx // bpc)
        out = np.zeros((ncy, ncx))
        for cy in range(ncy):
            for cx in range(ncx):
                t = off16[cy * bpc:(cy + 1) * bpc, cx * bpc:(cx + 1) * bpc]
                out[cy, cx] = t.mean()
        return np.clip(np.rint(out), -7, 0).astype(np.int32)
