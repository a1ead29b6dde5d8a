"""Slicetype decision lookahead: lowres (b, p0, p1) cost lattice, the
b-adapt path DP and the cost-ratio scenecut (port of
x265_mod_by_patman_tpu/analysis/slicetype.py).

Per block the lattice takes min(intra, me(p0), me(p1), bi-average), the
reference's lowres model.  The reference evaluates the triples of a
decision round as one vmapped program over a lane count and a plane
stack padded to powers of two, to bound XLA recompiles; padded lanes
recompute lane 0 and are thrown away.  Here the triples run in a loop
and each distinct (b, ref) motion search of a round runs once: K1 (the
integer full search at n = 8, r = 16, around hme_seeds' window
centres under --hme), then the qpel refinement (K2
windows of 17) and the MC (K2 windows of 15) on the lowres planes.  A P
triple (p1 == b) searches p0 only: the reference computes its p1 search
and discards it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.cost import satd_batch
from ..ops.interp import mc_batch
from ..ops.me import _org_blocks, full_search_batch, subpel_refine_batch
from .lookahead import (LOOKAHEAD_LAMBDA_X256, N, SEARCH_RANGE, LowresStore,
                        hme_seeds)


def _lattice_costs(low, intra, triples, nby: int, nbx: int,
                   hme: bool = False):
    """Frame costs of (b, p0, p1) display-index triples.

    low / intra: disp -> (h, w) int32 lowres plane / (nby, nbx) int32
    lowres intra costs, on one device.  A triple with p1 == b is a P
    (list 0 only).  Returns a list of float32-rounded Python floats, the
    block costs summed as integers (exact) and then cast, as the
    reference does."""
    dev = next(iter(low.values())).device
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    x0 = torch.from_numpy((bxs.ravel() * N).astype(np.int32)).to(dev)
    y0 = torch.from_numpy((bys.ravel() * N).astype(np.int32)).to(dev)
    zero = torch.zeros_like(x0)
    orgs: Dict[int, torch.Tensor] = {}
    preds: Dict[Tuple[int, int], tuple] = {}

    def org_of(b):
        if b not in orgs:
            orgs[b] = _org_blocks(low[b], x0, y0, N)
        return orgs[b]

    def me_pred(b, ref):
        # integer full search then qpel refinement: the reference
        # lookahead is qpel-accurate on lowres (lowres.h:74-120
        # lowresQPelCost)
        got = preds.get((b, ref))
        if got is None:
            cur, rp = low[b], low[ref]
            cx = cy = None
            if hme:
                # 1/4-of-lowres HME tier seeds the window centre
                cx, cy = hme_seeds(cur, rp, nby, nbx)
            mvx, mvy, _ = full_search_batch(
                rp, cur, x0, y0, zero, zero, LOOKAHEAD_LAMBDA_X256, N,
                SEARCH_RANGE, center_x=cx, center_y=cy)
            mvx, mvy, cost = subpel_refine_batch(
                rp, cur, x0, y0, mvx, mvy, zero, zero,
                LOOKAHEAD_LAMBDA_X256, N, 8, subme=2, org=org_of(b))
            got = preds[(b, ref)] = (mc_batch(rp, x0, y0, mvx, mvy, N),
                                     cost)
        return got

    sums = []
    for (b, p0, p1) in triples:
        ic = intra[b].reshape(-1)
        pr0, c0 = me_pred(b, p0)
        if p1 != b:
            pr1, c1 = me_pred(b, p1)
            cbi = satd_batch(org_of(b), (pr0 + pr1 + 1) >> 1)
            best = torch.minimum(torch.minimum(c0, c1),
                                 torch.minimum(cbi, ic))
        else:
            best = torch.minimum(c0, ic)
        sums.append(best.sum(dtype=torch.int64))
    host = torch.stack(sums).cpu().numpy() if sums else np.zeros(0)
    return [float(np.float32(s)) for s in host]


class SlicetypeLookahead:
    """Sliding lowres window keyed by display index.

    push() registers a frame's padded luma; decide_gop() returns the
    length k of the next mini-GOP (frames start..start+k-1 are B,
    frame start+k-1 is the P anchor) using the b-adapt DP; scenecut()
    applies the reference's intra/inter cost ratio test."""

    def __init__(self, pad_w: int, pad_h: int, bframes: int,
                 b_adapt: int = 1, scenecut_bias: float = 0.05,
                 scenecut_threshold: int = 40,
                 b_frame_bias: int = 0, hme: bool = False,
                 store: LowresStore = None, device="cuda") -> None:
        self.hme = bool(hme)
        self.store = store if store is not None \
            else LowresStore(pad_w, pad_h, device)
        self.store.register("slicetype")
        self.w, self.h = self.store.w, self.store.h
        self.nbx, self.nby = self.store.nbx, self.store.nby
        self.bframes = bframes
        self.b_adapt = b_adapt
        self.b_frame_bias = b_frame_bias
        self.bias = scenecut_bias
        self.thresh = scenecut_threshold / 100.0
        self._have: set = set()        # display indices pushed (window)
        self._cost: Dict[Tuple[int, int, int], float] = {}

    def push(self, disp: int, y_padded) -> None:
        """Register a frame: its lowres decimation and intra sweep are
        queued on the device; the host scalars download on first use."""
        self.store.ensure(disp, y_padded)
        self._have.add(disp)

    def has(self, disp: int) -> bool:
        return disp in self._have

    def fade_state(self, disp: int) -> int:
        """+1 fade-in / -1 fade-out / 0 none, from the lowres luma DC
        trend over the trailing 4 frames (reference x265 --fades
        detection, slicetype.cpp:917 lowres DC walk): a sustained
        monotonic brightness ramp is a fade, not a scene change, so
        scenecut must hold fire until the ramp ends (and weightP picks
        up the luminance shift)."""
        ds = [d for d in (disp - 3, disp - 2, disp - 1, disp)
              if d in self._have]
        if len(ds) < 3:
            return 0
        means = [self.store.dc(d) for d in ds]
        deltas = [b - a for a, b in zip(means, means[1:])]
        if all(d > 0.7 for d in deltas) and means[-1] - means[0] > 3.5:
            return 1
        if all(d < -0.7 for d in deltas) and means[0] - means[-1] > 3.5:
            return -1
        return 0

    def drop_before(self, disp: int) -> None:
        self._have = {d for d in self._have if d >= disp}
        self._cost = {k: v for k, v in self._cost.items()
                      if min(k) >= disp}
        self.store.release("slicetype", disp)

    def intra_cost(self, disp: int) -> float:
        return self.store.intra_sum(disp)

    def _eval_triples(self, triples: List[Tuple[int, int, int]]) -> None:
        """Evaluate the uncached (b, p0, p1) triples (display idx)."""
        todo = [t for t in dict.fromkeys(triples) if t not in self._cost
                and t[0] in self._have and t[1] in self._have
                and t[2] in self._have]
        if not todo:
            return
        keys = {d for tr in todo for d in tr}
        low = {d: self.store.low(d) for d in keys}
        intra = {d: self.store.intra_dev(d) for d in keys}
        costs = _lattice_costs(low, intra, todo, self.nby, self.nbx,
                               self.hme)
        for key, c in zip(todo, costs):
            if key[2] != key[0]:
                # B-frame cost discount before any path/GOP comparison
                # (reference estimateFrameCost, slicetype.cpp:4322:
                # score = score*100/(130+bias) when b != p1)
                c = c * 100.0 / (130.0 + self.b_frame_bias)
            self._cost[key] = c

    def frame_cost(self, b: int, p0: int, p1: int) -> float:
        key = (b, p0, p1)
        if key not in self._cost:
            self._eval_triples([key])
        got = self._cost.get(key)
        if got is None:
            got = self.store.intra_sum(b) if b in self._have else 0.0
        return got

    def gop_cost(self, p0: int, frames: List[int]) -> float:
        """Cost of a mini-GOP: frames[:-1] are B (refs p0/frames[-1]),
        frames[-1] is P (ref p0)."""
        anchor = frames[-1]
        c = self.frame_cost(anchor, p0, anchor)
        for b in frames[:-1]:
            c += self.frame_cost(b, p0, anchor)
        return c

    def decide_gop(self, p0: int, queue: List[int]) -> int:
        """Length of the next mini-GOP covering queue[0:k] given the
        last anchor p0.  b_adapt 0: always the max; 1: single-GOP
        horizon argmin; 2: full-path DP over the queue (slicetypePath
        analog)."""
        maxk = min(len(queue), self.bframes + 1)
        if self.b_adapt == 0 or maxk == 1:
            return maxk
        # prefetch every triple any path can ask for, in one dispatch
        want = []
        horizon = queue if self.b_adapt == 2 else queue[:maxk]
        n = len(horizon)
        starts = [p0] + horizon
        for i in range(n):
            for k in range(1, min(self.bframes + 1, n - i) + 1):
                a = starts[i]          # anchor before frame i
                anchor = horizon[i + k - 1]
                want.append((anchor, a, anchor))
                for j in range(i, i + k - 1):
                    want.append((horizon[j], a, anchor))
        self._eval_triples(want)
        if self.b_adapt == 1:
            best_k, best = 1, float("inf")
            for k in range(1, maxk + 1):
                c = self.gop_cost(p0, queue[:k]) / k
                if c < best:
                    best, best_k = c, k
            return best_k
        # b_adapt 2: DP C[i] = min_k gop(i, k) + C[i+k]
        INF = float("inf")
        C = [0.0] * (n + 1)
        choice = [1] * (n + 1)
        for i in range(n - 1, -1, -1):
            C[i], choice[i] = INF, 1
            a = starts[i]
            for k in range(1, min(self.bframes + 1, n - i) + 1):
                c = self.gop_cost(a, horizon[i:i + k]) + C[i + k]
                if c < C[i]:
                    C[i], choice[i] = c, k
        return choice[0]

    def scenecut(self, b: int, p0: int, dist_to_key: int,
                 min_key: int, max_key: int) -> bool:
        """Reference scenecutInternal (slicetype.cpp:2832): I when the
        P cost is no better than (1 - bias) of the intra cost, the bias
        ramping from threshMin/4 near the last keyframe up to threshMax
        as the frame approaches keyint-max."""
        if b not in self._have or p0 not in self._have:
            return False
        icost = self.intra_cost(b)
        if icost <= 0:
            return False
        pcost = self.frame_cost(b, p0, b)
        thresh_max = self.thresh
        thresh_min = thresh_max * 0.25
        if min_key > 0 and dist_to_key <= min_key / 4:
            bias = thresh_min / 4
        elif min_key > 0 and dist_to_key <= min_key:
            bias = thresh_min * dist_to_key / min_key
        elif max_key > min_key:
            bias = thresh_min + (thresh_max - thresh_min) \
                * (dist_to_key - min_key) / (max_key - min_key)
        else:
            bias = thresh_max
        return pcost >= (1.0 - min(max(bias, 0.0), thresh_max)) * icost
