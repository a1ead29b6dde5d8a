"""Analysis save/load (port of x265_mod_by_patman_tpu/analysis/reuse.py):
record mode decisions in one encode, replay them in later encodes.

Per-frame intra modes, inter masks, MVs, reference selections and
prediction directions are pickled to a file as numpy arrays, so a file
written by either package loads in the other.  A loading encoder skips
mode decision and motion search and only rebuilds the MC predictions
of the stored decisions (mc_for_p / mc_for_b, one batched gather pass
through K2 on the card).  AnalysisStore and AnalysisLoad are host code
copied unchanged from the reference."""
from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from ..frame.planes import dev_i32
from ..ops.interp import bi_combine, mc_batch, mc_batch_14, wp_apply_batch

MAGIC = "x265-tpu-analysis-v1"


class AnalysisStore:
    def __init__(self, path: str) -> None:
        self._fh = open(path, "wb")
        pickle.dump(MAGIC, self._fh)

    def save(self, disp: int, ftype: str, **arrays) -> None:
        rec = {"disp": disp, "ftype": ftype}
        rec.update({k: np.asarray(v) if v is not None else None
                    for k, v in arrays.items()})
        pickle.dump(rec, self._fh)

    def close(self) -> None:
        self._fh.close()


class AnalysisLoad:
    def __init__(self, path: str) -> None:
        self.records = {}
        with open(path, "rb") as fh:
            assert pickle.load(fh) == MAGIC, "bad analysis file"
            while True:
                try:
                    rec = pickle.load(fh)
                except EOFError:
                    break
                self.records[rec["disp"]] = rec

    def get(self, disp: int, ftype: str) -> Optional[dict]:
        rec = self.records.get(disp)
        if rec is not None and rec["ftype"] == ftype:
            return rec
        return None


def _grid(sps, block: int, device):
    nbx, nby = sps.width // block, sps.height // block
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    t = lambda a: torch.from_numpy(a.ravel().astype(np.int32)).to(device)
    return nby, nbx, t(bxs * block), t(bys * block)


def _flat(a, device):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).ravel()).astype(np.int32)).to(device)


def _sel_ref(preds, rs):
    """Per-block pick among the reference lanes' predictions."""
    sel = preds[0]
    for ridx in range(1, len(preds)):
        sel = torch.where((rs == ridx)[:, None, None], preds[ridx], sel)
    return sel


def mc_for_p(refs, mvs, ref_sel, sps, device, weights=None,
             block: int = 16):
    """Rebuild P MC predictions from stored (mvs, ref_sel): the replay
    side of analyse_p_frame.  Returns (mc_y, mc_u, mc_v) device tensors
    of (nby, nbx, n, n)."""
    bd = sps.bit_depth
    nby, nbx, bx, by = _grid(sps, block, device)
    mvx = _flat(mvs[..., 0], device)
    mvy = _flat(mvs[..., 1], device)
    rs = _flat(ref_sel, device)
    if weights is None:
        weights = [None] * len(refs)
    nc = block // 2
    mc = []
    for pi in range(3):
        sz = block if pi == 0 else nc
        bx_ = bx if pi == 0 else bx // 2
        by_ = by if pi == 0 else by // 2
        preds = []
        for r, wp in zip(refs, weights):
            rp = dev_i32(r[pi], device)
            if pi == 0 and wp is not None:
                p14 = mc_batch_14(rp, bx_, by_, mvx, mvy, sz, pi, bd)
                preds.append(wp_apply_batch(p14, wp[0], wp[1], 6, bd))
            else:
                preds.append(mc_batch(rp, bx_, by_, mvx, mvy, sz, pi, bd))
        mc.append(_sel_ref(preds, rs).reshape(nby, nbx, sz, sz))
    return tuple(mc)


def mc_for_b(refs0, refs1, dirs, mv_l0, mv_l1, sps, device,
             block: int = 16, ref_sel0=None, ref_sel1=None):
    """Rebuild B MC predictions from stored (dirs, mv_l0, mv_l1,
    ref_sel0, ref_sel1).  refs0/refs1: lists of (y, u, v) planes in list
    order.  Returns (mc_y, mc_u, mc_v) device tensors."""
    bd = sps.bit_depth
    nby, nbx, bx, by = _grid(sps, block, device)
    mv0x = _flat(mv_l0[..., 0], device)
    mv0y = _flat(mv_l0[..., 1], device)
    mv1x = _flat(mv_l1[..., 0], device)
    mv1y = _flat(mv_l1[..., 1], device)
    d = _flat(dirs, device)
    rs0 = torch.zeros_like(d) if ref_sel0 is None else _flat(ref_sel0,
                                                             device)
    rs1 = torch.zeros_like(d) if ref_sel1 is None else _flat(ref_sel1,
                                                             device)
    is_bi = (d == 3)[:, None, None]
    use_l0 = ((d == 1) | (d == 3))[:, None, None]
    nc = block // 2
    mc = []
    for pi in range(3):
        sz = block if pi == 0 else nc
        bx_ = bx if pi == 0 else bx // 2
        by_ = by if pi == 0 else by // 2
        p0 = [dev_i32(r[pi], device) for r in refs0]
        p1 = [dev_i32(r[pi], device) for r in refs1]
        u0 = _sel_ref([mc_batch(p, bx_, by_, mv0x, mv0y, sz, pi, bd)
                       for p in p0], rs0)
        u1 = _sel_ref([mc_batch(p, bx_, by_, mv1x, mv1y, sz, pi, bd)
                       for p in p1], rs1)
        b0 = _sel_ref([mc_batch_14(p, bx_, by_, mv0x, mv0y, sz, pi, bd)
                       for p in p0], rs0)
        b1 = _sel_ref([mc_batch_14(p, bx_, by_, mv1x, mv1y, sz, pi, bd)
                       for p in p1], rs1)
        sel = torch.where(is_bi, bi_combine(b0, b1, bd),
                          torch.where(use_l0, u0, u1))
        mc.append(sel.reshape(nby, nbx, sz, sz))
    return tuple(mc)
