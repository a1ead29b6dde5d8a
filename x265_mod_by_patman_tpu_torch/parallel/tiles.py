"""CTU tile-row sharded P analysis with halo exchange (port of
x265_mod_by_patman_tpu/parallel/tiles.py).

A frame's P analysis is split over the shards of a mesh by block rows.
Each shard holds its band's rows of the source and reference planes and
HALO_BLOCKS block rows of real neighbour pixels above and below (the
frame's edge bands repeat their edge row), and runs _p_core on that
slab; between candidate rounds the bands trade their boundary rows of
motion.  The reference trades halos and rows over ICI with ppermute; on
one card the bands run as threads of one process that meet at a barrier
at each trade, all on the caller's CUDA stream, so the stream's order
carries the data from one band to the next.

The result equals the reference's tiled analysis, which equals its
whole-frame call only while every read stays inside the 32-pixel halo:
a search of r = 32 (`--me star`) or HME reads further, and the tiled
path then decides on its own.  Its options are its own too: luma-only
weights, no AMP, SEA or HME, rounds (2, 1), no padded reference lanes.
Tiles are 4:2:0 only, as in the reference.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..analysis.inter_mode import (Band, _p_core, lambda_qp,
                                   temporal_merge_field)
from ..frame.planes import dev_i32
from ..frame.zscan import frame_avail_masks
from .mesh import make_mesh

HALO_BLOCKS = 2          # 32 px luma: search 16 + 8-tap margin + slack


class _Exchange:
    """The bands' boundary-row trade: band i posts the first and last row
    of each field and, once every band has posted, reads band i-1's last
    row and band i+1's first row (zeros past the frame's edges)."""

    def __init__(self, nd: int):
        self.barrier = threading.Barrier(nd)
        self.slots = {}
        self.lock = threading.Lock()

    def for_band(self, i: int):
        calls = [0]

        def exchange(fields):
            k = calls[0]
            calls[0] += 1
            with self.lock:
                self.slots[(k, i)] = [(f[:1].clone(), f[-1:].clone())
                                      for f in fields]
            self.barrier.wait()
            with self.lock:
                up = self.slots.get((k, i - 1))
                down = self.slots.get((k, i + 1))
            out = []
            for j, f in enumerate(fields):
                zero = torch.zeros_like(f[:1])
                out.append((up[j][1] if up else zero,
                            down[j][0] if down else zero))
            return out

        return exchange


def _slab(plane, b: int, rows: int, halo: int):
    """Band b's rows of `plane` (rows per band) with `halo` rows above and
    below, the plane's edge rows repeated past its edges."""
    idx = torch.arange(b * rows - halo, (b + 1) * rows + halo,
                       device=plane.device).clamp_(0, plane.shape[0] - 1)
    return plane.index_select(0, idx)


def _pad_rows(a, rows: int):
    a = np.asarray(a)
    if rows == 0:
        return a
    return np.concatenate([a, np.repeat(a[-1:], rows, 0)], 0)


def analyse_p_frame_tiles(y, u, v, refs, sps, qp: int, n_devices: int = 8,
                          search_range: int = 16, block: int = 16,
                          weights=None, subme: int = 2, rect: bool = False,
                          mesh=None, col=None, ref_pocs=None,
                          cur_poc: int = 0, device="cuda"):
    """Tile-row sharded analyse_p_frame (the reference's returns; the mc
    planes stay device tensors).

    Rows are padded by edge replication to n bands of per_band block
    rows, per_band at least HALO_BLOCKS and a multiple of 4 so that the
    32 and 64 motion-homogenisation groups keep the global grid; the
    padded rows' outputs are dropped.  The availability masks and the
    TMVP field keep the frame's own geometry, sharded by rows."""
    if block != 16:
        raise NotImplementedError("only 16x16 analysis blocks are ported")
    if getattr(sps, "chroma_format_idc", 1) != 1:
        raise NotImplementedError("tile-row analysis outside 4:2:0")
    if mesh is None:
        mesh = make_mesh(n_devices, axis="rows", device=device)
    dev = mesh.device
    nd = mesh.size
    bd = sps.bit_depth
    n = block
    if weights is None:
        weights = [None] * len(refs)
    rect_eff = rect and not any(wp is not None for wp in weights)

    h, w = y.shape
    nby, nbx = h // n, w // n
    per_band = max(-(-nby // nd), HALO_BLOCKS)
    per_band = -(-per_band // 4) * 4
    nby_pad = nd * per_band
    pad_rows = (nby_pad - nby) * n

    oy = dev_i32(_pad_rows(y, pad_rows), dev)
    pl = [[dev_i32(_pad_rows(r[i], pad_rows >> (i > 0)), dev) for r in refs]
          for i in range(3)]
    avail = frame_avail_masks(sps.width, sps.height, block,
                              sps.log2_ctu_size, 0)
    avail = _pad_rows(avail, nby_pad - nby)

    lam, _ = lambda_qp(qp)
    lam256 = int(round(lam * 256)) << (bd - 8)
    halo_y = HALO_BLOCKS * n

    tmvp = None
    if col is not None and ref_pocs is not None and ref_pocs[0]:
        low_delay = all(rp <= cur_poc for lst_p in ref_pocs for rp in lst_p)
        tmvp = [_pad_rows(a, nby_pad - nby) for a in temporal_merge_field(
            col, nby, avail.shape[1], n, sps.width, sps.height,
            sps.log2_ctu_size, 0, ref_pocs[0][0], cur_poc, low_delay)]

    ex = _Exchange(nd)
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    outs = [None] * nd
    errs = []

    def run(b: int):
        rows = slice(b * per_band, (b + 1) * per_band)
        slab = lambda p, c: _slab(p, b, (per_band * n) >> c, halo_y >> c)
        try:
            with torch.cuda.stream(stream) if stream is not None \
                    else contextlib.nullcontext():
                outs[b] = _p_core(
                    slab(oy, 0), [slab(p, 0) for p in pl[0]],
                    [slab(p, 1) for p in pl[1]],
                    [slab(p, 1) for p in pl[2]], weights,
                    [None] * len(refs),
                    torch.from_numpy(np.ascontiguousarray(
                        avail[rows].reshape(-1, avail.shape[-1]))).to(dev),
                    lam256, qp, search_range, n, bd, sps.log2_ctu_size,
                    subme, None if tmvp is None else
                    tuple(a[rows] for a in tmvp), len(refs), (2, 1), rect_eff,
                    band=Band(b, nby_pad, HALO_BLOCKS, ex.for_band(b)))
        except BaseException as e:       # release the other bands
            errs.append(e)
            ex.barrier.abort()

    threads = [threading.Thread(target=run, args=(b,), daemon=True)
               for b in range(nd)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errs:
        raise next((e for e in errs
                    if not isinstance(e, threading.BrokenBarrierError)),
                   errs[0])
    cat = [torch.cat([o[k] for o in outs], 0)[:nby] for k in range(9)]
    modes, inter, mvs, rsel, mcy, mcu, mcv, part, mvs_b = cat
    h_ = lambda a: a.cpu().numpy()
    return (h_(modes), h_(inter), h_(mvs), h_(rsel), (mcy, mcu, mcv),
            h_(part), h_(mvs_b))

