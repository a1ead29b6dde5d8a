"""Sharded encode steps over a mesh of logical shards on one device
(port of x265_mod_by_patman_tpu/parallel/mesh.py).

The reference maps its parallel strategies onto a jax.sharding device
mesh: axis "gop" shards GOPs or segments, axis "stream" the streams of a
multi-stream encode, axis "rows" a frame's tile rows, and rate-control
statistics cross the shards through psum.  The port runs on one card, so
its mesh is a record of n logical shards of one torch device: a sharded
step runs its shards in turn on that device and sums their statistics
as the psum does.  Integer totals come out the same in any order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.cost import satd_batch
from ..ops.intra import (block_index, gather_ref_samples,
                         intra_pred_all_batch, substitute_filter_batch)
from ..ops.transform import dct_batch, quant_batch
from ..utils.device import resolve

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class Mesh:
    """n logical shards along one named axis, all on `device`."""
    size: int
    axis: str
    device: torch.device


def make_mesh(n_devices: int, axis: str = "gop", device="cuda") -> Mesh:
    """A mesh of n_devices logical shards on one device (the reference
    takes n_devices of jax.devices())."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n_devices}")
    return Mesh(int(n_devices), axis, resolve(device))


def _frame_analysis(y, qp: int, block: int = 16):
    """The reference's per-frame analysis step: the 35-mode SATD sweep of
    each block from the frame's own neighbours, the best mode's residual
    transformed and quantised.  y: (H, W) int32 tensor.  Returns (modes
    (nby, nbx), levels (nby, nbx, n, n), the SATD sum, the non-zero level
    count), the two sums as int32 0-d tensors."""
    h, w = y.shape
    n = block
    log2n = n.bit_length() - 1
    nby, nbx = h // n, w // n
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    t = lambda a: torch.from_numpy(
        (a.ravel() * n).astype(np.int64)).to(y.device)
    x0, y0 = t(bxs), t(bys)
    ks = np.arange(4 * n + 1)
    k_x = torch.from_numpy(np.where(ks <= 2 * n, -1, ks - (2 * n + 1))) \
        .to(y.device)
    k_y = torch.from_numpy(np.where(ks < 2 * n, 2 * n - 1 - ks, -1)) \
        .to(y.device)
    xs = x0[:, None] + k_x[None]
    ys = y0[:, None] + k_y[None]
    avail = (xs >= 0) & (ys >= 0) & (xs < w) & (ys < h)
    s_sub, s_filt = substitute_filter_batch(
        gather_ref_samples(y, x0, y0, n), avail, log2n)
    preds = intra_pred_all_batch(s_sub, s_filt, log2n, 0)
    gy, gx = block_index(x0, y0, n, h, w)
    org = y[gy, gx].to(I32)
    costs = satd_batch(org[:, None], preds)
    modes = torch.argmin(costs, dim=1).to(I32)
    best = torch.gather(preds, 1, modes.long()[:, None, None, None]
                        .expand(-1, 1, n, n))[:, 0]
    lev = quant_batch(dct_batch(org - best, log2n), qp, log2n)
    satd_sum = costs.amin(1).sum(dtype=I32)
    nz = (lev != 0).sum(dtype=I32)
    return (modes.reshape(nby, nbx), lev.reshape(nby, nbx, n, n), satd_sum,
            nz)


def sharded_encode_step(mesh: Mesh, qp: int, block: int = 16):
    """The reference's multi-frame analysis step: frames batched on the
    leading axis and split over the mesh's shards in equal runs, each
    frame analysed by _frame_analysis, the SATD and non-zero totals
    summed over the shards (the reference's psum).  Returns step(frames)
    with frames (B, H, W), B a multiple of the mesh size, giving (modes,
    levels, total SATD, total non-zero levels)."""
    def step(frames):
        frames = torch.as_tensor(frames).to(mesh.device, I32)
        if frames.shape[0] % mesh.size:
            raise ValueError(f"{frames.shape[0]} frames do not split over "
                             f"{mesh.size} shards")
        per = frames.shape[0] // mesh.size
        modes, levs = [], []
        total_satd = torch.zeros((), dtype=I32, device=mesh.device)
        total_nz = torch.zeros((), dtype=I32, device=mesh.device)
        for s in range(mesh.size):
            satd = nz = 0
            for y in frames[s * per:(s + 1) * per]:
                m, lev, sa, z = _frame_analysis(y, qp, block)
                modes.append(m)
                levs.append(lev)
                satd = satd + sa
                nz = nz + z
            total_satd = total_satd + satd
            total_nz = total_nz + nz
        return (torch.stack(modes), torch.stack(levs), total_satd, total_nz)

    return step
