"""Batched intra mode decision (port of the I-path half of
x265_mod_by_patman_tpu/analysis/intra_mode.py): every block of the frame
evaluates all 35 modes from original-pixel neighbours; the variable
CU-tree decision then compares 16- and 32-level transform RD, and the
NxN candidate (four 8x8 PUs, optionally split into 4x4 DST TUs) is
proposed by SATD and confirmed by transform RD.  The batched all-intra
path decides F frames at once (decide_modes_batch; decide_modes_rd_multi
wholly on the device, in float32 as the reference's one program).

Device work (the 35-mode SATD sweeps, the TU RD estimates) runs in
torch on the plane's device; the small host DP stays numpy, as in the
reference."""
from __future__ import annotations


import numpy as np
import torch

from ..frame.planes import dev_i32
from ..frame.zscan import frame_avail_masks
from ..ops.cost import satd_batch
from ..ops.numeric import fma32, osum
from ..ops.intra import (block_index, gather_ref_samples,
                         intra_pred_all_batch, intra_pred_select_batch,
                         substitute_filter_batch)
from ..ops.rdoq import tu_rd_levels
from ..ops.transform import dct_batch

I32 = torch.int32


def _refs_and_org(orig, avail, bx, by, log2n: int, bit_depth: int):
    """Substituted/filtered reference vectors from ORIGINAL neighbours
    and the blocks' source pixels."""
    n = 1 << log2n
    x0 = bx.long() * n
    y0 = by.long() * n
    s_sub, s_filt = substitute_filter_batch(
        gather_ref_samples(orig, x0, y0, n), avail, log2n, bit_depth)
    gy, gx = block_index(x0, y0, n, *orig.shape)
    return s_sub, s_filt, orig[gy, gx].to(I32)


def _mode_costs(orig, avail, bx, by, log2n: int, bit_depth: int = 8):
    """SATD of all 35 modes per block, predicted from original
    neighbours: (B, 35) int32."""
    s_sub, s_filt, org = _refs_and_org(orig, avail, bx, by, log2n,
                                       bit_depth)
    preds = intra_pred_all_batch(s_sub, s_filt, log2n, 0, bit_depth)
    return satd_batch(org[:, None], preds)


def _tu_rd_for_modes(orig, avail, bx, by, modes, qp, log2n: int,
                     bit_depth: int = 8):
    """Level-units transform+quant RD of coding each block with its given
    mode (predictions from original neighbours)."""
    s_sub, s_filt, org = _refs_and_org(orig, avail, bx, by, log2n,
                                       bit_depth)
    pred = intra_pred_select_batch(s_sub, s_filt, modes, log2n, 0,
                                   bit_depth)
    return tu_rd_levels(dct_batch(org - pred, log2n, bit_depth), qp, log2n,
                        bit_depth)


def _grid(w: int, h: int, block: int, log2_ctu: int, device):
    """(avail (B, 4n+1), bx, by) device tensors of a block grid."""
    nbx, nby = w // block, h // block
    avail = frame_avail_masks(w, h, block, log2_ctu, 0)
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(avail.reshape(-1, avail.shape[-1])),
            t(bxs.ravel().astype(np.int32)), t(bys.ravel().astype(np.int32)))


def _mpm_grid(modes: np.ndarray, log2_ctu: int, block: int) -> np.ndarray:
    """Vectorized MPM derivation (spec 8.4.2) over a (nby, nbx) mode grid
    (copied from the reference).  Returns (nby, nbx, 3)."""
    nby, nbx = modes.shape
    left = np.empty_like(modes)
    left[:, 1:] = modes[:, :-1]
    left[:, 0] = 1
    top = np.empty_like(modes)
    top[1:, :] = modes[:-1, :]
    top[0, :] = 1
    ys = (np.arange(nby) * block) % (1 << log2_ctu) == 0
    top[ys, :] = 1
    a, b = left, top
    eq = a == b
    lt2 = a < 2
    m0 = np.where(eq & lt2, 0, np.where(eq, a, a))
    m1 = np.where(eq & lt2, 1,
                  np.where(eq, 2 + ((a + 29) % 32), b))
    c = np.where((a != 0) & (b != 0), 0,
                 np.where((a != 1) & (b != 1), 1, 26))
    m2 = np.where(eq & lt2, 26,
                  np.where(eq, 2 + ((a - 1) % 32), c))
    return np.stack([m0, m1, m2], axis=-1)


def _homogenize_ctus(modes, total, lam, sps, block) -> None:
    """CTU-homogenization (in place; copied from the reference)."""
    nby, nbx = modes.shape
    bpc = (1 << sps.log2_ctu_size) // block
    if bpc != 2 or nby < 2 or nbx < 2:
        return
    cy, cx = nby // 2, nbx // 2
    t = total[:cy * 2, :cx * 2].reshape(cy, 2, cx, 2, 35)
    group = t.sum(axis=(1, 3))
    best_common = group.min(axis=-1)
    common_mode = group.argmin(axis=-1)
    chosen = np.take_along_axis(total, modes[..., None], axis=-1)[..., 0]
    indiv = chosen[:cy * 2, :cx * 2].reshape(cy, 2, cx, 2).sum(axis=(1, 3))
    unify = best_common <= indiv + lam * 20.0
    mm = modes[:cy * 2, :cx * 2].reshape(cy, 2, cx, 2)
    cm = common_mode[:, None, :, None]
    mm[...] = np.where(unify[:, None, :, None], cm, mm)


def _mpm_bits(mpm: np.ndarray, shape) -> np.ndarray:
    modes_axis = np.arange(35)[None, None, :]
    bits = np.full(shape, 6.0)
    bits = np.where(modes_axis == mpm[..., 2:3], 3.0, bits)
    bits = np.where(modes_axis == mpm[..., 1:2], 3.0, bits)
    return np.where(modes_axis == mpm[..., 0:1], 2.0, bits)


def decide_modes_rd(y, sps, qp: int, device, block: int = 16,
                    topk: int = 0):
    """Two-pass mode decision: SATD sweep, then re-argmin with MPM-aware
    mode-bit costs (see the reference)."""
    from .inter_mode import lambda_qp
    h, w = sps.height, sps.width
    nbx, nby = w // block, h // block
    log2n = block.bit_length() - 1
    orig = dev_i32(y, device)
    avail, bx, by = _grid(w, h, block, sps.log2_ctu_size, device)
    costs = _mode_costs(orig, avail, bx, by, log2n, sps.bit_depth) \
        .cpu().numpy().reshape(nby, nbx, 35)
    pass1 = np.argmin(costs, axis=-1).astype(np.int32)
    mpm = _mpm_grid(pass1, sps.log2_ctu_size, block)
    lam = lambda_qp(qp)[0] * (1 << (sps.bit_depth - 8))
    bits = _mpm_bits(mpm, (nby, nbx, 35))
    total = costs + lam * bits
    modes = np.argmin(total, axis=-1).astype(np.int32)
    _homogenize_ctus(modes, total, lam, sps, block)
    if topk:
        cand = np.argsort(total, axis=-1)[..., :topk].astype(np.int32)
        cand[..., 0] = modes
        hom = modes != np.argmin(total, axis=-1).astype(np.int32)
        cand[hom] = modes[hom][:, None]
        cbits = np.take_along_axis(bits, cand, axis=-1).astype(np.float32)
        return modes, cand, cbits
    return modes


def decide_modes_tree(y, sps, qp: int, device, nxn: bool = False):
    """Variable CU-tree intra decision over depths {32, 16(, 8 NxN)}.
    Returns (modes16, split_map or None, modes8 or None, split32,
    mode32, cand16, cbits16)."""
    from .inter_mode import lambda_qp
    h, w = sps.height, sps.width
    nbx, nby = w // 16, h // 16
    n32x, n32y = w // 32, h // 32
    lam = lambda_qp(qp)[0] * (1 << (sps.bit_depth - 8))
    if nxn:
        modes16, split_map, modes8 = decide_modes_split(y, sps, qp, device,
                                                        16)
        cand16 = cbits16 = None
    else:
        modes16, cand16, cbits16 = decide_modes_rd(y, sps, qp, device, 16,
                                                   topk=3)
        split_map = modes8 = None
    orig = dev_i32(y, device)
    avail, bxs, bys = _grid(w, h, 16, sps.log2_ctu_size, device)
    avail32, b32x, b32y = _grid(w, h, 32, sps.log2_ctu_size, device)
    c32 = _mode_costs(orig, avail32, b32x, b32y, 5, sps.bit_depth) \
        .cpu().numpy().reshape(n32y, n32x, 35)
    mpm32 = _mpm_grid(np.argmin(c32, axis=-1).astype(np.int32),
                      sps.log2_ctu_size, 32)
    bits32 = _mpm_bits(mpm32, (n32y, n32x, 35))
    t32 = c32 + lam * bits32
    mode32 = np.argmin(t32, axis=-1).astype(np.int32)

    K = 0.134
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    rd16 = _tu_rd_for_modes(
        orig, avail, bxs, bys, t(modes16.ravel().astype(np.int32)), qp, 4,
        sps.bit_depth).cpu().numpy().reshape(nby, nbx)
    rd32 = _tu_rd_for_modes(
        orig, avail32, b32x, b32y, t(mode32.ravel().astype(np.int32)), qp,
        5, sps.bit_depth).cpu().numpy().reshape(n32y, n32x)
    if cbits16 is not None:
        chosen_bits16 = cbits16[..., 0]
    else:
        chosen_bits16 = np.full((nby, nbx), 4.0)
    bits32_chosen = np.take_along_axis(
        bits32, mode32[..., None], axis=-1)[..., 0]

    def q16(a):
        return (a[0:2 * n32y:2, 0:2 * n32x:2]
                + a[0:2 * n32y:2, 1:2 * n32x:2]
                + a[1:2 * n32y:2, 0:2 * n32x:2]
                + a[1:2 * n32y:2, 1:2 * n32x:2])

    cost32 = rd32 + K * bits32_chosen
    cost16 = q16(rd16) + K * (q16(chosen_bits16) + 22.0)
    split32 = cost32 > cost16
    if split_map is not None:
        # a 16-block that chose NxN carries TU8/TU4 levels in its slot,
        # which the unsplit-32 assembly cannot represent
        nxn_any = (split_map[0:2 * n32y:2, 0:2 * n32x:2]
                   | split_map[0:2 * n32y:2, 1:2 * n32x:2]
                   | split_map[1:2 * n32y:2, 0:2 * n32x:2]
                   | split_map[1:2 * n32y:2, 1:2 * n32x:2])
        split32 = split32 | nxn_any
    return (modes16, split_map, modes8, split32, mode32, cand16, cbits16)


def _tu4_costs(orig, avail, bx, by, modes, qp, bit_depth: int = 8):
    """TU8 (DCT) against 4x TU4 (DST) level-units RD per 8x8 sub-PU
    (original neighbours, a shared 8x8 prediction).  Returns (rd8, rd4)
    float32 (B,); rd4 excludes the split syntax charge."""
    s_sub, s_filt, org = _refs_and_org(orig, avail, bx, by, 3, bit_depth)
    pred = intra_pred_select_batch(s_sub, s_filt, modes, 3, 0, bit_depth)
    resi = org - pred
    rd8 = tu_rd_levels(dct_batch(resi, 3, bit_depth), qp, 3, bit_depth)
    q = resi.reshape(-1, 2, 4, 2, 4).permute(0, 1, 3, 2, 4) \
        .reshape(-1, 4, 4)
    r4 = tu_rd_levels(dct_batch(q, 2, bit_depth, dst=True), qp, 2,
                      bit_depth).reshape(-1, 4)
    # the reference's 4-term sum runs left to right
    rd4 = ((r4[:, 0] + r4[:, 1]) + r4[:, 2]) + r4[:, 3]
    return rd8, rd4


def _z4(a):
    """(2nby, 2nbx) -> (nby, nbx, 4) z-order quadrants."""
    return np.stack([a[0::2, 0::2], a[0::2, 1::2], a[1::2, 0::2],
                     a[1::2, 1::2]], axis=-1)


def _modes8_flat(modes8: np.ndarray) -> np.ndarray:
    """(nby, nbx, 4) z-order modes -> (2nby, 2nbx) 8x8 grid."""
    nby, nbx = modes8.shape[:2]
    m8 = np.empty((2 * nby, 2 * nbx), np.int32)
    m8[0::2, 0::2] = modes8[..., 0]
    m8[0::2, 1::2] = modes8[..., 1]
    m8[1::2, 0::2] = modes8[..., 2]
    m8[1::2, 1::2] = modes8[..., 3]
    return m8


def decide_tu4_split(y, sps, qp: int, modes8: np.ndarray,
                     split_map: np.ndarray, device) -> np.ndarray:
    """Per-NxN-quad TU4 (DST) split decision (nby, nbx, 4) bool: split an
    8x8 luma TU into four DST 4x4 TBs when the level-units RD plus the
    split syntax charge (8 bins) wins."""
    h, w = sps.height, sps.width
    nbx, nby = w // 16, h // 16
    avail8, bx8, by8 = _grid(w, h, 8, sps.log2_ctu_size, device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    qpt = torch.tensor(qp, dtype=I32, device=device)
    rd8, rd4 = _tu4_costs(dev_i32(y, device), avail8, bx8, by8,
                          t(_modes8_flat(modes8).ravel()), qpt,
                          sps.bit_depth)
    win = (rd4.cpu().numpy() + 0.134 * 8.0 <
           rd8.cpu().numpy()).reshape(2 * nby, 2 * nbx)
    return _z4(win) & split_map[..., None]


def decide_modes_split(y, sps, qp: int, device, block: int = 16,
                       tu4: bool = False):
    """Mode decision with the NxN (4x 8x8 PU) candidate per block (see
    the reference): SATD proposes, a level-units RD gate (with the TU4
    option under tu4) confirms.  Returns (modes (nby, nbx) int32 with
    PU0's mode on split blocks, split_map (nby, nbx) bool, modes8
    (nby, nbx, 4) int32)."""
    from .inter_mode import lambda_qp
    h, w = sps.height, sps.width
    nbx, nby = w // block, h // block
    lam = lambda_qp(qp)[0] * (1 << (sps.bit_depth - 8))
    modes = decide_modes_rd(y, sps, qp, device, block)
    orig = dev_i32(y, device)
    avail8, bx8, by8 = _grid(w, h, 8, sps.log2_ctu_size, device)
    c8 = _mode_costs(orig, avail8, bx8, by8, 3, sps.bit_depth) \
        .cpu().numpy().reshape(2 * nby, 2 * nbx, 35)
    best8 = (c8 + lam * 5.5).min(axis=-1)
    m8 = c8.argmin(axis=-1).astype(np.int32)
    sum8 = (best8[0::2, 0::2] + best8[0::2, 1::2] +
            best8[1::2, 0::2] + best8[1::2, 1::2])
    modes8 = _z4(m8)
    avail16, bx16, by16 = _grid(w, h, block, sps.log2_ctu_size, device)
    c16 = _mode_costs(orig, avail16, bx16, by16, block.bit_length() - 1,
                      sps.bit_depth).cpu().numpy().reshape(nby, nbx, 35)
    cost16 = np.take_along_axis(c16, modes[..., None],
                                axis=-1)[..., 0] + lam * 4.0
    # NxN extra syntax: part bin + deeper-TU cbf flags ~ 6 bins
    split = sum8 + lam * 6.0 < cost16
    if split.any():
        # RD gate (the reference's _nxn_rd_costs): every SATD-proposed
        # split must also win in level-units RD, the TU16 of the 2Nx2N
        # mode against the four TU8s of the NxN modes
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        qpt = torch.tensor(qp, dtype=I32, device=device)
        m8t = t(m8.ravel())
        rd16 = _tu_rd_for_modes(orig, avail16, bx16, by16, t(modes.ravel()),
                                qpt, 4, sps.bit_depth).cpu().numpy() \
            .reshape(nby, nbx)
        rd8f = _tu_rd_for_modes(orig, avail8, bx8, by8, m8t, qpt, 3,
                                sps.bit_depth).cpu().numpy()
        if tu4:
            _, rd4f = _tu4_costs(orig, avail8, bx8, by8, m8t, qpt,
                                 sps.bit_depth)
            # split charge mirrors decide_tu4_split (8 bins)
            rd8f = np.minimum(rd8f, rd4f.cpu().numpy() + 0.134 * 8.0)
        r8 = rd8f.reshape(2 * nby, 2 * nbx)
        rd8 = (r8[0::2, 0::2] + r8[0::2, 1::2]
               + r8[1::2, 0::2] + r8[1::2, 1::2])
        # NxN syntax + model-bias charge, in level units (64 bins)
        split &= rd8 + 0.134 * 64.0 < rd16
    out = modes.copy()
    out[split] = modes8[split][:, 0]
    return out, split, modes8


# -- batched all-intra mode decision (frames along a leading axis) ---------

def _mode_costs_multi(origs, avail, bx, by, log2n: int, bit_depth: int = 8):
    """_mode_costs over a leading frame axis of origs (F, h, w): the
    frames are stacked along the rows and each frame's blocks offset by
    its row band, so one pass covers all F frames (the shared avail
    masks keep every reference sample inside its own frame; samples
    outside it are substituted).  Returns (F, B, 35) int32."""
    f, h, w = origs.shape
    n = 1 << log2n
    off = torch.arange(f, dtype=by.dtype, device=by.device) * (h // n)
    costs = _mode_costs(origs.reshape(f * h, w), avail.repeat(f, 1),
                        bx.repeat(f), (by[None, :] + off[:, None]).reshape(-1),
                        log2n, bit_depth)
    return costs.reshape(f, -1, 35)


def decide_modes_batch(ys, sps, device, block: int = 16,
                       qp: int = None) -> np.ndarray:
    """Batched mode decision for (F, h, w) frame stacks -> (F, nby, nbx);
    with qp given, applies the MPM-aware second pass per frame on the
    host in float64, as the reference does."""
    h, w = sps.height, sps.width
    nbx, nby = w // block, h // block
    log2n = block.bit_length() - 1
    avail, bx, by = _grid(w, h, block, sps.log2_ctu_size, device)
    costs = _mode_costs_multi(dev_i32(np.asarray(ys), device), avail, bx,
                              by, log2n, sps.bit_depth) \
        .cpu().numpy().reshape(-1, nby, nbx, 35)
    pass1 = np.argmin(costs, axis=-1).astype(np.int32)
    if qp is None:
        return pass1
    from .inter_mode import lambda_qp
    lam = lambda_qp(qp)[0] * (1 << (sps.bit_depth - 8))
    out = np.empty_like(pass1)
    for f in range(pass1.shape[0]):
        mpm = _mpm_grid(pass1[f], sps.log2_ctu_size, block)
        total = costs[f] + lam * _mpm_bits(mpm, (nby, nbx, 35))
        out[f] = np.argmin(total, axis=-1)
        _homogenize_ctus(out[f], total, lam, sps, block)
    return out


def _mpm_grid_t(modes, log2_ctu: int, block: int):
    """_mpm_grid on the device over (..., nby, nbx) mode grids (spec
    8.4.2).  Returns (..., nby, nbx, 3)."""
    nby, nbx = modes.shape[-2:]
    one = lambda *s: torch.ones(modes.shape[:-2] + s, dtype=modes.dtype,
                                device=modes.device)
    left = torch.cat([one(nby, 1), modes[..., :, :-1]], -1)
    top = torch.cat([one(1, nbx), modes[..., :-1, :]], -2)
    ctu_top = (torch.arange(nby, device=modes.device) * block) \
        % (1 << log2_ctu) == 0
    top = torch.where(ctu_top[:, None], 1, top)
    a, b = left, top
    eq = a == b
    lt2 = a < 2
    m0 = torch.where(eq & lt2, 0, a)
    m1 = torch.where(eq & lt2, 1, torch.where(eq, 2 + ((a + 29) % 32), b))
    c = torch.where((a != 0) & (b != 0), 0,
                    torch.where((a != 1) & (b != 1), 1, 26))
    m2 = torch.where(eq & lt2, 26, torch.where(eq, 2 + ((a - 1) % 32), c))
    return torch.stack([m0, m1, m2], -1).to(modes.dtype)


def _modes_rd_multi(origs, avail, bx, by, lam, log2n: int, log2_ctu: int,
                    bit_depth: int, nby: int, nbx: int, homog: bool):
    """The reference's decide_modes_rd for F frames on the device, with
    no host sync: SATD sweep, MPM-bit re-argmin and CTU homogenisation,
    in float32 as the reference's one program computes them (lam a
    float32; its products with the bit counts contracted into the adds;
    the 2x2 group sums in row-major order, osum)."""
    block = 1 << log2n
    f = origs.shape[0]
    costs = _mode_costs_multi(origs, avail, bx, by, log2n, bit_depth) \
        .reshape(f, nby, nbx, 35).to(torch.float32)
    pass1 = torch.argmin(costs, -1).to(I32)
    mpm = _mpm_grid_t(pass1, log2_ctu, block)
    ma = torch.arange(35, device=origs.device)
    bits = torch.full((f, nby, nbx, 35), 6.0, dtype=torch.float32,
                      device=origs.device)
    bits = torch.where(ma == mpm[..., 2:3], 3.0, bits)
    bits = torch.where(ma == mpm[..., 1:2], 3.0, bits)
    bits = torch.where(ma == mpm[..., 0:1], 2.0, bits)
    total = fma32(lam, bits, costs)
    modes = torch.argmin(total, -1).to(I32)
    if not homog:
        return modes
    cy, cx = nby // 2, nbx // 2
    t = total[:, :cy * 2, :cx * 2].reshape(f, cy, 2, cx, 2, 35)
    group = osum(t, (2, 4))
    best_common = group.amin(-1)
    common = torch.argmin(group, -1).to(I32)
    chosen = torch.gather(total, -1, modes[..., None].long())[..., 0]
    indiv = osum(chosen[:, :cy * 2, :cx * 2].reshape(f, cy, 2, cx, 2),
                 (2, 4))
    unify = best_common <= fma32(lam, torch.tensor(20.0, device=lam.device),
                                  indiv)
    mm = modes[:, :cy * 2, :cx * 2].reshape(f, cy, 2, cx, 2)
    mm = torch.where(unify[:, :, None, :, None], common[:, :, None, :, None],
                     mm).reshape(f, cy * 2, cx * 2)
    out = modes.clone()
    out[:, :cy * 2, :cx * 2] = mm
    return out


_GEOM_CACHE: dict = {}


def decide_modes_rd_multi(ys, sps, qp, device, block: int = 16):
    """decide_modes_rd for (F, h, w) stacks, wholly on `device`: returns a
    device (F, nby, nbx) int32 tensor without waiting on the device."""
    from .inter_mode import lambda_qp
    h, w = sps.height, sps.width
    nbx, nby = w // block, h // block
    log2n = block.bit_length() - 1
    dev = torch.device(device)
    key = (w, h, block, sps.log2_ctu_size, str(dev))
    if key not in _GEOM_CACHE:
        _GEOM_CACHE[key] = _grid(w, h, block, sps.log2_ctu_size, dev)
    avail, bx, by = _GEOM_CACHE[key]
    lam = lambda_qp(qp)[0] * (1 << (sps.bit_depth - 8))
    bpc = (1 << sps.log2_ctu_size) // block
    origs = ys if isinstance(ys, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(ys))
    return _modes_rd_multi(
        origs.to(device=dev, dtype=I32), avail, bx, by,
        torch.tensor(np.float32(lam), device=dev), log2n,
        sps.log2_ctu_size, sps.bit_depth, nby, nbx,
        bpc == 2 and nby >= 2 and nbx >= 2)


def decide_modes(y, sps, device, block: int = 16) -> np.ndarray:
    """The SATD-best of 35 modes per block.  Returns (nby, nbx)."""
    h, w = sps.height, sps.width
    nbx, nby = w // block, h // block
    avail, bx, by = _grid(w, h, block, sps.log2_ctu_size, device)
    costs = _mode_costs(dev_i32(y, device), avail, bx, by,
                        block.bit_length() - 1, sps.bit_depth)
    return torch.argmin(costs, 1).to(I32).cpu().numpy().reshape(nby, nbx)
