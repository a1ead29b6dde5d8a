"""SEA / ADS motion search (integral-image candidate pruning; port of
x265_mod_by_patman_tpu/ops/sea.py, `--me sea`).

Each candidate window's quadrant sums come from an integral image of the
edge-padded reference; sum_q |sum(ref quadrant) - sum(src quadrant)| is a
lower bound on the window's SAD.  The bound (plus the lambda * mv-bits
charge) is computed densely for all (2r+1)^2 candidates, the k smallest
bounds are kept per block, and only those k windows get an exact SAD.

The reference runs this as XLA ops (no Pallas kernel), so plain torch ops
on the tensors' own device are its port.  Two departures keep the result
exact and the same on every device:

* the k smallest bounds are selected on a unique int64 key
  (bound * ncc + candidate index): `jax.lax.top_k` returns equal values
  lowest index first, `torch.topk` promises no order among ties, and a
  tie at the k-th place decides which windows get an exact SAD;
* the integral image is summed in int64 (the reference's int32 wraps;
  window differences are the same), and the quadrant sums are taken
  once into an int32 box-sum plane, so the (B, 2r+1, 2r+1) temporaries
  stay int32.

integral_ref and sea_search_ref are the reference's numpy goldens,
copied unchanged."""
from __future__ import annotations

import numpy as np
import torch

from .me import mv_bits, mv_bits_np

I32 = torch.int32
I64 = torch.int64
SAD_CHUNK = 16           # exact-SAD candidates gathered per step


def integral_ref(plane: np.ndarray) -> np.ndarray:
    """Scalar golden: (H+1, W+1) exclusive 2-D prefix sums (the
    concatenation of the reference's integral_initv/inith passes).
    int64 so 4K planes cannot overflow."""
    p = np.asarray(plane, np.int64)
    out = np.zeros((p.shape[0] + 1, p.shape[1] + 1), np.int64)
    out[1:, 1:] = p.cumsum(0).cumsum(1)
    return out


def integral_batch(plane: torch.Tensor) -> torch.Tensor:
    """(H+1, W+1) exclusive 2-D prefix sums, int64, on the plane's
    device."""
    s = torch.cumsum(torch.cumsum(plane.to(I64), 0), 1)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


def _edge_pad(ref: torch.Tensor, r: int) -> torch.Tensor:
    """The plane edge-extended by r on every side."""
    h, w = ref.shape
    dev = ref.device
    ys = torch.clamp(torch.arange(-r, h + r, device=dev), 0, h - 1)
    xs = torch.clamp(torch.arange(-r, w + r, device=dev), 0, w - 1)
    return ref[ys[:, None], xs[None, :]]


def _comp_bits(v: torch.Tensor) -> torch.Tensor:
    """One component's share of mv_bits: 2 * ceil(log2(|v| + 1)) + 1."""
    return mv_bits(v, torch.zeros_like(v)) - 1


def sea_search_batch(ref, orig, x0, y0, pred_mv_x, pred_mv_y,
                     lambda_x256: int, n: int, search_range: int = 16,
                     k: int = 48):
    """SEA-pruned integer search; same contract as full_search_batch
    (returns qpel (mv_x, mv_y, cost) int32; cost = SAD +
    (lambda_x256 * mvd-bits) >> 8, ties to the lowest (dy, dx)
    row-major candidate).  k: exact-SAD candidates per block; k >=
    (2r+1)^2 is the exact dense search."""
    r = search_range
    h, w = ref.shape
    dev = ref.device
    nb = x0.shape[0]
    nc = 2 * r + 1
    ncc = nc * nc
    k = min(k, ncc)
    x0 = x0.to(I64)
    y0 = y0.to(I64)
    refp = _edge_pad(ref.to(I32), r)
    hp, wp = refp.shape
    ar = torch.arange(n, device=dev)
    org = orig.to(I32)[torch.clamp(y0[:, None, None] + ar[None, :, None],
                                   0, h - 1),
                       torch.clamp(x0[:, None, None] + ar[None, None, :],
                                   0, w - 1)]
    # quadrant-granular bound: one int32 plane of every hn x hn window's
    # sum, read at each candidate's four quadrant origins
    hn = n // 2
    integ = integral_batch(refp)
    box = (integ[hn:, hn:] - integ[:-hn, hn:] - integ[hn:, :-hn]
           + integ[:-hn, :-hn]).to(I32)
    bh, bw = box.shape
    d = torch.arange(nc, device=dev)
    bound = torch.zeros((nb, nc, nc), dtype=I32, device=dev)
    for (qy, qx) in ((0, 0), (0, hn), (hn, 0), (hn, hn)):
        oq = org[:, qy:qy + hn, qx:qx + hn].sum((1, 2), dtype=I32)
        ty = torch.clamp(y0[:, None] + d[None] + qy, 0, bh - 1)
        tx = torch.clamp(x0[:, None] + d[None] + qx, 0, bw - 1)
        ws = box[ty[:, :, None], tx[:, None, :]]
        bound += torch.abs(ws - oq[:, None, None])
    mq = (d.to(I32) - r) * 4
    bits_x = _comp_bits(mq[None, :] - pred_mv_x.to(I32)[:, None])  # (B, C)
    bits_y = _comp_bits(mq[None, :] - pred_mv_y.to(I32)[:, None])
    bound += (lambda_x256 * (bits_y[:, :, None] + bits_x[:, None, :])) >> 8
    # the k smallest (bound, index) pairs: unique keys, so the set is the
    # reference's top_k set on any device
    key = bound.reshape(nb, ncc).to(I64) * ncc + torch.arange(ncc,
                                                              device=dev)
    idx = torch.topk(key, k, dim=1, largest=False).indices       # (B, K)
    del bound, key
    ky = idx // nc
    kx = idx % nc
    sad = []
    for c0 in range(0, k, SAD_CHUNK):
        cy = torch.clamp(y0[:, None, None, None] + ky[:, c0:c0 + SAD_CHUNK,
                                                      None, None]
                         + ar[None, None, :, None], 0, hp - 1)
        cx = torch.clamp(x0[:, None, None, None] + kx[:, c0:c0 + SAD_CHUNK,
                                                      None, None]
                         + ar[None, None, None, :], 0, wp - 1)
        sad.append(torch.abs(refp[cy, cx] - org[:, None])
                   .sum((2, 3), dtype=I32))
    sad = torch.cat(sad, 1)
    kb = torch.gather(bits_x, 1, kx) + torch.gather(bits_y, 1, ky)
    cost = sad + ((lambda_x256 * kb) >> 8)
    best = cost.amin(1)
    sel = torch.where(cost == best[:, None], idx, ncc).amin(1)
    return (((sel % nc - r) * 4).to(I32), ((sel // nc - r) * 4).to(I32),
            best.to(I32))


def sea_search_ref(ref, orig, x0, y0, pred_mv, lambda_x256, n,
                   search_range=16, k=48):
    """Scalar golden for one block (numpy; exact same pruning rule)."""
    r = search_range
    refp = np.pad(np.asarray(ref, np.int64), r, mode="edge")
    integ = integral_ref(refp)
    org = np.asarray(orig, np.int64)[y0:y0 + n, x0:x0 + n]
    hn = n // 2
    n_cand = 2 * r + 1
    rows = []
    for dy in range(n_cand):
        for dx in range(n_cand):
            b = 0
            for (qy, qx) in ((0, 0), (0, hn), (hn, 0), (hn, hn)):
                ty, tx = y0 + dy + qy, x0 + dx + qx
                ws = (integ[ty + hn, tx + hn] - integ[ty, tx + hn]
                      - integ[ty + hn, tx] + integ[ty, tx])
                b += abs(int(ws -
                             org[qy:qy + hn, qx:qx + hn].sum()))
            bits = mv_bits_np((dx - r) * 4 - pred_mv[0],
                              (dy - r) * 4 - pred_mv[1])
            rows.append((b + ((lambda_x256 * bits) >> 8),
                         dy * n_cand + dx))
    rows.sort(key=lambda t: (t[0], t[1]))
    best = (1 << 60, -1)
    for _, ci in rows[:k]:
        dy, dx = ci // n_cand, ci % n_cand
        cand = refp[y0 + dy:y0 + dy + n, x0 + dx:x0 + dx + n]
        sad = int(np.abs(cand - org).sum())
        bits = mv_bits_np((dx - r) * 4 - pred_mv[0],
                          (dy - r) * 4 - pred_mv[1])
        cost = sad + ((lambda_x256 * bits) >> 8)
        if cost < best[0] or (cost == best[0] and ci < best[1]):
            best = (cost, ci)
    ci = best[1]
    return ((ci % n_cand - r) * 4, (ci // n_cand - r) * 4, best[0])
