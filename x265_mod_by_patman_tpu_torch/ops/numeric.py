"""Device-independent numeric helpers.

The encoder's decisions must come out the same on the CPU and on the
card, so three things are pinned down here instead of left to each
backend:

* integer matrix products (CUDA has no int32 GEMM): computed in float64,
  which is exact while every partial sum stays below 2**53;
* float32 sums: where the reference's CPU backend is known to add the
  terms left to right in row-major order, that order (osum; on the card
  the hand kernel K3, ops.cuda.ordered_sum); elsewhere a fixed pairwise
  order (fsum, halving the reduced axis), so the rounding does not
  depend on the backend's reduction tree;
* float32 transcendental functions: evaluated in float64 and rounded
  once to float32;
* 2**q for the integer exponents of the RDOQ level scale: the value the
  reference's CPU backend gives (exp2_ref).
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch


_EINSUM_LOCK = threading.Lock()


def ieinsum(eq: str, *ops) -> torch.Tensor:
    """Exact int32 einsum (JAX's preferred_element_type=int32).  Any
    contraction order is exact here, so opt_einsum's path search (a
    host cost on every call, larger than the small products it orders)
    is skipped: the operands contract left to right.  The switch is
    process-wide, so encoders running in threads take it in turn."""
    with _EINSUM_LOCK, torch.backends.opt_einsum.flags(enabled=False):
        r = torch.einsum(eq, *[o.to(torch.float64) for o in ops])
    return torch.round(r).to(torch.int64).to(torch.int32)


def fsum(x: torch.Tensor, dims) -> torch.Tensor:
    """float32 sum over `dims` in a fixed pairwise order."""
    if isinstance(dims, int):
        dims = (dims,)
    nd = x.dim()
    dims = sorted(d % nd for d in dims)
    keep = [d for d in range(nd) if d not in dims]
    x = x.permute(*keep, *dims)
    x = x.reshape(*x.shape[:len(keep)], -1)
    n = x.shape[-1]
    p = 1
    while p < n:
        p <<= 1
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def osum_plain(xt: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: (K, M) float32 terms -> (M,) sums, the terms
    of each column added in order of k from a float32 zero."""
    acc = torch.zeros(xt.shape[1:], dtype=torch.float32, device=xt.device)
    for k in range(xt.shape[0]):
        acc = acc + xt[k]
    return acc


def lanes_sum_plain(xt: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of K3's lane mode: (n*n, M) float32 terms, each
    column an n x n block in row-major order -> (M,) sums in the order
    the reference's CPU backend gives a fused TU sum (8-lane vectors):
    for n <= 8 each row summed left to right, then the n row sums as a
    tree (j + n/2 into j, halving); for n >= 16 row by row, lane j
    summing the row's terms j, j + 8, ... after the running sum is
    added into lane 0's first term, the 8 lanes as a tree (j + 4, + 2,
    + 1) giving the new running sum."""
    x = xt.reshape(n, n, -1)
    if n <= 8:
        lanes = [osum_plain(x[r]) for r in range(n)]
        w = n // 2
        while w >= 1:
            lanes = [lanes[j] + lanes[j + w] for j in range(w)]
            w //= 2
        return lanes[0]
    acc = torch.zeros(x.shape[2:], dtype=torch.float32, device=xt.device)
    for r in range(n):
        lane = x[r, :8].clone()
        lane[0] = acc + lane[0]
        for c in range(8, n, 8):
            lane = x[r, c:c + 8] + lane
        lane = lane[:4] + lane[4:]
        lane = lane[:2] + lane[2:]
        acc = lane[0] + lane[1]
    return acc


def lsum(x: torch.Tensor) -> torch.Tensor:
    """(..., n, n) float32 -> (...) sums of each n x n block in the
    reference's fused TU-sum order (lanes_sum_plain; K3's lane mode on
    the card)."""
    from .cuda.ordered_sum import ordered_sum_lanes
    n = x.shape[-1]
    lead = x.shape[:-2]
    xt = x.to(torch.float32).reshape(-1, n * n).T.contiguous()
    return ordered_sum_lanes(xt, n).reshape(lead)


def osum(x: torch.Tensor, dims) -> torch.Tensor:
    """float32 sum over `dims`, the terms added one by one in row-major
    order of the reduced dims (K3 on the card, osum_plain on the CPU)."""
    from .cuda.ordered_sum import ordered_sum
    if isinstance(dims, int):
        dims = (dims,)
    nd = x.dim()
    dims = sorted(d % nd for d in dims)
    keep = [d for d in range(nd) if d not in dims]
    shape = [x.shape[d] for d in keep]
    xt = x.to(torch.float32).permute(*dims, *keep).reshape(
        -1, int(np.prod(shape, dtype=np.int64))).contiguous()
    return ordered_sum(xt).reshape(shape)


def fma32(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as the reference's CPU backend
    contracts a multiply into the add that consumes it (float64 holds
    the product of two float32 exactly).  b may be a Python number."""
    f = lambda x: x.to(torch.float64) if isinstance(x, torch.Tensor) else x
    return (f(a) * f(b) + f(c)).to(torch.float32)


def flog2(x: torch.Tensor) -> torch.Tensor:
    return torch.log2(x.to(torch.float64)).to(torch.float32)


def fexp2(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(x.to(torch.float64)).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _exp2_ref_table(device) -> torch.Tensor:
    arg = (np.arange(64, dtype=np.float64)
           * np.float64(np.float32(np.log(2.0)))).astype(np.float32)
    return torch.from_numpy(
        np.exp(arg.astype(np.float64)).astype(np.float32)).to(device)


def exp2_ref(q: torch.Tensor) -> torch.Tensor:
    """float32 2**q for integer q in [0, 63] as the reference's backend
    (XLA on the CPU) evaluates float32 exp2: exp(q * ln2) with the product
    rounded to float32, so odd q come out inexact (524287.78 for q = 19).
    The RDOQ level scale divides by it: an exact .5 tie of the scaled
    coefficient then falls on the reference's side."""
    return _exp2_ref_table(q.device)[q.long()]


def fsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def lam2_f32(qp: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """0.85 * 2**((qp - 12) / 3) * 4**(bd - 8) in float32, the SSE lambda
    the wavefront's skip and mode-RD tests use."""
    q = qp.to(torch.float32)
    return (0.85 * fexp2((q - 12.0) / 3.0)) * float(1 << (2 * (bit_depth - 8)))
