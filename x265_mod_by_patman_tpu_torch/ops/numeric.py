"""Device-independent numeric helpers.

The encoder's decisions must come out the same on the CPU and on the
card, so three things are pinned down here instead of left to each
backend:

* integer matrix products (CUDA has no int32 GEMM): computed in float64,
  which is exact while every partial sum stays below 2**53;
* float32 sums: a fixed pairwise order (halving the reduced axis), so the
  rounding does not depend on the backend's reduction tree;
* float32 transcendental functions: evaluated in float64 and rounded
  once to float32.
"""
from __future__ import annotations

import torch


def ieinsum(eq: str, *ops) -> torch.Tensor:
    """Exact int32 einsum (JAX's preferred_element_type=int32).  Any
    contraction order is exact here, so opt_einsum's path search (a
    host cost on every call, larger than the small products it orders)
    is skipped: the operands contract left to right."""
    with torch.backends.opt_einsum.flags(enabled=False):
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


def flog2(x: torch.Tensor) -> torch.Tensor:
    return torch.log2(x.to(torch.float64)).to(torch.float32)


def fexp2(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(x.to(torch.float64)).to(torch.float32)


def fsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def lam2_f32(qp: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """0.85 * 2**((qp - 12) / 3) * 4**(bd - 8) in float32, the SSE lambda
    the wavefront's skip and mode-RD tests use."""
    q = qp.to(torch.float32)
    return (0.85 * fexp2((q - 12.0) / 3.0)) * float(1 << (2 * (bit_depth - 8)))
