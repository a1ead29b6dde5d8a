"""K3: float32 sums with the terms added strictly in index order
(CUDA source csrc/ordered_sum.cu).  It ports no TPU kernel: it gives the
port the summation order of the reference's CPU backend where that order
is known (ops.numeric.osum), and in a second mode (`ordered_sum_lanes`,
ops.numeric.lsum) the 8-lane order its CPU backend gives a fused sum
over an n x n transform block, and in a third (`ordered_sum_chained`,
ops.numeric.csum) the chained lane orders its wavefront gives its TB bit
estimates: W lanes a row, the lanes' tree, then the row's tail.

Both read the terms where the caller holds them: the launch takes the
sizes and strides of the reduced and the kept axes (`term_layout`), so
no copy of the terms is made first.  Both dispatch on the tensor's
device: a CPU tensor takes the plain PyTorch version (ops.numeric.
osum_plain, lanes_sum_plain, chain_sum_plain) on a view of the same
layout, a CUDA tensor launches the kernel (or raises)."""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..numeric import chain_sum_plain, lanes_sum_plain, osum_plain
from .build import check, count_launch, load_library

MAX_REDUCED = 2     # reduced axes the row-mode kernel walks (after merging)
MAX_KEPT = 4        # kept axes
LANE_SIZES = (4, 8, 16, 32)   # the lane mode's n: the TU sizes
# the chained lane mode's (n, lanes, span): the wavefront's TB bit
# estimates (n = 8, 16) and the lane mode's n >= 16
CHAIN_ORDERS = ((8, 8, 8), (8, 4, 8), (16, 8, 8), (16, 8, 16), (32, 8, 32),
                (16, 4, 12), (32, 8, 16), (32, 16, 32))


class TermLayout(NamedTuple):
    """Where the terms of a sum lie in a tensor's storage: the reduced
    and the kept axes, each a tuple of (size, stride) in row-major
    order, outermost first (strides in elements)."""
    reduced: Tuple[Tuple[int, int], ...]
    kept: Tuple[Tuple[int, int], ...]

    @property
    def k(self) -> int:
        return _prod(s for s, _ in self.reduced)

    @property
    def m(self) -> int:
        return _prod(s for s, _ in self.kept)


def _prod(it) -> int:
    p = 1
    for v in it:
        p *= v
    return p


def _merge(axes):
    """Drop size-1 axes and merge neighbours that one stride walks (the
    outer's stride is the inner's times the inner's size); at least one
    axis, (1, 0), is left."""
    out = []
    for size, stride in axes:
        if size == 1:
            continue
        if out and out[-1][1] == stride * size:
            out[-1] = (out[-1][0] * size, stride)
        else:
            out.append((size, stride))
    return tuple(out) or ((1, 0),)


def term_layout(x: torch.Tensor, dims) -> TermLayout:
    """The layout of x's terms for a sum over `dims` (reduced dims in
    row-major order, the kept ones in x's order).  Raises ValueError
    when a side needs more axes than the kernel walks after merging (no
    call site does)."""
    nd = x.dim()
    dims = sorted({d % nd for d in dims})
    keep = [d for d in range(nd) if d not in dims]
    red = _merge((x.shape[d], x.stride(d)) for d in dims)
    kept = _merge((x.shape[d], x.stride(d)) for d in keep)
    if len(red) > MAX_REDUCED or len(kept) > MAX_KEPT:
        raise ValueError(f"ordered_sum: {len(red)} reduced and {len(kept)} "
                         f"kept axes after merging; the kernel walks up to "
                         f"{MAX_REDUCED} and {MAX_KEPT}")
    if 0 in x.shape:
        # nothing to read: a zero-size axis stands for the whole side
        red = ((_prod(x.shape[d] for d in dims), 0),)
        kept = ((_prod(x.shape[d] for d in keep), 0),)
    return TermLayout(red, kept)


def terms_view(x: torch.Tensor, lay: TermLayout) -> torch.Tensor:
    """The (K, M) terms of `lay` as a view of x's storage."""
    axes = lay.reduced + lay.kept
    v = torch.as_strided(x, [s for s, _ in axes], [st for _, st in axes],
                         x.storage_offset())
    return v.reshape(lay.k, lay.m)


def _check(x) -> None:
    if x.dtype != torch.float32:
        raise TypeError("ordered_sum takes a float32 tensor")


def ordered_sum(x: torch.Tensor, dims) -> torch.Tensor:
    """float32 sums of x over `dims` (an int or a sequence), each
    output's terms added in row-major order of the reduced dims from a
    float32 zero; the output has the kept dims' shape."""
    _check(x)
    if isinstance(dims, int):
        dims = (dims,)
    nd = x.dim()
    dims = sorted({d % nd for d in dims})
    shape = [x.shape[d] for d in range(nd) if d not in dims]
    lay = term_layout(x, dims)
    if x.device.type == "cpu":
        return osum_plain(terms_view(x, lay)).reshape(shape)
    if x.device.type != "cuda":
        raise ValueError(f"ordered_sum: unsupported device {x.device}")
    k, m = lay.k, lay.m
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    pad = lambda axes, n: list(axes) + [(1, 0)] * (n - len(axes))
    red, kept = pad(lay.reduced, MAX_REDUCED), pad(lay.kept, MAX_KEPT)
    arr = (ctypes.c_longlong * (2 * (MAX_REDUCED + MAX_KEPT)))(
        *[s for s, _ in red], *[st for _, st in red],
        *[s for s, _ in kept], *[st for _, st in kept])
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check(lib.ordered_sum_launch(x.data_ptr(), out.data_ptr(), arr, stream),
          "ordered_sum")
    count_launch(ordered_sum, (k, m))
    return out


def ordered_sum_lanes(x: torch.Tensor, n: int) -> torch.Tensor:
    """K3's lane mode: (M,) float32 sums of the M n x n blocks of x, an
    (M, n, n) tensor in any strides (n = 4, 8, 16 or 32), in the order
    of ops.numeric.lanes_sum_plain.  Its launches count as
    ordered_sum's, keyed ("lanes", n, M)."""
    _check(x)
    if n not in LANE_SIZES or x.dim() != 3 or tuple(x.shape[1:]) != (n, n):
        raise ValueError(f"ordered_sum_lanes: {tuple(x.shape)} terms are "
                         f"not (M, n, n) blocks with n = {n} in "
                         f"{LANE_SIZES}")
    m = x.shape[0]
    if x.device.type == "cpu":
        return lanes_sum_plain(x.reshape(m, n * n).T, n)
    if x.device.type != "cuda":
        raise ValueError(f"ordered_sum_lanes: unsupported device "
                         f"{x.device}")
    out = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sb, sr, sc = x.stride()
    check(lib.ordered_sum_lanes_launch(x.data_ptr(), out.data_ptr(), n, m,
                                       sb, sr, sc, stream),
          "ordered_sum_lanes")
    count_launch(ordered_sum, ("lanes", n, m))
    return out


def ordered_sum_chained(x: torch.Tensor, n: int, lanes: int,
                        span: int) -> torch.Tensor:
    """K3's chained lane mode: (M,) float32 sums of the M n x n blocks of
    x, an (M, n, n) tensor in any strides, in the order of
    ops.numeric.chain_sum_plain(., n, lanes, span) for (n, lanes, span)
    in CHAIN_ORDERS.  Its launches count as ordered_sum's, keyed
    ("chain", n, lanes, span, M)."""
    _check(x)
    if (n, lanes, span) not in CHAIN_ORDERS or x.dim() != 3 or \
            tuple(x.shape[1:]) != (n, n):
        raise ValueError(f"ordered_sum_chained: {tuple(x.shape)} terms in "
                         f"order (n, lanes, span) = {(n, lanes, span)}; "
                         f"the kernel takes (M, n, n) blocks in "
                         f"{CHAIN_ORDERS}")
    m = x.shape[0]
    if x.device.type == "cpu":
        return chain_sum_plain(x.reshape(m, n * n).T, n, lanes, span)
    if x.device.type != "cuda":
        raise ValueError(f"ordered_sum_chained: unsupported device "
                         f"{x.device}")
    out = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sb, sr, sc = x.stride()
    check(lib.ordered_sum_chain_launch(x.data_ptr(), out.data_ptr(), n,
                                       lanes, span, m, sb, sr, sc, stream),
          "ordered_sum_chained")
    count_launch(ordered_sum, ("chain", n, lanes, span, m))
    return out


ordered_sum.launches = 0
ordered_sum.launches_by_shape = {}  # (K, M), ("lanes", n, M) or
#                                     ("chain", n, lanes, span, M) -> launches
