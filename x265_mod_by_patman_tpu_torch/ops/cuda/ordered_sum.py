"""K3: float32 row sums with the terms added strictly in index order
(CUDA source csrc/ordered_sum.cu).  It ports no TPU kernel: it gives the
port the summation order of the reference's CPU backend where that order
is known (ops.numeric.osum), and in a second mode (`ordered_sum_lanes`,
ops.numeric.lsum) the 8-lane order its CPU backend gives a fused sum
over an n x n transform block.

Both dispatch on the tensor's device: a CPU tensor takes the plain
PyTorch version (ops.numeric.osum_plain, lanes_sum_plain), a CUDA
tensor launches the kernel (or raises)."""
from __future__ import annotations

import torch

from ..numeric import lanes_sum_plain, osum_plain
from .build import check, count_launch, load_library


def _check(xt) -> None:
    if xt.dtype != torch.float32:
        raise TypeError("ordered_sum takes a float32 tensor")
    if xt.dim() != 2:
        raise ValueError("ordered_sum takes the (K, M) terms, reduced "
                         "axis first")
    if not xt.is_contiguous():
        raise ValueError("ordered_sum takes a contiguous tensor")


def ordered_sum(xt: torch.Tensor) -> torch.Tensor:
    """(M,) float32: out[m] = sum over k of xt[k, m], added in order of
    k from a float32 zero."""
    _check(xt)
    if xt.device.type == "cpu":
        return osum_plain(xt)
    if xt.device.type != "cuda":
        raise ValueError(f"ordered_sum: unsupported device {xt.device}")
    k, m = xt.shape
    out = torch.empty((m,), dtype=torch.float32, device=xt.device)
    if m == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(xt.device).cuda_stream
    check(lib.ordered_sum_launch(xt.data_ptr(), out.data_ptr(), k, m,
                                 stream), "ordered_sum")
    count_launch(ordered_sum, (k, m))
    return out


def ordered_sum_lanes(xt: torch.Tensor, n: int) -> torch.Tensor:
    """K3's lane mode: (M,) float32 sums of the (n*n, M) terms, each
    column an n x n block in row-major order, in the order of
    ops.numeric.lanes_sum_plain.  Its launches count as ordered_sum's,
    keyed ("lanes", n, M)."""
    _check(xt)
    if xt.shape[0] != n * n or not (n in (1, 2, 4, 8) or n % 8 == 0):
        raise ValueError(f"ordered_sum_lanes: {tuple(xt.shape)} terms are "
                         f"not n x n blocks with n = {n} in 1, 2, 4 or a "
                         "multiple of 8")
    if xt.device.type == "cpu":
        return lanes_sum_plain(xt, n)
    if xt.device.type != "cuda":
        raise ValueError(f"ordered_sum_lanes: unsupported device "
                         f"{xt.device}")
    m = xt.shape[1]
    out = torch.empty((m,), dtype=torch.float32, device=xt.device)
    if m == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(xt.device).cuda_stream
    check(lib.ordered_sum_lanes_launch(xt.data_ptr(), out.data_ptr(), n, m,
                                       stream), "ordered_sum_lanes")
    count_launch(ordered_sum, ("lanes", n, m))
    return out


ordered_sum.launches = 0
ordered_sum.launches_by_shape = {}  # (K, M) or ("lanes", n, M) -> launches
