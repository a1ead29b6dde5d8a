"""K3: float32 row sums with the terms added strictly in index order
(CUDA source csrc/ordered_sum.cu).  It ports no TPU kernel: it gives the
port the summation order of the reference's CPU backend where that order
is known (ops.numeric.osum).

`ordered_sum` dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version (ops.numeric.osum_plain), a CUDA tensor launches
the kernel (or raises)."""
from __future__ import annotations

import torch

from ..numeric import osum_plain
from .build import check, load_library


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
    ordered_sum.launches += 1
    key = (k, m)
    ordered_sum.launches_by_shape[key] = \
        ordered_sum.launches_by_shape.get(key, 0) + 1
    return out


ordered_sum.launches = 0
ordered_sum.launches_by_shape = {}  # (K, M) -> launches
