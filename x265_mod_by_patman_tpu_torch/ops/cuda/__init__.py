"""Hand-written Hopper kernels of the port (counterpart of the
reference's ops/pallas): K1 `full_search.full_search` (the SAD grid
fused with its caller's cost and argmin), K2 `gather.window_gather`;
and K3 `ordered_sum.ordered_sum`, the float32 row sums in index order
that ops.numeric.osum runs on the card (it ports no TPU kernel)."""
from __future__ import annotations

from .gather import window_gather
from .full_search import full_search
from .ordered_sum import ordered_sum

KERNELS = {"full_search": full_search, "window_gather": window_gather,
           "ordered_sum": ordered_sum}


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.launches_by_shape.clear()


def counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def counts_by_shape() -> dict:
    """Launches per kernel by shape: full_search's keyed by (n, r, H, W),
    window_gather's by (size, H, W), ordered_sum's by (K, M)."""
    return {name: dict(fn.launches_by_shape) for name, fn in KERNELS.items()}
