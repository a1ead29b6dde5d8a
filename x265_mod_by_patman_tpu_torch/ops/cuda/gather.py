"""K2: per-block clamped window gather (port of the TPU kernel
x265_mod_by_patman_tpu/ops/pallas/gather.py; CUDA source
csrc/window_gather.cu).

`window_gather` dispatches on the tensors' device: CPU tensors take the
plain PyTorch version, CUDA tensors launch the kernel (or raise)."""
from __future__ import annotations

import torch

from .build import check, count_launch, load_library


def window_gather_plain(plane: torch.Tensor, ys: torch.Tensor,
                        xs: torch.Tensor, size: int) -> torch.Tensor:
    """out[b, i, j] = plane[clamp(ys[b]+i, 0, H-1), clamp(xs[b]+j, 0, W-1)]
    as (B, size, size) int32."""
    h, w = plane.shape
    ar = torch.arange(size, device=plane.device)
    gy = torch.clip(ys.long()[:, None, None] + ar[None, :, None], 0, h - 1)
    gx = torch.clip(xs.long()[:, None, None] + ar[None, None, :], 0, w - 1)
    return plane[gy, gx].to(torch.int32)


def _check(plane, ys, xs, size: int) -> None:
    if plane.dtype != torch.int32 or ys.dtype != torch.int32 or \
            xs.dtype != torch.int32:
        raise TypeError("window_gather takes int32 tensors")
    if plane.dim() != 2 or ys.dim() != 1 or tuple(xs.shape) != \
            tuple(ys.shape):
        raise ValueError("window_gather takes a (H, W) plane and (B,) "
                         "starts")
    if not (plane.is_contiguous() and ys.is_contiguous()
            and xs.is_contiguous()):
        raise ValueError("window_gather takes contiguous tensors")
    if not (plane.device == ys.device == xs.device):
        raise ValueError("plane and starts must be on one device")
    if size <= 0:
        raise ValueError("window size must be positive")


def window_gather(plane: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                  size: int) -> torch.Tensor:
    """(B, size, size) int32 windows read at (ys, xs) with edge clamping."""
    _check(plane, ys, xs, size)
    if plane.device.type == "cpu":
        return window_gather_plain(plane, ys, xs, size)
    if plane.device.type != "cuda":
        raise ValueError(f"window_gather: unsupported device {plane.device}")
    b = ys.shape[0]
    h, w = plane.shape
    out = torch.empty((b, size, size), dtype=torch.int32,
                      device=plane.device)
    lib = load_library()
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    check(lib.window_gather_launch(plane.data_ptr(), ys.data_ptr(),
                                   xs.data_ptr(), out.data_ptr(), b, h, w,
                                   size, stream), "window_gather")
    count_launch(window_gather, (size, h, w))
    return out


window_gather.launches = 0
window_gather.launches_by_shape = {}  # (size, H, W) -> launches
