"""K1: fused integer full search (port of the TPU kernel
x265_mod_by_patman_tpu/ops/pallas/sad.py together with the cost and
argmin of its caller full_search_batch_pallas; CUDA source
csrc/full_search.cu).

`full_search` dispatches on the tensors' device: CPU tensors take the
plain PyTorch chain `full_search_plain` (window gather, SAD grid, the
lambda * mv_bits charge and the first-minimum argmin), CUDA tensors
launch the one fused kernel (or raise).  Optional per-block fullpel
window centres (the HME seeds of the reference's center_x / center_y)
move each search window; the MVs include the shift."""
from __future__ import annotations

import functools

import torch

from .build import check, count_launch, load_library
from .gather import window_gather_plain

I32 = torch.int32
KERNEL_N = (8, 16)       # block sizes the CUDA kernel is instantiated for
EXACT_SUM = 1 << 24      # fp32 holds every integer SAD below this


@functools.lru_cache(maxsize=None)
def _pow2(device) -> torch.Tensor:
    return torch.tensor([1 << k for k in range(31)], dtype=torch.int64,
                        device=device)


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """bit_length(|v|), exactly, as int32."""
    a = torch.abs(v.to(torch.int64)).contiguous()
    return torch.searchsorted(_pow2(a.device), a, right=True).to(I32)


def mv_bits(dx, dy):
    """MVD bit estimate 2*ceil(log2(|v|+1)) + 1 per component (qpel units),
    in integers: ceil(log2(|v|+1)) == bit_length(|v|)."""
    return 2 * _bit_length(dx) + 1 + 2 * _bit_length(dy) + 1


def sad_grid_plain(win: torch.Tensor, org: torch.Tensor, n: int,
                   r: int) -> torch.Tensor:
    """Plain PyTorch SAD grid: win (B, n+2r, n+2r), org (B, n, n) int32 ->
    (B, (2r+1)^2) int32, row-major over (dy, dx)."""
    b = win.shape[0]
    c = 2 * r + 1
    rows = []
    for dy in range(c):
        strip = win[:, dy:dy + n, :].unfold(2, n, 1)   # (B, n, c, n)
        d = torch.abs(strip - org[:, :, None, :])
        rows.append(d.sum((1, 3), dtype=torch.int32))
    return torch.stack(rows, 1).reshape(b, c * c)


def full_search_plain(ref, orig, x0, y0, pred_mv_x, pred_mv_y,
                      lambda_x256: int, n: int, r: int, center_x=None,
                      center_y=None):
    """Plain PyTorch full search: (mv_x, mv_y, cost) int32 (B,), MVs in
    QPEL units, cost = SAD + (lambda_x256 * bits) >> 8, first minimum in
    (dy, dx) row-major order.  center_x / center_y: optional (B,)
    FULLPEL window centres (HME seeds): the window moves to
    (x0 + cx, y0 + cy) +- r and the MVs include the shift."""
    dev = ref.device
    cx = torch.zeros_like(x0) if center_x is None else center_x
    cy = torch.zeros_like(y0) if center_y is None else center_y
    win = window_gather_plain(ref, y0 + cy - r, x0 + cx - r, n + 2 * r)
    org = window_gather_plain(orig, y0, x0, n)
    c = 2 * r + 1
    sad = sad_grid_plain(win, org, n, r)
    ar = torch.arange(c, device=dev, dtype=I32)
    mv_x = (ar.repeat(c)[None, :] - r + cx[:, None]) * 4
    mv_y = (ar.repeat_interleave(c)[None, :] - r + cy[:, None]) * 4
    bits = mv_bits(mv_x - pred_mv_x[:, None], mv_y - pred_mv_y[:, None])
    cost = sad + ((lambda_x256 * bits) >> 8)
    arg = torch.argmin(cost, dim=1)
    bi = torch.arange(cost.shape[0], device=dev)
    return mv_x[bi, arg], mv_y[bi, arg], cost[bi, arg].to(I32)


def _check(ref, orig, vecs, n: int, r: int) -> None:
    if any(t.dtype != I32 for t in (ref, orig, *vecs)):
        raise TypeError("full_search takes int32 tensors")
    if ref.dim() != 2 or tuple(orig.shape) != tuple(ref.shape):
        raise ValueError("full_search takes two (H, W) planes of one shape")
    if any(v.dim() != 1 or v.shape != vecs[0].shape for v in vecs):
        raise ValueError("full_search takes (B,) origins and predictors")
    if not all(t.is_contiguous() for t in (ref, orig, *vecs)):
        raise ValueError("full_search takes contiguous tensors")
    if any(t.device != ref.device for t in (orig, *vecs)):
        raise ValueError("planes, origins and predictors must be on one "
                         "device")
    if not (1 <= n <= 64 and 0 <= r <= 63):
        raise ValueError("full_search supports n <= 64 and r <= 63")


def full_search(ref, orig, x0, y0, pred_mv_x, pred_mv_y, lambda_x256: int,
                n: int, r: int, center_x=None, center_y=None):
    """Integer full search of (B,) n x n blocks at (x0, y0) over +-r on
    the (H, W) int32 planes, optionally around fullpel window centres;
    see full_search_plain."""
    centers = (center_x, center_y)
    if (center_x is None) != (center_y is None):
        raise ValueError("full_search takes both window centres or none")
    vecs = (x0, y0, pred_mv_x, pred_mv_y) + \
        (centers if center_x is not None else ())
    _check(ref, orig, vecs, n, r)
    if ref.device.type == "cpu":
        return full_search_plain(ref, orig, x0, y0, pred_mv_x, pred_mv_y,
                                 lambda_x256, n, r, center_x, center_y)
    if ref.device.type != "cuda":
        raise ValueError(f"full_search: unsupported device {ref.device}")
    if n not in KERNEL_N:
        raise ValueError(f"the full_search kernel takes n in {KERNEL_N}")
    if not torch.cuda.is_current_stream_capturing():
        # the kernel sums absolute differences in fp32 (full_search.cu):
        # exact while n^2 * (largest sample) < 2^24.  A CUDA graph under
        # capture cannot read the planes back; it records the launch
        # only, and its replays run on the planes of the capture.
        top = int(torch.maximum(ref.max(), orig.max()))
        if n * n * top >= EXACT_SUM:
            raise ValueError(f"full_search: n^2 * {top} reaches 2^24; "
                             "fp32 SAD sums would no longer be exact")
    b = x0.shape[0]
    h, w = ref.shape
    mx, my, cost = (torch.empty(b, dtype=I32, device=ref.device)
                    for _ in range(3))
    lib = load_library()
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    cptr = [None if c is None else c.data_ptr() for c in centers]
    check(lib.full_search_launch(
        ref.data_ptr(), orig.data_ptr(), h, w, x0.data_ptr(), y0.data_ptr(),
        pred_mv_x.data_ptr(), pred_mv_y.data_ptr(), cptr[0], cptr[1],
        int(lambda_x256),
        mx.data_ptr(), my.data_ptr(), cost.data_ptr(), b, n, r, stream),
        "full_search")
    count_launch(full_search, (n, r, h, w))
    return mx, my, cost


full_search.launches = 0
full_search.launches_by_shape = {}    # (n, r, H, W) -> launches
