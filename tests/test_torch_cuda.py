"""The port's CUDA kernels on a card (skipped without one): each kernel
against its plain PyTorch twin on the same device tensors, the launch
counters, and a card encode that must give the CPU's bytes.  The GPU
machine has no JAX, which tests/conftest.py imports, so run them there
with `python -m pytest --noconftest tests/test_torch_cuda.py -q`.

Tolerance: exact (integers and bytes)."""
import numpy as np
import pytest
import torch

from x265_mod_by_patman_tpu_torch.ops import cuda as kernels
from x265_mod_by_patman_tpu_torch.ops.cuda.gather import (
    window_gather, window_gather_plain)
from x265_mod_by_patman_tpu_torch.ops.cuda.full_search import (
    full_search, full_search_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,n,r,kind", [
    (5, 8, 4, "random"), (33, 16, 16, "random"), (4, 16, 63, "random"),
    (40, 16, 16, "constant"), (9, 8, 4, "constant")])
def test_full_search_kernel_equals_plain(dev, b, n, r, kind):
    """Origins anywhere in and around a 72x130 plane (windows clamp on
    every edge); random predictors; a constant plane makes every SAD tie,
    so the first-minimum rule decides."""
    rng = np.random.default_rng(b)
    h, w = 72, 130
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if kind == "constant":
        ref = org = t(np.full((h, w), 200, np.int32))
    else:
        ref = t(rng.integers(0, 256, (h, w), dtype=np.int32))
        org = t(rng.integers(0, 256, (h, w), dtype=np.int32))
    x0 = t(rng.integers(-n, w, b, dtype=np.int32))
    y0 = t(rng.integers(-n, h, b, dtype=np.int32))
    pmx = t(rng.integers(-90, 90, b, dtype=np.int32))
    pmy = t(rng.integers(-90, 90, b, dtype=np.int32))
    for lam in (0, 1, 350):
        kernels.reset_counts()
        got = full_search(ref, org, x0, y0, pmx, pmy, lam, n, r)
        assert kernels.counts()["full_search"] == 1
        exp = full_search_plain(ref, org, x0, y0, pmx, pmy, lam, n, r)
        for g, e in zip(got, exp):
            assert torch.equal(g, e), (lam, g, e)


@pytest.mark.parametrize("size", [1, 11, 16, 23, 25, 48, 70])
def test_window_gather_kernel_equals_plain(dev, size):
    rng = np.random.default_rng(size)
    plane = torch.from_numpy(rng.integers(0, 256, (72, 130),
                                          dtype=np.int32)).to(dev)
    # 203 windows: CTAs end at windows whose output starts are not
    # 16-byte aligned
    ys = torch.from_numpy(rng.integers(-90, 160, 203,
                                       dtype=np.int32)).to(dev)
    xs = torch.from_numpy(rng.integers(-90, 220, 203,
                                       dtype=np.int32)).to(dev)
    kernels.reset_counts()
    got = window_gather(plane, ys, xs, size)
    assert kernels.counts()["window_gather"] == 1
    assert torch.equal(got, window_gather_plain(plane, ys, xs, size))


def test_card_encode_equals_cpu(dev):
    from x265_mod_by_patman_tpu_torch.encoder.top import encode_sequence
    from x265_mod_by_patman_tpu_torch.params import default_params
    rng = np.random.default_rng(0)
    world = rng.integers(0, 256, (80, 128)).astype(np.int32)
    world = (world + np.roll(world, 1, 0) + np.roll(world, 1, 1)) // 3
    frames = [(world[i:i + 64, 3 * i:3 * i + 96].astype(np.uint8),
               np.full((32, 48), 100 + i, np.uint8),
               np.full((32, 48), 140 - i, np.uint8)) for i in range(3)]
    p = lambda: default_params(96, 64, qp=30, bframes=0)
    kernels.reset_counts()
    s_gpu, _ = encode_sequence(p(), frames, dev)
    assert min(kernels.counts().values()) > 0
    s_cpu, _ = encode_sequence(p(), frames, "cpu")
    assert s_gpu == s_cpu
