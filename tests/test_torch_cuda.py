"""The port's CUDA kernels on a card (skipped without one): each kernel
against its plain PyTorch twin on the same device tensors, the launch
counters, the lookahead lattice, B analysis and cuTree's lowres inter
costs on the card against the CPU, and card encodes (CQP, and CRF with
AQ and cuTree) that must give the CPU's bytes.  The GPU
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


@pytest.mark.parametrize("size", [1, 8, 11, 15, 16, 17, 23, 25, 48, 70])
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


def test_card_lattice_and_b_analysis_equal_cpu(dev):
    """The slicetype lattice (K1 at n = 8, K2 windows of 8, 15, 17 on
    the lowres planes) and B analysis on the card give the CPU's
    numbers."""
    from x265_mod_by_patman_tpu_torch.analysis.inter_mode import \
        analyse_b_frame
    from x265_mod_by_patman_tpu_torch.analysis.slicetype import \
        SlicetypeLookahead
    from x265_mod_by_patman_tpu_torch.bitstream.headers import \
        build_sps_info
    from x265_mod_by_patman_tpu_torch.params import default_params
    rng = np.random.default_rng(1)
    world = rng.integers(0, 256, (80, 128)).astype(np.int32)
    world = (world + np.roll(world, 1, 0) + np.roll(world, 1, 1)) // 3
    frames = [(world[i:i + 64, 3 * i:3 * i + 96].astype(np.uint8),
               np.full((32, 48), 100 + i, np.uint8),
               np.full((32, 48), 140 - i, np.uint8)) for i in range(5)]
    got = []
    for d in (dev, torch.device("cpu")):
        st = SlicetypeLookahead(96, 64, 4, 2, device=d)
        for i, f in enumerate(frames):
            st.push(i, f[0])
        k = st.decide_gop(0, [1, 2, 3, 4])
        sps = build_sps_info(default_params(96, 64).validate())
        kernels.reset_counts()
        out = analyse_b_frame(*frames[2], [frames[1], frames[0]],
                              [frames[3], frames[4]], sps, 32, d)
        if d.type == "cuda":
            assert min(kernels.counts().values()) > 0
        got.append((k, dict(st._cost), [np.asarray(a) for a in out[:7]],
                    [m.cpu().numpy() for m in out[7]]))
    (k_g, c_g, o_g, m_g), (k_c, c_c, o_c, m_c) = got
    assert k_g == k_c and c_g == c_c
    for a, b in zip(o_g + m_g, o_c + m_c):
        assert np.array_equal(a, b)


def test_card_default_encode_equals_cpu(dev):
    """The repo defaults: B pictures, the b-adapt 2 lookahead, pyramid."""
    from x265_mod_by_patman_tpu_torch.encoder.top import encode_sequence
    from x265_mod_by_patman_tpu_torch.params import default_params
    rng = np.random.default_rng(2)
    world = rng.integers(0, 256, (80, 128)).astype(np.int32)
    world = (world + np.roll(world, 1, 0) + np.roll(world, 1, 1)) // 3
    frames = [(world[i:i + 64, 3 * i:3 * i + 96].astype(np.uint8),
               np.full((32, 48), 100 + i, np.uint8),
               np.full((32, 48), 140 - i, np.uint8)) for i in range(6)]
    s_gpu, e_gpu = encode_sequence(default_params(96, 64), frames, dev)
    s_cpu, _ = encode_sequence(default_params(96, 64), frames, "cpu")
    assert "B" in [f.slice_type for f in e_gpu]
    assert s_gpu == s_cpu


def test_card_inter_costs_equal_cpu(dev):
    """cuTree's lowres inter costs (K1 at n = 8, K2 windows of 8) on the
    card give the CPU's costs and motion vectors."""
    from x265_mod_by_patman_tpu_torch.analysis.lookahead import (
        LowresStore, _inter_costs)
    rng = np.random.default_rng(3)
    world = rng.integers(0, 256, (80, 128)).astype(np.int32)
    world = (world + np.roll(world, 1, 0) + np.roll(world, 1, 1)) // 3
    ys = [world[i:i + 64, 3 * i:3 * i + 96].astype(np.uint8)
          for i in range(2)]
    got = []
    for d in (dev, torch.device("cpu")):
        st = LowresStore(96, 64, d)
        for i, y in enumerate(ys):
            st.ensure(i, y)
        kernels.reset_counts()
        out = _inter_costs(st.low(1), st.low(0), st.nby, st.nbx)
        if d.type == "cuda":
            assert min(kernels.counts().values()) > 0
        got.append([a.cpu().numpy() for a in out])
    for a, b in zip(*got):
        assert np.array_equal(a, b)


def test_card_crf_aq_cutree_encode_equals_cpu(dev):
    """CRF 28 with AQ 2 and cuTree at the repo defaults."""
    from x265_mod_by_patman_tpu_torch.encoder.top import encode_sequence
    from x265_mod_by_patman_tpu_torch.params import default_params
    rng = np.random.default_rng(4)
    world = rng.integers(0, 256, (80, 128)).astype(np.int32)
    world = (world + np.roll(world, 1, 0) + np.roll(world, 1, 1)) // 3
    frames = [(world[i:i + 64, 3 * i:3 * i + 96].astype(np.uint8),
               np.full((32, 48), 100 + i, np.uint8),
               np.full((32, 48), 140 - i, np.uint8)) for i in range(6)]
    p = lambda: default_params(96, 64, rc_mode="crf", crf=28.0, aq_mode=2)
    s_gpu, e_gpu = encode_sequence(p(), frames, dev)
    s_cpu, _ = encode_sequence(p(), frames, "cpu")
    assert "B" in [f.slice_type for f in e_gpu]
    assert s_gpu == s_cpu
