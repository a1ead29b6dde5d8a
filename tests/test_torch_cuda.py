"""The port's CUDA kernels on a card (skipped without one): each kernel
against its plain PyTorch twin on the same device tensors (K3 also in a
card encode and the batched all-intra path), the launch
counters, the lookahead lattice, B analysis and cuTree's lowres inter
costs on the card against the CPU, K1 on 12-bit planes and its fp32
bound, K1 around HME window centres, and card encodes (CQP, CRF with AQ
and cuTree, Main10 CRF under a VBV with HRD, --preset slow --hme
in row bands, AMP in P and B, weighted B with --me sea, NxN with TU4,
scaling lists and NR, lossless) that must give the CPU's bytes, and the
SEA search on the card against the CPU.  The GPU
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


def _k1_k2_launched() -> bool:
    c = kernels.counts()
    return c["full_search"] > 0 and c["window_gather"] > 0


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
        assert kernels.counts_by_shape()["full_search"] == {(n, r, h, w): 1}
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
    assert kernels.counts_by_shape()["window_gather"] == {(size, 72, 130): 1}
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
    assert _k1_k2_launched()
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
            assert _k1_k2_launched()
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
            assert _k1_k2_launched()
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


@pytest.mark.parametrize("n,top", [(8, 4095), (16, 4095)])
def test_full_search_kernel_on_12bit_planes_and_its_bound(dev, n, top):
    """12-bit samples stay exact in the kernel's fp32 sums (n^2 * 4095 <
    2^24); a plane whose n^2 * max reaches 2^24 is refused."""
    rng = np.random.default_rng(n)
    h, w = 72, 130
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ref = t(rng.integers(0, top + 1, (h, w), dtype=np.int32))
    org = t(rng.integers(0, top + 1, (h, w), dtype=np.int32))
    x0 = t(rng.integers(-n, w, 20, dtype=np.int32))
    y0 = t(rng.integers(-n, h, 20, dtype=np.int32))
    z = torch.zeros_like(x0)
    got = full_search(ref, org, x0, y0, z, z, 700, n, 16)
    exp = full_search_plain(ref, org, x0, y0, z, z, 700, n, 16)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    big = torch.full_like(ref, (1 << 24) // (n * n))
    with pytest.raises(ValueError, match="2\\^24"):
        full_search(big, org, x0, y0, z, z, 700, n, 16)


def test_card_main10_vbv_hrd_encode_equals_cpu(dev):
    """Main10 CRF 28 with AQ 2 and cuTree under a VBV with HRD, tight
    enough that pictures re-encode."""
    from x265_mod_by_patman_tpu_torch.encoder.top import encode_sequence
    from x265_mod_by_patman_tpu_torch.params import default_params
    rng = np.random.default_rng(5)
    world = rng.integers(0, 1024, (80, 128)).astype(np.int32)
    world = (world + np.roll(world, 1, 0) + np.roll(world, 1, 1)) // 3
    # noise from frame 3 on busts the buffer
    frames = [(world[i:i + 64, 3 * i:3 * i + 96].astype(np.uint16)
               if i < 3 else rng.integers(0, 1024, (64, 96)).astype(
                   np.uint16),
               np.full((32, 48), 400 + i, np.uint16),
               np.full((32, 48), 560 - i, np.uint16)) for i in range(6)]
    p = lambda: default_params(96, 64, rc_mode="crf", crf=28.0, aq_mode=2,
                               internal_bit_depth=10, vbv_bufsize=60,
                               vbv_maxrate=60, hrd=True)
    s_gpu, e_gpu = encode_sequence(p(), frames, dev)
    s_cpu, _ = encode_sequence(p(), frames, "cpu")
    assert max(f.pipeline_runs for f in e_gpu) > 1
    assert s_gpu == s_cpu


@pytest.mark.parametrize("n,r", [(16, 32), (8, 32), (8, 16)])
def test_full_search_kernel_with_window_centres_equals_plain(dev, n, r):
    """HME window centres (up to +-5 r, so windows clamp on every edge)
    at the slow path's shapes."""
    rng = np.random.default_rng(n + r)
    h, w, b = 96, 160, 37
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ref = t(rng.integers(0, 256, (h, w), dtype=np.int32))
    org = t(rng.integers(0, 256, (h, w), dtype=np.int32))
    x0 = t(rng.integers(-n, w, b, dtype=np.int32))
    y0 = t(rng.integers(-n, h, b, dtype=np.int32))
    cx = t(rng.integers(-5 * r, 5 * r + 1, b, dtype=np.int32))
    cy = t(rng.integers(-5 * r, 5 * r + 1, b, dtype=np.int32))
    z = torch.zeros_like(x0)
    kernels.reset_counts()
    got = full_search(ref, org, x0, y0, z, z, 400, n, r, cx, cy)
    assert kernels.counts()["full_search"] == 1
    exp = full_search_plain(ref, org, x0, y0, z, z, 400, n, r, cx, cy)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


def test_card_slow_preset_encode_equals_cpu(dev):
    """--preset slow --hme (rect PUs, RDOQ with sign hiding, star search)
    under CRF with a VBV, in row bands: the card gives the CPU's bytes."""
    from x265_mod_by_patman_tpu_torch.analysis import inter_mode
    from x265_mod_by_patman_tpu_torch.encoder.top import encode_sequence
    from x265_mod_by_patman_tpu_torch.params import default_params

    def bands(sps, block, sr):
        nby = sps.height // block
        if nby * (sps.width // block) <= 16:
            return None
        return [(r0, min(nby, r0 + 2), min(1, r0), min(1, nby - r0 - 2))
                for r0 in range(0, nby, 2)]

    rng = np.random.default_rng(6)
    world = rng.integers(0, 256, (112, 200)).astype(np.int32)
    world = (world + np.roll(world, 1, 0) + np.roll(world, 1, 1)) // 3
    frames = [(world[2 * i:2 * i + 96, 9 * i:9 * i + 128].astype(np.uint8),
               np.full((48, 64), 120, np.uint8),
               np.full((48, 64), 130, np.uint8)) for i in range(6)]

    def p():
        q = default_params(128, 96, rc_mode="crf", crf=24.0)
        q.apply_preset("slow")
        q.hme, q.rc_lookahead, q.vbv_bufsize, q.vbv_maxrate = True, 8, 80, 80
        return q
    orig = inter_mode._analysis_bands
    inter_mode._analysis_bands = bands
    try:
        s_gpu, _ = encode_sequence(p(), frames, dev)
        s_cpu, _ = encode_sequence(p(), frames, "cpu")
    finally:
        inter_mode._analysis_bands = orig
    assert s_gpu == s_cpu


def test_sea_search_on_card_equals_cpu(dev):
    """The SEA-pruned search (torch ops on the tensors' device) at the
    analysis shape n = 16, r = 32, k = 64: the card's MVs and costs equal
    the CPU's (the top-k selection runs on unique keys, so ties at the
    k-th bound cannot differ between devices)."""
    from x265_mod_by_patman_tpu_torch.ops.sea import sea_search_batch
    rng = np.random.default_rng(8)
    h, w, n = 128, 192, 16
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    ref = (ref + np.roll(ref, 1, 0) + np.roll(ref, 1, 1)) // 3
    org = np.clip(np.roll(ref, (5, -9), (0, 1))
                  + rng.integers(-4, 5, (h, w)), 0, 255).astype(np.int32)
    bys, bxs = np.mgrid[0:h // n, 0:w // n]
    cols = [(bxs.ravel() * n).astype(np.int32),
            (bys.ravel() * n).astype(np.int32)]
    cols += [rng.integers(-60, 60, bys.size).astype(np.int32)] * 2
    for plane in (ref, np.full_like(ref, 77)):
        args = [plane, org if plane is ref else plane] + cols
        out = [sea_search_batch(*[torch.from_numpy(a).to(d) for a in args],
                                900, n, 32, k=64) for d in (dev, "cpu")]
        for g, c in zip(*out):
            assert torch.equal(g.cpu(), c)


def _quarter_strip(w, h, n):
    """tests/test_amp_pu.py's quarter-strip scene (horizontal boundary at
    y = 36), made here without the reference package."""
    rng = np.random.default_rng(11)
    big = rng.integers(0, 255, (h + 128, w + 128)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, (1, 1), (0, 1))) // 4
    out = []
    for i in range(n):
        y = np.array(big[16 + 2 * i:16 + 2 * i + h, 16:16 + w])
        y[:36] = big[16:52, 16 + 3 * i:16 + 3 * i + w]
        out.append((np.clip(y, 0, 255).astype(np.uint8),
                    np.full((h // 2, w // 2), 120, np.uint8),
                    np.full((h // 2, w // 2), 132, np.uint8)))
    return out


def _fade(w, h, n, fade=0.82):
    """tests/test_weightb.py's fade, made here at w x h."""
    rng = np.random.default_rng(9)
    base = rng.integers(40, 230, (h, w)).astype(np.float64)
    return [(np.clip(np.roll(base, i, axis=1) * fade ** i, 0, 255)
             .astype(np.uint8), np.full((h // 2, w // 2), 120, np.uint8),
             np.full((h // 2, w // 2), 136, np.uint8)) for i in range(n)]


@pytest.mark.parametrize("case", ["amp_quarter_strip", "weightb_sea_fade"])
def test_card_inter_tools_encode_equals_cpu(dev, case):
    """AMP in P and B (the quarter-strip scene, I P B B P) and weighted B
    with the SEA search (a fade): the card gives the CPU's bytes."""
    from x265_mod_by_patman_tpu_torch.encoder.top import encode_sequence
    from x265_mod_by_patman_tpu_torch.params import default_params
    if case == "amp_quarter_strip":
        frames = _quarter_strip(96, 64, 5)
        p = lambda: default_params(96, 64, qp=30, keyframe_max=250,
                                   bframes=2, b_adapt=0, rect=True, amp=True,
                                   sao=False, scenecut=False, cu_tree=False,
                                   aq_mode=0)
    else:
        frames = _fade(96, 64, 7)
        p = lambda: default_params(96, 64, qp=30, keyframe_max=250,
                                   bframes=2, b_adapt=0, scenecut=False,
                                   cu_tree=False, aq_mode=0, weightb=True,
                                   search_method="sea")
    s_gpu, e_gpu = encode_sequence(p(), frames, dev)
    s_cpu, _ = encode_sequence(p(), frames, "cpu")
    assert s_gpu == s_cpu
    if case == "amp_quarter_strip":
        for t in ("P", "B"):
            assert any(f.stats.get("cu_amp_pct", 0) > 0 for f in e_gpu
                       if f.slice_type == t), t


def _park(w, h, n):
    """The park clip of tools/make_clips.py (uint8 y, u, v frames)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "make_clips.py")
    spec = importlib.util.spec_from_file_location("make_clips", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [tuple(p.astype(np.uint8) for p in f)
            for f in mod.make_park(w, h, n)]


@pytest.mark.parametrize("case", ["nxn_tu4_lists_nr", "lossless"])
def test_card_residual_options_encode_equals_cpu(dev, case):
    """The residual-side options at 416x240 on park: chip_smoke.py phase
    9a's combination (CRF 24, AQ 2, NxN with TU4, the default scaling
    lists, NR 200/400; I P B) and --lossless with 2 B-frames: the card
    gives the CPU's bytes, and the lossless recon is the source."""
    from x265_mod_by_patman_tpu_torch.encoder.top import encode_sequence
    from x265_mod_by_patman_tpu_torch.params import default_params
    frames = _park(416, 240, 3)
    if case == "lossless":
        p = lambda: default_params(416, 240, qp=30, bframes=2, b_adapt=0,
                                   lossless=True)
    else:
        p = lambda: default_params(416, 240, rc_mode="crf", crf=24.0,
                                   aq_mode=2, nxn_intra=True,
                                   tu_intra_depth=2, scaling_list="default",
                                   nr_intra=200, nr_inter=400)
    s_gpu, e_gpu = encode_sequence(p(), frames, dev)
    s_cpu, _ = encode_sequence(p(), frames, "cpu")
    assert s_gpu == s_cpu
    assert [f.slice_type for f in e_gpu] == ["I", "P", "B"]
    if case == "lossless":
        for f in e_gpu:
            for a, b in zip(f.recon, frames[f.disp]):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("k,m", [(1, 1), (4, 2040), (16, 510), (1024, 510),
                                 (510, 1), (7, 100003)])
def test_ordered_sum_kernel_equals_plain(dev, k, m):
    """K3 against osum_plain on the card: the same float32 bits."""
    from x265_mod_by_patman_tpu_torch.ops.cuda.ordered_sum import \
        ordered_sum
    from x265_mod_by_patman_tpu_torch.ops.numeric import osum_plain
    rng = np.random.default_rng(k * 7 + m)
    xt = torch.from_numpy((rng.random((k, m)) * rng.choice(
        [1.0, 1e3, 1e6], (k, m))).astype(np.float32)).to(dev)
    kernels.reset_counts()
    got = ordered_sum(xt, 0)
    assert kernels.counts()["ordered_sum"] == 1
    assert torch.equal(got, osum_plain(xt))


@pytest.mark.parametrize("n,m", [(4, 130560), (8, 32640), (16, 8160),
                                 (32, 2040), (16, 1)])
def test_ordered_sum_lanes_equals_plain(dev, n, m):
    """K3's lane mode against lanes_sum_plain on the card: the same
    float32 bits, one launch counted under ordered_sum."""
    from x265_mod_by_patman_tpu_torch.ops.cuda.ordered_sum import \
        ordered_sum_lanes
    from x265_mod_by_patman_tpu_torch.ops.numeric import lanes_sum_plain
    rng = np.random.default_rng(n * 5 + m)
    x = torch.from_numpy((rng.random((m, n, n)) * rng.choice(
        [1.0, 1e2, 1e5], (m, n, n))).astype(np.float32)).to(dev)
    kernels.reset_counts()
    got = ordered_sum_lanes(x, n)
    assert kernels.counts()["ordered_sum"] == 1
    assert torch.equal(got, lanes_sum_plain(x.reshape(m, n * n).T, n))


@pytest.mark.parametrize("n,lanes,span,m", [
    (8, 8, 8, 8160), (8, 4, 8, 8160), (16, 8, 8, 8160), (16, 8, 16, 8160),
    (32, 8, 32, 2040), (8, 4, 8, 1), (16, 4, 12, 8), (32, 8, 16, 8),
    (32, 16, 32, 2048), (32, 16, 32, 37)])
def test_ordered_sum_chained_equals_plain(dev, n, lanes, span, m):
    """K3's chained lane mode against chain_sum_plain on the card: the
    same float32 bits, one launch counted under ordered_sum."""
    from x265_mod_by_patman_tpu_torch.ops.cuda.ordered_sum import \
        ordered_sum_chained
    from x265_mod_by_patman_tpu_torch.ops.numeric import chain_sum_plain
    rng = np.random.default_rng(n * 5 + lanes + m)
    x = torch.from_numpy((rng.random((m, n, n)) * rng.choice(
        [1.0, 1e2, 1e5], (m, n, n))).astype(np.float32)).to(dev)
    kernels.reset_counts()
    got = ordered_sum_chained(x, n, lanes, span)
    assert kernels.counts()["ordered_sum"] == 1
    assert torch.equal(got, chain_sum_plain(x.reshape(m, n * n).T, n,
                                            lanes, span))


def test_card_intra_batched_equals_cpu(dev):
    """encode_intra_batched on the card (K3 in its CTU group sums) gives
    the CPU's bytes."""
    from x265_mod_by_patman_tpu_torch.encoder.top import Encoder
    from x265_mod_by_patman_tpu_torch.params import default_params
    rng = np.random.default_rng(4)
    frames = [(rng.integers(0, 256, (64, 96)).astype(np.uint8),
               np.full((32, 48), 100 + i, np.uint8),
               np.full((32, 48), 140 - i, np.uint8)) for i in range(3)]
    p = lambda: default_params(96, 64, qp=32, keyframe_max=1, ctu_size=32,
                               rd_level=2, sao=False)
    kernels.reset_counts()
    got = Encoder(p(), dev).encode_intra_batched(frames, batch=2)
    assert kernels.counts()["ordered_sum"] > 0
    ref = Encoder(p(), "cpu").encode_intra_batched(frames, batch=2)
    assert [f.bitstream for f in got] == [f.bitstream for f in ref]
