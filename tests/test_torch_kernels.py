"""K1 (fused full search) and K2 (window gather) of the PyTorch port:
their plain versions against the reference's Pallas kernels (run in
interpret mode, as the reference's own tests run them), the full search
against the reference's, dispatch and argument checks, and mv_bits.

Tolerance: every output here is an integer and must match exactly."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_mod_by_patman_tpu.ops import me as jme
from x265_mod_by_patman_tpu.ops.interp import _gather_windows as j_gather
from x265_mod_by_patman_tpu.ops.pallas.gather import (
    MARGIN, pad_plane, window_gather as j_window_gather)
from x265_mod_by_patman_tpu.ops.pallas.sad import sad_grid as j_sad_grid
from x265_mod_by_patman_tpu_torch.convert import to_numpy, to_torch
from x265_mod_by_patman_tpu_torch.ops import cuda as kernels
from x265_mod_by_patman_tpu_torch.ops import me as tme
from x265_mod_by_patman_tpu_torch.ops.cuda.gather import (
    window_gather, window_gather_plain)
from x265_mod_by_patman_tpu_torch.ops.cuda.ordered_sum import (
    ordered_sum, ordered_sum_lanes)
from x265_mod_by_patman_tpu_torch.ops.numeric import lanes_sum_plain, lsum
from x265_mod_by_patman_tpu_torch.ops.cuda.full_search import (
    full_search, sad_grid_plain)
from x265_mod_by_patman_tpu_torch.ops.interp import _gather_windows

CPU = torch.device("cpu")


@pytest.mark.parametrize("b,n,r", [(5, 8, 4), (3, 16, 5)])
def test_sad_grid_plain_matches_pallas_interpret(b, n, r):
    rng = np.random.default_rng(b * 100 + r)
    win = rng.integers(0, 256, (b, n + 2 * r, n + 2 * r)).astype(np.int32)
    org = rng.integers(0, 256, (b, n, n)).astype(np.int32)
    ref = np.asarray(j_sad_grid(jnp.asarray(win), jnp.asarray(org), n, r,
                                interpret=True))
    got = to_numpy(sad_grid_plain(to_torch(win, CPU), to_torch(org, CPU),
                                  n, r))
    np.testing.assert_array_equal(got, ref)


def test_window_gather_plain_matches_pallas_within_margin():
    rng = np.random.default_rng(0)
    h, w, size = 48, 64, 23
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    ys = np.array([-3, 0, 10, h - 5, h + 4, -30], np.int32)
    xs = np.array([-7, 5, 40, w - 3, -1, w + 10], np.int32)
    exp = np.asarray(j_window_gather(
        pad_plane(jnp.asarray(ref)), jnp.asarray(ys + MARGIN),
        jnp.asarray(xs + MARGIN), size, interpret=True))
    got = to_numpy(window_gather(to_torch(ref, CPU), to_torch(ys, CPU),
                                 to_torch(xs, CPU), size))
    np.testing.assert_array_equal(got, exp)


def test_gather_windows_beyond_margin_matches_clamped_path():
    """Starts far outside the 48-px margin: the port clamps every
    coordinate, as the reference's plain (non-Pallas) path does."""
    rng = np.random.default_rng(1)
    h, w, n, nt = 40, 56, 16, 8
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    x0 = np.array([-200, -60, 10, w + 70, 300], np.int32)
    y0 = np.array([-90, h + 100, 5, -1, 250], np.int32)
    exp = np.asarray(j_gather(jnp.asarray(ref), jnp.asarray(x0),
                              jnp.asarray(y0), n, nt, use_pallas=False))
    got = to_numpy(_gather_windows(to_torch(ref, CPU), to_torch(x0, CPU),
                                   to_torch(y0, CPU), n, nt))
    np.testing.assert_array_equal(got, exp)
    plain = to_numpy(window_gather_plain(to_torch(ref, CPU),
                                         to_torch(y0 - 3, CPU),
                                         to_torch(x0 - 3, CPU), n + nt - 1))
    np.testing.assert_array_equal(plain, exp)


@pytest.mark.parametrize("n,r,lam", [(16, 8, 400), (8, 4, 1000)])
def test_full_search_matches_reference(n, r, lam):
    rng = np.random.default_rng(n + r)
    h, w = 64, 96
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    org = np.roll(ref, (2, -3), (0, 1))
    org[::7] = rng.integers(0, 256, org[::7].shape)
    x0 = np.arange(0, w - n + 1, n, dtype=np.int32)
    y0 = np.full(x0.shape, 16, np.int32)
    pmx = rng.integers(-20, 20, x0.shape).astype(np.int32)
    pmy = rng.integers(-20, 20, x0.shape).astype(np.int32)
    exp = jme.full_search_batch(jnp.asarray(ref), jnp.asarray(org),
                                jnp.asarray(x0), jnp.asarray(y0),
                                jnp.asarray(pmx), jnp.asarray(pmy), lam, n, r,
                                use_pallas=False)
    t = lambda a: to_torch(a, CPU)
    got = tme.full_search_batch(t(ref), t(org), t(x0), t(y0), t(pmx),
                                t(pmy), lam, n, r)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    for k in range(len(x0)):
        mx, my, c = jme.full_search_ref(ref, org, int(x0[k]), int(y0[k]),
                                        (int(pmx[k]), int(pmy[k])), lam, n,
                                        r)
        assert (int(got[0][k]), int(got[1][k]), int(got[2][k])) == \
            (mx, my, c)


def test_cpu_tensors_leave_launch_counters_at_zero():
    kernels.reset_counts()
    rng = np.random.default_rng(3)
    plane = to_torch(rng.integers(0, 256, (32, 32)).astype(np.int32), CPU)
    ys = to_torch(np.array([0, 5], np.int32), CPU)
    full_search(plane, plane, ys, ys, ys, ys, 100, 8, 4)
    window_gather(plane, ys, ys, 9)
    ordered_sum(torch.ones((4, 3)))
    ordered_sum_lanes(torch.ones((16, 3)), 4)
    assert kernels.counts() == {"full_search": 0, "window_gather": 0,
                                "ordered_sum": 0}
    assert kernels.counts_by_shape() == {"full_search": {},
                                         "window_gather": {},
                                         "ordered_sum": {}}


def test_wrappers_reject_bad_inputs():
    plane = torch.zeros((8, 8), dtype=torch.int32)
    ys = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        full_search(plane.to(torch.int64), plane, ys, ys, ys, ys, 1, 8, 4)
    with pytest.raises(ValueError):
        full_search(plane, plane[:4], ys, ys, ys, ys, 1, 8, 4)
    with pytest.raises(ValueError):
        full_search(plane.t(), plane, ys, ys, ys, ys, 1, 8, 4)
    with pytest.raises(ValueError):
        full_search(plane, plane, ys, ys[:2], ys, ys, 1, 8, 4)
    with pytest.raises(ValueError):
        full_search(plane, plane, ys, ys, ys, ys, 1, 8, 64)
    with pytest.raises(TypeError):
        window_gather(plane.float(), ys, ys, 4)
    with pytest.raises(ValueError):
        window_gather(plane.t(), ys, ys, 4)
    with pytest.raises(ValueError):
        window_gather(plane, torch.zeros(6, dtype=torch.int32)[::2], ys, 4)
    with pytest.raises(ValueError):
        ordered_sum_lanes(torch.zeros((15, 3)), 4)      # not 4 x 4 terms
    with pytest.raises(ValueError):
        ordered_sum_lanes(torch.zeros((144, 3)), 12)    # no lane layout
    with pytest.raises(TypeError):
        ordered_sum_lanes(torch.zeros((16, 3), dtype=torch.float64), 4)


def _lane_model(block):
    """K3's lane order in numpy, one n x n float32 block at a time: rows
    as lanes and a halving tree for n <= 8; per row 8 lanes over the
    columns j mod 8 with the running sum added to lane 0's first term,
    then a tree, for n >= 16."""
    f = np.float32
    n = block.shape[0]
    if n <= 8:
        lanes = []
        for r in range(n):
            acc = f(0)
            for x in block[r]:
                acc = f(acc + x)
            lanes.append(acc)
        while len(lanes) > 1:
            h = len(lanes) // 2
            lanes = [f(lanes[j] + lanes[j + h]) for j in range(h)]
        return lanes[0]
    acc = f(0)
    for r in range(n):
        lanes = list(block[r, :8])
        lanes[0] = f(acc + lanes[0])
        for c in range(8, n, 8):
            lanes = [f(block[r, c + j] + lanes[j]) for j in range(8)]
        while len(lanes) > 1:
            h = len(lanes) // 2
            lanes = [f(lanes[j] + lanes[j + h]) for j in range(h)]
        acc = lanes[0]
    return acc


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_lane_mode_twin_is_the_lane_order(n):
    """K3's lane mode (ordered_sum_lanes, which takes its plain version
    on the CPU) and lsum against the numpy model of the order; the
    row-major order gives other bits on these terms."""
    rng = np.random.default_rng(n)
    x = (rng.random((40, n, n)) * rng.choice([1.0, 1e2, 1e5], (40, n, n))) \
        .astype(np.float32)
    want = np.array([_lane_model(b) for b in x], np.float32)
    xt = torch.from_numpy(x.reshape(40, -1).T.copy())
    np.testing.assert_array_equal(lanes_sum_plain(xt, n).numpy(), want)
    np.testing.assert_array_equal(ordered_sum_lanes(xt, n).numpy(), want)
    np.testing.assert_array_equal(lsum(torch.from_numpy(x)).numpy(), want)
    rowmajor = ordered_sum(xt).numpy()
    assert (rowmajor != want).any()


def test_mv_bits_matches_reference_over_range():
    v = np.arange(-4096, 4097, dtype=np.int32)
    other = np.roll(v, 1234)
    exp = np.asarray(jme.mv_bits(jnp.asarray(v), jnp.asarray(other)))
    got = to_numpy(tme.mv_bits(to_torch(v, CPU), to_torch(other, CPU)))
    np.testing.assert_array_equal(got, exp)
    assert got.dtype == np.int32
