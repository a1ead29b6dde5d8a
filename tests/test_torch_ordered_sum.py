"""K3's plain version (ops.numeric.osum_plain, which the CPU takes) and
the float32 sums that follow the reference's order through it: the
lookahead's two per-frame scalars (XLA's windowed tree of row-major
sums) and the motion-homogenisation group sums (row-major).  Each site
is checked on inputs where the port's earlier pairwise order (fsum)
gives other bits, so the check would fail with it.

Tolerance: exact (float32 bits)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from x265_mod_by_patman_tpu.analysis import lookahead as jla
from x265_mod_by_patman_tpu_torch.analysis import lookahead as tla
from x265_mod_by_patman_tpu_torch.analysis.inter_mode import _group_sum
from x265_mod_by_patman_tpu_torch.ops.cuda.ordered_sum import ordered_sum
from x265_mod_by_patman_tpu_torch.ops.numeric import fsum, osum, osum_plain
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

F32 = np.float32


def _loop(xt):
    """Row-major float32 loop in numpy: the order K3 keeps."""
    acc = np.zeros(xt.shape[1:], F32)
    for k in range(xt.shape[0]):
        acc = (acc + xt[k]).astype(F32)
    return acc


def _terms(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * rng.choice([1.0, 1e3, 1e6], shape)) \
        .astype(F32)


@pytest.mark.parametrize("k,m", [(1, 5), (16, 300), (1024, 510)])
def test_twin_is_a_row_major_float32_loop(k, m):
    xt = _terms((k, m), k)
    np.testing.assert_array_equal(osum_plain(torch.from_numpy(xt)).numpy(),
                                  _loop(xt))
    np.testing.assert_array_equal(ordered_sum(torch.from_numpy(xt))
                                  .numpy(), _loop(xt))


def test_osum_takes_the_reduced_dims_in_row_major_order():
    x = _terms((3, 4, 5, 6), 1)
    want = _loop(x.transpose(1, 3, 0, 2).reshape(24, 15)).reshape(3, 5)
    np.testing.assert_array_equal(osum(torch.from_numpy(x), (1, 3))
                                  .numpy(), want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        ordered_sum(torch.zeros((4, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        ordered_sum(torch.zeros((4, 3, 2)))
    with pytest.raises(ValueError):
        ordered_sum(torch.zeros((3, 4)).T)


def _fsum_scalars(low, intra):
    """The port's earlier _lowres_scalars (pairwise order)."""
    recip = torch.tensor(F32(1.0) / F32(low.numel()))
    return torch.stack([fsum(low.to(torch.float32), (0, 1)) * recip,
                        fsum(intra.to(torch.float32), (0, 1))])


def test_lowres_scalars_equal_reference_at_1080p():
    """50 frames of 1080p lowres (544x960 plane, 68x120 intra costs whose
    sum is near 20 M, as on park): mean and sum bit-identical to the
    reference's jnp.mean / jnp.sum."""
    rng = np.random.default_rng(4)
    ref_fn = jax.jit(jla._lowres_scalars)
    old_bad = 0
    for _ in range(50):
        low = rng.integers(0, 256, (544, 960)).astype(np.int32)
        intra = rng.integers(800, 4200, (68, 120)).astype(np.int32)
        ref = np.asarray(ref_fn(jnp.asarray(low), jnp.asarray(intra)))
        lt, it = torch.from_numpy(low), torch.from_numpy(intra)
        np.testing.assert_array_equal(tla._lowres_scalars(lt, it).numpy(),
                                      ref)
        old_bad += int((_fsum_scalars(lt, it).numpy() != ref).any())
    assert old_bad > 0          # the pairwise order fails these inputs


@pytest.mark.parametrize("shape,win", [
    ((544, 960), (17, 30)), ((68, 120), (3, 4)), ((20, 100), (1, 4)),
    ((17, 30), None)])
def test_tree_sum_windows_as_the_reference_compiles(shape, win):
    """The windowing rule: windows of min(side, 32), the padding split
    over both ends, none when both sides fit one window."""
    x = _terms(shape, 5) * 100
    got = tla._tree_sum(torch.from_numpy(x)).item()
    ref = float(jax.jit(jnp.sum)(jnp.asarray(x)))
    assert got == ref
    hlo = jax.jit(jnp.sum).lower(jnp.asarray(x)).compile().as_text()
    assert ("reduce-window" in hlo) == (win is not None)


@pytest.mark.parametrize("shape", [(544, 960), (1088, 1920)])
def test_tree_sum_int64_windows_equal_row_major(shape):
    """12-bit lowres samples: the windows summed exactly in int64 give the
    bits of the row-major float32 windows, at one level (1080p) and two
    (2160p, the window sums then added through osum)."""
    x = np.random.default_rng(6).integers(0, 4096, shape).astype(np.int32)
    t = torch.from_numpy(x)
    assert (tla._tree_sum(t, tla.LOWRES_MAX).item()
            == tla._tree_sum(t).item())


@pytest.mark.parametrize("g", [2, 4])
def test_group_sums_equal_reference(g):
    """_region_uniform's g x g group sums of float32 RD costs against the
    reference's a.reshape(gh, g, gw, g).sum((1, 3))."""
    nby, nbx = 34, 60
    gh, gw = nby // g, nbx // g
    ref_fn = jax.jit(lambda a: a.reshape(gh, g, gw, g).sum((1, 3)))
    old_bad = 0
    for seed in range(4):
        a = _terms((gh * g, gw * g), 10 + seed)
        ref = np.asarray(ref_fn(jnp.asarray(a)))
        t = torch.from_numpy(a)
        np.testing.assert_array_equal(_group_sum(t, gh, g, gw).numpy(), ref)
        old_bad += int((fsum(t.reshape(gh, g, gw, g), (1, 3)).numpy()
                        != ref).sum())
    assert old_bad > 0
