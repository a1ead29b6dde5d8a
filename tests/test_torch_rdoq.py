"""ops/rdoq.py of the PyTorch port against the JAX reference on the same
seeded inputs (the input style of tests/test_rdoq.py and
tests/test_tb_bits_est.py).

Tolerance: levels are integers and must match exactly.  The bit
estimates are float32 sums over a TB: the JAX CPU backend accumulates
them sequentially, the port pairwise (so that the card and the CPU give
the same bits), and two orders of an n-term float32 sum differ by up to
about n * 6e-8 relative.  They are held to rtol=1e-6 up to 16x16 TBs
and rtol=1e-5 for 32x32 TBs (1024 terms)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_mod_by_patman_tpu.ops import rdoq as jr
from x265_mod_by_patman_tpu.ops.transform import dct_batch
from x265_mod_by_patman_tpu.entropy.contexts import init_states
from x265_mod_by_patman_tpu.entropy.est_bits import bits_table_from_states
from x265_mod_by_patman_tpu_torch.convert import to_numpy, to_torch
from x265_mod_by_patman_tpu_torch.ops import rdoq as tr

CPU = torch.device("cpu")


def _t(a):
    return to_torch(a, CPU)


def _coefs(log2n, b=16, seed=0):
    rng = np.random.default_rng(seed + log2n)
    n = 1 << log2n
    resi = rng.integers(-40, 41, (b, n, n)).astype(np.int32)
    resi[: b // 2] //= 6
    return np.asarray(dct_batch(jnp.asarray(resi), log2n, 8))


@pytest.mark.parametrize("log2n,c_idx", [(2, 0), (3, 1), (4, 0), (5, 0)])
@pytest.mark.parametrize("mode", ["static", "est", "table", "psy"])
def test_rdoq_levels_match_reference(log2n, c_idx, mode):
    coef = _coefs(log2n)
    b = coef.shape[0]
    imask = np.arange(b) % 3 != 0
    qp = np.full(b, 30, np.int32)
    qp[::4] = 37
    kw_j, kw_t = {}, {}
    it = None if mode == "static" else 1
    if mode == "table":
        tab = bits_table_from_states(init_states(1, 30)).astype(np.float32)
        kw_j["bits_table"] = jnp.asarray(tab)
        kw_t["bits_table"] = _t(tab)
    if mode == "psy":
        kw_j["psy_rdoq"] = jnp.float32(1.0)
        kw_t["psy_rdoq"] = 1.0
    exp = np.asarray(jr.rdoq_levels(jnp.asarray(coef), jnp.asarray(imask),
                                    jnp.asarray(qp), log2n, 8, c_idx,
                                    None if it is None else jnp.int32(it),
                                    **kw_j))
    got = to_numpy(tr.rdoq_levels(_t(coef), _t(imask), _t(qp), log2n, 8,
                                  c_idx, it, **kw_t))
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("log2n,c_idx", [(2, 0), (3, 1), (4, 0), (5, 0)])
@pytest.mark.parametrize("mode", ["static", "est", "table", "psy"])
def test_rdoq_sign_hide_matches_reference(log2n, c_idx, mode):
    """RDOQ-integrated sign hiding (sign_hide=True): the parity flips
    pick the same level as the reference, ties to the first minimum."""
    coef = _coefs(log2n, seed=7)
    b = coef.shape[0]
    imask = np.arange(b) % 3 != 0
    qp = np.full(b, 27, np.int32)
    qp[::4] = 33
    kw_j, kw_t = {}, {}
    it = None if mode == "static" else 2
    if mode == "table":
        tab = bits_table_from_states(init_states(2, 27)).astype(np.float32)
        kw_j["bits_table"] = jnp.asarray(tab)
        kw_t["bits_table"] = _t(tab)
    if mode == "psy":
        kw_j["psy_rdoq"] = jnp.float32(1.0)
        kw_t["psy_rdoq"] = 1.0
    args_j = (jnp.asarray(coef), jnp.asarray(imask), jnp.asarray(qp), log2n,
              8, c_idx, None if it is None else jnp.int32(it))
    exp = np.asarray(jr.rdoq_levels(*args_j, sign_hide=True, **kw_j))
    plain = np.asarray(jr.rdoq_levels(*args_j, **kw_j))
    got = to_numpy(tr.rdoq_levels(_t(coef), _t(imask), _t(qp), log2n, 8,
                                  c_idx, it, sign_hide=True, **kw_t))
    np.testing.assert_array_equal(got, exp)
    if log2n >= 3:
        assert (exp != plain).any()           # hiding fired somewhere


@pytest.mark.parametrize("log2n,c_idx", [(2, 0), (3, 1), (4, 0), (4, 2),
                                         (5, 0)])
def test_tb_bits_est_matches_reference(log2n, c_idx):
    rng = np.random.default_rng(log2n * 3 + c_idx)
    n = 1 << log2n
    b = 12
    lev = np.where(rng.random((b, n, n)) < 0.15,
                   rng.integers(-5, 6, (b, n, n)), 0).astype(np.int32)
    lev[0] = 0
    lev[1, 0, 0] = 40
    qp = np.full(b, 32, np.int32)
    exp = np.asarray(jr.tb_bits_est(jnp.asarray(lev), jnp.asarray(qp),
                                    log2n, c_idx, jnp.int32(1)))
    got = to_numpy(tr.tb_bits_est(_t(lev), _t(qp), log2n, c_idx, 1))
    rtol = 1e-6 if log2n <= 4 else 1e-5
    np.testing.assert_allclose(got, exp, rtol=rtol, atol=0)
    rows = np.stack([bits_table_from_states(init_states(1, q))
                     for q in (20, 30, 40)]).astype(np.float32)
    per_lane = rows[np.arange(b) % 3]
    exp2 = np.asarray(jr.tb_bits_est(jnp.asarray(lev), jnp.asarray(qp),
                                     log2n, c_idx, jnp.int32(1),
                                     bits_table=jnp.asarray(per_lane)))
    got2 = to_numpy(tr.tb_bits_est(_t(lev), _t(qp), log2n, c_idx, 1,
                                   bits_table=_t(per_lane)))
    np.testing.assert_allclose(got2, exp2, rtol=rtol, atol=0)


@pytest.mark.parametrize("log2n", [3, 4, 5])
def test_tu_rd_levels_matches_reference(log2n):
    coef = _coefs(log2n, seed=7)
    qp = np.full(coef.shape[0], 33, np.int32)
    exp = np.asarray(jr.tu_rd_levels(jnp.asarray(coef), jnp.asarray(qp),
                                     log2n))
    got = to_numpy(tr.tu_rd_levels(_t(coef), _t(qp), log2n))
    np.testing.assert_allclose(got, exp, rtol=1e-6 if log2n <= 4 else 1e-5,
                               atol=0)
