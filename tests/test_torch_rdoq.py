"""ops/rdoq.py of the PyTorch port against the JAX reference on the same
seeded inputs (the input style of tests/test_rdoq.py and
tests/test_tb_bits_est.py).

Tolerance: levels are integers and must match exactly.  The bit
estimates are float32 sums over a TB.  Where the wavefront takes them
(tb_bits_est with the step's lane count) they follow the reference's
compiled order and are held exactly; elsewhere the port sums pairwise
(so that the card and the CPU give the same bits) and two orders of an
n-term float32 sum differ by up to about n * 6e-8 relative: held to
rtol=1e-6 up to 16x16 TBs and rtol=1e-5 for 32x32 TBs (1024 terms)."""
import functools

import numpy as np
import pytest
import jax
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


@functools.partial(jax.jit, static_argnums=(4, 5))
def _tb_bits_in_steps(lev, qp, tabs, thr, log2n, c_idx):
    """The reference's tb_bits_est as its wavefront runs it: a fori_loop
    whose step s estimates the (B, n, n) levels lev[s] with per-lane rate
    tables, the estimate consumed by a compare (the skip test's) and
    stored.  So XLA's CPU backend emits the coefficient-bit sum as a
    fusion of its own, as in jit(_wavefront_body), and vectorises its row
    loop as there: for B = 1 the whole row (16 lanes at n = 16, 8 at
    n = 8), for B = 4 eight lanes and the row's tail one by one, for
    B = 15 16 lanes (the loop structure of the fusions' LLVM IR, dumped
    with XLA_FLAGS=--xla_dump_to, equals the wavefront's at 96x64,
    416x240 and 1920x1088).  The wavefront's chroma sums at B > 1 (four
    lanes) arise only in its own layout and are not reproduced here.
    -> ((S, B) bits, (S, B) compares)."""
    def step(s, carry):
        bits, flags = carry
        b = jr.tb_bits_est(lev[s], qp[s], log2n, c_idx, jnp.int32(1),
                           bits_table=tabs[s])
        return bits.at[s].set(b), flags.at[s].set(thr[s] <= 6.0 + b)
    z = jnp.zeros(lev.shape[:2], jnp.float32)
    return jax.lax.fori_loop(0, lev.shape[0], step,
                             (z, jnp.zeros(lev.shape[:2], bool)))


def _tb_case(log2n, c_idx, lanes):
    """(S, B, n, n) seeded levels with large ones (8197 among them, where
    the reference's floor(log2) of the remaining level is one short),
    per-lane QPs and rate tables."""
    rng = np.random.default_rng(100 * log2n + 10 * c_idx + lanes)
    n = 1 << log2n
    shape = (48, lanes, n, n)
    lev = np.where(rng.random(shape) < 0.35,
                   rng.integers(-60, 61, shape), 0).astype(np.int32)
    big = rng.random(shape) < 0.01
    lev[big] = rng.integers(-20000, 20000, int(big.sum()))
    lev[:, :, 0, 0] = np.where(rng.random(shape[:2]) < 0.2, 8197,
                               lev[:, :, 0, 0])
    lev[0, 0] = 0
    qp = rng.integers(22, 40, shape[:2]).astype(np.int32)
    rows = np.stack([bits_table_from_states(init_states(1, q))
                     for q in (22, 30, 38)]).astype(np.float32)
    tabs = rows[rng.integers(0, 3, shape[:2])]
    return lev, qp, tabs


@pytest.mark.parametrize("log2n,c_idx,lanes", [
    pytest.param(2, 0, None, id="2-0"), pytest.param(3, 1, None, id="3-1"),
    pytest.param(4, 0, None, id="4-0"), pytest.param(4, 2, None, id="4-2"),
    pytest.param(5, 0, None, id="5-0"),
    pytest.param(4, 0, 1, id="4-0-wavefront-1"),
    pytest.param(3, 1, 1, id="3-1-wavefront-1"),
    pytest.param(3, 2, 1, id="3-2-wavefront-1"),
    pytest.param(4, 0, 4, id="4-0-wavefront-4"),
    pytest.param(4, 0, 15, id="4-0-wavefront-15")])
def test_tb_bits_est_matches_reference(log2n, c_idx, lanes):
    """With `lanes`, the wavefront's estimate (tb_bits_est(lanes=B)) is
    held exactly against the reference's function in the wavefront's
    compiled context (_tb_bits_in_steps), and the pairwise sums with the
    exact floor (the port's arithmetic before) differ from it."""
    if lanes is not None:
        lev, qp, tabs = _tb_case(log2n, c_idx, lanes)
        thr = np.zeros(lev.shape[:2], np.float32)
        exp = np.asarray(_tb_bits_in_steps(lev, qp, tabs, thr, log2n,
                                           c_idx)[0])
        got, before = (np.stack([to_numpy(tr.tb_bits_est(
            _t(lev[s]), _t(qp[s]), log2n, c_idx, 1, bits_table=_t(tabs[s]),
            lanes=ln)) for s in range(lev.shape[0])])
            for ln in (lanes, None))
        np.testing.assert_array_equal(got, exp)
        assert (before != exp).any()
        return
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
