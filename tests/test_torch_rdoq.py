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
from x265_mod_by_patman_tpu.ops.transform import (
    MAX_TR_DYNAMIC_RANGE, QUANT_SCALES, QUANT_SHIFT, dct_batch)
from x265_mod_by_patman_tpu.entropy.contexts import init_states
from x265_mod_by_patman_tpu.entropy.est_bits import (
    bits_table_from_states, residual_ctx_scalars, sig_ctx_map)
from x265_mod_by_patman_tpu_torch.convert import to_numpy, to_torch
from x265_mod_by_patman_tpu_torch.ops import numeric
from x265_mod_by_patman_tpu_torch.ops import rdoq as tr
from tests.test_torch_recon import _exact_fma32

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
    """With `lanes`, the wavefront's estimate (tb_bits_est with
    order=wavefront_sum_order(n, B)) is
    held exactly against the reference's function in the wavefront's
    compiled context (_tb_bits_in_steps), and the pairwise sums with the
    exact floor (the port's arithmetic before) differ from it."""
    if lanes is not None:
        lev, qp, tabs = _tb_case(log2n, c_idx, lanes)
        thr = np.zeros(lev.shape[:2], np.float32)
        exp = np.asarray(_tb_bits_in_steps(lev, qp, tabs, thr, log2n,
                                           c_idx)[0])
        order = tr.wavefront_sum_order(1 << log2n, lanes)
        got, before = (np.stack([to_numpy(tr.tb_bits_est(
            _t(lev[s]), _t(qp[s]), log2n, c_idx, 1, bits_table=_t(tabs[s]),
            order=o)) for s in range(lev.shape[0])])
            for o in (order, None))
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


# -- RDOQ in the reference's compiled float32 ---------------------------------
# rdoq_levels runs inside jit(_wavefront_body) (1 block a step at 96x64,
# 15 at 1920x1088), jit(_tu32_core) (rp = 8 to 2048) and
# jit(_wavefront_tree_body).  In each, XLA's CPU backend emits the level
# bits' log as a fusion of its own (maximum_log_fusion.*), the candidate
# costs with their group sums of cbest as another (the bitcast_reduce
# fusions with a floor), the groups' cs * cs sums as a third, and the
# zero-out compare in the levels' fusion.  The programs below hold the
# reference's own expressions; their fusions were checked against those
# (XLA_FLAGS=--xla_dump_to, objdump -d of the fusions' object files).

@jax.jit
def _rdoq_log(cs):
    """The level bits' log of RDOQ's ceil candidate (reference ops/
    rdoq.py:170-174): the same object code as jit(_wavefront_body)'s
    maximum_log_fusion.5 at (1, 16, 16) and (15, 16, 16) and
    jit(_tu32_core)'s maximum_log_fusion.7 at (16, 32, 32)."""
    return jnp.log(jnp.maximum(jnp.maximum(jnp.ceil(cs) - 3.0, 0.0) - 2.0,
                               1.0))


@functools.partial(jax.jit, static_argnums=(5, 6, 7))
def _rdoq_sums(coef, imask, qp, tabs, psy_rdoq, log2n, c_idx, psy):
    """The reference's RDOQ candidate costs and group sums (ops/rdoq.py:
    98-209 with init_type, per-lane rate tables and psy-RDOQ on luma),
    its own expressions in a program that returns them: -> (keep, the
    groups' cs * cs sums, kill, levels); cbest stays inside the program,
    summed where it is made, as in the production programs.  Its costs'
    and sums' fusions contract the products as the production programs'
    do (k * bits rounded, the square into its add, the psy product into
    the subtraction; the cs * cs terms into the row adds) and sum each
    group's rows as 4-lane vectors with the same tree; its kill rounds k
    * saving apart, as jit(_tu32_core) and the wavefront below 4 blocks
    a step do."""
    n, g = 1 << log2n, 1 << (log2n - 2)
    per, rem6 = qp // 6, qp % 6
    qbits = (QUANT_SHIFT + per + MAX_TR_DYNAMIC_RANGE - 8 - log2n)
    scale = jnp.asarray(QUANT_SCALES)[rem6][:, None, None]
    cs = jnp.abs(coef).astype(jnp.float32) * scale.astype(jnp.float32) \
        / jnp.exp2(qbits.astype(jnp.float32))[:, None, None]
    k = jnp.where(imask, jr.K_INTRA, jr.K_INTER).astype(jnp.float32)
    k = k[:, None, None]
    smap = jnp.asarray(sig_ctx_map(log2n, c_idx))
    sig0, sig1 = tabs[:, smap, 0], tabs[:, smap, 1]
    g1c, g2c, cgc = residual_ctx_scalars(log2n, c_idx)
    g1_0, g1_1 = tabs[:, g1c, 0][:, None, None], tabs[:, g1c, 1][:, None, None]
    g2_0, g2_1 = tabs[:, g2c, 0][:, None, None], tabs[:, g2c, 1][:, None, None]
    cg_save = tabs[:, cgc, 1] - tabs[:, cgc, 0]

    def level_bits(lv):
        v = jnp.maximum(lv - 3.0, 0.0)
        rem = jnp.where(v < 3.0, v + 1.0, 4.0 + 2.0 * jnp.floor(
            jnp.log2(jnp.maximum(v - 2.0, 1.0))))
        return jnp.where(lv == 0, sig0, sig1 + 1.0 + jnp.where(
            lv == 1, g1_0, g1_1 + jnp.where(lv == 2, g2_0, g2_1 + rem)))
    if psy:
        nondc = jnp.ones((n, n), jnp.float32).at[0, 0].set(0.0)
        psy_k = (psy_rdoq * jnp.sqrt(k)) * nondc[None]
        cost = lambda lv: (cs - lv) ** 2 + k * level_bits(lv) - psy_k * lv
    else:
        cost = lambda lv: (cs - lv) ** 2 + k * level_bits(lv)
    hi, lo, zero = jnp.ceil(cs), jnp.floor(cs), jnp.zeros_like(cs)
    c_hi, c_lo, c_z = cost(hi), cost(lo), cost(zero)
    lv = jnp.where(c_hi < c_lo, hi, lo)
    cbest = jnp.minimum(c_hi, c_lo)
    lv = jnp.where(c_z <= cbest, zero, lv)
    cbest = jnp.minimum(c_z, cbest)
    keep = cbest.reshape(-1, g, 4, g, 4).sum(axis=(2, 4))
    squares = (cs ** 2).reshape(-1, g, 4, g, 4).sum(axis=(2, 4))
    kill = squares - (k[:, 0, 0] * cg_save)[:, None, None]
    zero_cg = (kill < keep)[:, :, None, :, None]
    lv = jnp.where(zero_cg, 0.0, lv.reshape(-1, g, 4, g, 4)).reshape(-1, n, n)
    return keep, squares, kill, jnp.sign(coef) * lv.astype(jnp.int32)


@pytest.mark.parametrize("site", [
    "floor", "sums-16-0-1", "sums-8-1-1", "sums-16-0-15", "sums-32-0-8",
    "sums-32-0-16", "sums-16-0-32", "sums-16-1-8", "sums-16-0-1-intra"])
def test_rdoq_float32_follows_the_reference(site):
    """RDOQ's float32 values bit for bit against the reference's compiled
    ones.  floor: floor(log2) of the level bits (floor_log2_ref, through
    _rem_bits_ref) equals the reference's floor of its log fusion times
    float32(1 / ln 2) at every argument 1..32769 (one short at 8192 and
    32768) and at the runs near 2**21..2**24 where it is one over; sums:
    cg_keep_kill's group sums of rdoq_candidates' costs (cbest) and of
    cs * cs, and the levels, equal _rdoq_sums' at n x n TBs, B blocks
    (sums-n-c_idx-B: the wavefront's 1 and 15, the TU32 pre-pass's rp =
    8 and 16 and its quads' 4 rp = 32; intra: the I-picture tree's
    K_INTRA), levels large enough for the one-short floor among them,
    where the earlier arithmetic (the costs rounded apart, fsum's group
    sums) differs."""
    t = torch.from_numpy
    if site == "floor":
        x = np.arange(1, numeric.LOG_REF_MAX + 1, dtype=np.float32)
        x = np.concatenate([x, np.arange(2097100, 2097200), np.arange(
            8388590, 8388620), np.arange(16777190, 16777216)]).astype(
                np.float32)
        shape = (16, 32, 32)
        pad = np.resize(x, -(-x.size // 16384) * 16384)
        ln = np.concatenate([np.asarray(_rdoq_log(c.reshape(shape) + 5.0))
                             .ravel() for c in pad.reshape(-1, 16384)])
        exp = np.floor(ln[:x.size] * numeric.LOG2E_F32)
        np.testing.assert_array_equal(numeric.floor_log2_ref(t(x)).numpy(),
                                      exp)
        assert exp[8191] == 12.0 and exp[32767] == 14.0
        return
    parts = site.split("-")
    n, c_idx, b = (int(v) for v in parts[1:4])
    intra = parts[-1] == "intra"
    log2n = n.bit_length() - 1
    rng = np.random.default_rng(n + 10 * c_idx + b)
    coef = (rng.integers(-400, 401, (b, n, n))
            * (rng.random((b, n, n)) < 0.6)).astype(np.int32)
    coef[:, 0, 0] = np.where(rng.random(b) < 0.5, 32000, coef[:, 0, 0])
    imask = np.full(b, intra) if intra else rng.random(b) < 0.3
    qp = np.where(coef[:, 0, 0] == 32000, 4,
                  rng.integers(22, 40, b)).astype(np.int32)
    rows = np.stack([bits_table_from_states(init_states(1, q))
                     for q in (22, 30, 38)]).astype(np.float32)
    tabs = rows[rng.integers(0, 3, b)]
    psy = c_idx == 0
    keep, squares, kill, lev = (np.asarray(a) for a in _rdoq_sums(
        coef, imask, qp, tabs, jnp.float32(1.0), log2n, c_idx, psy))
    kw = dict(psy_rdoq=1.0 if psy else None, bits_table=t(tabs))
    _, cs, k, cg_save, _, _, _, got = tr.rdoq_candidates(
        t(coef), t(imask), t(qp), log2n, 8, c_idx, 1, **kw)
    gk, gl = tr.cg_keep_kill(got, cs, k[:, 0, 0], cg_save)
    np.testing.assert_array_equal(gk.numpy(), keep)
    np.testing.assert_array_equal(gl.numpy(), kill)
    # the P/B wavefront at 4 blocks a step or more contracts k * saving
    # into kill (vfnmadd213 in its levels' fusions; no test program
    # compiles that form): one rounding of the exact value
    _, gf = tr.cg_keep_kill(got, cs, k[:, 0, 0], cg_save, contract=True)
    ks = lambda a: a.numpy()[:, None, None]
    np.testing.assert_array_equal(gf.numpy().ravel(), _exact_fma32(
        *(a.ravel() for a in np.broadcast_arrays(
            -ks(k[:, 0, 0]), ks(cg_save), squares))))
    np.testing.assert_array_equal(to_numpy(tr.rdoq_levels(
        t(coef), t(imask), t(qp), log2n, 8, c_idx, 1, **kw)), lev)
    g = n // 4
    apart = numeric.fsum(got.reshape(b, g, 4, g, 4), (2, 4))
    assert (apart.numpy() != keep).any() or \
        (numeric.fsum((cs * cs).reshape(b, g, 4, g, 4), (2, 4)).numpy()
         - (k[:, 0, 0] * cg_save)[:, None, None].numpy() != kill).any()
