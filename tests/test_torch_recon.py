"""frame/recon_intra.py (the reconstruction wavefront) and
frame/inter_tu32.py of the PyTorch port against the JAX reference on
the same seeded planes and decisions.

Tolerance: recon planes, level stores and mode winners are integers and
must match exactly; so must the wavefront's float32 decision values
(the candidate costs, the lambda, the log tables), which follow the
reference's compiled program bit for bit."""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from x265_mod_by_patman_tpu.analysis.intra_mode import decide_modes_tree
from x265_mod_by_patman_tpu.bitstream.headers import build_sps_info
from x265_mod_by_patman_tpu.entropy.contexts import init_states
from x265_mod_by_patman_tpu.entropy.est_bits import bits_table_from_states
from x265_mod_by_patman_tpu.frame import inter_tu32 as jtu
from x265_mod_by_patman_tpu.frame.recon_intra import (
    IntraReconstructor as JRecon)
from x265_mod_by_patman_tpu.ops.transform import quant_dyn as jquant
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.frame import inter_tu32 as ttu
from x265_mod_by_patman_tpu_torch.frame.recon_intra import (
    IntraReconstructor as TRecon, candidate_cost, skip_costs)
from x265_mod_by_patman_tpu_torch.ops.cost import psy_weight
from x265_mod_by_patman_tpu_torch.ops import numeric
from x265_mod_by_patman_tpu_torch.ops.transform import quant_dyn as tquant

CPU = torch.device("cpu")
KEYS = ("recon_y", "recon_u", "recon_v", "lev_y", "lev_u", "lev_v")


def _frame(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip((xx * 2 + yy) % 200 + rng.integers(0, 50, (h, w)), 0, 255)
    u = np.clip(100 + rng.integers(0, 30, (h // 2, w // 2)), 0, 255)
    v = np.clip(150 - rng.integers(0, 30, (h // 2, w // 2)), 0, 255)
    return (y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8))


def _recons(w, h):
    p = default_params(w, h).validate()
    sps = build_sps_info(p)
    kw = dict(tree=p.var_cu_tree, psy_rd=p.psy_rd)
    return p, sps, JRecon(sps, **kw), TRecon(sps, CPU, **kw)


def _assert_same(got, exp):
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(exp[k]),
                                      err_msg=k)


@pytest.mark.parametrize("qp", [27, 36, 22, 31, 44])
def test_run_tree_matches_reference(qp):
    w, h = 96, 64
    y, u, v = _frame(w, h, qp)
    p, sps, jr, tr = _recons(w, h)
    modes, _, _, split32, mode32, c16, cb16 = decide_modes_tree(y, sps, qp)
    split32 = split32.copy()
    split32[0, 0] = False
    exp = jr.run_tree(y, u, v, modes, split32, mode32, qp=qp,
                      cand=(c16, cb16))
    got = tr.run_tree(y, u, v, modes, split32, mode32, qp=qp,
                      cand=(c16, cb16))
    _assert_same(got, exp)
    np.testing.assert_array_equal(got["modes_sel"], exp["modes_sel"])


def _inter_inputs(w, h, seed):
    rng = np.random.default_rng(seed)
    nby, nbx = h // 16, w // 16
    y, u, v = _frame(w, h, seed)
    mc_y = np.clip(y.astype(np.int32) + rng.integers(-6, 7, y.shape), 0,
                   255).reshape(nby, 16, nbx, 16).transpose(0, 2, 1, 3)
    mc_u = np.clip(u.astype(np.int32) + rng.integers(-3, 4, u.shape), 0,
                   255).reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)
    mc_v = np.clip(v.astype(np.int32) + rng.integers(-3, 4, v.shape), 0,
                   255).reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)
    mc = tuple(np.ascontiguousarray(a, np.int32) for a in (mc_y, mc_u,
                                                          mc_v))
    inter = rng.random((nby, nbx)) < 0.7
    modes = rng.integers(0, 35, (nby, nbx)).astype(np.int32)
    return (y, u, v), mc, inter, modes


def _ebits_rows(qp, nby):
    tab = bits_table_from_states(init_states(1, qp)).astype(np.float32)
    rows = np.stack([tab, bits_table_from_states(
        init_states(1, qp + 3)).astype(np.float32)])
    return rows[np.arange(nby + 1) % 2]


@pytest.mark.parametrize("qp", [30, 38, 25, 41, 47])
def test_run_inter_matches_reference(qp):
    w, h = 96, 64
    (y, u, v), mc, inter, modes = _inter_inputs(w, h, qp)
    p, sps, jr, tr = _recons(w, h)
    eb = _ebits_rows(qp, h // 16)
    exp = jr.run(y, u, v, modes, tuple(jnp.asarray(a) for a in mc), inter,
                 qp=qp, init_type=1, ebits=eb)
    got = tr.run(y, u, v, modes, tuple(torch.from_numpy(a) for a in mc),
                 inter, qp=qp, init_type=1, ebits=eb)
    _assert_same(got, exp)


def test_inter_tu32_prepass_matches_reference():
    w, h, qp = 96, 64, 30
    (y, u, v), mc, _, _ = _inter_inputs(w, h, 5)
    p, sps, jr, tr = _recons(w, h)
    mask = np.array([[True, True, False], [False, True, True]])
    eb = bits_table_from_states(init_states(1, qp)).astype(np.float32)
    exp = jtu.prepare_inter_tu32(y, u, v, tuple(jnp.asarray(a) for a in mc),
                                 mask, qp, jr, 1, ebits=eb)
    got = ttu.prepare_inter_tu32(y, u, v,
                                 tuple(torch.from_numpy(a) for a in mc),
                                 mask, qp, tr, 1, ebits=eb)
    assert (exp is None) == (got is None)
    assert exp is not None and exp["use"].any()
    for k in ("use", "nzy", "nzu", "nzv"):
        np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
    for k in ("levy", "levu", "levv"):
        assert got[k].keys() == exp[k].keys()
        for key in exp[k]:
            np.testing.assert_array_equal(got[k][key], exp[k][key])
    for a, b in zip(got["spliced"][:3], exp["spliced"][:3]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["spliced"][3], exp["spliced"][3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_region_uniform_mask_is_the_reference_function():
    rng = np.random.default_rng(2)
    inter = rng.random((4, 6)) < 0.9
    mvs = np.zeros((4, 6, 2), np.int32)
    mvs[:2, :2] = 8
    rs = np.zeros((4, 6), np.int32)
    np.testing.assert_array_equal(
        ttu.region_uniform_mask(inter, mvs, None, None, rs, None, 96, 64),
        jtu.region_uniform_mask(inter, mvs, None, None, rs, None, 96, 64))


# -- the wavefront's float32 decision values ---------------------------------
# The reference's candidate choice and skip test ride float32 values whose
# arithmetic its CPU backend fixes when it compiles the wavefront.  The
# programs below put the reference's own expressions in that context (a
# fori_loop over steps, the value consumed as the wavefront consumes it),
# so XLA emits them as it does there: the same polynomial log and exp
# with the same multiply-adds contracted, the same vectorised row loop
# for the TB's sum (read in the fusions' LLVM IR and object code,
# XLA_FLAGS=--xla_dump_to, against jit(_wavefront_tree_body) at 96x64,
# 416x240 and 1920x1088).

@jax.jit
def _rate_terms_in_steps(lev):
    """(S, 1, 16, 16) levels with one nonzero each -> (S,) candidate rates,
    each the reference's 3 + 2 * log2(|level| + 1) at that level."""
    def step(s, acc):
        al = jnp.abs(lev[s]).astype(jnp.float32)
        rate = jnp.sum(jnp.where(al > 0.0, 3.0 + 2.0 * jnp.log2(al + 1.0),
                                 0.0), axis=(1, 2))
        return acc.at[s].set(rate[0])
    return jax.lax.fori_loop(0, lev.shape[0], step,
                             jnp.zeros(lev.shape[0], jnp.float32))


@jax.jit
def _candidates_in_steps(coef, qps, cb, sse):
    """The reference's candidate RD choice (recon_intra._substep_body at
    cand_bits) over steps of B blocks and K candidates: the levels
    quantized in the step, the rate, the lambda of the step's QPs, the
    cost and the running minimum.  -> ((S, K, B) costs, (S, B) winners,
    (S, B) lambdas)."""
    s_, k_, b_ = coef.shape[:3]

    def step(s, carry):
        costs, sel, lams = carry
        qp = qps[s]
        ones = jnp.ones(qp.shape, bool)
        lam2 = 0.85 * jnp.exp2((qp.astype(jnp.float32) - 12.0) / 3.0)
        best = None
        for kk in range(k_):
            lev = jquant(coef[s, kk], ones, qp, 4, 8, None)
            al = jnp.abs(lev).astype(jnp.float32)
            rate = jnp.sum(jnp.where(al > 0.0,
                                     3.0 + 2.0 * jnp.log2(al + 1.0), 0.0),
                           axis=(1, 2))
            cost = sse[s, kk].astype(jnp.float32) + lam2 * (rate
                                                           + cb[s, kk])
            costs = costs.at[s, kk].set(cost)
            if best is None:
                best = (cost, jnp.zeros(qp.shape, jnp.int32))
            else:
                u = cost < best[0]
                best = (jnp.where(u, cost, best[0]),
                        jnp.where(u, kk, best[1]))
        return costs, sel.at[s].set(best[1]), lams.at[s].set(lam2)
    z = jnp.zeros((s_, b_), jnp.float32)
    return jax.lax.fori_loop(
        0, s_, step, (jnp.zeros((s_, k_, b_), jnp.float32),
                      jnp.zeros((s_, b_), jnp.int32), z))


@jax.jit
def _skip_costs_in_steps(sse_skip, sse_coded, est, qps, psy_skip, psy_coded,
                         psy256, init_type):
    """The reference's luma zero-residual test (recon_intra._substep_body
    with init_type and psy-rd) over steps of B blocks: the lambda of the
    step's QPs, bits = base + the TB estimate, the two costs with their
    psy terms and the decision.  -> ((S, B) cost_skip, cost_coded,
    skip)."""
    def step(s, carry):
        cs, cc, sk = carry
        qp = qps[s]
        lam2 = 0.85 * jnp.exp2((qp.astype(jnp.float32) - 12.0) / 3.0)
        bits = jnp.where(init_type == 0, 14.0, 6.0) + est[s]
        cost_skip = sse_skip[s].astype(jnp.float32)
        cost_coded = sse_coded[s].astype(jnp.float32) + lam2 * bits
        styp = jnp.asarray([300.0, 256.0, 96.0], jnp.float32)[
            jnp.clip(init_type, 0, 2)] / 256.0
        qpf = qp.astype(jnp.float32)
        roll = jnp.where(qpf >= 40.0,
                         jnp.clip((51.0 - qpf) * 23.0 / 256.0, 0.0, 1.0),
                         1.0)
        psy_w = jnp.sqrt(lam2) * (psy256.astype(jnp.float32) / 256.0) \
            * 0.33 * styp * roll
        cost_skip = cost_skip + psy_w * psy_skip[s].astype(jnp.float32)
        cost_coded = cost_coded + psy_w * psy_coded[s].astype(jnp.float32)
        return (cs.at[s].set(cost_skip), cc.at[s].set(cost_coded),
                sk.at[s].set(cost_skip <= cost_coded))
    z = jnp.zeros(qps.shape, jnp.float32)
    return jax.lax.fori_loop(0, qps.shape[0], step,
                             (z, z, jnp.zeros(qps.shape, bool)))


def _exact_fma32(a, b, c):
    """float32 a * b + c rounded once to nearest even, in Python integers
    (each float32 is an integer times a power of two)."""
    from fractions import Fraction
    out = []
    for x, y, z in zip(*np.broadcast_arrays(*(np.asarray(v, np.float32)
                                              for v in (a, b, c)))):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        f = np.float32(v.numerator / v.denominator)
        up, dn = (np.nextafter(f, np.float32(d)) for d in (np.inf, -np.inf))
        dist = [(abs(Fraction(float(c)) - v),
                 int(np.array(c, np.float32).view(np.int32)) & 1, c)
                for c in (f, up, dn)]
        out.append(min(dist)[2])
    return np.array(out, np.float32)


def _before_cost(lev, sse, qp, cb):
    """The candidate cost in the port's earlier arithmetic: the log2 in
    float64, the pairwise sum, the product and the add rounded apart,
    the lambda's 2**x in float64."""
    al = torch.abs(lev).to(torch.float32)
    l2 = torch.log2(al.to(torch.float64) + 1.0).to(torch.float32)
    rate = numeric.fsum(torch.where(al > 0.0, 3.0 + 2.0 * l2, 0.0), (1, 2))
    return sse + _lam2_f64_rounded(qp) * (rate + cb)


def _lam2_f64_rounded(qp):
    """The port's earlier lambda: 0.85 * 2**((qp - 12) / 3) with 2**x in
    float64, rounded once, then times 0.85 in float32."""
    q = (qp.to(torch.float32) - 12.0) / 3.0
    return 0.85 * torch.exp2(q.to(torch.float64)).to(torch.float32)


@pytest.mark.parametrize("site", ["log", "fma", "rate-term", "candidates-1",
                                  "candidates-4", "candidates-15",
                                  "skip-costs-1", "skip-costs-15"])
def test_wavefront_float32_follows_the_reference(site):
    """log_ref / log2_ref equal the reference's float32 log and log2 at
    every integer they take (1 to 32769; their tables' multiply-adds,
    and the candidate term's fma32 on them, each equal the exactly
    rounded value); the candidate term equals the reference's
    3 + 2 * log2(a + 1) in a loop at every a; candidate_cost and
    lam2_ref equal the reference's costs, winners and lambdas at every
    QP 0-51 with 1, 4 and 15 blocks a step, where the earlier arithmetic
    (_before_cost) gives other costs; skip_costs with lam2_ref and
    psy_weight equals the reference's zero-residual test (its costs and
    decisions) at every QP, where the products rounded apart do not."""
    x = np.arange(1, numeric.LOG_REF_MAX + 1, dtype=np.float32)
    xt = torch.from_numpy(x)
    if site == "log":
        np.testing.assert_array_equal(numeric.log_ref(xt).numpy(),
                                      np.asarray(jax.jit(jnp.log)(x)))
        np.testing.assert_array_equal(numeric.log2_ref(xt).numpy(),
                                      np.asarray(jax.jit(jnp.log2)(x)))
        # the floor the skip test's remaining-level length takes
        assert numeric.log2_ref(torch.tensor([8192.0])).floor() == 12.0
        with pytest.raises(ValueError):
            numeric.log_ref(torch.tensor([0.0, 5.0]))
        with pytest.raises(ValueError):
            numeric.log2_ref(torch.tensor([numeric.LOG_REF_MAX + 1.0]))
        return
    if site == "fma":
        # the tables' multiply-adds (numeric._fma_f32) and the term's
        # float64-route fma32 against exact rounding, at every entry
        exact = functools.partial(numeric._xla_log, fma=_exact_fma32)
        np.testing.assert_array_equal(numeric.log_ref(xt).numpy(),
                                      exact(x))
        two = np.float32(2 * float(numeric.LOG2E_F32))
        ln = numeric.log_ref(xt)
        np.testing.assert_array_equal(
            numeric.fma32(ln, float(two), 3.0).numpy(),
            _exact_fma32(ln.numpy(), two, np.float32(3.0)))
        return
    if site == "rate-term":
        a = np.arange(1, numeric.LOG_REF_MAX, dtype=np.int32)
        lev = np.zeros((a.size, 1, 16, 16), np.int32)
        lev[np.arange(a.size), 0, (a // 16) % 16, a % 16] = \
            np.where(a % 2 == 0, a, -a)
        exp = np.asarray(_rate_terms_in_steps(lev))
        t = torch.from_numpy(a)
        got = numeric.fma32(numeric.log_ref(t + 1),
                            2 * float(numeric.LOG2E_F32), 3.0).numpy()
        np.testing.assert_array_equal(got, exp)
        return
    lanes = int(site.split("-")[-1])
    rng = np.random.default_rng(lanes)
    t = torch.from_numpy
    if site.startswith("skip-costs"):
        steps = 52 * 4
        qps = np.repeat(np.arange(52, dtype=np.int32), 4)[:, None] \
            .repeat(lanes, 1)
        sse_s = rng.integers(0, 200000, qps.shape).astype(np.int32)
        sse_c = (sse_s * rng.uniform(0.3, 1.0, qps.shape)).astype(np.int32)
        est = (rng.random(qps.shape) * 300).astype(np.float32)
        psy_s = rng.integers(0, 30000, qps.shape).astype(np.int32)
        psy_c = rng.integers(0, 30000, qps.shape).astype(np.int32)
        psy256, it = 512, 1
        cs, cc, sk = (np.asarray(a) for a in _skip_costs_in_steps(
            sse_s, sse_c, est, qps, psy_s, psy_c, jnp.int32(psy256),
            jnp.int32(it)))
        lam2 = numeric.lam2_ref(t(qps))
        psy = (psy_weight(lam2, psy256, it, t(qps)), t(psy_s), t(psy_c))
        got = skip_costs(t(sse_s), t(sse_c), 6.0 + t(est), lam2, psy)
        np.testing.assert_array_equal(got[0].numpy(), cs)
        np.testing.assert_array_equal(got[1].numpy(), cc)
        np.testing.assert_array_equal((got[0] <= got[1]).numpy(), sk)
        apart = (t(sse_c).to(torch.float32) + lam2 * (6.0 + t(est))) \
            + psy[0] * t(psy_c).to(torch.float32)
        assert (apart.numpy() != cc).any()
        return
    steps, k = 52 * 2, 3
    qps = np.repeat(np.arange(52, dtype=np.int32), 2)[:, None] \
        .repeat(lanes, 1)
    coef = (rng.integers(-4000, 4001, (steps, k, lanes, 16, 16))
            * (rng.random((steps, k, lanes, 16, 16)) < 0.4)).astype(np.int32)
    cb = (rng.random((steps, k, lanes)) * 12).astype(np.float32)
    sse = rng.integers(0, 60000, (steps, k, lanes)).astype(np.int32)
    costs, sel, lams = (np.asarray(a) for a in
                        _candidates_in_steps(coef, qps, cb, sse))
    got_lam = numeric.lam2_ref(t(qps))
    np.testing.assert_array_equal(got_lam.numpy(), lams)
    ones = torch.ones(lanes, dtype=torch.bool)
    got = np.zeros_like(costs)
    before = np.zeros_like(costs)
    for s in range(steps):
        for kk in range(k):
            lev = tquant(t(coef[s, kk]), ones, t(qps[s]), 4, 8, None)
            sse_f = t(sse[s, kk]).to(torch.float32)
            got[s, kk] = candidate_cost(lev, sse_f, got_lam[s],
                                        t(cb[s, kk])).numpy()
            before[s, kk] = _before_cost(lev, sse_f, t(qps[s]),
                                         t(cb[s, kk])).numpy()
    np.testing.assert_array_equal(got, costs)
    first_min = np.argmin(got, axis=1)          # ties to the first
    np.testing.assert_array_equal(first_min, sel)
    assert (before != costs).any()


# -- the inter TU32 pre-pass's float32 decision values -----------------------
# jit(_tu32_core) pads its region batch to rp = 8, 16, 32, ... regions, and
# its CPU backend compiles the pre-pass per rp.  Each program below holds
# one site of it in a program whose fusion at that site was checked
# (XLA_FLAGS=--xla_dump_to, objdump -d of the fusions' object files)
# against jit(_tu32_core)'s at the same rp: the lambda's exp fusion is
# the same object code at every rp 8 to 2048, the choice's and the costs'
# fusions contract the same products (vfmadd) in the same order, and the
# bit estimate's coefficient-sum loop is the same loop nest (the same
# strips, vector widths and reductions in the LLVM IR).

@jax.jit
def _tu32_lambda(qp):
    """The pre-pass's 2**((qp - 12) / 3) (inter_tu32.py:57, :118), which
    its program multiplies by 0.85 once per use."""
    return jnp.exp2((qp.astype(jnp.float32) - 12.0) / 3.0)


@jax.jit
def _tu32_choice(cost32, c16, e):
    """The pre-pass's TU32 choice (inter_tu32.py:117-122) from the
    lambda's 2**x (_tu32_lambda, the pre-pass's separate exp fusion):
    -> (cost16 + lam2 * 3.0, use32)."""
    cost16 = c16.reshape(-1, 4).sum(1)
    lam2 = 0.85 * e * 1
    thr = cost16 + lam2 * 3.0
    return thr, cost32 <= thr


@functools.partial(jax.jit, static_argnums=(8,))
def _tu32_costs(sse_skip, sse_coded, nz, est, qp, psy_skip, psy_coded,
                init_type, luma):
    """The pre-pass's zero-residual costs (_plane_rd at inter_tu32.py:
    57-86, psy 512) from its SSEs, nonzero counts, bit estimates and psy
    costs: -> (cost_skip, cost_coded)."""
    lam2 = 0.85 * jnp.exp2((qp.astype(jnp.float32) - 12.0) / 3.0) * 1
    if luma:
        nzf = nz.astype(jnp.float32)
        lin = jnp.where(nzf > 0.0, 10.0, 0.0) + 4.5 * nzf
        bits = 6.0 + jnp.maximum(lin, est)
    else:
        bits = 2.0 + est
    cost_skip = sse_skip.astype(jnp.float32)
    cost_coded = sse_coded.astype(jnp.float32) + lam2 * bits
    if luma:
        styp = jnp.asarray([300.0, 256.0, 96.0], jnp.float32)[
            jnp.clip(init_type, 0, 2)] / 256.0
        qpf = qp.astype(jnp.float32)
        roll = jnp.where(qpf >= 40.0,
                         jnp.clip((51.0 - qpf) * 23.0 / 256.0, 0.0, 1.0),
                         1.0)
        psy_w = jnp.sqrt(lam2) * (jnp.int32(512).astype(jnp.float32)
                                  / 256.0) * 0.33 * styp * roll
        cost_skip = cost_skip + psy_w * psy_skip.astype(jnp.float32)
        cost_coded = cost_coded + psy_w * psy_coded.astype(jnp.float32)
    return cost_skip, cost_coded


@functools.partial(jax.jit, static_argnums=(5, 6))
def _tu32_bits(levt, levt2, qp, tab, thr, log2n, c_idx):
    """The pre-pass's TB bit estimates of two planes whose levels it holds
    position-major, (n * n, B), as its quantiser leaves them; the two
    estimates share the rate tables, which the program then stores once,
    as jit(_tu32_core) stores each plane's.  -> ((estimates, compares)
    of levt, of levt2), all four returned so that both planes stay in the
    program."""
    n, b = 1 << log2n, levt.shape[1]
    out = []
    for lt, ci in ((levt, c_idx), (levt2, 2 if c_idx else 0)):
        est = jtu.tb_bits_est(lt.T.reshape(b, n, n), qp, log2n, ci,
                              jnp.int32(1), bits_table=tab)
        out.append((est, thr <= 2.0 + est))
    return out


@pytest.mark.parametrize("site,rp", [
    (s, rp) for s in ("lambda", "choice", "costs", "bits-32", "bits-quads",
                      "bits-chroma") for rp in (8, 16)])
def test_tu32_float32_follows_the_reference(site, rp):
    """The inter TU32 pre-pass's float32 values bit for bit against the
    reference's, in programs compiled at the pre-pass's padded batch rp:
    lambda: lam2_exp_ref / lam2_ref at every QP 0-51 (the port's earlier
    float64 2**x differs at QP 32); choice: use32_choice at costs on
    either side of the reference's cost16 + lam2 * 3.0 within an ulp;
    costs: skip_costs with lam2_ref and the folded psy weight, for P and
    B slices; bits: tb_bits_est in tu32_sum_order's order for the TU32
    luma (n = 32, rp blocks), the quad luma (n = 16, 4 rp) and the chroma
    (n = 16, rp), levels of 8197 among them (the one-short floor), where
    the pairwise sums differ."""
    rng = np.random.default_rng(rp + len(site))
    t = torch.from_numpy
    qps = np.arange(52, dtype=np.int32)
    batches = [np.resize(np.roll(qps, -i), rp) for i in range(0, 52, rp)]
    if site == "lambda":
        for q in batches:
            e = np.asarray(_tu32_lambda(q))
            np.testing.assert_array_equal(numeric.lam2_exp_ref(t(q)).numpy(),
                                          e)
            lam2 = (e * np.float32(0.85)).astype(np.float32)
            np.testing.assert_array_equal(numeric.lam2_ref(t(q)).numpy(),
                                          lam2)
            np.testing.assert_array_equal(
                numeric.lam2_ref(t(q), 10).numpy(), lam2 * 16)
        q32 = torch.tensor([32])
        assert _lam2_f64_rounded(q32) != numeric.lam2_ref(q32)
        return
    if site == "choice":
        for q in batches:
            c16 = (rng.random((rp, 4)) * 3e5).astype(np.float32)
            e = _tu32_lambda(q)
            thr, _ = (np.asarray(a) for a in _tu32_choice(
                np.zeros(rp, np.float32), c16, e))
            for c32 in (thr, np.nextafter(thr, np.float32(np.inf)),
                        np.nextafter(thr, np.float32(-np.inf))):
                _, use = _tu32_choice(c32, c16, e)
                got = ttu.use32_choice(t(c32), t(c16), t(q), 8)
                np.testing.assert_array_equal(got.numpy(), np.asarray(use))
        return
    if site == "costs":
        for it in (0, 1):
            for luma, b in ((True, rp), (True, 4 * rp), (False, rp)):
                for q in batches:
                    q = np.resize(q, b)
                    sse_s = rng.integers(0, 400000, b).astype(np.int32)
                    sse_c = (sse_s * rng.uniform(0.2, 1.0, b)).astype(
                        np.int32)
                    nz = rng.integers(0, 60, b).astype(np.int32)
                    est = (rng.random(b) * 400).astype(np.float32)
                    ps = rng.integers(0, 30000, b).astype(np.int32)
                    pc = rng.integers(0, 30000, b).astype(np.int32)
                    cs, cc = (np.asarray(a) for a in _tu32_costs(
                        sse_s, sse_c, nz, est, q, ps, pc, jnp.int32(it),
                        luma))
                    lam2 = numeric.lam2_ref(t(q))
                    if luma:
                        lin = torch.where(t(nz) > 0, 10.0, 0.0) \
                            + 4.5 * t(nz).to(torch.float32)
                        bits = 6.0 + torch.maximum(lin, t(est))
                        psy = (psy_weight(lam2, 512, it, t(q), folded=True),
                               t(ps), t(pc))
                    else:
                        bits, psy = 2.0 + t(est), None
                    got = skip_costs(t(sse_s), t(sse_c), bits, lam2, psy)
                    np.testing.assert_array_equal(got[0].numpy(), cs)
                    np.testing.assert_array_equal(got[1].numpy(), cc)
        return
    log2n, c_idx, b = {"bits-32": (5, 0, rp), "bits-quads": (4, 0, 4 * rp),
                       "bits-chroma": (4, 1, rp)}[site]
    n = 1 << log2n
    tab = bits_table_from_states(init_states(1, 30)).astype(np.float32)
    for _ in range(3):
        lev = np.where(rng.random((2, b, n, n)) < 0.5,
                       rng.integers(-3000, 3001, (2, b, n, n)),
                       0).astype(np.int32)
        lev[:, :, 0, 0] = np.where(rng.random((2, b)) < 0.3, 8197, 5)
        q = rng.integers(22, 40, b).astype(np.int32)
        lt = [np.ascontiguousarray(a.reshape(b, n * n).T) for a in lev]
        exp = np.asarray(_tu32_bits(lt[0], lt[1], q, tab,
                                    np.zeros(b, np.float32), log2n,
                                    c_idx)[0][0])
        args = (t(lev[0]), t(q), log2n, c_idx, 1)
        got = ttu.tb_bits_est(*args, bits_table=t(tab),
                              order=ttu.tu32_sum_order(n, b))
        np.testing.assert_array_equal(got.numpy(), exp)
        pairwise = ttu.tb_bits_est(*args, bits_table=t(tab))
        assert (pairwise.numpy() != exp).any()
