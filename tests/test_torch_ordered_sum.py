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
    np.testing.assert_array_equal(ordered_sum(torch.from_numpy(xt), 0)
                                  .numpy(), _loop(xt))


def test_osum_takes_the_reduced_dims_in_row_major_order():
    x = _terms((3, 4, 5, 6), 1)
    want = _loop(x.transpose(1, 3, 0, 2).reshape(24, 15)).reshape(3, 5)
    np.testing.assert_array_equal(osum(torch.from_numpy(x), (1, 3))
                                  .numpy(), want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """float32 only; at most two reduced and four kept axes after
    merging; the lane mode on (M, n, n) blocks at n = 4, 8, 16, 32."""
    from x265_mod_by_patman_tpu_torch.ops.cuda.ordered_sum import \
        ordered_sum_lanes
    with pytest.raises(TypeError):
        ordered_sum(torch.zeros((4, 3), dtype=torch.float64), 0)
    with pytest.raises(ValueError):     # three reduced axes
        ordered_sum(torch.zeros((2, 3) * 3), (0, 2, 4))
    with pytest.raises(ValueError):     # five kept axes
        ordered_sum(torch.zeros((2, 3) * 5), (1, 3, 5, 7, 9))
    with pytest.raises(ValueError):     # n = 2
        ordered_sum_lanes(torch.zeros((3, 2, 2)), 2)
    with pytest.raises(ValueError):     # (n*n, M) terms, not blocks
        ordered_sum_lanes(torch.zeros((16, 3)), 4)


def _permuted_osum(x, dims):
    """The sum as osum made it before it read the caller's layout: the
    reduced dims permuted first and the terms copied to (K, M)."""
    keep = [d for d in range(x.dim()) if d not in dims]
    shape = [x.shape[d] for d in keep]
    xt = x.permute(*dims, *keep).reshape(-1, int(np.prod(shape))) \
        .contiguous()
    return osum_plain(xt).reshape(shape)


def _site_view(site):
    """A call site's terms in the layout its caller hands osum, and the
    reduced dims: _group_sum's (gh, g, gw, g) crop of the block map (a
    slice where the groups do not cover it), _modes_rd_multi's 2x2 CTU
    groups of the (F, nby, nbx, 35) totals and of the chosen totals
    (views of a slice), _tree_sum's padded 32x32 windows and its last
    level."""
    kind, shape = site
    x = torch.from_numpy(_terms(shape, sum(shape)))
    if kind == "group":
        g = 4 if shape[0] % 4 == 3 else 2
        gh, gw = shape[0] // g, shape[1] // g
        return x[:gh * g, :gw * g].reshape(gh, g, gw, g), (1, 3)
    if kind == "modes":
        f, nby, nbx = shape[:3]
        cy, cx = nby // 2, nbx // 2
        return x[:, :cy * 2, :cx * 2].reshape(f, cy, 2, cx, 2,
                                              *shape[3:]), (2, 4)
    if kind == "windows":
        h, w = shape
        a = torch.nn.functional.pad(x, (0, (-w) % 32, 0, (-h) % 32))
        return a.reshape(a.shape[0] // 32, 32, a.shape[1] // 32, 32), (1, 3)
    return x, (0, 1)


@pytest.mark.parametrize("site", [
    ("group", (34, 60)), ("group", (135, 240)), ("group", (67, 121)),
    ("modes", (2, 9, 13, 35)), ("modes", (1, 8, 12, 35)),
    ("modes", (2, 9, 13)), ("windows", (68, 120)), ("windows", (17, 30)),
    ("last", (17, 30)), ("last", (3, 4))])
def test_osum_reads_the_callers_layout(site):
    """osum reads each call site's terms where they lie (the kernel's
    sizes and strides, here through torch.as_strided on the CPU) and
    gives the bits of the old permute-then-sum, with no copy of the
    terms: the term view shares the caller's storage."""
    from x265_mod_by_patman_tpu_torch.ops.cuda.ordered_sum import (
        term_layout, terms_view)
    x, dims = _site_view(site)
    got = osum(x, dims)
    np.testing.assert_array_equal(got.numpy(),
                                  _permuted_osum(x, dims).numpy())
    lay = term_layout(x, dims)
    assert lay is not None and lay.k * lay.m == x.numel()
    assert len(lay.reduced) <= 2 and len(lay.kept) <= 4
    v = torch.as_strided(x, [s for s, _ in lay.reduced + lay.kept],
                         [st for _, st in lay.reduced + lay.kept],
                         x.storage_offset())
    assert v.data_ptr() == x.data_ptr()
    np.testing.assert_array_equal(terms_view(x, lay).numpy(),
                                  x.permute(*dims, *[
                                      d for d in range(x.dim())
                                      if d not in dims]).reshape(
                                          lay.k, lay.m).numpy())


@pytest.mark.parametrize("case", ["merge", "drop_ones", "interleaved",
                                  "empty", "five_axes"])
def test_term_layout_arithmetic(case):
    """The sizes and strides the kernel is given: neighbours that one
    stride walks merge, size-1 axes drop, interleaved reduced and kept
    axes stay apart, an empty side is one axis of size 1, and five
    reduced axes that do not merge are refused (no call site has more
    than two)."""
    from x265_mod_by_patman_tpu_torch.ops.cuda.ordered_sum import (
        MAX_REDUCED, term_layout)
    if case == "merge":
        x = torch.zeros((4, 5, 6))
        assert term_layout(x, (1, 2)) == (((30, 1),), ((4, 30),))
    elif case == "drop_ones":
        x = torch.zeros((1, 5, 1, 6))
        assert term_layout(x, (0, 1)) == (((5, 6),), ((6, 1),))
    elif case == "interleaved":
        x = torch.zeros((3, 4, 5, 6))
        assert term_layout(x, (1, 3)) == (((4, 30), (6, 1)),
                                          ((3, 120), (5, 6)))
    elif case == "empty":
        x = torch.zeros((5, 6))
        assert term_layout(x, (0, 1)) == (((30, 1),), ((1, 0),))
        assert term_layout(x, ()) == (((1, 0),), ((30, 1),))
    else:
        x = torch.from_numpy(_terms((2,) * 10, 3))
        dims = (1, 3, 5, 7, 9)
        assert MAX_REDUCED == 2
        with pytest.raises(ValueError):
            term_layout(x, dims)
        with pytest.raises(ValueError):
            osum(x, dims)
        # merged to one axis, the same five dims are taken
        x = torch.from_numpy(_terms((3,) + (2,) * 5, 3))
        np.testing.assert_array_equal(
            osum(x, (1, 2, 3, 4, 5)).numpy(),
            _permuted_osum(x, (1, 2, 3, 4, 5)).numpy())


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_lsum_reads_the_blocks_in_place(n):
    """lsum hands the kernel the (M, n, n) blocks where they lie (no
    transpose); the bits equal the old transposed terms', and every
    other block of a taller tensor (block-strided) gives the same."""
    from x265_mod_by_patman_tpu_torch.ops.cuda.ordered_sum import \
        ordered_sum_lanes
    from x265_mod_by_patman_tpu_torch.ops.numeric import (lanes_sum_plain,
                                                          lsum)
    x = torch.from_numpy(_terms((3, 7, n, n), n) * F32(1e-2))
    old = lanes_sum_plain(x.reshape(-1, n * n).T.contiguous(), n)
    np.testing.assert_array_equal(lsum(x).numpy(), old.reshape(3, 7))
    wide = torch.from_numpy(_terms((42, n, n), n + 1))
    np.testing.assert_array_equal(
        ordered_sum_lanes(wide[::2], n).numpy(),
        lanes_sum_plain(wide[::2].reshape(-1, n * n).T.contiguous(),
                        n).numpy())


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


def test_lowres_mean_equals_reference_at_2160p():
    """Fault 1's repair: 20 frames of 2160p lowres (1088x1920 plane at 8
    and 12 bits, 136x240 intra costs): both scalars bit-identical to the
    reference's.  The mean's last level is a 2x2 reduce that the
    reference's backend adds as (a00 + a01) + (a10 + a11) (its compiled
    code); the row-major order the port had there fails some frames."""
    rng = np.random.default_rng(7)
    ref_fn = jax.jit(jla._lowres_scalars)
    rowmajor_bad = 0
    for i in range(20):
        low = rng.integers(0, 4096 if i % 2 else 256,
                           (1088, 1920)).astype(np.int32)
        intra = rng.integers(800, 4200, (136, 240)).astype(np.int32)
        ref = np.asarray(ref_fn(jnp.asarray(low), jnp.asarray(intra)))
        lt = torch.from_numpy(low)
        got = tla._lowres_scalars(lt, torch.from_numpy(intra)).numpy()
        np.testing.assert_array_equal(got, ref)
        # the row-major last level, as before the repair
        win = lt.reshape(34, 32, 60, 32).sum((1, 3), dtype=torch.int64)
        a = torch.nn.functional.pad(win.to(torch.float32), (2, 2, 15, 15))
        a = osum(a.reshape(2, 32, 2, 32), (1, 3))
        old = osum(a, (0, 1)) * torch.tensor(F32(1.0) / F32(lt.numel()))
        rowmajor_bad += int(old.item() != ref[0])
    assert rowmajor_bad > 0


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


# -- the multiply-adds of the RD costs and the TU sums ----------------------
#
# The reference's CPU backend contracts a float32 multiply into the add
# that consumes it (one rounding) and sums each n x n transform block of
# a fused element-wise term 8 lanes wide.  The sums are read out of the
# reference's own jitted functions: _p_core / _b_core are traced again
# with their module's jnp, jax.vmap and _rd_resid_cost wrapped so that
# the values they produce become extra outputs of the same program.

def _capturing(core, static, rec):
    """A jitted call of `core`'s function that also returns what the
    wrappers recorded while it was traced (rec: (tag, arrays...))."""
    import functools
    from jax._src.interpreters.batching import BatchTracer
    from x265_mod_by_patman_tpu.analysis import inter_mode as jim
    inner = core.__wrapped__
    tags = []
    orig_rd = jim._rd_resid_cost

    class Jnp:
        def __getattr__(self, k):
            return getattr(jnp, k)

        def minimum(self, a, b):
            if getattr(a, "dtype", None) == np.float32 and \
                    getattr(b, "shape", None) == a.shape and \
                    not isinstance(a, BatchTracer):
                rec.append(("min", a, b))
            return jnp.minimum(a, b)

        def where(self, c, x, y=None):
            if getattr(x, "ndim", 0) == 2 and hasattr(y, "shape") \
                    and not isinstance(x, BatchTracer):
                rec.append(("w2" if y.shape != () else "masked", x))
            return jnp.where(c, x, y)

    class Jax:
        def __getattr__(self, k):
            return getattr(jax, k)

        def vmap(self, fn):
            def run(*args):
                out = jax.vmap(fn)(*args)
                rec.append(("vmap",) + tuple(out))
                return out
            return run

    def rd(org, pred, qp_b, log2n, bd, lam2):
        cc, sz = orig_rd(org, pred, qp_b, log2n, bd, lam2)
        if not isinstance(cc, BatchTracer):
            rec.append(("rd", org, pred, qp_b, lam2, cc, sz))
        return cc, sz

    @functools.wraps(inner)
    def f(*a, **k):
        rec.clear()
        saved = jim.jnp, jim.jax, jim._rd_resid_cost
        jim.jnp, jim.jax, jim._rd_resid_cost = Jnp(), Jax(), rd
        try:
            out = inner(*a, **k)
        finally:
            jim.jnp, jim.jax, jim._rd_resid_cost = saved
        tags[:] = [(e[0], len(e) - 1) for e in rec]
        return out, [x for e in rec for x in e[1:]]

    jf = jax.jit(f, static_argnames=static)
    calls = []

    @functools.wraps(core)
    def call(*a, **k):
        out, flat = jf(*a, **k)
        evs, i = [], 0
        for tag, m in tags:
            evs.append((tag,) + tuple(np.asarray(v) for v in flat[i:i + m]))
            i += m
        calls.append(evs)
        return out
    return call, calls


def _fma(a, b, c):
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _plain(a, b, c):
    return (np.asarray(c, F32) + (F32(a) * np.asarray(b, F32))).astype(F32)


def _count_sites(calls, w, h, merge_len, gbits_at):
    """Per site, (sums, equal with one rounding, equal with two): the
    residual cost sse + lam2 * bits (_rd_resid_cost), the region totals
    gsum + lam2 * gbits, and both sides of the minima cc + lam2 * s /
    sz + lam2 * s' (the ME winner's, best_rd; the merge candidates',
    rdk_all), s recovered from the sz side."""
    from x265_mod_by_patman_tpu_torch.analysis import inter_mode as tim
    from x265_mod_by_patman_tpu_torch.analysis.inter_mode import (
        _group_sum, _rd_resid_cost)
    from x265_mod_by_patman_tpu_torch.ops import numeric
    nby, nbx = h // 16, w // 16
    sites = {k: [0, 0, 0] for k in ("rd", "region", "best_rd", "rdk_all")}
    t = lambda a: torch.from_numpy(np.array(a))
    for evs in calls:
        last_rd = last_vmap = None
        w2 = []
        for e in evs:
            if e[0] == "rd":
                _, org, pred, qp_b, lam2, cc, sz = e
                last_rd, w2 = e, []
                # the port's cost, with one rounding and with two
                s = sites["rd"]
                s[0] += cc.size
                for i, fma in ((1, tim.fma32),
                               (2, lambda a, b, c: c + a * b)):
                    tim.fma32 = fma
                    try:
                        got, _ = _rd_resid_cost(t(org), t(pred), t(qp_b),
                                                4, 8, t(lam2))
                    finally:
                        tim.fma32 = numeric.fma32
                    s[i] += int((got.numpy() == cc).sum())
            elif e[0] == "vmap":
                last_vmap = e
            elif e[0] == "min" and last_rd is not None:
                _, a, b = e
                lam2 = F32(last_rd[4])
                if a.ndim == 1 and a.shape == last_rd[5].shape:
                    cc, sz, key, step = last_rd[5], last_rd[6], "best_rd", -1
                    if np.array_equal(a, cc):
                        continue             # min(cc, sz): no product
                elif a.ndim == 2 and last_vmap is not None \
                        and a.shape == last_vmap[2].shape:
                    cc, sz, key, step = last_vmap[2], last_vmap[3], \
                        "rdk_all", 4
                else:
                    continue
                sb = np.rint((b.astype(np.float64) - sz) / lam2)
                sa = sb + step
                ok = (a < 1e38) & (b < 1e38)
                s = sites[key]
                s[0] += int(ok.sum())
                s[1] += int((ok & (_fma(lam2, sa, cc) == a)
                             & (_fma(lam2, sb, sz) == b)).sum())
                s[2] += int((ok & (_plain(lam2, sa, cc) == a)
                             & (_plain(lam2, sb, sz) == b)).sum())
            elif e[0] == "w2":
                w2.append(e)
                if len(w2) == merge_len:
                    tot, gb = w2[0][1], w2[gbits_at][1]
                    assert tot.dtype == F32 and gb.dtype == np.int32
                    _, _o, _p, _q, lam2, cc, sz = last_rd
                    gh, gw = tot.shape
                    g = 2 if (gh, gw) == (nby // 2, nbx // 2) else 4
                    blk = np.minimum(cc, sz).reshape(nby, nbx)[
                        :gh * g, :gw * g]
                    gs = _group_sum(torch.from_numpy(blk.copy()), gh, g,
                                    gw).numpy()
                    m = tot < F32(1e38)
                    s = sites["region"]
                    s[0] += int(m.sum())
                    s[1] += int((_fma(lam2, gb, gs) == tot)[m].sum())
                    s[2] += int((_plain(lam2, gb, gs) == tot)[m].sum())
                    w2 = []
    return sites


def test_rd_cost_products_round_once_as_the_reference():
    """The FMA repair: every x + lam2 * y site of the P and B analysis
    against the reference's own _p_core / _b_core, on 416x240 scenes at
    QP 22-40.  With one rounding (ops.numeric.fma32) all of at least
    2,000 sums of each site equal the reference's; with two the
    residual costs (and the B picture's best_rd) differ on some."""
    from x265_mod_by_patman_tpu.analysis import inter_mode as jim
    from x265_mod_by_patman_tpu.encoder.top import Encoder as JEncoder
    from x265_mod_by_patman_tpu.params import default_params
    from tests.test_e2e_inter import moving_scene
    w, h = 416, 240
    static_p = ("wpat", "search_range", "block", "bd", "log2_ctu",
                "use_pallas", "subme", "rect", "amp", "band", "cpat",
                "cshift", "is422", "me_sea", "hme", "rounds")
    static_b = ("search_range", "block", "bd", "use_pallas", "subme", "wb",
                "cshift", "is422", "rect", "log2_ctu", "me_sea", "amp",
                "hme", "rounds")
    rec = []
    p_core, p_calls = _capturing(jim._p_core, static_p, rec)
    b_core, b_calls = _capturing(jim._b_core, static_b, rec)
    saved = jim._p_core, jim._b_core
    jim._p_core, jim._b_core = p_core, b_core
    try:
        enc = JEncoder(default_params(w, h).validate())
        pad = lambda f: tuple(enc._pad(a, s) for a, s in zip(f, (0, 1, 1)))
        for k in range(4):
            fr = [pad(f) for f in moving_scene(w, h, 3, seed=k)]
            qp = 22 + (k * 5) % 19
            jim.analyse_p_frame(*fr[1], [fr[0]], enc.sps, qp)
            jim.analyse_b_frame(*fr[1], [fr[0]], [fr[2]], enc.sps, qp)
    finally:
        jim._p_core, jim._b_core = saved
    two_roundings_differ = False
    for name, calls, merge_len, gbits_at in (("P", p_calls, 7, 5),
                                             ("B", b_calls, 11, 9)):
        sites = _count_sites(calls, w, h, merge_len, gbits_at)
        print(name, sites)
        for key, (n, one, two) in sites.items():
            assert n >= (400 if key == "best_rd" else 2000), (name, sites)
            assert one == n, (name, key, sites)
            two_roundings_differ |= two < n
    assert two_roundings_differ


@pytest.mark.parametrize("log2n", [2, 3, 4, 5])
def test_tu_rd_sums_follow_the_reference_lane_order(log2n):
    """Fault 3's repair at tu_rd_levels: the level-units TU costs of the
    reference's own jitted _tu_rd_for_modes (n = 8, 16, 32) and
    _tu4_costs (TU8 and the four TU4 DSTs, n = 4) on random planes and
    modes, QP 12-44: the port's element d * d + K * bits rounded once
    and summed in K3's lane order equals all of at least 400 sums; the
    pairwise order (fsum) it replaced does not."""
    from x265_mod_by_patman_tpu.analysis import intra_mode as jim
    from x265_mod_by_patman_tpu.frame.zscan import frame_avail_masks
    from x265_mod_by_patman_tpu_torch.analysis import intra_mode as tim
    from x265_mod_by_patman_tpu_torch.ops import rdoq
    n = 8 if log2n == 2 else 1 << log2n
    w, h = (256, 128) if n < 16 else (512, 256)
    rng = np.random.default_rng(log2n)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    total = equal = pairwise = 0
    for trial in range(4 if n == 32 else 2):
        orig = rng.integers(0, 256, (h, w)).astype(np.int32)
        orig = (orig + np.roll(orig, 1, 1)) // 2
        nby, nbx = h // n, w // n
        avail = frame_avail_masks(w, h, n, 6, 0).reshape(nby * nbx, -1)
        bys, bxs = np.mgrid[0:nby, 0:nbx]
        bx = bxs.ravel().astype(np.int32)
        by = bys.ravel().astype(np.int32)
        modes = rng.integers(0, 35, bx.shape[0]).astype(np.int32)
        qp = int(rng.integers(12, 45))
        args = (orig, avail, bx, by, modes)
        if log2n == 2:
            ref = np.asarray(jim._tu4_costs(*map(jnp.asarray, args), qp)[1])
            got = lambda: tim._tu4_costs(*map(t, args), qp)[1].numpy()
        else:
            ref = np.asarray(jim._tu_rd_for_modes(*map(jnp.asarray, args),
                                                  qp, log2n))
            got = lambda: tim._tu_rd_for_modes(*map(t, args), qp,
                                               log2n).numpy()
        total += ref.size
        equal += int((got() == ref).sum())
        lanes = rdoq.lsum
        rdoq.lsum = lambda x: fsum(x, (-2, -1))
        try:
            pairwise += int((got() == ref).sum())
        finally:
            rdoq.lsum = lanes
    assert total >= 400 and equal == total, (equal, total)
    assert pairwise < total
