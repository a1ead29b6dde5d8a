"""Weighted B prediction (--weightb) and the SEA-pruned integer search
(--me sea) of the PyTorch port against the JAX reference, on the CPU.

* ops: `sea_search_batch` equals the reference's `sea_search_batch` and
  its numpy golden `sea_search_ref`, equals the dense full search when k
  covers every candidate, and resolves ties at the k-th lower bound to
  the lowest candidate index (the reference's `top_k` order, which
  `torch.topk` does not promise); `integral_batch` equals the golden;
  `wp_bi_combine` equals the reference's on random 14-bit inputs;
* streams: a luma fade at 96x64 under --weightb (the reference's
  tests/test_weightb.py clip and params) and moving_scene under --me sea
  (tests/test_sea.py's params) are byte-identical to the reference
  encoder's and decode with matching MD5 SEIs; the fade's B slices carry
  explicit weights.

Tolerance: exact (integers, bytes, pixels, MD5s)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.ops import interp as jinterp
from x265_mod_by_patman_tpu.ops import sea as jsea
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.decoder.decoder import Decoder as TDecoder
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from x265_mod_by_patman_tpu_torch.ops import interp as tinterp
from x265_mod_by_patman_tpu_torch.ops import sea as tsea
from x265_mod_by_patman_tpu_torch.ops.me import full_search_batch
from tests.test_e2e_inter import moving_scene
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401
from tests.test_torch_slow import check_decodes
from tests.test_weightb import _fade_frames

CPU = torch.device("cpu")
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))


def _search_case(h, w, n, r, seed):
    """A reference plane, a shifted noisy source and the n-block grid,
    with random predictors."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    for _ in range(2):                     # some spatial correlation
        ref = (ref + np.roll(ref, 1, 0) + np.roll(ref, 1, 1)) // 3
    orig = np.clip(np.roll(ref, (3, -5), (0, 1))
                   + rng.integers(-6, 7, (h, w)), 0, 255).astype(np.int32)
    bys, bxs = np.mgrid[0:h // n, 0:w // n]
    x0 = (bxs.ravel() * n).astype(np.int32)
    y0 = (bys.ravel() * n).astype(np.int32)
    pm = rng.integers(-4 * r, 4 * r, (2, x0.size)).astype(np.int32)
    return ref, orig, x0, y0, pm[0], pm[1]


def test_integral_batch_equals_golden():
    p = np.random.default_rng(0).integers(0, 4096, (64, 80))
    np.testing.assert_array_equal(tsea.integral_batch(t(p)).numpy(),
                                  tsea.integral_ref(p))


@pytest.mark.parametrize("h,w,n,r,k,lam", [
    (64, 64, 16, 6, 24, 100 * 256), (96, 112, 16, 8, 64, 64 * 256),
    (64, 96, 16, 32, 64, 3000), (48, 64, 8, 4, 20, 700)])
def test_sea_search_equals_jax_and_golden(h, w, n, r, k, lam):
    ref, orig, x0, y0, pmx, pmy = _search_case(h, w, n, r, h + r)
    got = tsea.sea_search_batch(t(ref), t(orig), t(x0), t(y0), t(pmx),
                                t(pmy), lam, n, r, k=k)
    exp = jsea.sea_search_batch(*(jnp.asarray(a) for a in
                                  (ref, orig, x0, y0, pmx, pmy)),
                                lam, n, r, k=k)
    for g, e in zip(got, exp):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    for i in range(0, x0.size, max(1, x0.size // 4)):
        gold = tsea.sea_search_ref(ref, orig, int(x0[i]), int(y0[i]),
                                   (int(pmx[i]), int(pmy[i])), lam, n, r,
                                   k=k)
        assert tuple(int(g[i]) for g in got) == gold, i


def test_sea_equals_full_search_at_k_all():
    n, r = 16, 8
    ref, orig, x0, y0, pmx, pmy = _search_case(96, 112, n, r, 1)
    args = (t(ref), t(orig), t(x0), t(y0), t(pmx), t(pmy), 64 * 256, n, r)
    full = full_search_batch(*args)
    sea = tsea.sea_search_batch(*args, k=(2 * r + 1) ** 2)
    for a, b in zip(full, sea):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_sea_ties_at_the_kth_bound_take_the_lowest_index(k):
    """A constant plane: every bound is the mv-bits charge alone.  A
    predictor halfway between candidates makes equal charges, so the
    k-th place is a tie; the kept windows (and so the MV) must be the
    lowest-index ones, as the reference's top_k and golden keep them."""
    ref = np.full((64, 64), 90, np.int32)
    x0 = np.array([16, 32, 0, 48], np.int32)
    y0 = np.array([16, 32, 48, 0], np.int32)
    pmx = np.array([6, -6, 2, 10], np.int32)
    pmy = np.array([-2, 6, 10, -6], np.int32)
    got = tsea.sea_search_batch(t(ref), t(ref), t(x0), t(y0), t(pmx),
                                t(pmy), 512, 16, 4, k=k)
    exp = jsea.sea_search_batch(*(jnp.asarray(a) for a in
                                  (ref, ref, x0, y0, pmx, pmy)),
                                512, 16, 4, k=k)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    for i in range(x0.size):
        gold = tsea.sea_search_ref(ref, ref, int(x0[i]), int(y0[i]),
                                   (int(pmx[i]), int(pmy[i])), 512, 16, 4,
                                   k=k)
        assert tuple(int(g[i]) for g in got) == gold, i


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_wp_bi_combine_equals_jax(bd):
    rng = np.random.default_rng(bd)
    p0, p1 = (rng.integers(0, 1 << 14, (3, 8, 8)).astype(np.int32)
              for _ in range(2))
    for w0, o0, w1, o1 in ((50, 4, 70, -6), (64, 0, 64, 0),
                           (127, -128, 1, 127)):
        got = tinterp.wp_bi_combine(t(p0), t(p1), w0, o0, w1, o1, 6, bd)
        exp = jinterp.wp_bi_combine(jnp.asarray(p0), jnp.asarray(p1), w0,
                                    o0, w1, o1, 6, bd)
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
        np.testing.assert_array_equal(
            got.numpy(), tinterp.wp_bi_combine_ref(p0, p1, w0, o0, w1, o1,
                                                   6, bd))


def _weightb():
    return default_params(96, 64, qp=30, keyframe_max=250, bframes=2,
                          scenecut=False, cu_tree=False, aq_mode=0,
                          weightp=True, weightb=True, b_adapt=0)


def _sea():
    return default_params(96, 64, qp=32, keyframe_max=250, bframes=2,
                          b_adapt=0, scenecut=False, search_method="sea")


CASES = {"weightb_fade": (_weightb, lambda: _fade_frames(7, 96, 64)),
         "me_sea": (_sea, lambda: moving_scene(96, 64, 5))}


@pytest.fixture(scope="module")
def streams():
    """case -> (JAX stream, port stream, port frames), each case encoded
    once, when a test first reads it."""
    cache = {}

    def get(case):
        if case not in cache:
            params, clip = CASES[case]
            frames = clip()
            js, _ = jtop.encode_sequence(params().validate(), frames)
            ts, tf = ttop.encode_sequence(params().validate(), frames, CPU)
            cache[case] = (js, ts, tf)
        return cache[case]
    return get


def _equals_jax(streams, case):
    js, ts, tf = streams(case)
    assert "B" in {f.slice_type for f in tf}
    assert ts == js


def _decodes(streams, case):
    _, ts, tf = streams(case)
    check_decodes(ts, tf)


def _b_slices_carry_explicit_weights(streams, case):
    """Premise: the fade makes the B slices' pred_weight_table carry an
    explicit luma weight (and one set per list: 1 + 1 references)."""
    _, ts, tf = streams(case)
    tables = []
    parse = TDecoder._parse_pred_weight_table

    def record(self, br, n_l0, n_l1=0):
        got = parse(self, br, n_l0, n_l1)
        if n_l1:
            tables.append((n_l0, n_l1, got))
        return got

    TDecoder._parse_pred_weight_table = record
    try:
        TDecoder().decode(ts)
    finally:
        TDecoder._parse_pred_weight_table = parse
    assert len(tables) == sum(f.slice_type == "B" for f in tf)
    assert all((n0, n1) == (1, 1) for n0, n1, _ in tables)
    assert any(w is not None for _, _, (_d, l0, _c, l1) in tables
               for w in l0 + l1)


STREAM_CHECKS = {"equals_jax": _equals_jax, "decodes": _decodes,
                 "explicit_b_weights": _b_slices_carry_explicit_weights}


# the case outermost: xdist's --dist load hands out runs of consecutive
# tests, so a case's checks land on the worker that encoded it
@pytest.mark.parametrize("case,check", [
    (c, k) for c in CASES for k in STREAM_CHECKS
    if k != "explicit_b_weights" or c == "weightb_fade"])
def test_stream(streams, case, check):
    STREAM_CHECKS[check](streams, case)
