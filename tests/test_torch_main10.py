"""The PyTorch port at 10 and 12 bits against the JAX reference, on the
same seeded inputs:

* op parity at bit depths 10 and 12: the transform, quant and dequant,
  RDOQ levels (with the float32 TU estimate), the 35-mode intra
  prediction with its substitution and smoothing, MC (8- and 4-tap,
  the 14-bit intermediate, bi and weighted), deblocking and SAO
  statistics / decision / apply;
* K1's and K2's plain versions on 12-bit-range planes against the
  reference's golden `full_search_ref` and `mc_block_ref`;
* a 12-bit saturated TU whose levels must survive the int16 level store;
* Main10 and 12-bit streams at 96x64: all-intra, the repo defaults (B
  pyramid, lookahead), CRF with AQ 2 and cuTree, and 12-bit with
  bframes=1 (tests/test_12bit.py's case), byte-identical to the JAX
  encoder's and decoded by the in-repo decoder with matching MD5 SEI.

Tolerance: exact for integers, levels, pixels and bytes; the float32 TU
estimates at rtol 1e-5 (the port sums in a fixed pairwise order,
ROADMAP §3)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.ops import deblock as jd
from x265_mod_by_patman_tpu.ops import intra as ji
from x265_mod_by_patman_tpu.ops import interp as jmc
from x265_mod_by_patman_tpu.ops import me as jme
from x265_mod_by_patman_tpu.ops import rdoq as jr
from x265_mod_by_patman_tpu.ops import sao as js
from x265_mod_by_patman_tpu.ops import transform as jt
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.convert import to_numpy, to_torch
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from x265_mod_by_patman_tpu_torch.frame.planes import pack_levels, pack_recon
from x265_mod_by_patman_tpu_torch.ops import deblock as td
from x265_mod_by_patman_tpu_torch.ops import intra as tin
from x265_mod_by_patman_tpu_torch.ops import interp as tmc
from x265_mod_by_patman_tpu_torch.ops import rdoq as tr
from x265_mod_by_patman_tpu_torch.ops import sao as ts
from x265_mod_by_patman_tpu_torch.ops import transform as tt
from x265_mod_by_patman_tpu_torch.ops.cuda.full_search import (
    full_search_plain)
from x265_mod_by_patman_tpu_torch.ops.cuda.gather import window_gather_plain
from tests.test_10bit import synth10
from tests.test_12bit import synth12
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
DEPTHS = (10, 12)


def _t(a):
    return to_torch(a, CPU)


def _eq(got, exp, msg=""):
    np.testing.assert_array_equal(to_numpy(got) if isinstance(
        got, torch.Tensor) else np.asarray(got), np.asarray(exp),
        err_msg=msg)


@pytest.mark.parametrize("bd", DEPTHS)
@pytest.mark.parametrize("log2n,dst", [(2, True), (3, False), (4, False),
                                       (5, False)])
def test_transform_quant_at_depth(bd, log2n, dst):
    rng = np.random.default_rng(bd * 10 + log2n)
    n, b, top = 1 << log2n, 8, (1 << bd) - 1
    resi = rng.integers(-top, top + 1, (b, n, n)).astype(np.int32)
    resi[: b // 2] //= 16
    coef = np.asarray(jt.dct_batch(jnp.asarray(resi), log2n, bd, dst))
    _eq(tt.dct_batch(_t(resi), log2n, bd, dst), coef)
    _eq(coef[0], jt.dct_ref(resi[0], bd, dst))
    _eq(tt.idct_batch(_t(coef), log2n, bd, dst),
        jt.idct_batch(jnp.asarray(coef), log2n, bd, dst))
    imask = np.arange(b) % 2 == 0
    qp = rng.integers(4, 45, b).astype(np.int32)
    lev = np.asarray(jt.quant_dyn(jnp.asarray(coef), jnp.asarray(imask),
                                  jnp.asarray(qp), log2n, bd))
    _eq(tt.quant_dyn(_t(coef), _t(imask), _t(qp), log2n, bd), lev)
    _eq(lev[0], jt.quant_ref(coef[0], int(qp[0]), log2n, bd, True))
    _eq(tt.quant_batch(_t(coef), 27, log2n, bd, False),
        jt.quant_batch(jnp.asarray(coef), 27, log2n, bd, False))
    deq = np.asarray(jt.dequant_dyn(jnp.asarray(lev), jnp.asarray(qp),
                                    log2n, bd))
    _eq(tt.dequant_dyn(_t(lev), _t(qp), log2n, bd), deq)
    _eq(deq[1], jt.dequant_ref(lev[1], int(qp[1]), log2n, bd))
    _eq(tt.sbh_adjust(_t(lev), _t(coef), _t(imask), _t(qp), log2n, bd),
        jt.sbh_adjust(jnp.asarray(lev), jnp.asarray(coef),
                      jnp.asarray(imask), jnp.asarray(qp), log2n, bd))


@pytest.mark.parametrize("bd", DEPTHS)
@pytest.mark.parametrize("log2n,c_idx", [(2, 0), (3, 1), (4, 0), (5, 0)])
def test_rdoq_at_depth(bd, log2n, c_idx):
    rng = np.random.default_rng(bd + log2n)
    n, b = 1 << log2n, 12
    resi = rng.integers(-40, 41, (b, n, n)).astype(np.int32) << (bd - 8)
    resi[: b // 2] //= 6
    coef = np.asarray(jt.dct_batch(jnp.asarray(resi), log2n, bd))
    imask = np.arange(b) % 3 != 0
    qp = np.full(b, 30, np.int32)
    qp[::4] = 37
    for it in (None, 1):
        exp = np.asarray(jr.rdoq_levels(
            jnp.asarray(coef), jnp.asarray(imask), jnp.asarray(qp), log2n,
            bd, c_idx, None if it is None else jnp.int32(it)))
        _eq(tr.rdoq_levels(_t(coef), _t(imask), _t(qp), log2n, bd, c_idx,
                           it), exp, f"init_type {it}")
    np.testing.assert_allclose(
        to_numpy(tr.tu_rd_levels(_t(coef), _t(qp), log2n, bd)),
        np.asarray(jr.tu_rd_levels(jnp.asarray(coef), jnp.asarray(qp),
                                   log2n, bd)), rtol=1e-5, atol=0)


@pytest.mark.parametrize("bd", DEPTHS)
def test_saturated_12bit_levels_fit_the_int16_store(bd):
    """A TU of full-range residuals at QP 0: HEVC clips coefficients and
    levels to 16 bits without extended precision, so the int16 level
    store (pack_levels) and the int16 recon buffer (pack_recon) hold
    them exactly."""
    top = (1 << bd) - 1
    for log2n in (2, 3, 4, 5):
        n = 1 << log2n
        yy, xx = np.mgrid[0:n, 0:n]
        resi = np.stack([np.where((yy + xx) % 2 == 0, top, -top),
                         np.full((n, n), top), np.full((n, n), -top)]
                        ).astype(np.int32)
        coef = np.asarray(jt.dct_batch(jnp.asarray(resi), log2n, bd))
        lev_j = np.asarray(jt.quant_dyn(
            jnp.asarray(coef), jnp.asarray(np.ones(3, bool)),
            jnp.asarray(np.zeros(3, np.int32)), log2n, bd))
        lev = tt.quant_dyn(_t(coef), _t(np.ones(3, bool)),
                           _t(np.zeros(3, np.int32)), log2n, bd)
        _eq(lev, lev_j)
        assert int(lev.abs().max()) <= 32767
        assert int(lev.abs().max()) > 1 << (bd - 1)
        packed = pack_levels(lev, lev, lev)
        _eq(packed[0].to(torch.int32), lev_j)
    plane = torch.full((4, 6), top, dtype=torch.int32)
    flat = pack_recon(plane, plane[:2, :3], plane[:2, :3], bd)
    assert flat.dtype == torch.int16
    assert (flat.numpy().view(np.uint16) == top).all()


@pytest.mark.parametrize("bd", DEPTHS)
@pytest.mark.parametrize("log2n", [2, 3, 4, 5])
def test_intra_prediction_at_depth(bd, log2n):
    rng = np.random.default_rng(bd * 7 + log2n)
    n, b = 1 << log2n, 6
    s = rng.integers(0, 1 << bd, (b, 4 * n + 1)).astype(np.int32)
    s[2] = (1 << (bd - 1)) + np.arange(4 * n + 1)      # smooth: strong
    avail = rng.random((b, 4 * n + 1)) < 0.7
    avail[0] = False
    avail[1:3] = True
    strong = log2n == 5
    ej = ji.substitute_filter_batch(jnp.asarray(s), jnp.asarray(avail),
                                    log2n, bd, strong)
    et = tin.substitute_filter_batch(_t(s), _t(avail), log2n, bd, strong)
    for a, e in zip(et, ej):
        _eq(a, e)
    su, sf = (np.asarray(a) for a in ej)
    for c_idx in (0, 1):
        _eq(tin.intra_pred_all_batch(_t(su), _t(sf), log2n, c_idx, bd),
            ji.intra_pred_all_batch(jnp.asarray(su), jnp.asarray(sf),
                                    log2n, c_idx, bd))
        modes = rng.integers(0, 35, b).astype(np.int32)
        modes[:3] = (1, 10, 26)
        sel = tin.intra_pred_select_batch(_t(su), _t(sf), _t(modes), log2n,
                                          c_idx, bd)
        _eq(sel, ji.intra_pred_select_batch(
            jnp.asarray(su), jnp.asarray(sf), jnp.asarray(modes), log2n,
            c_idx, bd))
        if c_idx == 0 and log2n < 5:
            for k in range(b):
                m = int(modes[k])
                src = sf[k] if ji.intra_filter_flag(m, log2n) else su[k]
                _eq(to_numpy(sel)[k], ji.intra_pred_ref(m, src, log2n, 0,
                                                        bd))


def _mc_case(seed, bd, h=48, w=64, b=10, span=120):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 1 << bd, (h, w)).astype(np.int32)
    x0 = rng.integers(-8, w, b).astype(np.int32)
    y0 = rng.integers(-8, h, b).astype(np.int32)
    mvx = rng.integers(-span, span, b).astype(np.int32)
    mvy = rng.integers(-span, span, b).astype(np.int32)
    mvx[:4] = (0, 1, 4, 6)
    mvy[:4] = (0, 0, 2, 7)
    return ref, x0, y0, mvx, mvy


@pytest.mark.parametrize("bd", DEPTHS)
@pytest.mark.parametrize("c_idx,n", [(0, 16), (0, 8), (1, 8), (2, 4)])
def test_mc_at_depth(bd, c_idx, n):
    """8-tap luma / 4-tap chroma MC through K2's plain version, the 14-bit
    intermediate, the bi-prediction combine and explicit weighting, against
    the reference's XLA path and its numpy goldens."""
    ref, x0, y0, mvx, mvy = _mc_case(bd + 10 * c_idx + n, bd)
    args_j = (jnp.asarray(ref), jnp.asarray(x0), jnp.asarray(y0),
              jnp.asarray(mvx), jnp.asarray(mvy), n, c_idx, bd)
    args_t = (_t(ref), _t(x0), _t(y0), _t(mvx), _t(mvy), n, c_idx, bd)
    got = to_numpy(tmc.mc_batch(*args_t))
    _eq(got, jmc.mc_batch(*args_j, use_pallas=False))
    got14 = to_numpy(tmc.mc_batch_14(*args_t))
    _eq(got14, jmc.mc_batch_14(*args_j, use_pallas=False))
    for k in range(4):
        a = (ref, int(x0[k]), int(y0[k]), int(mvx[k]), int(mvy[k]), n, n,
             c_idx, bd)
        _eq(got[k], jmc.mc_block_ref(*a))
        _eq(got14[k], jmc.mc_block_ref_14(*a))
    rev = got14[::-1].copy()
    _eq(tmc.bi_combine(_t(got14), _t(rev), bd),
        jmc.bi_combine_ref(got14, rev, bd))
    _eq(tmc.wp_apply_batch(_t(got14), 70, -5 << (bd - 8), 6, bd),
        jmc.wp_apply_batch(jnp.asarray(got14), 70, -5 << (bd - 8), 6, bd))
    _eq(tmc.wp_apply_batch(_t(got14), 70, -5 << (bd - 8), 6, bd),
        jmc.wp_apply_ref(got14, 70, -5 << (bd - 8), 6, bd))


def _planes(w, h, bd, seed):
    """Flat 8x8 blocks a few steps apart (the blocking the filter
    smooths) over low noise, in the bit depth's range."""
    rng = np.random.default_rng(seed)
    s = 1 << (bd - 8)

    def plane(ph, pw, base):
        steps = np.kron(rng.integers(0, 5, (ph // 8, pw // 8)),
                        np.ones((8, 8), np.int64))
        return (base + (3 * steps + rng.integers(0, 2, (ph, pw))) * s
                ).astype(np.int32)
    return (plane(h, w, 80 * s), plane(h // 2, w // 2, 110 * s),
            plane(h // 2, w // 2, 120 * s))


@pytest.mark.parametrize("bd", DEPTHS)
@pytest.mark.parametrize("qp", [22, 37])
def test_deblock_at_depth(bd, qp):
    w, h = 96, 64
    y, u, v = _planes(w, h, bd, qp + bd)
    merge32 = np.array([[True, False, True], [False, True, False]])
    bs = td.intra_bs_maps(w, h, 16, None, merge32)
    on = td.chroma_on_maps(bs[0], bs[1], h // 2, w // 2)
    qpc = jd.CHROMA_QP_TABLE[min(qp, 69)]
    exp = jd.deblock_frame_batch(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.asarray(bs[0]),
        jnp.asarray(bs[1]), jnp.asarray(on[0]), jnp.asarray(on[1]),
        jnp.asarray(qp, jnp.int32), int(qpc), int(qpc), 0, 0, bd, 1, 6)
    got = td.deblock_frame_batch(
        _t(y), _t(u), _t(v), bs[0], bs[1], on[0], on[1], qp, int(qpc),
        int(qpc), 0, 0, bd, 1, 6)
    for a, e in zip(got, exp):
        _eq(a, e)
    assert not np.array_equal(to_numpy(got[0]), y)     # the edge filtered
    _eq(got[0], jd.deblock_luma_ref(y, bs[0], bs[1], qp, bit_depth=bd,
                                    log2_ctu=6))


@pytest.mark.parametrize("bd", DEPTHS)
def test_sao_at_depth(bd):
    ctu, h, w = 32, 32, 48
    rng = np.random.default_rng(bd)
    top = (1 << bd) - 1
    org = np.zeros((h, 64), np.int32)
    rec = np.zeros((h, 64), np.int32)
    org[:, :w] = rng.integers(0, top + 1, (h, w))
    rec[:, :w] = np.clip(org[:, :w] + rng.integers(-5, 6, (h, w))
                         * (1 << (bd - 8)), 0, top)
    exp = js.sao_stats_batch(jnp.asarray(org), jnp.asarray(rec), ctu, h, w,
                             bd)
    got = ts.sao_stats_batch(_t(org), _t(rec), ctu, h, w, bd)
    for a, e in zip(got, exp):
        _eq(a, e)
    st = tuple(np.asarray(a) for a in exp)
    lam = 40.0
    for a, e in zip(ts.sao_decide(*st, lam, bd), js.sao_decide(*st, lam,
                                                                bd)):
        _eq(a, e)
    cb = ts.sao_decide_chroma(st, st, lam, bd)
    for a, e in zip(cb, js.sao_decide_chroma(st, st, lam, bd)):
        if isinstance(e, (list, tuple)):
            for x, z in zip(a, e):
                _eq(x, z)
        else:
            _eq(a, e)
    ncx = 2
    t = rng.integers(0, 3, (1, ncx)).astype(np.int32)
    c = rng.integers(0, 4, (1, ncx)).astype(np.int32)
    band = rng.integers(0, 32, (1, ncx)).astype(np.int32)
    o = rng.integers(-31, 32, (1, ncx, 4)).astype(np.int32)
    o[..., :2] = np.abs(o[..., :2])
    o[..., 2:] = -np.abs(o[..., 2:])
    exp_a = js.sao_apply_batch(jnp.asarray(rec), jnp.asarray(t),
                               jnp.asarray(c), jnp.asarray(band),
                               jnp.asarray(o), ctu, h, w, bd)
    got_a = ts.sao_apply_batch(_t(rec), t, c, band, o, ctu, h, w, bd)
    _eq(got_a, exp_a)
    params = [[js.SaoParams(int(t[0, x]), int(c[0, x]), int(band[0, x]),
                            tuple(int(q) for q in o[0, x]))
               for x in range(ncx)]]
    _eq(to_numpy(got_a)[:h, :w], js.sao_apply_ref(rec[:h, :w], params, ctu,
                                                  bd))


def test_kernel_plain_versions_on_12bit_planes():
    """K1's plain chain against the reference's golden full search, and
    K2's plain gather under MC against the golden MC, on planes of 12-bit
    values (0-4095) with blocks on the frame edges."""
    rng = np.random.default_rng(12)
    h, w = 40, 56
    ref = rng.integers(0, 4096, (h, w)).astype(np.int32)
    org = np.roll(ref, (3, -2), (0, 1))
    org[::5] = rng.integers(0, 4096, org[::5].shape)
    for n, r, lam in ((8, 4, 700), (16, 6, 300)):
        # in-frame blocks (the golden reads the source unclamped), with
        # windows that leave the frame on every side
        xs = np.array([0, w - n, (w - n) // 2, 3], np.int32)
        ys = np.array([0, h - n, (h - n) // 2, 1], np.int32)
        pmx = rng.integers(-40, 40, 4).astype(np.int32)
        pmy = rng.integers(-40, 40, 4).astype(np.int32)
        t = [torch.from_numpy(a) for a in (ref, org, xs, ys, pmx, pmy)]
        got = full_search_plain(*t, lam, n, r)
        for k in range(4):
            exp = jme.full_search_ref(ref, org, int(xs[k]), int(ys[k]),
                                      (int(pmx[k]), int(pmy[k])), lam, n, r)
            assert tuple(int(g[k]) for g in got) == exp, (n, k)
    win = window_gather_plain(_t(ref), _t(np.array([-5, 30], np.int32)),
                              _t(np.array([50, -9], np.int32)), 17)
    assert int(win.max()) <= 4095 and win.shape == (2, 17, 17)
    x0 = np.array([-6, 20, w - 10], np.int32)
    y0 = np.array([h - 4, -3, 10], np.int32)
    mvx = np.array([5, -37, 90], np.int32)
    mvy = np.array([-7, 22, -61], np.int32)
    got = to_numpy(tmc.mc_batch(_t(ref), _t(x0), _t(y0), _t(mvx), _t(mvy),
                                16, 0, 12))
    for k in range(3):
        _eq(got[k], jmc.mc_block_ref(ref, int(x0[k]), int(y0[k]),
                                     int(mvx[k]), int(mvy[k]), 16, 16, 0,
                                     12))


STREAMS = {
    # tests/test_10bit.py's intra case
    "main10_intra": (dict(qp=30, keyframe_max=1, internal_bit_depth=10),
                     lambda: [synth10(96, 64, seed=i) for i in range(2)],
                     ["I", "I"]),
    # the repo defaults: B pyramid, b-adapt 2 lookahead, 6 frames
    "main10_defaults": (dict(internal_bit_depth=10),
                        lambda: [synth10(96, 64, seed=3, motion=3 * i)
                                 for i in range(6)], None),
    "main10_crf_aq2_cutree": (dict(rc_mode="crf", crf=28.0, aq_mode=2,
                                   internal_bit_depth=10),
                              lambda: [synth10(96, 64, seed=3, motion=3 * i)
                                       for i in range(6)], None),
    # the same clip at 8 bits: the TU32 QP-chain repair on the 8-bit path
    "main8_crf_aq2_cutree_tu32": (
        dict(rc_mode="crf", crf=28.0, aq_mode=2),
        lambda: [tuple((p >> 2).astype(np.uint8) for p in
                       synth10(96, 64, seed=3, motion=3 * i))
                 for i in range(6)], None),
    # tests/test_12bit.py's inter case at the shared frame size
    "main12_bframes1": (dict(qp=32, keyframe_max=250, bframes=1,
                             internal_bit_depth=12),
                        lambda: [synth12(96, 64, seed=3, motion=3 * i)
                                 for i in range(4)],
                        ["I", "P", "B", "P"]),
}


# Clips on which the reference deblocks a CTU whose only coded residual
# is a TU32 at the inherited QP while its syntax signals another: the
# port repairs that, so its bytes follow the reference's only where the
# reference's stream decodes to the reference's recon.
REF_TU32_FAULT = ("main10_crf_aq2_cutree", "main8_crf_aq2_cutree_tu32")


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_deep_stream_equals_jax_and_decodes(case):
    kw, frames, types = STREAMS[case]
    frames = frames()
    bd = kw.get("internal_bit_depth", 8)
    s_jax, e_jax = jtop.encode_sequence(default_params(96, 64, **kw), frames)
    s_pt, e_pt = ttop.encode_sequence(default_params(96, 64, **kw), frames,
                                      "cpu")
    if types is not None:
        assert [f.slice_type for f in e_pt] == types
    else:
        assert "B" in [f.slice_type for f in e_pt]
    assert [f.qp for f in e_pt] == [f.qp for f in e_jax]
    same = [a.bitstream == b.bitstream for a, b in zip(e_pt, e_jax)]
    if case in REF_TU32_FAULT:
        # the reference's own stream does not decode to its recon in
        # exactly the pictures where the port differs (its QP chain omits
        # TU32-coded residual, ROADMAP §3); everywhere else the bytes
        # are the reference's
        ref_ok = [p.md5 == f.md5 for f, p in zip(e_jax,
                                                 Decoder().decode(s_jax))]
        assert not all(ref_ok)
        assert same == ref_ok
    else:
        for i, ok in enumerate(same):
            assert ok, f"frame {i} bytes differ"
        assert s_pt == s_jax
    dec = Decoder()
    pics = dec.decode(s_pt)
    assert dec.sps.bit_depth == bd
    assert len(pics) == len(e_pt)
    for i, (f, pic) in enumerate(zip(e_pt, pics)):
        assert f.recon[0].dtype == (np.uint8 if bd == 8 else np.uint16)
        for k, plane in enumerate((pic.y, pic.u, pic.v)):
            assert np.array_equal(plane, f.recon[k]), (i, k)
        assert pic.md5 == f.md5 == pic.sei_md5
