"""4:2:2 chroma (Main 4:2:2 10, RExt) in the PyTorch port against the JAX
reference, on the same seeded numpy inputs:

* op parity at 8, 10 and 12 bits: deblocking of the full-height chroma
  planes (scalar QP and per-CTU QP maps, QpC clipped at 51 with no
  Table 8-10) with the QpC edge maps, SAO on the rectangular (64, 32)
  chroma tiles, intra prediction under the Table 8-3 mode remap, and the
  chroma MC of the two stacked 8x8 TBs (vertical MV doubled);
* IntraReconstructor.run for an I and a P picture at 64x64 (the
  row-doubled chroma grid of stacked TBs);
* analyse_p_frame / analyse_b_frame decisions and MC planes;
* streams at 96x64 on tests/test_422.py's synth422 clip (seed 5, motion
  3 px a frame, six frames, I P B B B B with the pyramid): the repo
  defaults at 8 bits and CRF 28 + AQ 2 + cuTree at 10 bits, byte-
  identical to the JAX encoder and decoded by the port's decoder with
  the MD5 SEI matching; the row-banded analysis on 2-row bands; the
  port's CLI on a C422p10 y4m against the JAX CLI.

tests/test_torch_chroma444.py holds 4:4:4 and reuses the helpers here.

Tolerance: exact (integers, levels, pixels, bytes)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_mod_by_patman_tpu import cli as jcli
from x265_mod_by_patman_tpu.analysis import inter_mode as jim
from x265_mod_by_patman_tpu.bitstream.headers import build_sps_info
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.frame.recon_intra import (
    IntraReconstructor as JRecon)
from x265_mod_by_patman_tpu.ops import deblock as jd
from x265_mod_by_patman_tpu.ops import intra as ji
from x265_mod_by_patman_tpu.ops import interp as jmc
from x265_mod_by_patman_tpu.ops import sao as js
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch import cli as tcli
from x265_mod_by_patman_tpu_torch.analysis import inter_mode as tim
from x265_mod_by_patman_tpu_torch.constants.hevc_tables import (
    CHROMA_422_ANGLE_MAP)
from x265_mod_by_patman_tpu_torch.convert import to_numpy, to_torch
from x265_mod_by_patman_tpu_torch.decoder.decoder import Decoder
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from x265_mod_by_patman_tpu_torch.frame.recon_intra import (
    IntraReconstructor as TRecon, _angle422, chroma_qp)
from x265_mod_by_patman_tpu_torch.io.y4m import VideoInfo, Y4MWriter
from x265_mod_by_patman_tpu_torch.ops import deblock as td
from x265_mod_by_patman_tpu_torch.ops import intra as tin
from x265_mod_by_patman_tpu_torch.ops import interp as tmc
from x265_mod_by_patman_tpu_torch.ops import sao as ts
from tests.test_422 import synth422
from tests.test_444 import synth444
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401
from tests.test_torch_recon import _ebits_rows
from tests.test_torch_slow import _small_bands

CPU = torch.device("cpu")
W, H = 96, 64
DEPTHS = (8, 10, 12)
CSP = 2
KEYS = ("recon_y", "recon_u", "recon_v", "lev_y", "lev_u", "lev_v")


def _t(a):
    return to_torch(a, CPU)


def _eq(got, exp, msg=""):
    np.testing.assert_array_equal(
        to_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(exp), err_msg=msg)


def chroma_shape(w, h, csp):
    """(rows, cols) of a chroma plane of a w x h picture."""
    return (h >> (1 if csp == 1 else 0), w >> (0 if csp == 3 else 1))


def blocky_planes(w, h, csp, bd, seed):
    """Flat 8x8 blocks a few steps apart over low noise (what the
    deblocking filter smooths), in the bit depth's range."""
    rng = np.random.default_rng(seed)
    s = 1 << (bd - 8)

    def plane(ph, pw, base):
        steps = np.kron(rng.integers(0, 5, (ph // 8, pw // 8)),
                        np.ones((8, 8), np.int64))
        return (base + (3 * steps + rng.integers(0, 2, (ph, pw))) * s
                ).astype(np.int32)
    hc, wc = chroma_shape(w, h, csp)
    return plane(h, w, 80 * s), plane(hc, wc, 110 * s), \
        plane(hc, wc, 120 * s)


def deep(frames, bd):
    """8-bit (y, u, v) frames at `bd` bits (samples times 2^(bd-8))."""
    if bd == 8:
        return frames
    return [tuple(p.astype(np.uint16) << (bd - 8) for p in f)
            for f in frames]


# -- ops ---------------------------------------------------------------------

def check_deblock(csp, bd, qmap):
    w, h = W, H
    y, u, v = blocky_planes(w, h, csp, bd, 7 * bd + qmap)
    hc, wc = chroma_shape(w, h, csp)
    merge32 = np.array([[True, False, True], [False, True, False]])
    bs_v, bs_h = td.intra_bs_maps(w, h, 16, None, merge32)
    on_v, on_h = td.chroma_on_maps(bs_v, bs_h, hc, wc, csp=csp)
    for a, e in zip((on_v, on_h), jd.chroma_on_maps(bs_v, bs_h, hc, wc,
                                                    csp)):
        _eq(a, e)
    off_cb, off_cr = 3, -2
    if qmap:
        # per-CTU QPs (32x32 CTUs) around 45: their averages with the
        # offsets cross QpC's clip at 51
        qp = np.array([[44, 48, 38], [50, 29, 47]], np.int32)
        qcb, qcr = off_cb, off_cr
    else:
        qp = 49
        qcb, qcr = chroma_qp(qp, off_cb, csp), chroma_qp(qp, off_cr, csp)
    exp = jd.deblock_frame_batch(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.asarray(bs_v),
        jnp.asarray(bs_h), jnp.asarray(on_v), jnp.asarray(on_h),
        jnp.asarray(qp, jnp.int32), qcb, qcr, 0, 0, bd, csp, 5)
    got = td.deblock_frame_batch(_t(y), _t(u), _t(v), bs_v, bs_h, on_v,
                                 on_h, qp, qcb, qcr, 0, 0, bd, csp, 5)
    for a, e, name in zip(got, exp, "yuv"):
        _eq(a, e, name)
    for a, src, off, q in ((got[1], u, off_cb, qcb), (got[2], v, off_cr,
                                                     qcr)):
        assert not np.array_equal(to_numpy(a), src)   # edges filtered
        gold = td.deblock_chroma_ref(
            src, on_v, on_h, q, 0, bd, qp_map=qp if qmap else None,
            c_off=off, log2_ctu=5, csp=csp)
        _eq(a, gold)


def check_chroma_qp_edge_maps(csp):
    hc, wc = chroma_shape(W, H, csp)
    qp = np.array([[44, 48, 38], [50, 29, 47]], np.int32)
    for q in (qp, np.int32(47)):
        exp = jd._chroma_qp_edge_maps(jnp.asarray(q), hc, wc, 4, -3, 5,
                                      csp=csp)
        got = td._chroma_qp_edge_maps(torch.as_tensor(q), hc, wc, 4, -3, 5,
                                      csp)
        for a, e in zip(got, exp):
            _eq(a, e)
    assert int(to_numpy(got[0]).max()) == 51       # clipped, no remap


def check_sao(tile, h, w, bd):
    """Stats, chroma decision and apply on (th, tw) tiles of an h x w
    plane (zero-padded to whole tiles), and the golden apply."""
    th, tw = (tile, tile) if isinstance(tile, int) else tile
    rng = np.random.default_rng(bd + th + tw)
    top = (1 << bd) - 1
    ph, pw = -(-h // th) * th, -(-w // tw) * tw
    org = np.zeros((ph, pw), np.int32)
    rec = np.zeros((ph, pw), np.int32)
    org[:h, :w] = rng.integers(0, top + 1, (h, w))
    rec[:h, :w] = np.clip(org[:h, :w] + rng.integers(-5, 6, (h, w))
                          * (1 << (bd - 8)), 0, top)
    exp = js.sao_stats_batch(jnp.asarray(org), jnp.asarray(rec), tile, h,
                             w, bd)
    got = ts.sao_stats_batch(_t(org), _t(rec), tile, h, w, bd)
    assert exp[0].shape[-2:] == (ph // th, pw // tw)
    for a, e in zip(got, exp):
        _eq(a, e)
    st = tuple(np.asarray(a) for a in exp)
    cb = ts.sao_decide_chroma(st, st, 40.0, bd)
    for a, e in zip(cb, js.sao_decide_chroma(st, st, 40.0, bd)):
        for x, z in (zip(a, e) if isinstance(e, (list, tuple)) else
                     ((a, e),)):
            _eq(x, z)
    ncy, ncx = ph // th, pw // tw
    t = rng.integers(0, 3, (ncy, ncx)).astype(np.int32)
    c = rng.integers(0, 4, (ncy, ncx)).astype(np.int32)
    band = rng.integers(0, 32, (ncy, ncx)).astype(np.int32)
    o = rng.integers(-7, 8, (ncy, ncx, 4)).astype(np.int32)
    o[..., :2] = np.abs(o[..., :2])
    o[..., 2:] = -np.abs(o[..., 2:])
    exp_a = js.sao_apply_batch(jnp.asarray(rec), jnp.asarray(t),
                               jnp.asarray(c), jnp.asarray(band),
                               jnp.asarray(o), tile, h, w, bd)
    got_a = ts.sao_apply_batch(_t(rec), t, c, band, o, tile, h, w, bd)
    _eq(got_a, exp_a)
    params = [[js.SaoParams(int(t[y, x]), int(c[y, x]), int(band[y, x]),
                            tuple(int(q) for q in o[y, x]))
               for x in range(ncx)] for y in range(ncy)]
    _eq(to_numpy(got_a)[:h, :w], ts.sao_apply_ref(rec[:h, :w], params,
                                                  tile, bd))


def ref_samples(log2n, bd, seed, b=35):
    """(b, 4n+1) random S vectors with partial availability."""
    n = 1 << log2n
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << bd, (b, 4 * n + 1)).astype(np.int32)
    raw = (raw + np.roll(raw, 1, 1)) // 2            # some smoothness
    avail = rng.random((b, 4 * n + 1)) < 0.8
    avail[:, 2 * n:] = True
    return raw, avail


def check_intra(log2n, bd, modes_of, filt_chroma):
    """Chroma intra prediction of every mode (mapped by modes_of) against
    the reference's batched op and its golden."""
    raw, avail = ref_samples(log2n, bd, 10 * log2n + bd)
    md = modes_of(np.arange(35, dtype=np.int32))
    js_, jf = ji.substitute_filter_batch(jnp.asarray(raw),
                                         jnp.asarray(avail), log2n, bd)
    ts_, tf = tin.substitute_filter_batch(_t(raw), _t(avail), log2n, bd)
    _eq(ts_, js_)
    _eq(tf, jf)
    got = tin.intra_pred_select_batch(ts_, tf, _t(md), log2n, 1, bd,
                                      filt_chroma=filt_chroma)
    exp = ji.intra_pred_select_batch(js_, jf, jnp.asarray(md), log2n, 1,
                                     bd, filt_chroma=filt_chroma)
    _eq(got, exp)
    su = np.asarray(js_)
    for k in range(35):
        _eq(to_numpy(got)[k], tin.predict_block_ref(
            int(md[k]), su[k], log2n, 1, bd, filt_chroma=filt_chroma),
            f"mode {k}")


def check_chroma_mc(csp, bd):
    """Chroma MC of a block grid the way the analysis' final MC reads it:
    4:2:2 two stacked 8x8 halves with the vertical MV doubled, 4:4:4
    16x16 blocks with both components doubled; 14-bit and pixel output,
    against the reference's ops and the golden."""
    hc, wc = chroma_shape(W, H, csp)
    rng = np.random.default_rng(bd + csp)
    ref = rng.integers(0, 1 << bd, (hc, wc)).astype(np.int32)
    bys, bxs = np.mgrid[0:H // 16, 0:W // 16]
    bx = (bxs.ravel() * 16).astype(np.int32)
    by = (bys.ravel() * 16).astype(np.int32)
    mvx = rng.integers(-70, 70, bx.shape).astype(np.int32)
    mvy = rng.integers(-70, 70, bx.shape).astype(np.int32)
    if csp == 2:
        calls = [(bx >> 1, by + 8 * j, mvx, mvy * 2, 8) for j in (0, 1)]
    else:
        calls = [(bx, by, mvx * 2, mvy * 2, 16)]
    for x0, y0, mx, my, n in calls:
        args = (x0, y0, mx, my)
        for tf, jf in ((tmc.mc_batch, jmc.mc_batch),
                       (tmc.mc_batch_14, jmc.mc_batch_14)):
            got = tf(_t(ref), *(_t(a) for a in args), n, 1, bd)
            exp = jf(jnp.asarray(ref), *(jnp.asarray(a) for a in args), n,
                     1, bd, use_pallas=False)
            _eq(got, exp)
        for k in range(len(x0)):
            _eq(to_numpy(got)[k], tmc.mc_block_ref_14(
                ref, int(x0[k]), int(y0[k]), int(mx[k]), int(my[k]), n, n,
                1, bd))


@pytest.mark.parametrize("bd", DEPTHS)
@pytest.mark.parametrize("qmap", [0, 1])
def test_deblock_422_matches_reference(bd, qmap):
    check_deblock(CSP, bd, qmap)


def test_chroma_qp_edge_maps_422():
    check_chroma_qp_edge_maps(CSP)


@pytest.mark.parametrize("bd", DEPTHS)
def test_sao_on_rectangular_chroma_tiles(bd):
    # the 4:2:2 chroma CTU of a 64x64 luma CTU is 64 rows x 32 columns;
    # a 96x64 picture's chroma is 64 x 48 (a partial tile column)
    check_sao((64, 32), H, W // 2, bd)


@pytest.mark.parametrize("bd", DEPTHS)
def test_intra_under_the_422_mode_remap(bd):
    remap = np.asarray(CHROMA_422_ANGLE_MAP, np.int32)
    _eq(_angle422(CPU), remap)
    check_intra(3, bd, lambda m: remap[m], False)


@pytest.mark.parametrize("bd", DEPTHS)
def test_stacked_chroma_mc_422(bd):
    check_chroma_mc(CSP, bd)


# -- reconstruction and analysis ---------------------------------------------

def recon_pair(w, h, csp, **kw):
    p = default_params(w, h, internal_csp=csp, **kw).validate()
    sps = build_sps_info(p)
    args = (p.cb_qp_offset, p.cr_qp_offset, p.sign_hide, p.rdoq_level > 0,
            (), p.nxn_intra, p.lossless)
    kw = dict(tree=p.var_cu_tree, psy_rd=p.psy_rd, psy_rdoq=p.psy_rdoq)
    return JRecon(sps, *args, **kw), TRecon(sps, CPU, *args, **kw)


def inter_inputs(w, h, csp, seed):
    """Source planes of synth clips, MC predictions near them (block
    stores; 4:2:2 chroma (nby, nbx, 16, 8)), an inter mask and modes."""
    rng = np.random.default_rng(seed)
    nby, nbx = h // 16, w // 16
    y, u, v = (synth422 if csp == 2 else synth444)(w, h, seed=seed)
    hc, wc = chroma_shape(w, h, csp)
    ch, cw = hc // nby, wc // nbx

    def blocks(pl, bh, bw, k):
        a = np.clip(pl.astype(np.int32) + rng.integers(-k, k + 1, pl.shape),
                    0, 255)
        return np.ascontiguousarray(a.reshape(nby, bh, nbx, bw)
                                    .transpose(0, 2, 1, 3), np.int32)
    mc = (blocks(y, 16, 16, 6), blocks(u, ch, cw, 3), blocks(v, ch, cw, 3))
    inter = rng.random((nby, nbx)) < 0.7
    modes = rng.integers(0, 35, (nby, nbx)).astype(np.int32)
    return (y, u, v), mc, inter, modes


def check_recon(csp, kind):
    w = h = 64
    qp = 34
    (y, u, v), mc, inter, modes = inter_inputs(w, h, csp, 3 + csp)
    if kind == "I":
        jr, tr = recon_pair(w, h, csp)
        exp = jr.run(y, u, v, modes, qp=qp)
        got = tr.run(y, u, v, modes, qp=qp)
    else:
        jr, tr = recon_pair(w, h, csp, rdoq_level=2, sign_hide=True,
                            psy_rdoq=1.0)
        eb = _ebits_rows(qp, h // 16)
        exp = jr.run(y, u, v, modes, tuple(jnp.asarray(a) for a in mc),
                     inter, qp=qp, init_type=1, ebits=eb)
        got = tr.run(y, u, v, modes, tuple(torch.from_numpy(a) for a in mc),
                     inter, qp=qp, init_type=1, ebits=eb)
    for k in KEYS:
        _eq(got[k], exp[k], k)
    hc, wc = chroma_shape(w, h, csp)
    assert got["recon_u"].shape == (hc, wc)
    nbc = (h // 16) * (2 if csp == 2 else 1)
    assert got["lev_u"].shape[:2] == (nbc, w // 16)
    assert np.any(got["lev_u"]) and np.any(got["lev_v"])


@pytest.mark.parametrize("kind", ["I", "P"])
def test_recon_run_422_matches_reference(kind):
    check_recon(CSP, kind)


def check_analysis(csp, kind):
    syn = synth422 if csp == 2 else synth444
    fr = [syn(W, H, seed=5, motion=3 * i) for i in range(4)]
    sps = build_sps_info(default_params(W, H, internal_csp=csp).validate())
    qp = 30
    if kind == "P":
        args = (*fr[2], [fr[1], fr[0]], sps, qp)
        kw = dict(search_range=16, subme=2, pad_refs=3, rounds=(2, 1))
        got = tim.analyse_p_frame(*args[:5], qp, CPU, **kw)
        exp = jim.analyse_p_frame(*args, **kw)
        flat = lambda o: list(o[:4]) + list(o[4]) + list(o[5:])
    else:
        # two L0 references: outside 4:2:0 the lists collapse to 1 + 1
        args = (*fr[1], [fr[0], fr[3]], [fr[2]], sps, qp)
        kw = dict(search_range=16, subme=2, ref_pocs=((0, 3), (2,)),
                  cur_poc=1, pad_refs=(3, 2), rounds=(2, 2))
        got = tim.analyse_b_frame(*args[:6], qp, CPU, **kw)
        exp = jim.analyse_b_frame(*args, **kw)
        flat = lambda o: list(o[:7]) + list(o[7]) + [o[8]] + list(o[9])
    got, exp = flat(got), flat(exp)
    for i, (a, b) in enumerate(zip(got, exp)):
        _eq(a, b, str(i))
    hc, wc = chroma_shape(W, H, csp)
    mc_u = got[5] if kind == "P" else got[8]
    assert tuple(mc_u.shape) == (H // 16, W // 16, hc * 16 // H,
                                 wc * 16 // W)
    assert np.asarray(got[1]).any(), "premise: inter blocks chosen"
    if kind == "B":
        assert set(np.unique(got[2])) >= {1, 2, 3}    # L0, L1 and bi
        assert not np.asarray(got[5]).any()            # ref 0 only


@pytest.mark.parametrize("kind", ["P", "B"])
def test_analysis_422_matches_reference(kind):
    check_analysis(CSP, kind)


# -- streams -----------------------------------------------------------------

STREAMS = {
    # the repo defaults (CQP 32, B pyramid, b-adapt 2 lookahead)
    "defaults8": (dict(), 8),
    "crf28_aq2_cutree10": (dict(rc_mode="crf", crf=28.0, aq_mode=2), 10),
}


def encode_both(csp, kw, bd, frames):
    """(port stream, port frames, JAX stream, JAX frames)."""
    params = lambda: default_params(W, H, internal_csp=csp,
                                    internal_bit_depth=bd, **kw)
    frames = deep(frames, bd)
    s_pt, e_pt = ttop.encode_sequence(params(), frames, "cpu")
    s_jax, e_jax = jtop.encode_sequence(params(), frames)
    return s_pt, e_pt, s_jax, e_jax


def check_stream_bytes(got, csp):
    s_pt, e_pt, s_jax, e_jax = got
    assert [f.slice_type for f in e_pt] == ["I", "P", "B", "B", "B", "B"]
    assert [f.qp for f in e_pt] == [f.qp for f in e_jax]
    for i, (a, b) in enumerate(zip(e_pt, e_jax)):
        assert a.bitstream == b.bitstream, f"frame {i} bytes differ"
    assert s_pt == s_jax


def check_stream_decodes(got, csp, bd):
    s_pt, e_pt = got[:2]
    dec = Decoder()
    pics = dec.decode(s_pt)
    assert dec.sps.chroma_format_idc == csp and dec.sps.bit_depth == bd
    assert dec.sps.ptl.profile_idc == 4                 # RExt
    assert len(pics) == len(e_pt)
    hc, wc = chroma_shape(W, H, csp)
    for i, (f, pic) in enumerate(zip(e_pt, pics)):
        assert pic.u.shape == (hc, wc)
        for k, plane in enumerate((pic.y, pic.u, pic.v)):
            assert np.array_equal(plane, f.recon[k]), (i, k)
        assert pic.md5 == f.md5 == pic.sei_md5


@pytest.fixture(scope="module")
def streams():
    """case -> both encoders' output, each case encoded once."""
    cache = {}

    def get(case):
        if case not in cache:
            kw, bd = STREAMS[case]
            frames = [synth422(W, H, seed=5, motion=3 * i) for i in range(6)]
            cache[case] = encode_both(CSP, kw, bd, frames)
        return cache[case]
    return get


STREAM_CHECKS = {
    "equals_jax": lambda st, c: check_stream_bytes(st(c), CSP),
    "decodes": lambda st, c: check_stream_decodes(st(c), CSP,
                                                  STREAMS[c][1])}


# the case outermost: xdist's --dist load hands out runs of consecutive
# tests, so a case's checks land on the worker that encoded it
@pytest.mark.parametrize("case,check", [(c, k) for c in sorted(STREAMS)
                                        for k in STREAM_CHECKS])
def test_422_stream(streams, case, check):
    STREAM_CHECKS[check](streams, case)


def test_banded_422_stream_equals_jax_and_decodes(monkeypatch):
    """The row-banded analysis (above 9000 16x16 blocks, e.g. 2160p) on
    2-row bands: each band's chroma rows are full height in 4:2:2."""
    monkeypatch.setattr(jim, "_analysis_bands", _small_bands)
    monkeypatch.setattr(tim, "_analysis_bands", _small_bands)
    frames = [synth422(W, H, seed=5, motion=3 * i) for i in range(4)]
    got = encode_both(CSP, dict(bframes=2), 8, frames)
    s_pt, e_pt, s_jax, e_jax = got
    assert "B" in [f.slice_type for f in e_pt]
    assert s_pt == s_jax
    pics = Decoder().decode(s_pt)
    assert all(p.md5 == f.md5 == p.sei_md5 for p, f in zip(pics, e_pt))


def test_cli_on_a_422_10bit_y4m_equals_jax_cli(tmp_path):
    n = 3
    wr = Y4MWriter(str(tmp_path / "in.y4m"),
                   VideoInfo(W, H, 25, 1, bit_depth=10, total_frames=n,
                             csp="422"))
    for f in deep([synth422(W, H, seed=5, motion=3 * i) for i in range(n)],
                  10):
        wr.write(*f)
    wr.close()

    def args(name):
        return ["--input", str(tmp_path / "in.y4m"),
                "-o", str(tmp_path / f"{name}.hevc"), "--crf", "28",
                "--aq-mode", "2", "--frames", str(n), "--no-progress",
                "--recon", str(tmp_path / f"{name}.y4m")]
    assert jcli.main(args("jax")) == 0
    assert tcli.main(args("port") + ["--device", "cpu"]) == 0
    port = (tmp_path / "port.hevc").read_bytes()
    assert port == (tmp_path / "jax.hevc").read_bytes()
    recon = (tmp_path / "port.y4m").read_bytes()
    assert recon == (tmp_path / "jax.y4m").read_bytes()
    assert b"C422p10" in recon[:80]
    dec = Decoder()
    pics = dec.decode(port)
    assert len(pics) == n and dec.sps.chroma_format_idc == 2
    assert all(pc.md5 == pc.sei_md5 for pc in pics)
