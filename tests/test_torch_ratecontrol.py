"""Rate control of the PyTorch port against the JAX reference on the same
seeded inputs, at 96x64 (one frame size, so the reference compiles its
programs once):

* the per-CTU QP path with a non-scalar (nCtuY, nCtuX) QP map varying
  by up to 6 around 32: the reconstruction wavefront (I tree and P),
  the inter TU32 pre-pass, deblocking, the decoder-visible QP chain and
  the rate tables at the map's QPs;
* the cuTree lookahead: the lowres inter costs and the pop() sequences
  of a static scene, a scene cut and a B structure;
* the AQ map, modes 1-4;
* whole streams under CRF with cuTree, AQ under CQP, CRF with AQ 2 and
  cuTree at the repo defaults, two-pass ABR with the pass-1 cuTree
  offsets played back (the port's pass 1 writes the reference's stats
  file and offsets; its pass 2 from them gives the reference's pass-2
  bytes), and a zone with a qpfile:
  byte-identical to the JAX encoder's and decoded by the in-repo decoder
  with matching MD5 SEI.

Tolerance: exact throughout (integers, float64 rate tables computed
from the same states, bytes, pixels, MD5s, file contents)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x265_mod_by_patman_tpu.analysis import lookahead as jla
from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.entropy.contexts import init_states
from x265_mod_by_patman_tpu.frame import inter_tu32 as jtu
from x265_mod_by_patman_tpu.ops import deblock as jd
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.analysis import lookahead as tla
from x265_mod_by_patman_tpu_torch.convert import to_numpy, to_torch
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from x265_mod_by_patman_tpu_torch.frame import inter_tu32 as ttu
from x265_mod_by_patman_tpu_torch.ops import deblock as td
from tests.test_aq import mixed_content
from tests.test_e2e_inter import moving_scene
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401
from tests.test_torch_loopfilter import _inter_bs, _planes
from tests.test_torch_recon import (_assert_same, _ebits_rows, _frame,
                                    _inter_inputs, _recons)

W, H = 96, 64
CPU = torch.device("cpu")


def _qp_map(shape, seed):
    """A (nCtuY, nCtuX) QP map of 26..38 with both extremes present."""
    m = np.random.default_rng(seed).integers(26, 39, shape).astype(np.int32)
    m.flat[0], m.flat[-1] = 26, 38
    return m


# -- the per-CTU QP path ---------------------------------------------------

def test_run_tree_with_qp_map_matches_reference():
    from x265_mod_by_patman_tpu.analysis.intra_mode import decide_modes_tree
    y, u, v = _frame(W, H, 11)
    p, sps, jr, tr = _recons(W, H)
    qpm = _qp_map((p.pic_height_in_ctus, p.pic_width_in_ctus), 1)
    modes, _, _, split32, mode32, c16, cb16 = decide_modes_tree(y, sps, 32)
    exp = jr.run_tree(y, u, v, modes, split32, mode32, qp=qpm,
                      cand=(c16, cb16))
    got = tr.run_tree(y, u, v, modes, split32, mode32, qp=qpm,
                      cand=(c16, cb16))
    _assert_same(got, exp)
    np.testing.assert_array_equal(got["modes_sel"], exp["modes_sel"])


def test_run_inter_with_qp_map_matches_reference():
    (y, u, v), mc, inter, modes = _inter_inputs(W, H, 12)
    p, sps, jr, tr = _recons(W, H)
    qpm = _qp_map((p.pic_height_in_ctus, p.pic_width_in_ctus), 2)
    eb = _ebits_rows(32, H // 16)
    exp = jr.run(y, u, v, modes, tuple(jnp.asarray(a) for a in mc), inter,
                 qp=qpm, init_type=1, ebits=eb)
    got = tr.run(y, u, v, modes, tuple(torch.from_numpy(a) for a in mc),
                 inter, qp=qpm, init_type=1, ebits=eb)
    _assert_same(got, exp)


def test_inter_tu32_with_qp_map_matches_reference():
    from x265_mod_by_patman_tpu.entropy.est_bits import bits_table_from_states
    (y, u, v), mc, _, _ = _inter_inputs(W, H, 13)
    p, sps, jr, tr = _recons(W, H)
    qpm = _qp_map((p.pic_height_in_ctus, p.pic_width_in_ctus), 3)
    mask = np.array([[True, True, False], [False, True, True]])
    eb = bits_table_from_states(init_states(1, 32)).astype(np.float32)
    exp = jtu.prepare_inter_tu32(y, u, v, tuple(jnp.asarray(a) for a in mc),
                                 mask, qpm, jr, 1, ebits=eb)
    got = ttu.prepare_inter_tu32(y, u, v,
                                 tuple(torch.from_numpy(a) for a in mc),
                                 mask, qpm, tr, 1, ebits=eb)
    assert exp is not None and got is not None and exp["use"].any()
    for k in ("use", "nzy", "nzu", "nzv"):
        np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
    for k in ("levy", "levu", "levv"):
        assert got[k].keys() == exp[k].keys()
        for key in exp[k]:
            np.testing.assert_array_equal(got[k][key], exp[k][key])
    for a, b in zip(got["spliced"][:3], exp["spliced"][:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("log2_ctu", [4, 5, 6])
def test_deblock_with_qp_map_matches_reference(log2_ctu):
    y, u, v = _planes(W, H, log2_ctu)
    args, kw = _inter_bs(W, H, log2_ctu)
    bs = td.inter_bs_maps(*args, **kw)
    on = td.chroma_on_maps(bs[0], bs[1], H // 2, W // 2)
    ctu = 1 << log2_ctu
    qpm = _qp_map((-(-H // ctu), -(-W // ctu)), log2_ctu)
    exp = jd.deblock_frame_batch(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.asarray(bs[0]),
        jnp.asarray(bs[1]), jnp.asarray(on[0]), jnp.asarray(on[1]),
        jnp.asarray(qpm), 1, -2, 0, 0, 8, 1, log2_ctu)
    got = td.deblock_frame_batch(
        to_torch(y, CPU), to_torch(u, CPU), to_torch(v, CPU), bs[0], bs[1],
        on[0], on[1], qpm, 1, -2, 0, 0, 8, 1, log2_ctu)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))


@pytest.mark.parametrize("wpp", [True, False])
def test_derived_qp_map_matches_reference(wpp):
    # CTU 16: a 4x6 map, so the chain crosses rows and runs of
    # CTUs without coded coefficients
    p = lambda: default_params(W, H, ctu_size=16, wpp=wpp)
    je, te = jtop.Encoder(p()), ttop.Encoder(p(), "cpu")
    rng = np.random.default_rng(wpp)
    qpm = _qp_map((H // 16, W // 16), 4 + wpp)
    for trial in range(3):
        r = {k: rng.random((H // 16, W // 16)) < 0.3
             for k in ("nz_y", "nz_u", "nz_v")}
        exp = je._derived_qp_map(qpm, r, 30)
        got = te._derived_qp_map(qpm, r, 30)
        np.testing.assert_array_equal(got, exp)
    assert te._derived_qp_map(31, r, 30) == je._derived_qp_map(31, r, 30)


def test_ebits_for_matches_reference_at_the_map_qps():
    je = jtop.Encoder(default_params(W, H))
    te = ttop.Encoder(default_params(W, H), "cpu")
    for enc_states in ({}, {
            0: init_states(0, 33),
            1: {"end": init_states(1, 29),
                "rows": np.stack([init_states(1, 27 + k) for k in range(4)])}}):
        je._adapt_states = dict(enc_states)
        te._adapt_states = dict(enc_states)
        for qp in np.unique(_qp_map((4, 6), 6)):
            for init_type in (0, 1):
                for per_row in (False, True):
                    np.testing.assert_array_equal(
                        te._ebits_for(init_type, int(qp), per_row),
                        je._ebits_for(init_type, int(qp), per_row))


# -- cuTree lookahead --------------------------------------------------------

def test_inter_costs_match_reference():
    (y0, _, _), (y1, _, _) = moving_scene(W, H, 2, seed=31)
    js, ts = jla.LowresStore(W, H), tla.LowresStore(W, H, CPU)
    for d, y in enumerate((y0, y1)):
        js.ensure(d, y)
        ts.ensure(d, y)
    exp = jla._inter_costs(js.low(1), js.low(0), ts.nby, ts.nbx)
    got = tla._inter_costs(ts.low(1), ts.low(0), ts.nby, ts.nbx)
    for g, e in zip(got, exp):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def _cutree_scene(name):
    rng = np.random.default_rng({"static": 3, "cut": 4, "bframes": 7}[name])
    a = rng.integers(0, 256, (H, W)).astype(np.uint8)
    if name == "cut":
        b = rng.integers(0, 256, (H, W)).astype(np.uint8)
        return [a] + [b] * 7, {}
    return [a] * (8 if name == "static" else 10), \
        ({"bframes": 2} if name == "bframes" else {})


@pytest.mark.parametrize("scene", ["static", "cut", "bframes"])
def test_cutree_pop_sequence_matches_reference(scene):
    """The scenes of tests/test_cutree.py, every frame pushed, then
    popped until the window is empty."""
    frames, kw = _cutree_scene(scene)
    jl = jla.CuTreeLookahead(W, H, 32, **kw)
    tl = tla.CuTreeLookahead(W, H, 32, device=CPU, **kw)
    for y in frames:
        jl.push(y)
        tl.push(y)
    pops = 0
    while len(jl):
        np.testing.assert_array_equal(tl.pop(), jl.pop())
        pops += 1
    assert pops == len(frames) and not len(tl)


def test_cutree_hme_pop_sequence_matches_reference():
    """cuTree with the HME tier (hme_seeds centring the lowres search):
    a scene panning 20 px a frame, every frame pushed, then popped."""
    rng = np.random.default_rng(9)
    big = rng.integers(0, 256, (H, W + 200)).astype(np.uint8)
    frames = [np.ascontiguousarray(big[:, 20 * i:20 * i + W])
              for i in range(8)]
    jl = jla.CuTreeLookahead(W, H, 32, hme=True)
    tl = tla.CuTreeLookahead(W, H, 32, hme=True, device=CPU)
    for y in frames:
        jl.push(y)
        tl.push(y)
    pops = 0
    while len(jl):
        np.testing.assert_array_equal(tl.pop(), jl.pop())
        pops += 1
    assert pops == len(frames) and not len(tl)


# -- AQ ------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_aq_map_matches_reference(mode):
    p = lambda: default_params(W, H, qp=32, keyframe_max=1, aq_mode=mode,
                               aq_strength=1.5)
    je, te = jtop.Encoder(p()), ttop.Encoder(p(), "cpu")
    y, _u, _v = mixed_content(W, H)
    for qp in (24, 32, 45):
        exp = je._aq_map(je._pad(y, 0), qp)
        got = te._aq_map(te._pad(y, 0), qp)
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)
    assert exp.min() < exp.max()


# -- streams ------------------------------------------------------------------

CRF_CUTREE = dict(qp=30, keyframe_max=250, bframes=2, rc_mode="crf",
                  crf=30.0, rc_lookahead=6)
STREAMS = {
    # tests/test_cutree.py's e2e case: 10 frames, rc_lookahead 6, so
    # cuTree pops happen inside the stream and in the flush
    "crf_cutree": (CRF_CUTREE, lambda: moving_scene(W, H, 10, seed=9)),
    # tests/test_aq.py's inter GOP: AQ under CQP
    "aq1_cqp": (dict(qp=30, keyframe_max=250, bframes=2, aq_mode=1),
                lambda: moving_scene(W, H, 5, seed=21)),
    # CRF with AQ 2 and cuTree at the repo defaults (4 B-frames, b-adapt 2)
    "crf_aq2_defaults": (dict(rc_mode="crf", crf=28.0, aq_mode=2),
                         lambda: moving_scene(W, H, 6)),
    # a fixed-QP zone over the first three frames of the CRF case, and a
    # qpfile that forces frame 6 to a (closed) IDR at QP 27
    "crf_zone": (dict(CRF_CUTREE, zones="0,2,q=24", qpfile="6 I 27\n"),
                 lambda: moving_scene(W, H, 10, seed=9)),
}


def _assert_decodes(stream, encoded):
    """The decoder returns pictures in decode order, as encoded."""
    pics = Decoder().decode(stream)
    assert len(pics) == len(encoded)
    for i, (f, pic) in enumerate(zip(encoded, pics)):
        assert pic.poc == f.poc, i
        assert np.array_equal(pic.y, f.recon[0]), i
        assert np.array_equal(pic.u, f.recon[1]), i
        assert np.array_equal(pic.v, f.recon[2]), i
        assert pic.md5 == f.md5 == pic.sei_md5


def _assert_same_stream(s_pt, e_pt, s_jax, e_jax):
    assert [f.qp for f in e_pt] == [f.qp for f in e_jax]
    for i, (a, b) in enumerate(zip(e_pt, e_jax)):
        assert a.bitstream == b.bitstream, f"frame {i} bytes differ"
    assert s_pt == s_jax


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_rc_stream_equals_jax_and_decodes(case, tmp_path):
    kw, frames = STREAMS[case]
    frames = frames()
    if "qpfile" in kw:
        (tmp_path / "qp.txt").write_text(kw["qpfile"])
        kw = dict(kw, qpfile=str(tmp_path / "qp.txt"))
    s_jax, e_jax = jtop.encode_sequence(default_params(W, H, **kw), frames)
    te = ttop.Encoder(default_params(W, H, **kw), "cpu")
    assert te.pps.cu_qp_delta_enabled
    assert (te._cutree is not None) == (kw.get("rc_mode") == "crf")
    e_pt = []
    for f in frames:
        e_pt.extend(te.encode_frame(*f))
    e_pt.extend(te.flush())
    s_pt = b"".join(f.bitstream for f in e_pt)
    _assert_same_stream(s_pt, e_pt, s_jax, e_jax)
    _assert_decodes(s_pt, e_pt)
    if case == "crf_zone":
        assert all(f.qp == 24 for f in e_pt if f.disp <= 2)
        [kf] = [f for f in e_pt if f.disp == 6]
        assert (kf.slice_type, kf.poc, kf.qp) == ("I", 0, 27)


def _two_pass(mod, pass_num, stats, frames, device=()):
    """tests/test_vbv_2pass.py's cuTree-reuse parameters."""
    p = default_params(W, H, rc_mode="abr", bitrate_kbps=400,
                       keyframe_max=250, bframes=2, b_adapt=0,
                       scenecut=False, stats_file=stats, pass_num=pass_num,
                       rc_lookahead=6)
    enc = mod.Encoder(p, *device)
    out = []
    for f in frames:
        out.extend(enc.encode_frame(*f))
    out.extend(enc.flush())
    enc.write_stats()
    return enc, b"".join(f.bitstream for f in out), out


def test_two_pass_abr_equals_jax_and_decodes(tmp_path):
    """The port's pass 2 driven by the JAX encoder's stats file gives the
    JAX pass 2's bytes; the port's own pass 1 gives the JAX pass 1's
    stream and writes the same stats file and .cutree offsets byte for
    byte, so a pass 2 from it is the run above.  One stats path serves
    every run: the info SEI names it, so the bytes depend on it."""
    frames = moving_scene(W, H, 10, seed=2)
    stats = str(tmp_path / "st.log")
    _, j1, _ = _two_pass(jtop, 1, stats, frames)
    saved = {ext: open(stats + ext, "rb").read() for ext in ("", ".cutree")}
    _, j2, ej2 = _two_pass(jtop, 2, stats, frames)

    e2, p2, ep2 = _two_pass(ttop, 2, stats, frames, ("cpu",))
    assert e2._ct2pass is not None and e2._cutree is None
    _assert_same_stream(p2, ep2, j2, ej2)
    _assert_decodes(p2, ep2)

    for ext in saved:
        os.remove(stats + ext)
    e1, p1, _ = _two_pass(ttop, 1, stats, frames, ("cpu",))
    assert e1._cutree is not None and e1._ct1_offs
    assert p1 == j1
    for ext, data in saved.items():
        assert open(stats + ext, "rb").read() == data, ext
