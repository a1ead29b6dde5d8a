"""The B half of the PyTorch port's default encode against the JAX
reference on the same seeded inputs, at one frame size (96x64) so the
reference compiles its B analysis and lookahead programs once:

* the lowres lookahead store (half-res plane, 8x8 intra costs, the two
  per-frame scalars);
* the slicetype lookahead: lattice frame costs, the b-adapt decision
  and the cost-ratio scenecut;
* B-picture analysis with two references per list and a TMVP field;
* whole streams at the repo defaults (B pyramid, b-adapt 2), with a
  fixed pyramid (b-adapt 0) and across an open-GOP CRA with RASL
  leaders: byte-identical to the JAX encoder's and decoded by the
  in-repo decoder with matching MD5 SEI.

Tolerance: exact throughout (integers, the float32-rounded frame costs,
the float32 scalars, bytes, pixels)."""
import ast
import ctypes
import gc
import os

import jax
import numpy as np
import pytest
import torch

from x265_mod_by_patman_tpu.analysis import inter_mode as jim
from x265_mod_by_patman_tpu.analysis import lookahead as jla
from x265_mod_by_patman_tpu.analysis import slicetype as jst
from x265_mod_by_patman_tpu.bitstream.headers import build_sps_info
from x265_mod_by_patman_tpu.bitstream.nal import split_annexb
from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.entropy.mv_pred import ColMotion
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.analysis import inter_mode as tim
from x265_mod_by_patman_tpu_torch.analysis import lookahead as tla
from x265_mod_by_patman_tpu_torch.analysis import slicetype as tst
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_e2e_inter import moving_scene
from tests.test_slicetype import clip_with_cut

W, H = 96, 64
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are on tiny tensors: one intra-op thread
    is faster than many, and keeps this file from starving the other
    test workers.  Integer results do not depend on the thread count.
    The worker's memory is released before and after the module."""
    _release_memory()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    _release_memory()


def _release_memory():
    """Drop the compiled JAX programs the worker holds and hand the freed
    heap back to the system (glibc keeps it otherwise).  A test worker
    otherwise keeps every program and the high-water mark of every module
    it ran, and six of them outgrow the host's memory late in a parallel
    run.  A program dropped here is compiled again when next called, from
    the persistent compilation cache; no result depends on it."""
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass                # not glibc: nothing to trim


def _defs(rel):
    """Top-level functions and class methods of a module's source."""
    src = open(os.path.join(ROOT, rel), encoding="utf-8").read()
    out = {}
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.FunctionDef):
            out.setdefault(node.name, ast.get_source_segment(src, node))
    return out


@pytest.mark.parametrize("rel,names", [
    ("analysis/lookahead.py", ("lowres_plane", "_raster_avail",
                               "_scatter", "_propagate", "pop")),
    ("analysis/slicetype.py", ("has", "fade_state", "drop_before",
                               "intra_cost", "frame_cost", "gop_cost",
                               "decide_gop", "scenecut")),
    ("analysis/inter_mode.py", ("_b_tmvp_field",)),
    ("encoder/top.py", ("_aq_map", "_zone_qp", "_cutree_pop",
                        "write_stats", "_nr_offsets", "_nr_update",
                        "build16", "build_region", "_pad",
                        "_frame_stats", "encode_frame",
                        "_post_filter_frame", "flush")),
    # the host halves of the loop filters, with their 4:2:2 / 4:4:4
    # branches (chroma edge maps, rectangular SAO tiles)
    ("ops/deblock.py", ("intra_bs_maps", "inter_bs_maps",
                        "chroma_on_maps", "clear_merge32_edges",
                        "mark_split_edges")),
    ("ops/sao.py", ("sao_decide", "sao_decide_chroma", "sao_merge_pass",
                    "_param_dist", "_best_offset_vec")),
    ("frame/recon_intra.py", ("chroma_qp",)),
])
def test_host_functions_are_verbatim(rel, names):
    """The host-side decision logic is a copy of the reference's."""
    ref = _defs(os.path.join("x265_mod_by_patman_tpu", rel))
    port = _defs(os.path.join("x265_mod_by_patman_tpu_torch", rel))
    for name in names:
        assert port[name] == ref[name], name


# -- lowres store ------------------------------------------------------------

def test_lowres_store_matches_reference():
    frames = moving_scene(W, H, 3, seed=5)
    js, ts = jla.LowresStore(W, H), tla.LowresStore(W, H, CPU)
    for d, (y, _u, _v) in enumerate(frames):
        js.ensure(d, y)
        ts.ensure(d, y)
    for d, (y, _u, _v) in enumerate(frames):
        np.testing.assert_array_equal(ts.low(d).numpy(),
                                      np.asarray(js.low(d)))
        np.testing.assert_array_equal(ts.low(d).numpy(),
                                      tla.lowres_plane(y))
        # the 8x8 (log2n = 3) intra sweep of intra_mode._mode_costs
        np.testing.assert_array_equal(ts.intra_host(d), js.intra_host(d))
        assert ts.dc(d) == js.dc(d), d
        assert ts.intra_sum(d) == js.intra_sum(d), d
    ts.register("a")
    ts.register("b")
    ts.release("a", 2)
    assert 0 in ts and 1 in ts
    ts.release("b", 1)
    assert 0 not in ts and 1 in ts


# -- slicetype lookahead -----------------------------------------------------

def _burst_clip():
    """Frames 0-3 pan slowly, 4-6 jump 18 px a frame (the motion burst
    of tests/test_slicetype.py)."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 255, (H + 64, W + 64)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    frames = []
    for i in range(7):
        off = i if i < 4 else 4 + (i - 3) * 18
        frames.append(np.clip(base[2:2 + H, off:off + W], 0, 255)
                      .astype(np.uint8))
    return frames


CLIPS = {
    "static": lambda: [f[0] for f in clip_with_cut(W, H, 9, cut=99)],
    "burst": _burst_clip,
    "cut": lambda: [f[0] for f in clip_with_cut(W, H, 8, cut=5)],
}


def _pair(clip, **kw):
    js = jst.SlicetypeLookahead(W, H, **kw)
    ts = tst.SlicetypeLookahead(W, H, device=CPU, **kw)
    for i, y in enumerate(CLIPS[clip]()):
        js.push(i, y)
        ts.push(i, y)
    return js, ts


# P and B triples on the burst clip, evaluated in one round on each side
# (16 lanes over 8 frames in the reference: the bucket of the default
# stream's b-adapt round, so its compiled lattice is shared)
TRIPLES = [(1, 0, 1), (2, 1, 2), (3, 2, 3), (4, 3, 4), (6, 5, 6),
           (1, 0, 2), (1, 0, 3), (2, 0, 3), (2, 1, 3), (2, 0, 4),
           (3, 0, 4), (4, 3, 6), (5, 3, 6), (5, 4, 6)]


@pytest.fixture(scope="module")
def frame_costs():
    js, ts = _pair("burst", bframes=4, b_adapt=2)
    js._eval_triples(TRIPLES)
    ts._eval_triples(TRIPLES)
    return js._cost, ts._cost


@pytest.mark.parametrize("triple", TRIPLES)
def test_frame_cost_matches_reference(frame_costs, triple):
    js_cost, ts_cost = frame_costs
    assert ts_cost[triple] == js_cost[triple]


@pytest.mark.parametrize("clip", ["static", "burst"])
@pytest.mark.parametrize("b_adapt", [1, 2])
def test_decide_gop_matches_reference(clip, b_adapt):
    js, ts = _pair(clip, bframes=3, b_adapt=b_adapt)
    calls = [(0, [1, 2, 3]), (3, [4, 5, 6])]
    got = [ts.decide_gop(p0, q) for p0, q in calls]
    assert got == [js.decide_gop(p0, q) for p0, q in calls]
    assert ts._cost == js._cost
    if clip == "burst" and b_adapt == 2:
        assert got[0] == 3 and got[1] <= 2      # the burst breaks the GOP
    ts.drop_before(4)
    js.drop_before(4)
    assert ts._cost == js._cost and ts._have == js._have
    assert 3 not in ts.store and 4 in ts.store


def test_scenecut_matches_reference():
    js, ts = _pair("cut", bframes=3, b_adapt=2)
    fired = [ts.scenecut(d, d - 1, d, 4, 250) for d in range(1, 8)]
    assert fired == [js.scenecut(d, d - 1, d, 4, 250) for d in range(1, 8)]
    assert fired[4] and fired.count(True) == 1, fired       # the cut at 5
    assert [ts.fade_state(d) for d in range(8)] == \
        [js.fade_state(d) for d in range(8)]


# -- B analysis ---------------------------------------------------------------

B_NAMES = ("modes", "inter_mask", "dirs", "mvs", "mvs1", "ref_sel0",
           "ref_sel1", "mc_y", "mc_u", "mc_v", "part", "pu1")


@pytest.fixture(scope="module")
def b_analysis():
    w, h, qp = W, H, 34
    fr = moving_scene(w, h, 5, seed=4)
    sps = build_sps_info(default_params(w, h).validate())
    rng = np.random.default_rng(1)
    nby, nbx = h // 16, w // 16
    rp = np.zeros((nby, nbx, 2), np.int64)
    rp[..., 1] = 4
    col = ColMotion(4, rng.integers(0, 4, (nby, nbx)).astype(np.int8),
                    rng.integers(-12, 13, (nby, nbx, 2, 2)).astype(np.int32),
                    rp)
    kw = dict(search_range=16, subme=2, col=col, ref_pocs=((1, 0), (3, 4)),
              cur_poc=2, pad_refs=(3, 2), rounds=(2, 2))
    y, u, v = fr[2]
    args = (y, u, v, [fr[1], fr[0]], [fr[3], fr[4]], sps, qp)
    flat = lambda o: list(o[:7]) + list(o[7]) + [o[8], o[9]]
    return (flat(tim.analyse_b_frame(*args, CPU, **kw)),
            flat(jim.analyse_b_frame(*args, **kw)))


@pytest.mark.parametrize("name", B_NAMES)
def test_analyse_b_frame_matches_reference(b_analysis, name):
    got, exp = b_analysis
    i = B_NAMES.index(name)
    if name == "pu1":
        for a, b in zip(got[i], exp[i]):
            np.testing.assert_array_equal(a, np.asarray(b))
        return
    a = got[i].numpy() if isinstance(got[i], torch.Tensor) else got[i]
    np.testing.assert_array_equal(a, np.asarray(exp[i]), err_msg=name)
    if name == "dirs":          # premise: every direction and intra occur
        assert set(np.unique(a)) == {0, 1, 2, 3}
    if name in ("ref_sel0", "ref_sel1"):
        assert a.max() == 1, "premise: the second reference is chosen"


def test_analyse_b_frame_rejects_weighted_b():
    """Weighted B (--weightb) was rejected before it was ported; the
    port's weighted analysis (the lists cut to 1 + 1, ME on the
    pre-weighted planes, weighted uni and bi predictions, luma-only
    weighted MC) must now equal the reference's on the same planes."""
    fr = moving_scene(W, H, 3, seed=4)
    sps = build_sps_info(default_params(W, H).validate())
    args = (*fr[1], [fr[0], fr[2]], [fr[2]], sps, 30)
    kw = dict(weights_b=((70, 2), None), ref_pocs=((0, 2), (2,)),
              cur_poc=1)
    flat = lambda o: list(o[:7]) + list(o[7]) + [o[8]] + list(o[9])
    got = flat(tim.analyse_b_frame(*args, CPU, **kw))
    exp = flat(jim.analyse_b_frame(*args, **kw))
    for i, (a, b) in enumerate(zip(got, exp)):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(i))
    assert np.asarray(got[2]).max() > 0        # premise: inter blocks


# -- streams ------------------------------------------------------------------

STREAMS = {
    # repo defaults: b-adapt 2 lookahead, a 4-B mini-GOP whose middle B
    # is referenced (pyramid); with access-unit delimiters
    "defaults": (dict(aud=True), 6, ["I", "P", "B", "B", "B", "B"],
                 [19, 1, 1, 0, 0, 0]),
    # no lookahead: fixed 3-B pyramid, then a P on the flush
    "fixed_pyramid": (dict(bframes=3, b_adapt=0), 6,
                      ["I", "P", "B", "B", "B", "P"], [19, 1, 1, 0, 0, 1]),
    # IDR, then a CRA at frame 6 whose two queued B become RASL leaders
    "open_gop": (dict(keyframe_max=6, bframes=2, b_adapt=0, scenecut=False),
                 8, ["I", "P", "B", "B", "I", "B", "B", "P"],
                 [19, 1, 0, 0, 21, 8, 8, 1]),
}


@pytest.fixture(scope="module")
def encoded():
    """case -> (port stream, port frames, JAX stream, JAX frames), each
    case encoded once for both tests that read it."""
    cache = {}

    def get(case):
        if case not in cache:
            kw, n, _types, _nals = STREAMS[case]
            frames = moving_scene(W, H, n)
            s_jax, e_jax = jtop.encode_sequence(
                default_params(W, H, **kw), frames)
            s_pt, e_pt = ttop.encode_sequence(default_params(W, H, **kw),
                                              frames, "cpu")
            cache[case] = (s_pt, e_pt, s_jax, e_jax)
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_b_stream_equals_jax_and_decodes(encoded, case):
    s_pt, e_pt, s_jax, e_jax = encoded(case)
    n = STREAMS[case][1]
    for i, (a, b) in enumerate(zip(e_pt, e_jax)):
        assert a.bitstream == b.bitstream, f"frame {i} bytes differ"
    assert s_pt == s_jax
    pics = Decoder().decode(s_pt)
    assert len(pics) == n
    for i, (f, pic) in enumerate(zip(e_pt, pics)):
        ry, ru, rv = f.recon
        assert np.array_equal(pic.y, ry), f"luma mismatch frame {i}"
        assert np.array_equal(pic.u, ru), f"cb mismatch frame {i}"
        assert np.array_equal(pic.v, rv), f"cr mismatch frame {i}"
        assert pic.md5 == f.md5 == pic.sei_md5


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_b_stream_slice_and_nal_types(encoded, case):
    s_pt, e_pt, _s_jax, _e_jax = encoded(case)
    _kw, n, types, nals = STREAMS[case]
    assert [f.slice_type for f in e_pt] == types
    assert sorted(f.disp for f in e_pt) == list(range(n))
    vcl = [t for t in ((u[0] >> 1) & 0x3F for u in split_annexb(s_pt))
           if t < 32]
    assert vcl == nals
    if case == "defaults":
        # the referenced middle B comes first among the B's, display 3
        assert [f.disp for f in e_pt] == [0, 5, 3, 1, 2, 4]
        aud = [u[2] >> 5 for u in split_annexb(s_pt)
               if (u[0] >> 1) & 0x3F == 35]
        assert aud == [0, 1, 2, 2, 2, 2]
