"""The analysis half of the --preset slow path of the PyTorch port
against the JAX reference on the same seeded planes: HME (the analysis'
quarter-res tier `_hme_center_fullres`, the lookahead's `hme_seeds` and
`_inter_costs`, the slicetype lattice with HME), `analyse_p_frame` /
`analyse_b_frame` with rect PUs, with HME and with both in row bands,
and the band geometry (`_analysis_bands` at 2160p, and held verbatim).
The streams are in tests/test_torch_slow.py.

Tolerance: exact (integers)."""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import x265_mod_by_patman_tpu.analysis.inter_mode as jim
import x265_mod_by_patman_tpu_torch.analysis.inter_mode as tim
from x265_mod_by_patman_tpu.analysis import lookahead as jla
from x265_mod_by_patman_tpu.analysis import slicetype as jst
from x265_mod_by_patman_tpu.bitstream.headers import build_sps_info
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.analysis import lookahead as tla
from x265_mod_by_patman_tpu_torch.analysis import slicetype as tst
from tests.test_rect_b import _b_band_clip
from tests.test_rect_pu import _band_clip
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401
from tests.test_torch_inter import _col
from tests.test_torch_slow import _pan, _small_bands

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


# -- HME pieces ----------------------------------------------------------------

def test_hme_center_fullres_matches_reference():
    frames = _pan(2, 96, 64, 13)
    oy, ry = (np.asarray(f[0], np.int32) for f in (frames[1], frames[0]))
    exp = jim._hme_center_fullres(jnp.asarray(ry), jnp.asarray(oy), 4, 6,
                                  300, 16)
    got = tim._hme_center_fullres(torch.from_numpy(ry),
                                  torch.from_numpy(oy), 4, 6, 300, 16)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.asarray(exp[0]).any(), "premise: seeds move the window"


def test_hme_seeds_and_inter_costs_match_reference():
    js, ts = jla.LowresStore(96, 64), tla.LowresStore(96, 64, CPU)
    for d, (y, _u, _v) in enumerate(_pan(2, 96, 64, 13)):
        js.ensure(d, y)
        ts.ensure(d, y)
    exp = jla.hme_seeds(js.low(1), js.low(0), ts.nby, ts.nbx)
    got = tla.hme_seeds(ts.low(1), ts.low(0), ts.nby, ts.nbx)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.asarray(exp[0]).any(), "premise: seeds move the window"
    exp = jla._inter_costs(js.low(1), js.low(0), ts.nby, ts.nbx, True)
    got = tla._inter_costs(ts.low(1), ts.low(0), ts.nby, ts.nbx, True)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_slicetype_lattice_with_hme_matches_reference():
    frames = _pan(6, 96, 64, 13)
    jl = jst.SlicetypeLookahead(96, 64, 4, b_adapt=2, hme=True)
    tl = tst.SlicetypeLookahead(96, 64, 4, b_adapt=2, hme=True, device=CPU)
    for d, (y, _u, _v) in enumerate(frames):
        jl.push(d, y)
        tl.push(d, y)
    for tr in ((2, 0, 4), (1, 0, 1), (3, 2, 5), (5, 4, 5)):
        assert tl.frame_cost(*tr) == jl.frame_cost(*tr), tr
    assert tl.decide_gop(0, [1, 2, 3, 4, 5]) == \
        jl.decide_gop(0, [1, 2, 3, 4, 5])


# -- analysis ------------------------------------------------------------------

def _cmp(got, exp):
    def flat(x):
        return [b for a in x for b in (flat(a) if isinstance(a, tuple)
                                       else [a])]
    for i, (a, b) in enumerate(zip(flat(got), flat(exp))):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(i))


@pytest.mark.parametrize("kind", ["P", "B"])
@pytest.mark.parametrize("opt", ["rect", "hme", "banded_rect_hme"])
def test_analysis_matches_reference(kind, opt, monkeypatch):
    """analyse_p_frame / analyse_b_frame with rect, HME, and both in row
    bands (the TMVP field cut per band): every output exact."""
    w, h = 96, 64
    sps = build_sps_info(default_params(w, h).validate())
    kw = dict(search_range=16, subme=2, rect="rect" in opt,
              hme="hme" in opt)
    if opt.startswith("banded"):
        monkeypatch.setattr(jim, "_analysis_bands", _small_bands)
        monkeypatch.setattr(tim, "_analysis_bands", _small_bands)
        kw["col"] = _col(h // 16, w // 16, 1)
    if kind == "P":
        fr = _band_clip(np.random.default_rng(4), w, h, 3, True)
        kw.update(pad_refs=2, rounds=(2, 1), ref_pocs=((1, 0), ()),
                  cur_poc=2)
        args = (*fr[2], [fr[1], fr[0]], sps, 30)
        exp = jim.analyse_p_frame(*args, **kw)
        got = tim.analyse_p_frame(*args, CPU, **kw)
        part = exp[5]
    else:
        fr = _b_band_clip(np.random.default_rng(7), w, h, 3)
        kw.update(pad_refs=(2, 1), rounds=(2, 2), ref_pocs=((0,), (2,)),
                  cur_poc=1)
        args = (*fr[1], [fr[0]], [fr[2]], sps, 30)
        exp = jim.analyse_b_frame(*args, **kw)
        got = tim.analyse_b_frame(*args, CPU, **kw)
        part = exp[8]
    _cmp(got, exp)
    if kw["rect"]:
        assert np.asarray(part).any(), "premise: rect PUs chosen"


def test_analysis_bands_at_2160p_equal_reference():
    p = default_params(3840, 2160)
    p.apply_preset("slow")
    sps = build_sps_info(p.validate())
    for sr in (16, 32):
        bands = tim._analysis_bands(sps, 16, sr)
        assert bands == jim._analysis_bands(sps, 16, sr)
        assert bands[0][0] == 0 and bands[-1][1] == sps.height // 16
    assert tim._analysis_bands(build_sps_info(default_params(
        1920, 1080).validate()), 16, 32) is None


def _defs(path):
    src = open(os.path.join(ROOT, path), encoding="utf-8").read()
    tree = ast.parse(src)
    out = {}
    for n in tree.body:
        if isinstance(n, ast.FunctionDef):
            out[n.name] = ast.get_source_segment(src, n)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.get_source_segment(src, n)
    return out


@pytest.mark.parametrize("name", ["WINDOW_NBY_LIMIT", "_analysis_bands"])
def test_band_geometry_is_verbatim(name):
    rel = "analysis/inter_mode.py"
    assert _defs(os.path.join("x265_mod_by_patman_tpu_torch", rel))[name] \
        == _defs(os.path.join("x265_mod_by_patman_tpu", rel))[name]
