"""The --preset slow path of the PyTorch port against the JAX reference:
streams with RDOQ sign hiding, rect PUs (2NxN / Nx2N) in P and B,
hierarchical ME (HME) in the analysis, the lattice and cuTree, the
banded analysis of frames above 9000 16x16 blocks, and `--preset slow
--hme` under CRF with a VBV at 128x96 (the analysis-level comparisons
are in tests/test_torch_slow_ops.py).

Each stream is encoded on the CPU by both encoders from the clips and
params of the reference's own tests (tests/test_rect_pu.py,
tests/test_rect_b.py, tests/test_rdoq.py, tests/test_banded_analysis.py,
so the reference's compiled programs are shared), must be byte-identical
and must decode, with the port's decoder and with the JAX decoder, to
the encoder's recon with matching MD5 SEIs.

Tolerance: exact throughout (integers, bytes, pixels, MD5s)."""
import numpy as np
import pytest
import torch

import x265_mod_by_patman_tpu.analysis.inter_mode as jim
import x265_mod_by_patman_tpu_torch.analysis.inter_mode as tim
from x265_mod_by_patman_tpu.decoder.decoder import Decoder as JDecoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.decoder.decoder import Decoder as TDecoder
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_banded_analysis import _clip as _banded_clip
from tests.test_e2e_inter import moving_scene
from tests.test_rect_b import _b_band_clip
from tests.test_rect_pu import _band_clip
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _small_bands(sps, block, search_range):
    """tests/test_banded_analysis.py's patch: 2-row bands, 1-row halos,
    sub-band calls unbanded."""
    nby = sps.height // block
    nbx = sps.width // block
    if nby * nbx <= 16:
        return None
    halo, per, bands, r0 = 1, 2, [], 0
    while r0 < nby:
        r1 = min(nby, r0 + per)
        bands.append((r0, r1, min(halo, r0), min(halo, nby - r1)))
        r0 = r1
    return bands


def _streams(params, frames):
    """Encode with both encoders; returns (jax stream, port stream, port
    EncodedFrames)."""
    js, _ = jtop.encode_sequence(params().validate(), frames)
    ts, tf = ttop.encode_sequence(params().validate(), frames, CPU)
    return js, ts, tf


def check_decodes(stream, frames):
    """The port's decoder and the JAX decoder give the encoder's recon
    and MD5 SEIs, picture by picture.  Returns the port's pictures."""
    by_poc = {f.poc: f for f in frames}
    out = None
    for dec in (TDecoder, JDecoder):
        pics = dec().decode(stream)
        assert len(pics) == len(frames), dec
        for pic in pics:
            f = by_poc[pic.poc]
            assert pic.sei_md5 == pic.md5 == f.md5, (dec, pic.poc)
            for a, b in zip((pic.y, pic.u, pic.v), f.recon):
                np.testing.assert_array_equal(a, np.asarray(b))
        out = pics if out is None else out
    return out


def _rect_p():
    return default_params(96, 64, qp=30, keyframe_max=250, bframes=0,
                          rect=True, scenecut=False, weightp=False)


def _rect_b():
    return default_params(96, 64, qp=30, keyframe_max=250, bframes=2,
                          rect=True, scenecut=False, weightp=False,
                          b_adapt=0)


def _rdoq_sbh():
    return default_params(96, 64, qp=30, keyframe_max=250, bframes=2,
                          rdoq_level=2, sign_hide=True)


def _hme():
    return default_params(96, 64, qp=30, keyframe_max=250, bframes=2,
                          hme=True, scenecut=False, b_adapt=2)


def _banded(rect=False):
    return default_params(128, 96, qp=33, keyframe_max=16, bframes=2,
                          b_adapt=0, scenecut=False, cu_tree=False,
                          rc_lookahead=0, open_gop=False, rect=rect)


def _slow():
    p = default_params(128, 96, rc_mode="crf", crf=24.0)
    p.apply_preset("slow")
    p.hme = True
    p.rc_lookahead = 8
    p.vbv_bufsize = 80
    p.vbv_maxrate = 80
    p.fps_num = 60
    return p


def _pan(n, w=96, h=64, step=11):
    """A textured scene panning `step` px a frame: far enough that the
    HME tier's seeds move the search windows."""
    rng = np.random.default_rng(13)
    big = rng.integers(0, 256, (h + 8, w + step * n)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3
    u = np.full((h // 2, w // 2), 118, np.uint8)
    return [(np.ascontiguousarray(big[4:4 + h, step * i:step * i + w])
             .astype(np.uint8), u, u) for i in range(n)]


CASES = {
    "rect_p": (_rect_p, lambda: _band_clip(np.random.default_rng(4), 96,
                                           64, 4, True)),
    "rect_b": (_rect_b, lambda: _b_band_clip(np.random.default_rng(7), 96,
                                             64, 4)),
    "rdoq_sign_hide": (_rdoq_sbh, lambda: moving_scene(96, 64, 5,
                                                       seed=11)),
    "hme": (_hme, lambda: _pan(6)),
    "banded": (_banded, lambda: _banded_clip(7)),
    "slow_hme_crf_vbv": (_slow, lambda: _band_clip(np.random.default_rng(4),
                                                   128, 96, 8, True)),
}


@pytest.fixture(scope="module")
def encoded():
    return {}


def _encoded(encoded, case, monkeypatch):
    if case not in encoded:
        params, clip = CASES[case]
        if case == "banded":
            monkeypatch.setattr(jim, "_analysis_bands", _small_bands)
            monkeypatch.setattr(tim, "_analysis_bands", _small_bands)
        encoded[case] = _streams(params, clip())
    return encoded[case]


@pytest.mark.parametrize("case", list(CASES))
def test_slow_stream_equals_jax_and_decodes(encoded, case, monkeypatch):
    js, ts, tf = _encoded(encoded, case, monkeypatch)
    assert ts == js
    check_decodes(ts, tf)


@pytest.mark.parametrize("case", ["rect_p", "rect_b", "slow_hme_crf_vbv"])
def test_slow_stream_uses_rect(encoded, case, monkeypatch):
    """Premise: rect PUs really occur in the stream."""
    _, _, tf = _encoded(encoded, case, monkeypatch)
    assert any(f.stats.get("cu_rect_pct", 0) > 0 for f in tf), case


def test_banded_rect_stream_decodes(monkeypatch):
    """Rect PUs in row bands.  A band's own MC clamps at the band's
    edges; the port reads the final predictions again from the
    whole-frame planes (analysis/inter_mode._whole_frame_mc), so its
    stream decodes where the reference's does not (its decisions are the
    reference's: test_analysis_matches_reference[banded_rect_hme-*])."""
    monkeypatch.setattr(tim, "_analysis_bands", _small_bands)
    ts, tf = ttop.encode_sequence(_banded(rect=True).validate(),
                                  _banded_clip(7), CPU)
    check_decodes(ts, tf)
    assert any(f.stats.get("cu_rect_pct", 0) > 0 for f in tf)


def test_slow_crf_vbv_stream_premises(encoded, monkeypatch):
    """The slow preset reaches the encoder as the CLI builds it (rd 4,
    RDOQ 2 + sign hiding, rect, star search r = 32, 4 refs) and the VBV
    binds: some picture re-encodes its rows."""
    _, _, tf = _encoded(encoded, "slow_hme_crf_vbv", monkeypatch)
    p = _slow().validate()
    assert (p.rd_level, p.rdoq_level, p.sign_hide, p.rect, p.amp) == \
        (4, 2, True, True, False)
    enc = ttop.Encoder(_slow(), CPU)
    assert enc._me_range == 32 and enc.max_refs == 4
    assert max(f.pipeline_runs for f in tf) > 1
    assert {f.slice_type for f in tf} >= {"I", "P", "B"}
