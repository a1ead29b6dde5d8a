"""Options the port has taken since its first slices without a test of
their own, held to the JAX reference on the CPU at 96x64: --slices 2,
--me dia / umh / full, --repeat-headers, --temporal-layers 2,
--interlace tff, --hist-scenecut on a scene cut, --fades on a luma fade
and a film-grain SEI.  Each case's stream must be byte-identical to the
JAX encoder's, show the option in its syntax, and decode with matching
MD5 SEIs.  The clips and settings are those of the reference's own
tests of each option (test_slices.py, test_temporal_layers.py,
test_interlace.py, test_scenecut.py, test_fades_vbvla.py,
test_level_fg_stats.py), at 96x64.

Tolerance: exact (bytes, decoded pictures)."""
import json

import numpy as np
import pytest

from x265_mod_by_patman_tpu.bitstream.nal import split_annexb
from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_e2e_inter import moving_scene
from tests.test_scenecut import flat_scene
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

W, H = 96, 64
# the film-grain model of tests/test_level_fg_stats.py's round trip
FILM_GRAIN = {
    "model_id": 0, "blending_mode_id": 0, "log2_scale_factor": 4,
    "persistence": True,
    "comp_models": [
        {"num_model_values": 1, "intervals": [
            {"lower": 0, "upper": 127, "values": [48]},
            {"lower": 128, "upper": 255, "values": [32]}]},
        None, None],
}


def _fade(n):
    """tests/test_fades_vbvla.py's luma ramp (+12 a frame) at 96x64."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 110, (H, W)).astype(np.int32)
    c = np.full((H // 2, W // 2), 128, np.uint8)
    return [(np.clip(base + 12 * i, 0, 255).astype(np.uint8), c, c)
            for i in range(n)]


def _nal_types(stream):
    return [(n[0] >> 1) & 0x3F for n in split_annexb(stream)]


def _vcl_per_au(frames):
    return [sum(t < 32 for t in _nal_types(f.bitstream)) for f in frames]


def _temporal_ids(stream):
    return sorted({(n[1] & 7) - 1 for n in split_annexb(stream)
                   if ((n[0] >> 1) & 0x3F) < 32})


CQP = dict(qp=30, keyframe_max=250, bframes=0)
# name: (params, clip, check of the stream and its frames)
CASES = {
    # CTU 32 gives the 64 rows two CTU rows (slices are CTU-row bands)
    "slices2": (dict(qp=30, keyframe_max=250, bframes=2, slices=2,
                     wpp=False, ctu_size=32),
                lambda: moving_scene(W, H, 4, seed=10),
                lambda s, e: set(_vcl_per_au(e)) == {2}),
    "me_dia": (dict(CQP, search_method="dia"),
               lambda: moving_scene(W, H, 3), None),
    "me_umh": (dict(CQP, search_method="umh"),
               lambda: moving_scene(W, H, 3), None),
    "me_full": (dict(CQP, search_method="full"),
                lambda: moving_scene(W, H, 3), None),
    # keyint 2: two IDRs, each carrying VPS/SPS/PPS
    "repeat_headers": (dict(CQP, keyframe_max=2, repeat_headers=True),
                       lambda: moving_scene(W, H, 4),
                       lambda s, e: _nal_types(s).count(33) == 2),
    "temporal_layers2": (dict(qp=33, keyframe_max=32, bframes=3,
                              temporal_layers=2, b_adapt=0,
                              scenecut=False, open_gop=False,
                              cu_tree=False, rc_lookahead=0),
                         lambda: moving_scene(W, H, 5),
                         lambda s, e: _temporal_ids(s) == [0, 1]),
    "interlace_tff": (dict(qp=32, keyframe_max=250, bframes=0,
                           interlace=1),
                      lambda: moving_scene(W, H, 4),
                      lambda s, e: _nal_types(s).count(39) >= 4),
    # the histogram test alone (the lookahead's scene cut off) must
    # open an IDR at the cut
    "hist_scenecut": (dict(qp=32, keyframe_max=250, keyframe_min=1,
                           bframes=0, scenecut=False, hist_scenecut=True),
                      lambda: moving_scene(W, H, 3, seed=1)
                      + flat_scene(W, H, 3),
                      lambda s, e: [f.slice_type for f in e][3] == "I"),
    "fades": (dict(qp=32, keyframe_max=250, keyframe_min=1, bframes=0,
                   cu_tree=False, aq_mode=0, weightp=True, fades=True),
              lambda: _fade(8),
              lambda s, e: [f.slice_type for f in e].count("I") <= 2),
    "film_grain": (dict(qp=32, keyframe_max=250, bframes=0),
                   lambda: moving_scene(W, H, 2),
                   lambda s, e: bytes((0x4E, 0x01, 19)) in s),
}


@pytest.mark.parametrize("case", list(CASES))
def test_option_stream_equals_jax_and_decodes(case, tmp_path):
    kw, clip, check = CASES[case]
    if case == "film_grain":
        path = tmp_path / "fg.json"
        path.write_text(json.dumps(FILM_GRAIN))
        kw = dict(kw, film_grain=str(path))
    frames = clip()
    s_jax, e_jax = jtop.encode_sequence(default_params(W, H, **kw), frames)
    s_pt, e_pt = ttop.encode_sequence(default_params(W, H, **kw), frames,
                                      "cpu")
    for i, (a, b) in enumerate(zip(e_pt, e_jax)):
        assert a.bitstream == b.bitstream, f"frame {i} bytes differ"
    assert s_pt == s_jax
    if check is not None:
        assert check(s_pt, e_pt), [f.slice_type for f in e_pt]
    pics = Decoder().decode(s_pt)
    assert len(pics) == len(frames)
    if len({f.poc for f in e_pt}) == len(e_pt):
        by_poc = {f.poc: f for f in e_pt}
        pairs = [(pic, by_poc[pic.poc]) for pic in pics]
    else:
        # a second IDR restarts the POCs: no B-frames here, so the
        # pictures come out in decode order
        pairs = list(zip(pics, e_pt))
    for pic, f in pairs:
        assert np.array_equal(pic.y, f.recon[0])
        assert pic.md5 == f.md5 == pic.sei_md5
