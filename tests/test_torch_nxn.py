"""NxN intra PUs and their TU4 (DST) splits in the PyTorch port against
the JAX reference, on the reference's own test clips (the directional
8x8 tiles of tests/test_nxn_intra.py at 96x64 and the micro-detail frame
of tests/test_tu4_dst.py at 64x64):

* the decisions: decide_modes_split (with and without the TU4 option in
  its RD gate), decide_tu4_split and decide_modes_tree(nxn=True);
* I pictures on the fixed-grid route with TU4 splits (the decoder must
  see 4x4 luma TBs) and on the CU-tree route at --tu-intra-depth 1:
  byte-identical to the JAX encoder's and decoded by the in-repo decoder
  to the port's recon with matching MD5 SEI.

Tolerance: exact (modes, split maps, bytes, pixels)."""
import numpy as np
import pytest
import torch

from x265_mod_by_patman_tpu.analysis import intra_mode as jim
from x265_mod_by_patman_tpu.bitstream.headers import build_sps_info
from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.analysis import intra_mode as tim
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_nxn_intra import micro_pattern
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401
from tests.test_tu4_dst import _decode_counting_tu4, detail_frame

CPU = torch.device("cpu")


def encode_both(p_fn, frames):
    """The same params and frames through the JAX encoder and the port on
    the CPU: the streams must be byte-identical, picture by picture, and
    decode to the port's recon with matching MD5 SEI.  Returns (stream,
    the port's EncodedFrames)."""
    s_jax, e_jax = jtop.encode_sequence(p_fn(), frames)
    s_pt, e_pt = ttop.encode_sequence(p_fn(), frames, "cpu")
    assert [f.slice_type for f in e_pt] == [f.slice_type for f in e_jax]
    for i, (a, b) in enumerate(zip(e_pt, e_jax)):
        assert a.bitstream == b.bitstream, f"picture {i} bytes differ"
    assert s_pt == s_jax
    check_decodes(s_pt, e_pt)
    return s_pt, e_pt


def check_decodes(stream, encoded):
    pics = Decoder().decode(stream)
    assert len(pics) == len(encoded)
    by_poc = {f.poc: f for f in encoded}
    for pic in pics:
        f = by_poc[pic.poc]
        for a, b in zip((pic.y, pic.u, pic.v), f.recon):
            assert np.array_equal(a, b), f"picture {pic.poc} differs"
        assert pic.md5 == f.md5 == pic.sei_md5


def _tiles():
    return micro_pattern(96, 64)


def _detail():
    return detail_frame()[0]


CLIPS = {"tiles": (_tiles, 96, 64, 28), "detail": (_detail, 64, 64, 30)}


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("tu4", [False, True])
def test_decide_modes_split_matches_reference(clip, tu4):
    make, w, h, qp = CLIPS[clip]
    y = make()
    sps = build_sps_info(default_params(w, h, nxn_intra=True).validate())
    exp = jim.decide_modes_split(y, sps, qp, 16, tu4=tu4)
    got = tim.decide_modes_split(y, sps, qp, CPU, 16, tu4=tu4)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a, b)
    assert exp[1].any()                 # the clips do split


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_decide_tu4_split_matches_reference(clip):
    make, w, h, qp = CLIPS[clip]
    y = make()
    sps = build_sps_info(default_params(w, h, nxn_intra=True,
                                        tu_intra_depth=2).validate())
    _, split_map, modes8 = jim.decide_modes_split(y, sps, qp, 16, tu4=True)
    exp = jim.decide_tu4_split(y, sps, qp, modes8, split_map)
    got = tim.decide_tu4_split(y, sps, qp, modes8, split_map, CPU)
    np.testing.assert_array_equal(got, exp)
    if clip == "detail":
        assert exp.any()


def test_decide_modes_tree_nxn_matches_reference():
    y = _tiles()
    sps = build_sps_info(default_params(96, 64, nxn_intra=True).validate())
    exp = jim.decide_modes_tree(y, sps, 28, nxn=True)
    got = tim.decide_modes_tree(y, sps, 28, CPU, nxn=True)
    assert got[5] is None and exp[5] is None
    for a, b in zip(got[:5], exp[:5]):
        np.testing.assert_array_equal(a, b)
    assert exp[1].any() and exp[3].all()   # NxN blocks force split32


def test_fixed_grid_tu4_stream_matches_reference():
    """--nxn-intra --tu-intra-depth 2 on the detail frame (the fixed-grid
    wavefront with the TU4 DST chain): the stream codes 4x4 luma TBs."""
    p_fn = lambda: default_params(64, 64, qp=30, keyframe_max=1,
                                  nxn_intra=True, tu_intra_depth=2,
                                  sao=False, deblock=False, aq_mode=0,
                                  cu_tree=False)
    assert not p_fn().validate().var_cu_tree
    stream, _ = encode_both(p_fn, [detail_frame()])
    _, n_tu4 = _decode_counting_tu4(stream)
    assert n_tu4 > 0


def test_tree_route_nxn_stream_matches_reference():
    """--nxn-intra at --tu-intra-depth 1 and rd 3: the CU-tree route
    (run_tree with the NxN sub-TUs), with deblock and SAO."""
    y = _tiles()
    u = np.full((32, 48), 110, np.uint8)
    v = np.full((32, 48), 140, np.uint8)
    p_fn = lambda: default_params(96, 64, qp=28, keyframe_max=1,
                                  nxn_intra=True)
    assert p_fn().validate().var_cu_tree
    encode_both(p_fn, [(y, u, v)])
