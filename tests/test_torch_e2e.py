"""The PyTorch port's encoder end to end on the CPU: its streams must be
byte-identical to the JAX encoder's, and the in-repo decoder must decode
them to the port's recon with matching MD5 SEI.

Tolerance: exact (bytes and pixels)."""
import numpy as np
import pytest

from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_e2e_inter import moving_scene
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

CASES = {
    "ippp": (dict(qp=30, keyframe_max=250, bframes=0), 4,
             ["I", "P", "P", "P"]),
    "intra": (dict(qp=30, keyframe_max=1), 2, ["I", "I"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_stream_equals_jax_and_decodes(case):
    w, h = 96, 64
    kw, n, types = CASES[case]
    frames = moving_scene(w, h, n)
    s_jax, e_jax = jtop.encode_sequence(default_params(w, h, **kw), frames)
    s_pt, e_pt = ttop.encode_sequence(default_params(w, h, **kw), frames,
                                      "cpu")
    assert [f.slice_type for f in e_pt] == types
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


@pytest.mark.parametrize("kw,name", [
    (dict(bframes=4, weightb=True), "--weightb"),
    (dict(bframes=0, rect=True), "--rect"),
    (dict(bframes=0, amp=True), "--amp"),
    (dict(bframes=0, search_method="sea"), "--me sea"),
    (dict(bframes=0, hme=True), "--hme"), (dict(bframes=0, mcstf=True),
                                           "--mcstf"),
    (dict(bframes=0, vbv_bufsize=800, vbv_maxrate=400), "VBV"),
    (dict(bframes=0, rc_mode="crf", frame_parallel_window=2),
     "--frame-threads"),
    (dict(bframes=0, analysis_save="x.dat"), "analysis save/load"),
    (dict(bframes=0, mesh_tile_rows=2), "mesh_tile_rows"),
    (dict(bframes=0, internal_csp=3), "4:4:4"),
    (dict(bframes=0, internal_bit_depth=10), "bit depths"),
])
def test_unported_options_raise(kw, name):
    with pytest.raises(NotImplementedError, match=name):
        ttop.Encoder(default_params(96, 64, **kw), "cpu")
