"""Frame-parallel B (--frame-threads > 1) in the PyTorch port against the
JAX reference, at the 96x64 of tests/test_torch_bframes.py:

* under CRF and ABR with --bframes 3 and a window of 3, the window's B
  pictures defer their rate-control update and decode-order step, which
  are replayed in decode order once the window is done.  The stream
  equals the JAX encoder's byte for byte (whose own window bytes are
  the same over two runs) and decodes
  with matching MD5 SEIs; under ABR the deferral changes a QP against
  the window of 1;
* under CQP the window gives the bytes of --frame-threads 1, and under
  a VBV the window is off, as in the reference.

Tolerance: exact (bytes, QPs, pixels)."""
import numpy as np
import pytest

from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_e2e_inter import moving_scene
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

W, H = 96, 64
N = 8
RC = {"crf": dict(rc_mode="crf", crf=28.0),
      "abr": dict(rc_mode="abr", bitrate_kbps=300)}


def _params(window, **kw):
    return default_params(W, H, bframes=3, frame_parallel_window=window,
                          **kw)


def _decodes(stream, frames):
    pics = Decoder().decode(stream)
    assert len(pics) == len(frames)
    for i, (f, pic) in enumerate(zip(frames, pics)):
        ry, ru, rv = f.recon
        assert np.array_equal(pic.y, ry), f"luma mismatch frame {i}"
        assert np.array_equal(pic.u, ru), f"cb mismatch frame {i}"
        assert np.array_equal(pic.v, rv), f"cr mismatch frame {i}"
        assert pic.md5 == f.md5 == pic.sei_md5


@pytest.mark.parametrize("rc", sorted(RC))
def test_window_stream_equals_jax_and_decodes(rc):
    frames = moving_scene(W, H, N)
    s_jax, e_jax = jtop.encode_sequence(_params(3, **RC[rc]), frames)
    s_jax2, _ = jtop.encode_sequence(_params(3, **RC[rc]), frames)
    assert s_jax2 == s_jax                # the reference is deterministic
    s_pt, e_pt = ttop.encode_sequence(_params(3, **RC[rc]), frames, "cpu")
    assert [f.slice_type for f in e_pt].count("B") == 5
    for i, (a, b) in enumerate(zip(e_pt, e_jax)):
        assert a.bitstream == b.bitstream, f"frame {i} bytes differ"
    assert s_pt == s_jax
    _decodes(s_pt, e_pt)
    if rc == "abr":
        # the deferral is what the window changes: in turn, the second
        # job takes its QP after the first job's update
        _s1, e_one = ttop.encode_sequence(_params(1, **RC[rc]), frames,
                                          "cpu")
        assert [f.qp for f in e_one] != [f.qp for f in e_pt]


def test_cqp_window_equals_in_turn():
    # info SEI off: it prints the window size
    frames = moving_scene(W, H, N)
    s3, e3 = ttop.encode_sequence(_params(3, info_sei=False), frames, "cpu")
    s1, _e1 = ttop.encode_sequence(_params(1, info_sei=False), frames,
                                   "cpu")
    assert s3 == s1
    _decodes(s3, e3)


def test_window_is_off_under_vbv():
    """As in the reference, a VBV (like HRD, NR or an analysis store)
    keeps the B pictures in turn with immediate updates: ABR under a VBV
    gives the bytes of --frame-threads 1."""
    frames = moving_scene(W, H, N)
    kw = dict(RC["abr"], vbv_bufsize=300, vbv_maxrate=300, info_sei=False)
    s3, e3 = ttop.encode_sequence(_params(3, **kw), frames, "cpu")
    s1, _e1 = ttop.encode_sequence(_params(1, **kw), frames, "cpu")
    assert s3 == s1
    _decodes(s3, e3)
