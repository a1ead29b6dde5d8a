"""Noise reduction (--nr-intra / --nr-inter), lossless (--lossless) and
the combination chip_smoke.py's phase 9a runs, in the PyTorch port
against the JAX reference on the CPU:

* NR on tests/test_nr.py's noisy clip: the per-picture offsets each
  wavefront ran with, the per-picture int32 |coef| sums it returned
  (nr_stats) and the bytes are the reference's;
* lossless with and without B pictures: bytes equal, every recon plane
  equals the source;
* 9a's options (--crf 24 --aq-mode 2 --nxn-intra --tu-intra-depth 2
  --scaling-list default --nr-intra 200 --nr-inter 400) at 96x64, I P B.

Every stream decodes to the port's recon with matching MD5 SEI.
Tolerance: exact (integer offsets and sums, bytes, pixels)."""
import numpy as np
import pytest

from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_e2e_inter import moving_scene
from tests.test_nr import _noisy_clip
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401
from tests.test_torch_nxn import check_decodes, encode_both


def _nr_trace(enc):
    """Record the NR offsets each wavefront run gets and the sums each
    picture adds to the running state."""
    seen = {"offsets": [], "stats": []}
    run, update = enc.recon.run, enc._nr_update

    def on_run(*a, **k):
        seen["offsets"].append(k.get("nr"))
        return run(*a, **k)

    def on_update(r):
        seen["stats"].append(tuple(np.asarray(a) for a in r["nr_stats"]))
        return update(r)

    enc.recon.run = on_run
    enc._nr_update = on_update
    return seen


def _encode(enc, frames):
    out = []
    for f in frames:
        out.extend(enc.encode_frame(*f))
    out.extend(enc.flush())
    return out


def test_nr_offsets_sums_and_stream_match_reference():
    frames = _noisy_clip(np.random.default_rng(9), 96, 64, 4)
    p_fn = lambda: default_params(96, 64, qp=26, keyframe_max=250,
                                  bframes=0, scenecut=False, weightp=False,
                                  nr_intra=800, nr_inter=800)
    je, te = jtop.Encoder(p_fn()), ttop.Encoder(p_fn(), "cpu")
    js, ts = _nr_trace(je), _nr_trace(te)
    jo, to = _encode(je, frames), _encode(te, frames)
    assert [f.bitstream for f in to] == [f.bitstream for f in jo]
    assert len(ts["offsets"]) == len(js["offsets"]) == 4
    for a, b in zip(ts["offsets"], js["offsets"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(ts["stats"], js["stats"]):
        assert [x.dtype for x in a] == [np.int32] * 5
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # offsets grow from the second picture on; DC is never denoised
    assert not np.any(ts["offsets"][0][0]) and np.any(ts["offsets"][1][0])
    assert all(o[0][:, 0].max() == 0 for o in ts["offsets"])
    check_decodes(b"".join(f.bitstream for f in to), to)


@pytest.mark.parametrize("bframes", [0, 2])
def test_lossless_stream_matches_reference(bframes):
    frames = moving_scene(96, 64, 3 if bframes else 2)
    _s, e = encode_both(lambda: default_params(
        96, 64, qp=30, keyframe_max=250, bframes=bframes, b_adapt=0,
        lossless=True), frames)
    if bframes:
        assert "B" in [f.slice_type for f in e]
    for f in e:
        for a, b in zip(f.recon, frames[f.disp]):
            np.testing.assert_array_equal(a, b)


def test_phase9a_options_stream_matches_reference():
    def p_fn():
        p = default_params(96, 64, rc_mode="crf", crf=24.0, aq_mode=2,
                           nxn_intra=True, tu_intra_depth=2,
                           scaling_list="default", nr_intra=200,
                           nr_inter=400)
        return p
    p = p_fn().validate()
    assert not p.var_cu_tree and p.cu_tree and p.min_cu_size == 16
    _s, e = encode_both(p_fn, moving_scene(96, 64, 3))
    assert [f.slice_type for f in e] == ["I", "P", "B"]
