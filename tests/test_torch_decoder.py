"""The port's own validation decoder (x265_mod_by_patman_tpu_torch.decoder,
a copy of the reference's jax-free decoder over the port's copies of its
numpy goldens) against the JAX decoder, on streams of the port's CPU
encoder at 96x64: the repo defaults with B pictures, Main10 under CRF
with AQ and cuTree, and one stream with the slow preset's tools together
(rect P/B PUs, HME, RDOQ with sign hiding).  Both decoders must give the
same pictures, in the same order, equal to the encoder's recon, with
each picture's MD5 SEI matching.

Tolerance: exact (pixels, MD5s)."""
import numpy as np
import pytest
import torch

from x265_mod_by_patman_tpu.decoder.decoder import Decoder as JDecoder
from x265_mod_by_patman_tpu_torch.decoder.decoder import Decoder as TDecoder
from x265_mod_by_patman_tpu_torch.encoder.top import encode_sequence
from x265_mod_by_patman_tpu_torch.params import default_params
from tests.test_e2e_inter import moving_scene
from tests.test_rect_b import _b_band_clip
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _defaults_b():
    return default_params(96, 64, qp=32, keyframe_max=250), \
        moving_scene(96, 64, 6, seed=3)


def _main10():
    p = default_params(96, 64, rc_mode="crf", crf=26.0, aq_mode=2,
                       internal_bit_depth=10, keyframe_max=250)
    frames = [tuple(a.astype(np.uint16) * 4 + (i & 3) for a in f)
              for i, f in enumerate(moving_scene(96, 64, 5, seed=8))]
    return p, frames


def _slow_tools():
    p = default_params(96, 64, qp=30, keyframe_max=250, bframes=2,
                       rect=True, hme=True, rdoq_level=2, sign_hide=True,
                       psy_rdoq=1.0, scenecut=False, b_adapt=0,
                       weightp=False)
    return p, _b_band_clip(np.random.default_rng(7), 96, 64, 4)


STREAMS = {"defaults_b": _defaults_b, "main10": _main10,
           "slow_tools": _slow_tools}


@pytest.fixture(scope="module")
def decoded():
    """name -> (port frames, port decoder's pictures, JAX decoder's),
    each stream encoded and decoded once, when a test first reads it."""
    cache = {}

    def get(name):
        if name not in cache:
            p, frames = STREAMS[name]()
            stream, enc = encode_sequence(p.validate(), frames, CPU)
            cache[name] = (enc, TDecoder().decode(stream),
                           JDecoder().decode(stream))
        return cache[name]
    return get


def _equals_jax_decoder(decoded, name):
    enc, tp, jp = decoded(name)
    assert [p.poc for p in tp] == [p.poc for p in jp]
    for a, b in zip(tp, jp):
        assert a.md5 == b.md5 and a.sei_md5 == b.sei_md5
        for pa, pb in zip((a.y, a.u, a.v), (b.y, b.u, b.v)):
            np.testing.assert_array_equal(pa, pb)


def _gives_the_encoder_recon(decoded, name):
    enc, tp, _ = decoded(name)
    assert len(tp) == len(enc)
    by_poc = {f.poc: f for f in enc}
    for pic in tp:
        f = by_poc[pic.poc]
        assert pic.sei_md5 == pic.md5 == f.md5
        for a, b in zip((pic.y, pic.u, pic.v), f.recon):
            np.testing.assert_array_equal(a, np.asarray(b))
    if name == "slow_tools":
        assert any(f.stats.get("cu_rect_pct", 0) > 0 for f in enc)
    assert {f.slice_type for f in enc} >= {"I", "P", "B"}


DECODER_CHECKS = {"equals_jax_decoder": _equals_jax_decoder,
                  "gives_the_encoder_recon": _gives_the_encoder_recon}


# the stream outermost: xdist's --dist load hands out runs of consecutive
# tests, so a stream's checks land on the worker that encoded it
@pytest.mark.parametrize("name,check", [(n, k) for n in STREAMS
                                        for k in DECODER_CHECKS])
def test_port_decoder(decoded, name, check):
    DECODER_CHECKS[check](decoded, name)
