"""Presets of the PyTorch port against the JAX reference, on the CPU, on
moving_scene at 96x64, QP 30:

* `--preset veryslow` (AMP in P and B, rect, rd 6, subme 4, 4 of its 5
  references, 8 B-frames, --me star): byte-identical to the reference
  encoder and decodes with matching MD5 SEIs; `slower` and `placebo`
  give the port the same slice NALs here;
* the rd-2 presets of BASELINE configs 1 and 2: `ultrafast` with keyint 1
  (intra only) and `fast`, byte-identical and decoding.

Tolerance: exact (bytes, pixels, MD5s)."""
import numpy as np
import pytest
import torch

from x265_mod_by_patman_tpu.decoder.decoder import Decoder as JDecoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.bitstream.nal import split_annexb
from x265_mod_by_patman_tpu_torch.decoder.decoder import Decoder as TDecoder
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_e2e_inter import moving_scene
from tests.test_torch_amp import parts_by_slice
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401
from tests.test_torch_slow import check_decodes

CPU = torch.device("cpu")


def preset_params(preset, **kw):
    p = default_params(96, 64, qp=30)
    p.apply_preset(preset)
    for k, v in kw.items():
        setattr(p, k, v)
    return p


CASES = {"veryslow": ("veryslow", {}),
         "ultrafast_intra": ("ultrafast", dict(keyframe_max=1)),
         "fast": ("fast", {})}


@pytest.fixture(scope="module")
def streams():
    out = {}
    frames = moving_scene(96, 64, 5)
    for name, (preset, kw) in CASES.items():
        js, _ = jtop.encode_sequence(preset_params(preset, **kw).validate(),
                                     frames)
        ts, tf = ttop.encode_sequence(preset_params(preset, **kw).validate(),
                                      frames, CPU)
        out[name] = (js, ts, tf)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_preset_stream_equals_jax(streams, case):
    js, ts, _ = streams[case]
    assert ts == js


def check_intra_decodes(stream, frames):
    """check_decodes for an all-IDR stream, whose pictures all have POC
    0: the pictures are matched in decode order."""
    for dec in (TDecoder, JDecoder):
        pics = dec().decode(stream)
        assert len(pics) == len(frames), dec
        for i, (pic, f) in enumerate(zip(pics, frames)):
            assert pic.sei_md5 == pic.md5 == f.md5, (dec, i)
            for a, b in zip((pic.y, pic.u, pic.v), f.recon):
                np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("case", list(CASES))
def test_preset_stream_decodes(streams, case):
    _, ts, tf = streams[case]
    if case == "ultrafast_intra":
        assert {f.slice_type for f in tf} == {"I"}
        check_intra_decodes(ts, tf)
    else:
        check_decodes(ts, tf)


def test_veryslow_premises(streams):
    """The preset reaches the encoder with AMP, rect, rd 6, subme 4,
    star search and 4 references, and AMP PUs occur in the stream."""
    _, ts, tf = streams["veryslow"]
    p = preset_params("veryslow").validate()
    assert (p.amp, p.rect, p.rd_level, p.subpel_refine, p.bframes,
            p.search_method) == (True, True, 6, 4, 8, "star")
    enc = ttop.Encoder(preset_params("veryslow"), CPU)
    assert enc.max_refs == 4
    parts = parts_by_slice(ts, tf)
    assert any(pm >= 4 for t in parts for pm in parts[t])


def slice_nals(stream):
    """The stream's slice (VCL) NAL units, in order."""
    return [u for u in split_annexb(stream) if u and (u[0] >> 1) & 0x3F < 32]


@pytest.mark.parametrize("preset", ["slower", "placebo"])
def test_slower_and_placebo_slices_equal_veryslow(streams, preset):
    """At this size the three top presets code the same slices (their
    parameter sets and info SEI differ): the port's slower and placebo
    slice NALs equal the reference's veryslow ones."""
    ts, _ = ttop.encode_sequence(preset_params(preset).validate(),
                                 moving_scene(96, 64, 5), CPU)
    assert ts != streams["veryslow"][0]
    assert slice_nals(ts) == slice_nals(streams["veryslow"][0])
