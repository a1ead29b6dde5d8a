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
    """case -> (JAX stream, port stream, port frames), each case encoded
    once, when a test first reads it."""
    cache = {}

    def get(case):
        if case not in cache:
            preset, kw = CASES[case]
            frames = moving_scene(96, 64, 5)
            js, _ = jtop.encode_sequence(
                preset_params(preset, **kw).validate(), frames)
            ts, tf = ttop.encode_sequence(
                preset_params(preset, **kw).validate(), frames, CPU)
            cache[case] = (js, ts, tf)
        return cache[case]
    return get


def _equals_jax(streams, case):
    js, ts, _ = streams(case)
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


def _decodes(streams, case):
    _, ts, tf = streams(case)
    if case == "ultrafast_intra":
        assert {f.slice_type for f in tf} == {"I"}
        check_intra_decodes(ts, tf)
    else:
        check_decodes(ts, tf)


def _veryslow_premises(streams, case):
    """The preset reaches the encoder with AMP, rect, rd 6, subme 4,
    star search and 4 references, and AMP PUs occur in the stream."""
    _, ts, tf = streams(case)
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


def _slices_equal(streams, case, preset):
    """At this size the three top presets code the same slices (their
    parameter sets and info SEI differ): the port's slower and placebo
    slice NALs equal the reference's veryslow ones."""
    ts, _ = ttop.encode_sequence(preset_params(preset).validate(),
                                 moving_scene(96, 64, 5), CPU)
    assert ts != streams(case)[0]
    assert slice_nals(ts) == slice_nals(streams(case)[0])


PRESET_CHECKS = {
    "equals_jax": _equals_jax, "decodes": _decodes,
    "premises": _veryslow_premises,
    "slower_slices": lambda st, c: _slices_equal(st, c, "slower"),
    "placebo_slices": lambda st, c: _slices_equal(st, c, "placebo")}
VERYSLOW_ONLY = ("premises", "slower_slices", "placebo_slices")


# the case outermost: xdist's --dist load hands out runs of consecutive
# tests, so a case's checks land on the worker that encoded it
@pytest.mark.parametrize("case,check", [
    (c, k) for c in CASES for k in PRESET_CHECKS
    if k not in VERYSLOW_ONLY or c == "veryslow"])
def test_preset_stream(streams, case, check):
    PRESET_CHECKS[check](streams, case)
