"""AMP inter PUs (2NxnU / 2NxnD / nLx2N / nRx2N) in P and B pictures of
the PyTorch port against the JAX reference, on the CPU.

The stream is the quarter-strip scene of the reference's own AMP test
(tests/test_amp_pu.py) as I P B B P (bframes 2, b-adapt 0, rect, amp):
the port's bytes must equal the reference encoder's, decode (port and
JAX decoders) to the recon with matching MD5 SEIs, and carry AMP part
codes in a P and in a B picture.  The same scene analysed in 2-row
bands (the port reads the final MC from the whole-frame planes) must
decode too.  The AMP geometry helpers must give the spec's PU split
(entropy.cu_syntax.pu_partitions, spec 7.4.9.5).

Tolerance: exact (bytes, pixels, MD5s, masks)."""
import numpy as np
import pytest
import torch

import x265_mod_by_patman_tpu_torch.analysis.inter_mode as tim
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.decoder.decoder import Decoder as TDecoder
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from x265_mod_by_patman_tpu_torch.entropy.cu_syntax import pu_partitions
from tests.test_amp_pu import quarter_strip_scene
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401
from tests.test_torch_slow import _small_bands, check_decodes

CPU = torch.device("cpu")


def _amp_ippb():
    return default_params(96, 64, qp=30, keyframe_max=250, bframes=2,
                          b_adapt=0, rect=True, amp=True, sao=False,
                          scenecut=False, cu_tree=False, aq_mode=0)


def parts_by_slice(stream, frames):
    """Decode `stream` with the port's decoder, recording each inter CU's
    part_mode; returns {slice type: [part codes]} (one slice per
    picture, `frames` in decode order)."""
    rows = []
    dec_slice, recon_cu = TDecoder._decode_slice, TDecoder._recon_cu

    def on_slice(self, *a, **k):
        rows.append([])
        return dec_slice(self, *a, **k)

    def on_cu(self, cu, *a, **k):
        if cu.is_inter:
            rows[-1].append(getattr(cu, "part_mode", 0))
        return recon_cu(self, cu, *a, **k)

    TDecoder._decode_slice, TDecoder._recon_cu = on_slice, on_cu
    try:
        TDecoder().decode(stream)
    finally:
        TDecoder._decode_slice, TDecoder._recon_cu = dec_slice, recon_cu
    out = {}
    for f, parts in zip(frames, rows):
        out.setdefault(f.slice_type, []).extend(parts)
    return out


@pytest.fixture(scope="module")
def amp_stream():
    frames = quarter_strip_scene(96, 64, 5, True)
    js, _ = jtop.encode_sequence(_amp_ippb().validate(), frames)
    ts, tf = ttop.encode_sequence(_amp_ippb().validate(), frames, CPU)
    return js, ts, tf


def test_amp_stream_equals_jax(amp_stream):
    js, ts, tf = amp_stream
    assert [f.slice_type for f in tf] == ["I", "P", "B", "B", "P"]
    assert ts == js


def test_amp_stream_decodes(amp_stream):
    _, ts, tf = amp_stream
    check_decodes(ts, tf)


def test_amp_parts_in_p_and_b(amp_stream):
    """Premise: the quarter-strip motion elicits AMP PUs in a P and in a
    B picture (and the encoder's stat counts them)."""
    _, ts, tf = amp_stream
    parts = parts_by_slice(ts, tf)
    for t in ("P", "B"):
        assert any(pm >= 4 for pm in parts[t]), (t, set(parts[t]))
        assert any(f.stats.get("cu_amp_pct", 0) > 0 for f in tf
                   if f.slice_type == t), t


def test_banded_amp_stream_decodes(monkeypatch):
    """AMP in row bands (2-row bands, as tests/test_torch_slow.py cuts
    them): the final P and B predictions are read again from the
    whole-frame planes, so the stream decodes to the port's recon."""
    monkeypatch.setattr(tim, "_analysis_bands", _small_bands)
    ts, tf = ttop.encode_sequence(_amp_ippb().validate(),
                                  quarter_strip_scene(96, 64, 5, True), CPU)
    check_decodes(ts, tf)
    parts = parts_by_slice(ts, tf)
    assert any(pm >= 4 for t in ("P", "B") for pm in parts[t])


@pytest.mark.parametrize("sz", [16, 8])
@pytest.mark.parametrize("code", [4, 5, 6, 7])
def test_amp_mask_is_the_spec_pu_split(code, sz):
    """_amp_mask marks PU1 of pu_partitions' split, and _amp_shapes' tile
    ranges cover PU0 and PU1 of the 16x16 luma block."""
    (x0, y0, w0, h0, _), (x1, y1, w1, h1, _) = pu_partitions(0, 0, sz, code)
    want = np.zeros((sz, sz), bool)
    want[y1:y1 + h1, x1:x1 + w1] = True
    got = tim._amp_mask(torch.tensor([code], dtype=torch.int32), sz, CPU)
    np.testing.assert_array_equal(got[0].numpy(), want)
    if sz == 16:
        _, ra, rb = [s for s in tim._amp_shapes(4) if s[0] == code][0]
        for (rows, cols), (x, y, w, h) in ((ra, (x0, y0, w0, h0)),
                                           (rb, (x1, y1, w1, h1))):
            assert (rows[0] * 4, cols[0] * 4) == (y, x)
            assert ((rows[1] - rows[0]) * 4, (cols[1] - cols[0]) * 4) == \
                (h, w)
