"""The delivery half of the Main10 path in the PyTorch port against the
JAX reference on the CPU:

* HDR10 signalling (colour description, mastering display, content
  light level) with HDR10+ dynamic metadata injected from a JSON file
  (tests/test_hdr10plus.py's record) as per-picture T.35 SEIs;
* Dolby Vision RPU pass-through (tests/test_dovi_rpu.py's RPU file):
  each picture's RPU NAL after its slice;
* the API at 10 bits (`api_get(10)`): every call's NAL list equals the
  JAX API's, and `api_get(12)`'s equal those of the JAX API's namespace
  class pinned to 12 bits (its api_get stops at 10);
* the CLI on a 10-bit y4m under CRF + AQ 2 + cuTree with VBV and HRD:
  the .hevc, the CSV log (with the VBV fullness column) and the 16-bit
  recon y4m equal the JAX CLI's.

Every stream decodes in the in-repo decoder with matching MD5 SEI.

Tolerance: exact (bytes, NAL lists, file contents)."""
import json

import numpy as np
import pytest

from x265_mod_by_patman_tpu import api as japi
from x265_mod_by_patman_tpu import cli as jcli
from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch import api as tapi
from x265_mod_by_patman_tpu_torch import cli as tcli
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from x265_mod_by_patman_tpu_torch.io.y4m import VideoInfo, Y4MWriter
from tests.test_10bit import synth10
from tests.test_12bit import synth12
from tests.test_dovi_rpu import _rpu_nal
from tests.test_e2e_inter import moving_scene
from tests.test_hdr10plus import REC
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

W, H = 96, 64
HDR10 = dict(colorprim=9, transfer=16, colormatrix=9,
             master_display="G(13250,34500)B(7500,3000)R(34000,16000)"
                            "WP(15635,16450)L(10000000,1)",
             max_cll=1000, max_fall=400)
IPP10 = dict(qp=30, keyframe_max=250, bframes=0, internal_bit_depth=10)


def _frames(n=3):
    return [synth10(W, H, seed=3, motion=3 * i) for i in range(n)]


def _side_files(tmp_path):
    jf = tmp_path / "hdr10plus.json"
    jf.write_text(json.dumps({"SceneInfo": [REC, REC, REC]}))
    rpu = tmp_path / "dovi.rpu"
    rpu.write_bytes(b"".join(_rpu_nal(i) for i in range(3)))
    return str(jf), str(rpu)


@pytest.mark.parametrize("case", ["hdr10plus", "dolby_vision_rpu"])
def test_hdr_metadata_stream_equals_jax_and_decodes(case, tmp_path):
    jf, rpu = _side_files(tmp_path)
    kw = dict(IPP10, **HDR10, dhdr10_info=jf) if case == "hdr10plus" \
        else dict(IPP10, dolby_vision_rpu=rpu, dolby_vision_profile=81)
    frames = _frames()
    s_jax, e_jax = jtop.encode_sequence(default_params(W, H, **kw), frames)
    s_pt, e_pt = ttop.encode_sequence(default_params(W, H, **kw), frames,
                                      "cpu")
    for i, (a, b) in enumerate(zip(e_pt, e_jax)):
        assert a.bitstream == b.bitstream, f"frame {i} bytes differ"
    assert s_pt == s_jax
    dec = Decoder()
    pics = dec.decode(s_pt)
    assert len(pics) == 3 and dec.sps.bit_depth == 10
    for f, pc in zip(e_pt, pics):
        assert np.array_equal(pc.y, f.recon[0])
        assert pc.md5 == f.md5 == pc.sei_md5
    if case == "hdr10plus":
        types = [t for t, _ in dec.prefix_seis]
        assert types.count(4) == 3                 # one T.35 per picture
        assert 137 in types and 144 in types       # mastering, CLL
        vui = dec.sps
        assert (vui.colour_primaries, vui.transfer_characteristics,
                vui.matrix_coeffs) == (9, 16, 9)
    else:
        assert [t for t, _ in dec.unspecified_nals] == [62] * 3
        assert dec.unspecified_nals[2][1].rstrip(b"\x00") \
            .endswith(bytes([0x12, 0xAA, 2]))


def _drive_10bit(api, *device):
    """The 10-bit namespace: open, headers, four pictures, close."""
    a = api.api_get(10)
    p = a.param_default_preset("medium")
    assert p.internal_bit_depth == 10
    for k, v in (("input-res", f"{W}x{H}"), ("qp", "30"), ("bframes", "2"),
                 ("keyint", "250"), ("aq-mode", "1")):
        assert a.param_parse(p, k, v) == 0
    assert a.param_apply_profile(p, "main10") == 0
    enc = a.encoder_open(p, *device)
    calls = [[(n.type, n.payload) for n in a.encoder_headers(enc)]]
    pics = []
    for i, f in enumerate(_frames(4)):
        n, nals, pic = a.encoder_encode(enc, api.Picture(planes=f, pts=i))
        calls.append([(x.type, x.payload) for x in nals])
        if n:
            pics.append(pic)
    for nals, pic in a.encoder_close(enc):
        calls.append([(x.type, x.payload) for x in nals])
        pics.append(pic)
    return calls, pics


def test_api_at_10_bits_equals_jax_api():
    assert tapi.MAX_BIT_DEPTH == tapi.max_bit_depth() == 12
    j_calls, j_pics = _drive_10bit(japi)
    t_calls, t_pics = _drive_10bit(tapi, "cpu")
    assert t_calls == j_calls
    assert [(p.poc, p.pts, p.slice_type) for p in t_pics] == \
        [(p.poc, p.pts, p.slice_type) for p in j_pics]
    for a, b in zip(t_pics, j_pics):
        for pa, pb in zip(a.planes, b.planes):
            assert pa.dtype == np.uint16 and np.array_equal(pa, pb)
    stream = b"".join(payload for call in t_calls for _t, payload in call)
    dec = Decoder()
    assert all(pc.md5 == pc.sei_md5 for pc in dec.decode(stream))
    assert dec.sps.bit_depth == 10


def _drive_12bit(api, ns, *device):
    p = ns.param_default_preset("medium")
    assert p.internal_bit_depth == 12
    for k, v in (("input-res", f"{W}x{H}"), ("qp", "32"), ("keyint", "1")):
        assert ns.param_parse(p, k, v) == 0
    enc = ns.encoder_open(p, *device)
    nals = list(ns.encoder_headers(enc))
    for i, f in enumerate(synth12(W, H, seed=i) for i in range(2)):
        nals += ns.encoder_encode(enc, api.Picture(planes=f, pts=i))[1]
    for more, _pic in ns.encoder_close(enc):
        nals += more
    return [(n.type, n.payload) for n in nals]


def test_api_get_12_encodes_as_the_jax_api():
    """The 12-bit namespace: the JAX API's api_get stops at 10 bits while
    its encoder takes 12, so the port's api_get(12) namespace is held to
    the JAX API's namespace class pinned to 12 bits."""
    assert tapi.api_get(9) is None and japi.api_get(12) is None
    got = _drive_12bit(tapi, tapi.api_get(12), "cpu")
    exp = _drive_12bit(japi, japi._Api(12))
    assert got == exp
    dec = Decoder()
    pics = dec.decode(b"".join(payload for _t, payload in got))
    assert dec.sps.bit_depth == 12 and len(pics) == 2
    assert all(pc.md5 == pc.sei_md5 for pc in pics)


def _write_y4m(path, n=6):
    """tests/test_torch_cli.py's 96x64 scene at 10 bits (times 4, plus a
    seeded dither in [-2, 2]).  The synth10 clip of the other cases
    meets the reference's TU32 QP-chain fault under CRF + AQ 2 + cuTree
    (tests/test_torch_main10.py holds the port's repair there), and the
    JAX CLI's bytes are the reference here."""
    rng = np.random.default_rng(10)
    wr = Y4MWriter(str(path), VideoInfo(W, H, 25, 1, bit_depth=10,
                                        total_frames=n))
    for f in moving_scene(W, H, n):
        wr.write(*(np.clip(p.astype(np.int32) * 4 + rng.integers(
            -2, 3, p.shape), 0, 1023).astype(np.uint16) for p in f))
    wr.close()


def _cli_args(tmp_path, name):
    return ["--input", str(tmp_path / "in.y4m"),
            "-o", str(tmp_path / f"{name}.hevc"), "--crf", "28",
            "--aq-mode", "2", "--rc-lookahead", "4", "--frames", "6",
            "--vbv-bufsize", "300", "--vbv-maxrate", "300", "--hrd",
            "--no-progress", "--csv", str(tmp_path / f"{name}.csv"),
            "--csv-log-level", "2", "--psnr",
            "--recon", str(tmp_path / f"{name}.y4m")]


def test_cli_10bit_output_equals_jax_cli(tmp_path):
    _write_y4m(tmp_path / "in.y4m")
    assert jcli.main(_cli_args(tmp_path, "jax")) == 0
    assert tcli.main(_cli_args(tmp_path, "port") + ["--device", "cpu"]) == 0
    port = (tmp_path / "port.hevc").read_bytes()
    assert port == (tmp_path / "jax.hevc").read_bytes()
    rows = (tmp_path / "port.csv").read_text().splitlines()
    assert rows == (tmp_path / "jax.csv").read_text().splitlines()
    assert rows[0].endswith(",vbv_fill_pct") and len(rows) == 7
    assert all(r.split(",")[-1] for r in rows[1:])     # fullness filled
    recon = (tmp_path / "port.y4m").read_bytes()
    assert recon == (tmp_path / "jax.y4m").read_bytes()
    assert b"C420p10" in recon[:80]
    dec = Decoder()
    pics = dec.decode(port)
    assert len(pics) == 6 and dec.sps.bit_depth == 10 and dec.sps.hrd
    assert all(pc.md5 == pc.sei_md5 for pc in pics)
