"""The PyTorch port's entry points against the JAX reference's, on the
CPU:

* the API (api.py): open, headers, encode, drain/close, intra refresh
  and a zone added with encoder_reconfig_zone, on the cases of
  tests/test_api.py (at the repo defaults, 96x64, with AQ); every call's NAL list (types and bytes) equals the
  JAX API's for the same pictures, and the stream decodes with matching
  MD5 SEI;
* the CLI (cli.py): the same 96x64 y4m through the port's main() and
  the reference's, under CRF with AQ 2 and cuTree, with a CSV log and
  PSNR; the .hevc files are byte-identical and the CSV rows equal.
  Options the port does not take raise NotImplementedError naming them.

Tolerance: exact (NAL types and bytes, file contents, CSV text)."""
import numpy as np
import pytest
import torch

from x265_mod_by_patman_tpu import api as japi
from x265_mod_by_patman_tpu import cli as jcli
from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu_torch import api as tapi
from x265_mod_by_patman_tpu_torch import cli as tcli
from x265_mod_by_patman_tpu_torch.io.y4m import VideoInfo, Y4MWriter
from tests.test_api import _frames
from tests.test_e2e_inter import moving_scene
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401


def _open(api, qp, *device):
    # the repo defaults, 96x64 and AQ (tests/test_api.py: the "fast"
    # preset, 64x48, no AQ) so that the reference reuses the programs
    # that tests/test_torch_ratecontrol.py compiles
    p = api.param_alloc()
    for k, v in (("input-res", "96x64"), ("qp", str(qp)), ("bframes", "0"),
                 ("keyint", "250"), ("aq-mode", "1")):
        assert api.param_parse(p, k, v) == 0
    assert api.param_apply_profile(p, "main") == 0
    return api.encoder_open(p, *device)


def _nals(nals):
    return [(n.type, n.payload) for n in nals]


def _drive(api, scenario, *device):
    """Run a scenario of tests/test_api.py through one API; returns the
    NAL list of every call (headers first) and the output pictures."""
    if scenario == "roundtrip":
        enc, frames, refresh_at = _open(api, 32, *device), \
            _frames(5, 96, 64), None
    else:
        enc, frames, refresh_at = _open(api, 30, *device), \
            _frames(6, 96, 64, seed=7), 2
        assert api.encoder_reconfig_zone(enc, 4, 5, qp=44) == 0
    calls = [_nals(api.encoder_headers(enc))]
    pics = []
    for i, f in enumerate(frames):
        if i == refresh_at:
            assert api.encoder_intra_refresh(enc) == 0
        n, nals, pic = api.encoder_encode(enc, api.Picture(planes=f, pts=i))
        calls.append(_nals(nals))
        if n:
            pics.append(pic)
    for nals, pic in api.encoder_close(enc):
        calls.append(_nals(nals))
        pics.append(pic)
    return enc, calls, pics


@pytest.mark.parametrize("scenario", ["roundtrip", "refresh_and_zone"])
def test_api_nals_equal_jax(scenario):
    _je, j_calls, j_pics = _drive(japi, scenario)
    te, t_calls, t_pics = _drive(tapi, scenario, "cpu")
    assert t_calls == j_calls
    assert [(p.poc, p.pts, p.slice_type) for p in t_pics] == \
        [(p.poc, p.pts, p.slice_type) for p in j_pics]
    for a, b in zip(t_pics, j_pics):
        for pa, pb in zip(a.planes, b.planes):
            assert np.array_equal(pa, pb)
    stream = b"".join(payload for call in t_calls for _t, payload in call)
    dec = Decoder().decode(stream)
    assert len(dec) == len(t_pics)
    for pc in dec:
        assert pc.md5 == pc.sei_md5
    st = tapi.encoder_get_stats(te)
    assert st.encoded_picture_count == len(t_pics)
    if scenario == "refresh_and_zone":
        types = {p.pts: p.slice_type for p in t_pics}
        assert types[2] == "I", types          # the intra refresh landed
        # the zone: frames 4 and 5 (the last two coded, no B-frames)
        assert [h.qp for h in te.enc.rc.history][-2:] == [44, 44]


def test_api_device_and_bit_depths():
    a8 = tapi.api_get(8)
    assert a8.param_default_preset("medium").internal_bit_depth == 8
    with pytest.raises(NotImplementedError, match="bit depths above 8"):
        tapi.api_get(10)
    p = tapi.param_alloc()
    tapi.param_parse(p, "input-res", "96x64")
    assert tapi.encoder_open(p, "cpu").enc.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.encoder_open(p)               # "cuda" by default


def _write_y4m(path, n=6):
    wr = Y4MWriter(str(path), VideoInfo(96, 64, 25, 1, total_frames=n))
    for f in moving_scene(96, 64, n):
        wr.write(*f)
    wr.close()


def _cli_args(tmp_path, name):
    return ["--input", str(tmp_path / "in.y4m"),
            "-o", str(tmp_path / f"{name}.hevc"), "--crf", "28",
            "--aq-mode", "2", "--rc-lookahead", "4", "--frames", "6",
            "--no-progress", "--csv", str(tmp_path / f"{name}.csv"),
            "--psnr"]


def test_cli_output_equals_jax_cli(tmp_path):
    _write_y4m(tmp_path / "in.y4m")
    assert jcli.main(_cli_args(tmp_path, "jax")) == 0
    assert tcli.main(_cli_args(tmp_path, "port") + ["--device", "cpu"]) == 0
    port = (tmp_path / "port.hevc").read_bytes()
    assert port == (tmp_path / "jax.hevc").read_bytes()
    rows = (tmp_path / "port.csv").read_text().splitlines()
    assert rows == (tmp_path / "jax.csv").read_text().splitlines()
    assert len(rows) == 7 and rows[0].startswith("poc,type,qp,bits,psnr_y")
    assert len(Decoder().decode(port)) == 6


@pytest.mark.parametrize("extra,name", [
    (["--abr-ladder", "ladder.txt"], "--abr-ladder"),
    (["--vbv-bufsize", "800", "--vbv-maxrate", "400"], "--vbv-bufsize"),
    (["--vbv-bufsize", "800", "--vbv-maxrate", "400", "--hrd"], "--hrd"),
    (["--frame-threads", "2"], "--frame-threads"),
])
def test_cli_rejects_unported_options(tmp_path, extra, name):
    _write_y4m(tmp_path / "in.y4m", 1)
    with pytest.raises(NotImplementedError, match=name):
        tcli.main(_cli_args(tmp_path, "x") + ["--device", "cpu"] + extra)
