"""The PyTorch port's entry points against the JAX reference's, on the
CPU:

* the API (api.py): open, headers, encode, drain/close, intra refresh
  and a zone added with encoder_reconfig_zone, on the cases of
  tests/test_api.py (at the repo defaults, 96x64, with AQ); every call's NAL list (types and bytes) equals the
  JAX API's for the same pictures, and the stream decodes with matching
  MD5 SEI;
* the CLI (cli.py): the same 96x64 y4m through the port's main() and
  the reference's, under CRF with AQ 2 and cuTree, with a CSV log and
  PSNR; the .hevc files are byte-identical and the CSV rows equal, also
  under --frame-threads 2;
  --amp, --weightb, --me sea, --preset veryslow and the residual-side
  options (--nxn-intra, --scaling-list, --nr-*, --lossless, analysis
  save/load), --mcstf, a cuTree share ring and --abr-ladder run through
  the CLI and decode.

Tolerance: exact (NAL types and bytes, file contents, CSV text)."""
import os

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
    for bd in (8, 10, 12):
        a = tapi.api_get(bd)
        assert a.param_default_preset("medium").internal_bit_depth == bd
    assert tapi.api_get(16) is None
    p = tapi.param_alloc()
    tapi.param_parse(p, "input-res", "96x64")
    p.internal_csp = 2                  # 4:2:2 is ported
    assert tapi.encoder_open(p, "cpu").enc.sps.chroma_format_idc == 2
    p = tapi.param_alloc()
    tapi.param_parse(p, "input-res", "96x64")
    p.internal_csp = 0                  # 4:0:0 is not (nor in the JAX API)
    with pytest.raises(NotImplementedError, match="4:0:0"):
        tapi.encoder_open(p, "cpu")
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
    (["--frame-threads", "2"], "--frame-threads"),
])
def test_cli_rejects_unported_options(tmp_path, extra, name):
    """--frame-threads under CRF is ported: the CLI's stream equals the
    JAX CLI's under the same options and decodes."""
    _write_y4m(tmp_path / "in.y4m")
    assert jcli.main(_cli_args(tmp_path, "jax") + extra) == 0
    assert tcli.main(_cli_args(tmp_path, "port") + ["--device", "cpu"]
                     + extra) == 0
    port = (tmp_path / "port.hevc").read_bytes()
    assert port == (tmp_path / "jax.hevc").read_bytes()
    pics = Decoder().decode(port)
    assert len(pics) == 6 and all(p.md5 == p.sei_md5 for p in pics)


@pytest.mark.parametrize("option", ["--mcstf", "--cutree-share-write",
                                    "--abr-ladder"])
def test_cli_takes_the_ladder_options(tmp_path, option):
    """The port's CLI takes --mcstf, a cuTree share ring and
    --abr-ladder (their streams are held to the reference in
    tests/test_torch_mcstf.py and tests/test_torch_ladder.py): the
    option reaches the encoder (its info SEI lists it) and the stream
    decodes with matching MD5 SEIs.  The ladder here is one rung, this
    file's command line."""
    from x265_mod_by_patman_tpu_torch.utils.ringmem import RingMem
    _write_y4m(tmp_path / "in.y4m")
    ring = f"x265tpu_test_cli_{os.getpid()}"
    argv = _cli_args(tmp_path, "x") + ["--device", "cpu"]
    signalled = {"--mcstf": b"mcstf=True",
                 "--cutree-share-write": f"cutree_share_write={ring}"
                 .encode(),
                 "--abr-ladder": b"rc_mode=crf"}[option]
    if option == "--mcstf":
        argv.append(option)
    elif option == "--cutree-share-write":
        argv += [option, ring]
    else:
        conf = tmp_path / "ladder.conf"
        conf.write_text(" ".join(argv) + "\n")
        argv = [option, str(conf)]
    try:
        assert tcli.main(argv) == 0
    finally:
        if option == "--cutree-share-write":
            RingMem(ring).unlink()
    stream = (tmp_path / "x.hevc").read_bytes()
    info = stream[stream.index(b"x265-tpu"):].split(b" ")
    assert signalled in info, signalled
    pics = Decoder().decode(stream)
    assert len(pics) == 6
    assert all(pc.md5 == pc.sei_md5 for pc in pics)


@pytest.mark.parametrize("extra,signalled", [
    (["--rect", "--amp"], [b"amp=True", b"rect=True"]),
    (["--weightb"], [b"weightb=True"]),
    (["--me", "sea"], [b"search_method=sea"]),
    (["--preset", "veryslow"], [b"amp=True", b"rd_level=6",
                                b"subpel_refine=4", b"bframes=8"]),
])
def test_cli_takes_the_inter_tools(tmp_path, extra, signalled):
    """The port's CLI takes --amp, --weightb, --me sea and --preset
    veryslow (their streams are held to the reference in
    tests/test_torch_amp.py, test_torch_weightb_sea.py and
    test_torch_presets.py): the options reach the encoder (its info SEI
    lists them) and the stream decodes with matching MD5 SEIs."""
    _write_y4m(tmp_path / "in.y4m")
    assert tcli.main(_cli_args(tmp_path, "x") + ["--device", "cpu"]
                     + extra) == 0
    stream = (tmp_path / "x.hevc").read_bytes()
    info = stream[stream.index(b"x265-tpu"):].split(b" ")
    assert all(s in info for s in signalled), signalled
    pics = Decoder().decode(stream)
    assert len(pics) == 6
    assert all(pc.md5 == pc.sei_md5 for pc in pics)


@pytest.mark.parametrize("extra,signalled", [
    (["--nxn-intra", "--tu-intra-depth", "2"],
     [b"nxn_intra=True", b"tu_intra_depth=2"]),
    (["--scaling-list", "default"], [b"scaling_list=default"]),
    (["--nr-intra", "200", "--nr-inter", "400"],
     [b"nr_intra=200", b"nr_inter=400"]),
    (["--lossless"], [b"lossless=True"]),
])
def test_cli_takes_the_residual_options(tmp_path, extra, signalled):
    """The port's CLI takes --nxn-intra with --tu-intra-depth,
    --scaling-list, --nr-intra/--nr-inter and --lossless (their streams
    are held to the reference in tests/test_torch_nxn.py,
    test_torch_scaling.py and test_torch_nr_lossless.py): the options
    reach the encoder (its info SEI lists them) and the stream decodes
    with matching MD5 SEIs."""
    _write_y4m(tmp_path / "in.y4m")
    assert tcli.main(_cli_args(tmp_path, "x") + ["--device", "cpu"]
                     + extra) == 0
    stream = (tmp_path / "x.hevc").read_bytes()
    info = stream[stream.index(b"x265-tpu"):].split(b" ")
    assert all(s in info for s in signalled), signalled
    pics = Decoder().decode(stream)
    assert len(pics) == 6
    assert all(pc.md5 == pc.sei_md5 for pc in pics)


def test_cli_analysis_save_then_load(tmp_path):
    """--analysis-save then --analysis-load through the port's CLI: the
    info SEI names the file, and with it off the two streams are
    byte-identical."""
    _write_y4m(tmp_path / "in.y4m")
    path = str(tmp_path / "a.bin")
    base = _cli_args(tmp_path, "x") + ["--device", "cpu", "--no-info"]
    assert tcli.main(base + ["--analysis-save", path]) == 0
    saved = (tmp_path / "x.hevc").read_bytes()
    assert tcli.main(base + ["--analysis-load", path]) == 0
    assert (tmp_path / "x.hevc").read_bytes() == saved
    assert all(pc.md5 == pc.sei_md5 for pc in Decoder().decode(saved))
    assert tcli.main(_cli_args(tmp_path, "y") + [
        "--device", "cpu", "--analysis-load", path]) == 0
    stream = (tmp_path / "y.hevc").read_bytes()
    info = stream[stream.index(b"x265-tpu"):].split(b" ")
    assert f"analysis_load={path}".encode() in info
