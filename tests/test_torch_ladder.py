"""The port's ABR ladder against the JAX reference on the CPU: the
polyphase scaler (utils/scaler.py), the library ladder
(parallel/ladder.py) with and without the cuTree share, and the
--abr-ladder app (abrenc.py through the CLI).

* `scale_plane` at 8, 10 and 12 bits, down and up: exact;
* `AbrLadder`: each rung's bytes equal the JAX ladder's, and decode with
  matching MD5 SEIs (the share case is tests/test_cutree_share.py's);
* `--abr-ladder`: a master at 96x64 under CRF + AQ 2 + --mcstf writing
  the share and two 64x48 slaves reading it: the files equal the JAX
  CLI's;
* the reference's four ladder faults, each beside the port:
  1. its CLI scales a 10-bit rung at 8 bits (clipped at 255); the
     port's rung equals the JAX library ladder's, which scales at the
     rung's depth;
  2. its scaler makes 4:2:0 chroma for a scaled 4:2:2 rung, so the rung
     codes the picture's chroma in its top half and edge copies below;
     the port refuses it;
  3. with --mcstf on the master only, the master publishes display j
     two source frames after the slave asks for it: the slave encodes
     those pictures without the master's offsets.  Copied: the port's
     bytes equal the reference's, and its slave gets no offsets for
     the pictures it codes before the flush;
  4. the share's ring has one consumer: the first slave's reader drains
     every record, so a second slave never gets the master's offsets.
     Copied, as 3.

Tolerance: exact (planes, bytes, source text)."""
import os

import numpy as np
import pytest

from x265_mod_by_patman_tpu import cli as jcli
from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.parallel import ladder as jlad
from x265_mod_by_patman_tpu.utils import scaler as jsc
from x265_mod_by_patman_tpu_torch import cli as tcli
from x265_mod_by_patman_tpu_torch.analysis.cutree_share import \
    CuTreeShareReader
from x265_mod_by_patman_tpu_torch.io.y4m import VideoInfo, Y4MWriter
from x265_mod_by_patman_tpu_torch.parallel import ladder as tlad
from x265_mod_by_patman_tpu_torch.utils import scaler as tsc
from tests.test_e2e_inter import moving_scene
from tests.test_torch_bframes import _defs
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

# -- scaler --------------------------------------------------------------

def test_scaler_host_code_is_verbatim():
    ref = _defs("x265_mod_by_patman_tpu/utils/scaler.py")
    port = _defs("x265_mod_by_patman_tpu_torch/utils/scaler.py")
    for name in ("_bicubic", "_filter_matrix"):
        assert port[name] == ref[name], name


@pytest.mark.parametrize("out_hw", [(36, 40), (96, 136)],
                         ids=["down", "up"])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_scale_plane_matches_reference(bd, out_hw):
    """Random samples over the whole range: upscaled, the bicubic
    kernel's negative lobes overshoot, so the arithmetic shift of
    negative values and the clip at both ends are exercised."""
    rng = np.random.default_rng(bd)
    dt = np.uint8 if bd == 8 else np.uint16
    plane = rng.integers(0, 1 << bd, (64, 96)).astype(dt)
    h, w = out_hw
    want = jsc.scale_plane(plane, w, h, bd)
    got = tsc.scale_plane(plane, w, h, bd, "cpu")
    assert got.dtype == want.dtype and got.shape == (h, w)
    np.testing.assert_array_equal(got, want)
    if h > 64:
        assert want.max() == (1 << bd) - 1 and want.min() == 0


def test_scale_frame_takes_only_420():
    y = np.zeros((64, 96), np.uint8)
    c = np.zeros((64, 48), np.uint8)          # 4:2:2 chroma
    with pytest.raises(NotImplementedError, match="4:2:0"):
        tsc.scale_frame((y, c, c), 48, 32, 8, "cpu")


@pytest.mark.parametrize("spec", ["640x360:qp30", "1280x720:1500k",
                                  "96x64:28", "64x48"])
def test_parse_rung_matches_reference(spec):
    assert vars(tlad.parse_rung(spec)) == vars(jlad.parse_rung(spec))


# -- library ladder ------------------------------------------------------

def _drive(lad, frames):
    outs = [[] for _ in lad.encoders]
    for f in frames:
        for i, fr in enumerate(lad.encode_frame(*f)):
            outs[i].extend(fr)
    for i, fr in enumerate(lad.flush()):
        outs[i].extend(fr)
    return outs


def _check_decodes(stream, frames, n):
    """The stream decodes to the encoder's recon, with matching MD5 SEIs
    (pictures paired by POC; in decode order where every picture is an
    IDR with POC 0)."""
    pics = Decoder().decode(stream)
    assert len(pics) == n
    if len({f.poc for f in frames}) == n:
        by_poc = {f.poc: f for f in frames}
        pairs = [(pic, by_poc[pic.poc]) for pic in pics]
    else:
        pairs = list(zip(pics, frames))
    for pic, f in pairs:
        h, w = pic.y.shape
        assert np.array_equal(pic.y, np.asarray(f.recon[0])[:h, :w])
        assert pic.md5 == f.md5 == pic.sei_md5
    return pics


def test_ladder_rungs_equal_jax_and_decode():
    """tests/test_ladder.py's two intra rungs."""
    rng = np.random.default_rng(4)
    frames = [(rng.integers(0, 256, (96, 128)).astype(np.uint8),
               rng.integers(0, 256, (48, 64)).astype(np.uint8),
               rng.integers(0, 256, (48, 64)).astype(np.uint8))
              for _ in range(3)]
    specs = ["128x96:qp32", "64x64:qp34"]
    want = _drive(jlad.AbrLadder([jlad.parse_rung(s) for s in specs],
                                 keyframe_max=1), frames)
    lad = tlad.AbrLadder([tlad.parse_rung(s) for s in specs],
                         keyframe_max=1, device="cpu")
    got = _drive(lad, frames)
    for i, (w, h) in enumerate(((128, 96), (64, 64))):
        stream = b"".join(f.bitstream for f in got[i])
        assert stream == b"".join(f.bitstream for f in want[i]), i
        assert _check_decodes(stream, got[i], 3)[0].y.shape == (h, w)


def _share_frames():
    rng = np.random.default_rng(3)
    big = rng.integers(0, 255, (96 + 32, 128 + 32)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3
    frames = []
    for i in range(8):
        y = np.clip(big[i:i + 96, 2 * i:2 * i + 128], 0, 255)
        frames.append((y.astype(np.uint8),
                       np.full((48, 64), 128, np.uint8),
                       np.full((48, 64), 128, np.uint8)))
    return frames


def test_ladder_share_equals_jax_and_decodes(monkeypatch):
    """tests/test_cutree_share.py's ladder: ABR rungs at 128x96 and
    64x48, the master's cuTree offsets shared with the slave."""
    frames = _share_frames()
    kw = dict(share_cutree=True, rc_lookahead=4, bframes=0,
              scenecut=False, keyframe_max=250)
    rungs = lambda m: [m.Rung(128, 96, rc_mode="abr", bitrate_kbps=800),
                       m.Rung(64, 48, rc_mode="abr", bitrate_kbps=300)]
    jl = jlad.AbrLadder(rungs(jlad), **kw)
    try:
        want = _drive(jl, frames)
    finally:
        tlad.close_shares(jl.encoders)      # the JAX ladder has no close
    log = _GetLog(monkeypatch)
    lad = tlad.AbrLadder(rungs(tlad), device="cpu", **kw)
    try:
        assert lad.encoders[1]._cutree is None       # no own lookahead
        assert lad.encoders[1].pps.cu_qp_delta_enabled
        got = _drive(lad, frames)
    finally:
        lad.close()
    for i in range(2):
        stream = b"".join(f.bitstream for f in got[i])
        assert stream == b"".join(f.bitstream for f in want[i]), i
        _check_decodes(stream, got[i], 8)
    # the slave coded every picture with the master's offsets
    assert log.got == [(d, True) for d in range(8)]


# -- the --abr-ladder app ------------------------------------------------

def _write_y4m(path, frames, bit_depth=8, csp="420"):
    h, w = frames[0][0].shape
    wr = Y4MWriter(str(path), VideoInfo(w, h, 25, 1, bit_depth=bit_depth,
                                        total_frames=len(frames), csp=csp))
    for f in frames:
        wr.write(*f)
    wr.close()


def _ring(tag):
    return f"x265tpu_test_{tag}_{os.getpid()}"


def _conf(tmp_path, name, lines):
    path = tmp_path / f"{name}.conf"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _rung_lines(tmp_path, name, ring, n, master="", slave="", extra="",
                slaves=1):
    """A 96x64 master under CRF 24 + AQ 2 writing the share and `slaves`
    64x48 slaves under CRF 26, 28, ... without AQ reading it."""
    src = tmp_path / "in.y4m"
    return [f"--input {src} -o {tmp_path}/{name}_0.hevc --crf 24 "
            f"--aq-mode 2 {master} --frames {n} --no-progress {extra} "
            f"cutree-share-write={ring}"] + [
        f"--input {src} -o {tmp_path}/{name}_{k}.hevc --input-res 64x48 "
        f"--crf {24 + 2 * k} --aq-mode 0 {slave} --frames {n} "
        f"--no-progress {extra} cutree-share-read={ring}"
        for k in range(1, slaves + 1)]


def _ladder_files(tmp_path, name, n=2):
    return [(tmp_path / f"{name}_{i}.hevc").read_bytes() for i in range(n)]


class _GetLog:
    """Records what the port's share readers hand each slave picture:
    `got` lists (display index, offsets received) per picture, in call
    order; `by_reader` the same per reader, in the readers' order."""

    def __init__(self, monkeypatch):
        self.got, self._by = [], {}
        get = CuTreeShareReader.get

        def logged(reader, disp, ncy, ncx):
            off = get(reader, disp, ncy, ncx)
            self.got.append((disp, off is not None))
            self._by.setdefault(id(reader), []).append(self.got[-1])
            return off
        monkeypatch.setattr(CuTreeShareReader, "get", logged)

    @property
    def by_reader(self):
        return list(self._by.values())


def test_abr_ladder_cli_files_equal_jax(tmp_path, monkeypatch):
    """Two slaves read one ring (fault 4, copied): the first slave's
    reader drains every record into its own table, so the second gets
    no offsets and codes its pictures without them."""
    n = 3
    _write_y4m(tmp_path / "in.y4m", moving_scene(96, 64, n))
    ring = _ring("cli")
    assert jcli.main(["--abr-ladder", _conf(tmp_path, "jax", _rung_lines(
        tmp_path, "jax", ring, n, master="--mcstf", slaves=2))]) == 0
    log = _GetLog(monkeypatch)
    assert tcli.main(["--abr-ladder", _conf(tmp_path, "port", _rung_lines(
        tmp_path, "port", ring, n, master="--mcstf", extra="--device cpu",
        slaves=2))]) == 0
    # the first slave took the master's offsets on every picture (the
    # clip is shorter than the lookahead: the master's flush publishes
    # first); the second took none
    assert log.by_reader == [[(d, True) for d in range(n)],
                             [(d, False) for d in range(n)]]
    for i, (a, b) in enumerate(zip(_ladder_files(tmp_path, "port", 3),
                                   _ladder_files(tmp_path, "jax", 3))):
        assert a == b, f"rung {i} differs"
        pics = Decoder().decode(a)
        assert len(pics) == n and all(p.md5 == p.sei_md5 for p in pics)
        assert pics[0].y.shape == ((64, 96), (48, 64), (48, 64))[i]


def test_mcstf_master_delays_the_share_as_in_the_reference(tmp_path,
                                                          monkeypatch):
    """Fault 3 (copied): MCSTF holds each master frame two source frames
    before its lookahead, so with rc_lookahead 4 the master publishes
    display j at source frame j + 6 while the slave asks for it at
    j + 4.  Over 10 frames the slave codes displays 0-5 without the
    master's offsets (the late records are never read) and 6-9, coded
    in the flush after the master's, with them."""
    n = 10
    _write_y4m(tmp_path / "in.y4m", moving_scene(96, 64, n))
    ring = _ring("f3")
    opts = "--rc-lookahead 4"
    assert jcli.main(["--abr-ladder", _conf(tmp_path, "jax", _rung_lines(
        tmp_path, "jax", ring, n, master=f"--mcstf {opts}",
        slave=opts))]) == 0
    log = _GetLog(monkeypatch)
    assert tcli.main(["--abr-ladder", _conf(tmp_path, "port", _rung_lines(
        tmp_path, "port", ring, n, master=f"--mcstf {opts}", slave=opts,
        extra="--device cpu"))]) == 0
    assert log.got == [(d, d >= 6) for d in range(n)]
    for i, (a, b) in enumerate(zip(_ladder_files(tmp_path, "port"),
                                   _ladder_files(tmp_path, "jax"))):
        assert a == b, f"rung {i} differs"
        pics = Decoder().decode(a)
        assert len(pics) == n and all(p.md5 == p.sei_md5 for p in pics)


def test_deep_rungs_are_scaled_at_their_depth(tmp_path):
    """Fault 1 (repaired): the reference's CLI scales a 10-bit source's
    rung at 8 bits, so every sample is clipped at 255; the port's rung
    is the JAX library ladder's, which scales at the rung's depth."""
    frames = [tuple((p.astype(np.uint16) << 2) + 1 for p in f)
              for f in moving_scene(96, 64, 2)]
    _write_y4m(tmp_path / "in.y4m", frames, bit_depth=10)
    line = (f"--input {tmp_path}/in.y4m -o {tmp_path}/{{}}.hevc "
            "--input-res 64x48 --no-info --no-progress")
    assert jcli.main(["--abr-ladder", _conf(tmp_path, "jax",
                                            [line.format("jax")])]) == 0
    assert tcli.main(["--abr-ladder", _conf(
        tmp_path, "port", [line.format("port") + " --device cpu"])]) == 0
    # the source's luma has a mean near 4 x 128; the reference's rung
    # was clipped at 255 before it was coded
    ref = Decoder().decode((tmp_path / "jax.hevc").read_bytes())
    assert all(p.md5 == p.sei_md5 and p.y.mean() < 260 for p in ref)
    lad = jlad.AbrLadder([jlad.Rung(64, 48)], internal_bit_depth=10,
                         info_sei=False)
    want = b"".join(f.bitstream for fr in _drive(lad, frames) for f in fr)
    port = (tmp_path / "port.hevc").read_bytes()
    assert port == want
    pics = Decoder().decode(port)
    assert all(p.md5 == p.sei_md5 and p.y.mean() > 400 for p in pics)


def test_scaled_rungs_outside_420_are_refused(tmp_path):
    """Fault 2 (refused): the reference scales a 4:2:2 source's chroma
    to 4:2:0 shapes for a scaled rung; its 4:2:2 stream decodes, but the
    rung's chroma holds the picture in its top half and edge copies of
    that half's last row below (coded within a few levels).  The port
    refuses the rung by name."""
    rng = np.random.default_rng(9)
    frames = []
    for y, _u, _v in moving_scene(96, 64, 2):
        ramp = np.linspace(40, 220, 64)[:, None] + rng.normal(0, 2,
                                                             (64, 48))
        c = np.clip(np.rint(ramp), 0, 255).astype(np.uint8)
        frames.append((y, c, c))
    _write_y4m(tmp_path / "in.y4m", frames, csp="422")
    line = (f"--input {tmp_path}/in.y4m -o {tmp_path}/{{}}.hevc "
            "--input-res 64x48 --no-progress")
    assert jcli.main(["--abr-ladder", _conf(tmp_path, "jax",
                                            [line.format("jax")])]) == 0
    pics = Decoder().decode((tmp_path / "jax.hevc").read_bytes())
    assert len(pics) == 2
    for p in pics:
        assert p.u.shape == (48, 32) and p.md5 == p.sei_md5
        # the source's ramp is squeezed into rows 0-23 and rows 24-47
        # are flat: far from the source's chroma at the rung's size
        u = p.u.astype(np.int32)
        right = tsc.scale_plane(frames[p.poc][1], 32, 48, 8, "cpu")
        assert np.ptp(u[24:]) <= 4 < 100 < np.ptp(u[:24])
        assert np.abs(u - right).mean() > 30
    with pytest.raises(NotImplementedError,
                       match="scaled --abr-ladder rung outside 4:2:0"):
        tcli.main(["--abr-ladder", _conf(
            tmp_path, "port", [line.format("port") + " --device cpu"])])


@pytest.mark.parametrize("second", ["--input other.y4m --device cpu",
                                    "--input {src} --device cuda"])
def test_abr_ladder_rejects_mixed_inputs_and_devices(tmp_path, second):
    src = tmp_path / "in.y4m"
    _write_y4m(src, moving_scene(96, 64, 1))
    cfg = _conf(tmp_path, "bad", [
        f"--input {src} -o {tmp_path}/a.hevc --device cpu",
        second.format(src=src) + f" -o {tmp_path}/b.hevc"])
    assert tcli.main(["--abr-ladder", cfg]) == 1
