"""VBV with the row-level re-encode, and the HRD timing SEIs, in the
PyTorch port against the JAX reference on the CPU, on the cases of
tests/test_hrd.py (ABR 200 kb/s under a 100 kbit / 200 kb/s VBV, 128x96,
10 frames, an easy clip that turns to noise at frame 5) and
tests/test_vbv_2pass.py:

* VBV alone, in which pictures re-encode (more than one run of the
  picture pipeline), with its fullness in the frame stats;
* the same with --hrd: buffering-period and picture-timing SEIs parsed
  back, and every access unit held to the CPB arrival/removal model of
  tests/test_hrd.py;
* an HRD stream with B pictures (decode order differs from display
  order, so the pic-timing DPB delay uses num_reorder_pics);
* VBV under two-pass ABR, the pass-2 run driven by the JAX pass 1's
  stats file.

Every stream is byte-identical to the JAX encoder's and decodes in the
in-repo decoder with matching MD5 SEI.

Tolerance: exact (bytes, QPs, pixels, fullness percentages)."""
import numpy as np
import pytest

from x265_mod_by_patman_tpu.bitstream.bitreader import BitReader
from x265_mod_by_patman_tpu.bitstream.headers import (
    HRD_AU_LEN, HRD_DPB_LEN, HRD_INIT_LEN)
from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_e2e_inter import moving_scene
from tests.test_hrd import _clip
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

W, H, FPS = 128, 96, 25.0
VBV = dict(rc_mode="abr", bitrate_kbps=200, fps_num=25, fps_denom=1,
           keyframe_max=250, bframes=0, vbv_bufsize=100, vbv_maxrate=200,
           scenecut=False)
CASES = {"vbv": {}, "vbv_hrd": dict(hrd=True),
         "vbv_hrd_bframes": dict(hrd=True, bframes=3)}


def _encode(mod, kw, frames, *device):
    enc = mod.Encoder(default_params(W, H, **kw), *device)
    out = []
    for f in frames:
        out.extend(enc.encode_frame(*f))
    out.extend(enc.flush())
    return enc, out


def timing_seis(dec):
    """(initial_cpb_removal_delay, offset) of each buffering-period SEI
    and (au_cpb_removal_delay_minus1, pic_dpb_output_delay) of each
    picture-timing SEI, in decode order (tests/test_hrd.py's parse)."""
    bps, pts = [], []
    for ptype, payload in dec.prefix_seis:
        br = BitReader(payload)
        if ptype == 0:
            br.ue()                        # sps id
            br.flag()                      # irap_cpb_params
            br.flag()                      # concatenation
            br.u(HRD_AU_LEN)               # delay delta
            bps.append((br.u(HRD_INIT_LEN), br.u(HRD_INIT_LEN)))
        elif ptype == 1:
            pts.append((br.u(HRD_AU_LEN), br.u(HRD_DPB_LEN)))
    return bps, pts


def assert_cpb_holds(bits, bps, pts, bitrate, fps):
    """Every AU's last bit arrives (at the signalled rate) before its
    removal time (removal of the buffering period's AU plus
    (au_cpb_removal_delay_minus1 + 1) frame periods)."""
    t_arrival = 0.0
    removal_bp = bps[0][0] / 90000.0
    for i, b in enumerate(bits):
        t_arrival += b / bitrate
        removal = removal_bp if i == 0 else \
            removal_bp + (pts[i][0] + 1) / fps
        assert t_arrival <= removal + 1e-9, \
            f"CPB underflow at AU {i}: arrive {t_arrival} > {removal}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_vbv_hrd_stream_equals_jax_and_decodes(case):
    kw = dict(VBV, **CASES[case])
    frames = _clip(W, H, 10)
    je, e_jax = _encode(jtop, kw, frames)
    te, e_pt = _encode(ttop, kw, frames, "cpu")
    assert [f.qp for f in e_pt] == [f.qp for f in e_jax]
    for i, (a, b) in enumerate(zip(e_pt, e_jax)):
        assert a.bitstream == b.bitstream, f"frame {i} bytes differ"
        assert a.stats["vbv_fill_pct"] == b.stats["vbv_fill_pct"], i
    assert te.rc.vbv_underflows == je.rc.vbv_underflows == 0
    runs = [f.pipeline_runs for f in e_pt]
    assert max(runs) > 1, runs              # the row re-encode ran
    assert all(1 <= r <= 4 for r in runs), runs
    assert te._last_row_bits is not None        # WPP substream sizes
    assert len(te._last_row_bits) == te.sps.pic_height_in_ctus
    stream = b"".join(f.bitstream for f in e_pt)
    dec = Decoder()
    pics = dec.decode(stream)
    assert len(pics) == len(e_pt)
    for f, pc in zip(e_pt, pics):
        assert pc.poc == f.poc
        assert np.array_equal(pc.y, f.recon[0])
        assert pc.md5 == f.md5 == pc.sei_md5
    bps, pts = timing_seis(dec)
    if not kw.get("hrd"):
        assert not bps and not pts
        return
    assert dec.sps.hrd and dec.sps.hrd_bitrate >= 200e3
    assert len(bps) == 1 and len(pts) == len(e_pt)
    assert_cpb_holds([f.bits for f in e_pt], bps, pts,
                     dec.sps.hrd_bitrate, FPS)
    if kw["bframes"]:
        types = [f.slice_type for f in e_pt]
        assert "B" in types
        # decode order is not display order: the DPB output delay
        # carries the reorder depth
        assert [f.disp for f in e_pt] != sorted(f.disp for f in e_pt)
        assert any(d > 0 for _au, d in pts)


def _two_pass(mod, pass_num, stats, frames, *device):
    """tests/test_vbv_2pass.py's two-pass ABR, under a VBV."""
    p = default_params(96, 64, rc_mode="abr", bitrate_kbps=400,
                       keyframe_max=250, bframes=2, b_adapt=0,
                       scenecut=False, stats_file=stats, pass_num=pass_num,
                       rc_lookahead=6, vbv_bufsize=200, vbv_maxrate=400)
    enc = mod.Encoder(p, *device)
    out = []
    for f in frames:
        out.extend(enc.encode_frame(*f))
    out.extend(enc.flush())
    enc.write_stats()
    return enc, out


def test_vbv_two_pass_equals_jax_and_decodes(tmp_path):
    """Pass 2 of the port, driven by the JAX pass 1's stats file and
    .cutree offsets, gives the JAX pass 2's bytes under a VBV.  One stats
    path serves every run: the info SEI names it."""
    frames = moving_scene(96, 64, 10, seed=2)
    stats = str(tmp_path / "st.log")
    _two_pass(jtop, 1, stats, frames)
    je, e_jax = _two_pass(jtop, 2, stats, frames)
    te, e_pt = _two_pass(ttop, 2, stats, frames, "cpu")
    assert te._ct2pass is not None and te.rc.vbv_buffer > 0
    assert [f.qp for f in e_pt] == [f.qp for f in e_jax]
    for i, (a, b) in enumerate(zip(e_pt, e_jax)):
        assert a.bitstream == b.bitstream, f"frame {i} bytes differ"
        assert a.stats["vbv_fill_pct"] == b.stats["vbv_fill_pct"], i
    assert te.rc.vbv_underflows == je.rc.vbv_underflows
    pics = Decoder().decode(b"".join(f.bitstream for f in e_pt))
    for f, pc in zip(e_pt, pics):
        assert pc.md5 == f.md5 == pc.sei_md5
