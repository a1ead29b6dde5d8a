"""The PyTorch port's encoder end to end on the CPU: its streams must be
byte-identical to the JAX encoder's, and the in-repo decoder must decode
them to the port's recon with matching MD5 SEI.

Tolerance: exact (bytes and pixels)."""
import os

import numpy as np
import pytest

from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_e2e_inter import moving_scene
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

CASES = {
    "ippp": (dict(qp=30, keyframe_max=250, bframes=0), 4,
             ["I", "P", "P", "P"]),
    "intra": (dict(qp=30, keyframe_max=1), 2, ["I", "I"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_stream_equals_jax_and_decodes(case):
    w, h = 96, 64
    kw, n, types = CASES[case]
    frames = moving_scene(w, h, n)
    s_jax, e_jax = jtop.encode_sequence(default_params(w, h, **kw), frames)
    s_pt, e_pt = ttop.encode_sequence(default_params(w, h, **kw), frames,
                                      "cpu")
    assert [f.slice_type for f in e_pt] == types
    for i, (a, b) in enumerate(zip(e_pt, e_jax)):
        assert a.bitstream == b.bitstream, f"frame {i} bytes differ"
    assert s_pt == s_jax
    pics = Decoder().decode(s_pt)
    assert len(pics) == n
    for i, (f, pic) in enumerate(zip(e_pt, pics)):
        ry, ru, rv = f.recon
        assert np.array_equal(pic.y, ry), f"luma mismatch frame {i}"
        assert np.array_equal(pic.u, ru), f"cb mismatch frame {i}"
        assert np.array_equal(pic.v, rv), f"cr mismatch frame {i}"
        assert pic.md5 == f.md5 == pic.sei_md5


@pytest.mark.parametrize("kw,name", [
    (dict(bframes=0, internal_csp=0), "4:0:0"),
    (dict(bframes=0, rc_mode="crf", frame_parallel_window=2),
     "--frame-threads"),
    (dict(bframes=0, mesh_tile_rows=2), "mesh_tile_rows"),
    (dict(bframes=0, internal_csp=3, scaling_list="default"),
     "--scaling-list in 4:4:4"),
])
def test_unported_options_raise(kw, name):
    """The port refuses what the reference fails on (4:0:0, lists in
    4:4:4).  --frame-threads under CRF and mesh_tile_rows are ported:
    those cases encode three frames and decode (their streams are held
    to the reference in tests/test_torch_frame_parallel.py and
    tests/test_torch_tiles.py)."""
    p = default_params(96, 64, **kw)
    if name not in ("--frame-threads", "mesh_tile_rows"):
        with pytest.raises(NotImplementedError, match=name):
            ttop.Encoder(p, "cpu")
        return
    stream, frames = ttop.encode_sequence(p, moving_scene(96, 64, 3), "cpu")
    pics = Decoder().decode(stream)
    assert len(pics) == 3
    for f, pic in zip(frames, pics):
        assert np.array_equal(pic.y, f.recon[0])
        assert pic.md5 == f.md5 == pic.sei_md5


@pytest.mark.parametrize("option", ["mcstf", "cutree_share_write",
                                    "cutree_share_read"])
def test_mcstf_and_the_cutree_share_are_accepted(option):
    """--mcstf and both sides of the cuTree share are ported (their
    streams are held to the reference in tests/test_torch_mcstf.py and
    tests/test_torch_ladder.py): the encoder opens with them and wires
    them as the reference does."""
    from x265_mod_by_patman_tpu_torch.analysis.cutree_share import \
        CuTreeShareWriter
    ring = f"x265tpu_test_accept_{os.getpid()}"
    writer = CuTreeShareWriter(ring, 1, 2) \
        if option == "cutree_share_read" else None
    value = True if option == "mcstf" else ring
    enc = ttop.Encoder(default_params(96, 64, rc_mode="crf",
                                      **{option: value}), "cpu")
    try:
        assert not ttop._unsupported(enc.p)
        if option == "mcstf":
            assert enc.p.mcstf and not enc._mc_buf
        elif option == "cutree_share_write":
            assert enc._cutree is not None and enc._ctshare_w is not None
        else:
            assert enc._cutree is None and enc._ctshare_r is not None
            assert enc.pps.cu_qp_delta_enabled and enc.rc.cu_tree
    finally:
        if enc._ctshare_r is not None:
            enc._ctshare_r.close()
        for w in (enc._ctshare_w, writer):
            if w is not None:
                w.close()


@pytest.mark.parametrize("csp", [2, 3])
def test_chroma_formats_are_accepted(csp):
    """4:2:2 and 4:4:4 are ported (their streams are held to the
    reference in tests/test_torch_chroma422.py and _chroma444.py), with
    the reference's own restrictions on their tools."""
    enc = ttop.Encoder(default_params(96, 64, internal_csp=csp, rect=True,
                                      amp=True), "cpu")
    assert enc.sps.chroma_format_idc == csp
    assert (enc.cshift, enc.is422) == ((1, True) if csp == 2 else (0, False))
    assert not (enc.p.rect or enc.p.amp or enc.p.var_cu_tree)
    assert "4:" not in ", ".join(ttop._unsupported(enc.p))


@pytest.mark.parametrize("kw", [
    dict(bframes=0, rect=True), dict(bframes=0, hme=True),
    dict(bframes=0, rdoq_level=2, sign_hide=True),
    dict(bframes=4, weightb=True), dict(bframes=0, rect=True, amp=True),
    dict(bframes=0, search_method="sea"),
])
def test_slow_preset_options_are_accepted(kw):
    """--rect, --hme, sign hiding under RDOQ, --weightb, --amp and --me
    sea are ported (their streams are held to the reference in
    tests/test_torch_slow.py, test_torch_amp.py, test_torch_presets.py and
    test_torch_weightb_sea.py)."""
    enc = ttop.Encoder(default_params(96, 64, **kw), "cpu")
    assert all(getattr(enc.p, k) == v for k, v in kw.items())
