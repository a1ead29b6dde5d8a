"""The port's mesh layer (parallel/mesh.py) and tile-row sharded P
analysis (parallel/tiles.py, _p_core's band form) against the JAX
reference's, on the reference calls of tests/test_tile_shard.py
(416x240, _clip, QP 30, rect, 8 shards; the encoder with
mesh_tile_rows=4, no B, no info SEI) so that the reference's compiled
programs are shared:

* analyse_p_frame_tiles equals the reference's output for output, at
  the default search (where both equal the whole-frame call) and at
  `--me star`'s r = 32 on a clip moving 36 rows a frame, where the
  tiled path decides otherwise than the whole-frame call;
* the tiled stream equals the JAX tiled stream byte for byte and
  decodes; at r = 32 the port's tiled stream decodes to its recon (its
  predictions are read from the whole-frame planes);
* sharded_encode_step on 4 shards equals the reference's modes, levels
  and totals.

Tolerance: exact (integers, bytes, pixels)."""
import numpy as np
import pytest
import torch

import jax
from x265_mod_by_patman_tpu.analysis.inter_mode import \
    analyse_p_frame as j_whole
from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.encoder.top import Encoder as JEncoder
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu.parallel import mesh as jmesh
from x265_mod_by_patman_tpu.parallel.tiles import \
    analyse_p_frame_tiles as j_tiles
from x265_mod_by_patman_tpu_torch.encoder.top import Encoder as TEncoder
from x265_mod_by_patman_tpu_torch.parallel import mesh as tmesh
from x265_mod_by_patman_tpu_torch.parallel.tiles import \
    analyse_p_frame_tiles as t_tiles
from tests.test_tile_shard import _clip
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

W, H = 416, 240


def _need_devices(n):
    if len(jax.devices("cpu")) < n:
        pytest.skip(f"the reference needs {n} virtual devices")


def _moving_rows(dy):
    """Two frames of tests/test_tile_shard.py's texture, the second moved
    dy rows down and 3 columns right."""
    rng = np.random.default_rng(9)
    big = rng.integers(0, 255, (H + 64, W + 64)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, (1, 1), (0, 1))) // 4
    u = np.full((H // 2, W // 2), 120, np.uint8)
    return [(np.clip(big[oy:oy + H, ox:ox + W], 0, 255).astype(np.uint8),
             u, u) for oy, ox in ((2, 0), (2 + dy, 3))]


def _padded(frames):
    enc = JEncoder(default_params(W, H, qp=30).validate())
    pad = lambda f: tuple(enc._pad(a, s) for a, s in zip(f, (0, 1, 1)))
    return pad(frames[0]), pad(frames[1]), enc.sps


def _assert_outputs_equal(got, ref):
    for i, (a, b) in enumerate(zip(got[:4] + got[5:], ref[:4] + ref[5:])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(i))
    for k in range(3):
        np.testing.assert_array_equal(got[4][k].numpy(),
                                      np.asarray(ref[4][k]), err_msg=str(k))


@pytest.mark.parametrize("case", ["hex16", "star32"])
def test_tiles_analysis_equals_reference(case):
    _need_devices(8)
    sr = 16 if case == "hex16" else 32
    f0, f1, sps = _padded(_clip(W, H, 2) if case == "hex16"
                          else _moving_rows(36))
    ref = j_tiles(*f1, [f0], sps, 30, n_devices=8, rect=True,
                  search_range=sr)
    got = t_tiles(*f1, [f0], sps, 30, n_devices=8, rect=True,
                  search_range=sr, device="cpu")
    _assert_outputs_equal(got, ref)
    if case == "star32":
        # premise: reads past the 32-pixel halo change the decisions
        whole = j_whole(*f1, [f0], sps, 30, rect=True, search_range=sr)
        assert not np.array_equal(np.asarray(whole[2]), np.asarray(ref[2]))


def _encode(cls, frames, tile_rows, *device, **kw):
    p = default_params(W, H, qp=32, keyframe_max=250, bframes=0,
                       rect=True, scenecut=False, weightp=False,
                       mesh_tile_rows=tile_rows, info_sei=False, **kw)
    enc = cls(p, *device)
    out = []
    for f in frames:
        out.extend(enc.encode_frame(*f))
    out.extend(enc.flush())
    return enc.headers() + b"".join(f.bitstream for f in out), out


def _decodes(stream, frames):
    pics = Decoder().decode(stream)
    assert len(pics) == len(frames)
    for f, pic in zip(frames, pics):
        assert np.array_equal(pic.y, f.recon[0])
        assert pic.md5 == f.md5 == pic.sei_md5


def test_tiled_stream_equals_reference_and_decodes():
    _need_devices(4)
    frames = _clip(W, H, 3)
    ref, _ = _encode(JEncoder, frames, 4)
    got, fr = _encode(TEncoder, frames, 4, "cpu")
    assert got == ref
    _decodes(got, fr)


def test_tiled_star_stream_decodes():
    """At r = 32 a band's own predictions can clamp at its slab; the
    port's encoder reads them from the whole-frame planes, so the
    stream decodes to the encoder's recon."""
    got, fr = _encode(TEncoder, _moving_rows(36), 4, "cpu",
                      search_method="star")
    assert [f.slice_type for f in fr] == ["I", "P"]
    _decodes(got, fr)


def test_sharded_encode_step_equals_reference():
    _need_devices(4)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (8, 48, 64)).astype(np.int32)
    frames = (frames + np.roll(frames, 1, 1)) // 2
    ref = jmesh.sharded_encode_step(jmesh.make_mesh(4, "gop"), 30)(
        jax.numpy.asarray(frames))
    step = tmesh.sharded_encode_step(tmesh.make_mesh(4, "gop", "cpu"), 30)
    got = step(torch.from_numpy(frames))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[3]) > 0


def test_make_mesh_is_a_record_of_logical_shards():
    m = tmesh.make_mesh(4, "rows", "cpu")
    assert (m.size, m.axis, m.device) == (4, "rows", torch.device("cpu"))
    with pytest.raises(ValueError):
        tmesh.make_mesh(0, "rows", "cpu")
    with pytest.raises(ValueError):
        tmesh.sharded_encode_step(m, 30)(torch.zeros((3, 16, 16)))
