"""The port's batched all-intra path on the CPU against the JAX package:
encode_batch, encode_intra_pipelined and encode_intra_batched give the
reference's bytes, and their streams decode in the port's decoder to the
port's recon with the MD5 SEI matching; the batched mode decision, the
multi-frame wavefront and the multi-frame deblock equal the reference's.

Tolerance: exact (bytes, modes, samples)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_mod_by_patman_tpu.analysis import intra_mode as jim
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.ops import deblock as jdb
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.analysis import intra_mode as tim
from x265_mod_by_patman_tpu_torch.bitstream.headers import build_sps_info
from x265_mod_by_patman_tpu_torch.decoder.decoder import Decoder
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from x265_mod_by_patman_tpu_torch.ops import deblock as tdb
from tests.test_e2e_intra import synth_frame
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

W, H = 96, 64
KW = dict(qp=32, keyframe_max=1, rc_mode="cqp", rd_level=2)


def _frames(n):
    return [synth_frame(W, H, seed=i, motion=i) for i in range(n)]


def _decodes(out):
    pics = Decoder().decode(b"".join(f.bitstream for f in out))
    assert len(pics) == len(out)
    for f, pic in zip(out, pics):
        assert pic.md5 == f.md5 == pic.sei_md5
        assert np.array_equal(pic.y, f.recon[0])
        assert np.array_equal(pic.u, f.recon[1])
        assert np.array_equal(pic.v, f.recon[2])


def _same(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.bitstream == y.bitstream, f"frame {i} bytes differ"
        assert x.md5 == y.md5


def test_encode_batch_equals_reference():
    frames = _frames(3)
    ref = jtop.Encoder(default_params(W, H, **KW)).encode_batch(frames)
    got = ttop.Encoder(default_params(W, H, **KW), "cpu").encode_batch(frames)
    _same(got, ref)
    _decodes(got)


def test_encode_intra_pipelined_equals_reference():
    frames = _frames(3)
    kw = dict(KW, sao=False)
    ref = jtop.Encoder(default_params(W, H, **kw)) \
        .encode_intra_pipelined(frames)
    got = ttop.Encoder(default_params(W, H, **kw), "cpu") \
        .encode_intra_pipelined(frames)
    _same(got, ref)
    _decodes(got)


def test_encode_intra_batched_equals_reference_and_pipelined():
    """Five frames in batches of two: the last batch is partial."""
    frames = _frames(5)
    kw = dict(KW, sao=False)
    ref = jtop.Encoder(default_params(W, H, **kw)).encode_intra_batched(
        frames, batch=2)
    got = ttop.Encoder(default_params(W, H, **kw), "cpu") \
        .encode_intra_batched(frames, batch=2)
    _same(got, ref)
    _decodes(got)
    piped = ttop.Encoder(default_params(W, H, **kw), "cpu") \
        .encode_intra_pipelined(frames)
    _same(got, piped)


def test_encode_intra_batched_threads_and_sao():
    """Entropy on two threads and SAO on: the bytes of one thread."""
    frames = _frames(3)
    one = ttop.Encoder(default_params(W, H, **KW), "cpu") \
        .encode_intra_batched(frames, batch=2)
    two = ttop.Encoder(default_params(W, H, **KW), "cpu") \
        .encode_intra_batched(frames, batch=2, entropy_workers=2)
    _same(two, one)
    _decodes(two)


def _sps(**kw):
    return build_sps_info(default_params(W, H, **dict(KW, ctu_size=32,
                                                      **kw)))


def _stack(seed, f=3, levels=None, bd=8):
    """F random frames; with `levels`, a few flat values plus noise of
    +-1, which makes many of the 35 modes tie or nearly tie."""
    rng = np.random.default_rng(seed)
    top = (1 << bd) - 1
    if levels is None:
        ys = rng.integers(0, top + 1, (f, H, W))
    else:
        ys = rng.integers(0, levels, (f, H, W)) * top // (levels - 1)
        ys = np.clip(ys + rng.integers(-1, 2, ys.shape), 0, top)
    return ys.astype(np.uint8 if bd == 8 else np.uint16)


@pytest.mark.parametrize("seed,qp,levels,bd", [
    (0, 22, None, 8), (1, 37, 3, 8), (2, 51, 2, 8), (3, 45, 4, 10)])
def test_decide_modes_rd_multi_equals_reference(seed, qp, levels, bd):
    """The reference's float32 device program, near-ties included (flat
    blocks tie across modes; the MPM bits and the CTU homogenisation
    decide them)."""
    sps = _sps(internal_bit_depth=bd)
    ys = _stack(seed, levels=levels, bd=bd)
    ref = np.asarray(jim.decide_modes_rd_multi(ys, sps, qp))
    got = tim.decide_modes_rd_multi(ys, sps, qp, "cpu")
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("qp", [None, 30])
def test_decide_modes_batch_equals_reference(qp):
    sps = _sps()
    ys = _stack(7, levels=3)
    ref = jim.decide_modes_batch(ys, sps, 16, qp)
    got = tim.decide_modes_batch(ys, sps, "cpu", 16, qp)
    np.testing.assert_array_equal(got, ref)


def test_decide_modes_equals_reference():
    sps = _sps()
    y = _stack(8, f=1)[0]
    np.testing.assert_array_equal(tim.decide_modes(y, sps, "cpu", 16),
                                  jim.decide_modes(y, sps, 16))


def test_mpm_grid_on_device_equals_host():
    rng = np.random.default_rng(9)
    m = rng.integers(0, 35, (2, 6, 8)).astype(np.int32)
    m[:, 2:4, 2:5] = 1                  # equal neighbours below 2
    m[:, 4:, :3] = 26
    got = tim._mpm_grid_t(torch.from_numpy(m), 5, 16).numpy()
    for f in range(2):
        np.testing.assert_array_equal(got[f], tim._mpm_grid(m[f], 5, 16))


def test_run_batch_equals_reference_and_per_frame():
    """The lockstep wavefront of three frames: the reference's
    run_batch, and the port's own per-frame run."""
    p = default_params(W, H, **KW)
    je, te = jtop.Encoder(p), ttop.Encoder(p, "cpu")
    frames = _frames(3)
    ys, us, vs = (np.stack([f[c] for f in frames]) for c in range(3))
    modes = jim.decide_modes_batch(ys, je.sps, 16, 32)
    ref = je.recon.run_batch(ys, us, vs, modes, qp=32)
    got = te.recon.run_batch(ys, us, vs, modes, qp=32)
    for i in range(3):
        one = te.recon.run(ys[i], us[i], vs[i], modes[i], qp=32)
        for k in ("recon_y", "recon_u", "recon_v", "lev_y", "lev_u",
                  "lev_v"):
            np.testing.assert_array_equal(got[i][k], ref[i][k])
            np.testing.assert_array_equal(got[i][k], one[k])


@pytest.mark.parametrize("qp_map", [False, True])
def test_deblock_frame_multi_equals_reference(qp_map):
    rng = np.random.default_rng(11)
    f = 3
    ys = rng.integers(0, 256, (f, H, W)).astype(np.int32)
    us = rng.integers(0, 256, (f, H // 2, W // 2)).astype(np.int32)
    vs = rng.integers(0, 256, (f, H // 2, W // 2)).astype(np.int32)
    bs_v, bs_h = tdb.intra_bs_maps(W, H, 16)
    on_v, on_h = tdb.chroma_on_maps(bs_v, bs_h, H // 2, W // 2)
    if qp_map:
        qp = rng.integers(26, 40, (H // 32, W // 32)).astype(np.int32)
        qcb, qcr = 1, -2              # chroma QP offsets with a map
    else:
        qp, qcb, qcr = 37, 34, 35
    ref = jdb.deblock_frame_multi(
        jnp.asarray(ys), jnp.asarray(us), jnp.asarray(vs),
        jnp.asarray(bs_v), jnp.asarray(bs_h), jnp.asarray(on_v),
        jnp.asarray(on_h), jnp.asarray(qp), qcb, qcr, 1, -1, 8)
    got = tdb.deblock_frame_multi(
        torch.from_numpy(ys), torch.from_numpy(us), torch.from_numpy(vs),
        bs_v, bs_h, on_v, on_h, qp, qcb, qcr, 1, -1, 8)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kw,name", [
    (dict(internal_csp=2), "4:2:2"),
    (dict(nxn_intra=True), "--nxn-intra"),
    (dict(nr_intra=200), "--nr-intra"),
    (dict(scaling_list="default"), "--scaling-list"),
    (dict(lossless=True), "--lossless"),
])
def test_batched_path_refuses_what_the_reference_does_not_take(kw, name):
    enc = ttop.Encoder(default_params(W, H, **dict(KW, **kw)), "cpu")
    with pytest.raises(NotImplementedError, match=name):
        enc.encode_intra_batched(_frames(1), batch=1)
