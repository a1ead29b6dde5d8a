"""The port's MCSTF pre-filter (analysis/mcstf.py and the encoder's
MCSTF window) against the JAX reference on the CPU:

* the block alignment `_align_and_error` (K1's full search at lambda 0,
  K2's clamped 16x16 gathers, the per-block squared error) on flat
  planes (every offset ties), textured motion and motion that leaves
  the plane, at 8 and 10 bits;
* the filtered planes of `mcstf_filter` at 8 and 10 bits;
* a 96x64 stream with --mcstf and 2 B-frames over 10 frames (MCSTF at
  strength 1.5 on display 0 and 0.95 on display 8), byte-identical to
  the JAX encoder's and decoded with matching MD5 SEIs;
* the host code (strength schedule, chroma MC, the encoder's MCSTF
  window) copied from the reference.

Tolerance: exact (planes, MVs, float32 errors, bytes, source text)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x265_mod_by_patman_tpu.analysis import mcstf as jm
from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.analysis import mcstf as tm
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_e2e_inter import moving_scene
from tests.test_torch_bframes import _defs
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

H, W = 64, 96


def test_host_code_is_verbatim():
    ref = _defs("x265_mod_by_patman_tpu/analysis/mcstf.py")
    port = _defs("x265_mod_by_patman_tpu_torch/analysis/mcstf.py")
    for name in ("filter_strength", "_mc_chroma"):
        assert port[name] == ref[name], name


def test_mcstf_pop_is_verbatim_but_for_the_device():
    """The encoder's MCSTF window step is the reference's; its one
    change hands the encoder's device to mcstf_filter."""
    ref = _defs("x265_mod_by_patman_tpu/encoder/top.py")["_mcstf_pop"]
    port = _defs("x265_mod_by_patman_tpu_torch/encoder/top.py")["_mcstf_pop"]
    assert port == ref.replace("self.p.internal_bit_depth)",
                               "self.p.internal_bit_depth, self.device)")


def _deep(a, bd, rng):
    """An 8-bit plane at bit depth bd: times 2^(bd-8) plus a seeded
    dither, clipped."""
    if bd == 8:
        return a.astype(np.int32)
    d = 1 << (bd - 9)
    v = a.astype(np.int32) * (1 << (bd - 8)) + rng.integers(-d, d + 1,
                                                            a.shape)
    return np.clip(v, 0, (1 << bd) - 1).astype(np.int32)


def _align_case(case, bd):
    rng = np.random.default_rng(17 + bd)
    if case == "flat":
        # constant planes with one flat-valued square: every offset of
        # a flat block ties at SAD 0 (the first minimum must win)
        cur = np.full((H, W), 90, np.uint8)
        cur[16:48, 32:64] = 180
        ref = cur.copy()
        ref[16:48, 30:62] = 180
        # no dither: the planes stay flat at 10 bits
        return (cur.astype(np.int32) << (bd - 8),
                ref.astype(np.int32) << (bd - 8))
    if case == "textured":
        f = moving_scene(W, H, 3, seed=4)
        cur, ref = f[2][0], f[0][0]
    else:
        # "border": the content moves 9 px right and 7 px down, so the
        # blocks on the top and left edges match only through the
        # clamped edge extension of the reference
        big = moving_scene(W + 32, H + 32, 1, seed=6)[0][0]
        cur = big[16:16 + H, 16:16 + W]
        ref = big[16 + 7:16 + 7 + H, 16 + 9:16 + 9 + W]
        ref = np.pad(ref, ((7, 0), (9, 0)), mode="edge")[:H, :W]
    return _deep(cur, bd, rng), _deep(ref, bd, rng)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("case", ["flat", "textured", "border"])
def test_align_and_error_matches_reference(case, bd):
    cur, ref = _align_case(case, bd)
    want = jm._align_and_error(jnp.asarray(cur), jnp.asarray(ref), H // 16,
                               W // 16)
    got = tm._align_and_error(torch.from_numpy(cur), torch.from_numpy(ref),
                              H // 16, W // 16)
    for name, a, b in zip(("aligned", "err", "fx", "fy"), want, got):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    if case == "flat":
        # the flat blocks tie everywhere: the first offset (-12, -12)
        assert got[2][0, 0] == got[3][0, 0] == -tm.SEARCH


def test_block_errors_above_2_24_follow_the_reference_order():
    """At 10 bits a misaligned block's squared error passes 2^24; the
    reference's float32 mean then rounds in its row-major order."""
    rng = np.random.default_rng(8)
    cur = rng.integers(0, 1024, (H, W)).astype(np.int32)
    ref = rng.integers(0, 1024, (H, W)).astype(np.int32)
    want = np.asarray(jm._align_and_error(jnp.asarray(cur),
                                          jnp.asarray(ref), 4, 6)[1])
    got = tm._align_and_error(torch.from_numpy(cur), torch.from_numpy(ref),
                              4, 6)[1].numpy()
    assert (want * 256 >= 2 ** 24).any()
    np.testing.assert_array_equal(got, want)


def _noisy_frames(n, bd, seed):
    """moving_scene plus seeded sigma-5 noise in luma and chroma (the
    filter has noise to remove), at bit depth bd."""
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bd == 8 else np.uint16
    out = []
    for f in moving_scene(W, H, n, seed=seed):
        planes = []
        for p in f:
            q = p.astype(np.float64) * (1 << (bd - 8)) + rng.normal(
                0, 5 * (1 << (bd - 8)), p.shape)
            planes.append(np.clip(np.rint(q), 0, (1 << bd) - 1).astype(dt))
        out.append(tuple(planes))
    return out


@pytest.mark.parametrize("bd", [8, 10])
def test_mcstf_filter_matches_reference(bd):
    frames = _noisy_frames(5, bd, 3)
    want = jm.mcstf_filter(frames, 2, 1.5, qp=32, bit_depth=bd)
    got = tm.mcstf_filter(frames, 2, 1.5, qp=32, bit_depth=bd,
                          device="cpu")
    for a, b in zip(want, got):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
    # the filter did something: the centre's luma changed
    assert not np.array_equal(got[0], frames[2][0])


def test_mcstf_stream_equals_jax_and_decodes():
    frames = _noisy_frames(10, 8, 5)
    kw = dict(qp=30, keyframe_max=250, bframes=2, mcstf=True)
    s_jax, e_jax = jtop.encode_sequence(default_params(W, H, **kw), frames)
    s_pt, e_pt = ttop.encode_sequence(default_params(W, H, **kw), frames,
                                      "cpu")
    assert "B" in [f.slice_type for f in e_pt]
    for i, (a, b) in enumerate(zip(e_pt, e_jax)):
        assert a.bitstream == b.bitstream, f"frame {i} bytes differ"
    assert s_pt == s_jax
    pics = Decoder().decode(s_pt)
    assert len(pics) == 10
    by_poc = {f.poc: f for f in e_pt}
    for pic in pics:
        f = by_poc[pic.poc]
        assert np.array_equal(pic.y, f.recon[0])
        assert pic.md5 == f.md5 == pic.sei_md5
