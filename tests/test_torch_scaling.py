"""Scaling lists (--scaling-list default | <file>) in the PyTorch port
against the JAX reference:

* quant_dyn / dequant_dyn with the lists' tables, default and custom,
  for TBs of 4 to 32, intra and inter lanes and per-lane QPs;
* RDOQ levels with the per-coefficient forward scale (qmats) and
  distortion weight (rawmats), with the static and the EstBits models;
* streams: the default lists with B pictures and WPP (the reference's
  own e2e case) and a custom list file under --rdoq-level 2 (the
  reference's file, where luma and chroma share each matrix and the 4x4
  lists are flat), byte-identical to the JAX encoder's and decoded to
  the port's recon with matching MD5 SEI;
* the port's repair of the NxN sub-TUs' lists: under a custom file
  whose luma and chroma 8x8 lists differ and whose 4x4 lists are not
  flat, the reference quantizes a luma 8x8 sub-TU with the chroma list
  and the 4x4 TBs as flat, so its stream does not decode to its recon;
  the port's streams (fixed grid with TU4, and the CU tree) decode, and
  the test holds the reference's stream on the same file and clip to
  failing, so the departure rests on a witness.

Tolerance: exact (integer levels, bytes, pixels)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_mod_by_patman_tpu.constants.scaling import (
    default_matrix, list_matrix, parse_scaling_list_file, quant_mats_custom)
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.ops import rdoq as jr
from x265_mod_by_patman_tpu.ops import transform as jt
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from x265_mod_by_patman_tpu_torch.ops import rdoq as tr
from x265_mod_by_patman_tpu_torch.ops import transform as tt
from tests.test_e2e_inter import moving_scene
from tests.test_nxn_intra import micro_pattern
from tests.test_scaling_list import _write_custom_file
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401
from tests.test_torch_nxn import check_decodes, encode_both
from tests.test_tu4_dst import detail_frame

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def write_distinct_lists(path):
    """A custom list file whose luma and chroma lists differ at every
    size and whose 4x4 lists are not flat: ramps 16 + k * (x + y) in
    raster order, k larger for chroma (Cb = Cr) and for inter."""
    names = ("INTRA{}_LUMA", "INTRA{}_CHROMAU", "INTRA{}_CHROMAV",
             "INTER{}_LUMA", "INTER{}_CHROMAU", "INTER{}_CHROMAV")
    with open(path, "w") as f:
        for sid, size in enumerate(("4X4", "8X8", "16X16", "32X32")):
            n = 4 if sid == 0 else 8
            yy, xx = np.mgrid[0:n, 0:n]
            for lid in range(0, 6, 3 if sid == 3 else 1):
                k = 2 + (lid % 3 > 0) + (lid >= 3)
                name = names[lid].format(size)
                f.write(f"{name} =\n" + ",".join(
                    str(int(v)) for v in (16 + k * (xx + yy)).ravel())
                    + "\n")
                if sid >= 2:
                    f.write(f"{name}_DC =\n16\n")
    return path


def _tables(kind, log2n, comp, tmp_path):
    """(qmats (2, 6, n, n), rawmats (2, n, n)) int32 of the default lists
    or of a custom file."""
    if kind == "default":
        raw = np.stack([default_matrix(log2n, True),
                        default_matrix(log2n, False)])
        return jt.quant_mats(log2n), raw.astype(np.int32)
    lists, dc = parse_scaling_list_file(
        write_distinct_lists(str(tmp_path / "lists.txt")))
    raw = np.stack([list_matrix(lists, dc, log2n, True, comp),
                    list_matrix(lists, dc, log2n, False, comp)])
    return (quant_mats_custom(log2n, lists, dc, comp).astype(np.int32),
            raw.astype(np.int32))


def _case(log2n, seed=0, b=24):
    rng = np.random.default_rng(seed + 10 * log2n)
    n = 1 << log2n
    resi = rng.integers(-60, 61, (b, n, n)).astype(np.int32)
    resi[: b // 3] //= 8
    coef = np.asarray(jt.dct_batch(jnp.asarray(resi), log2n, 8))
    intra = rng.random(b) < 0.5
    qp = rng.integers(12, 46, b).astype(np.int32)
    return coef, intra, qp


@pytest.mark.parametrize("kind", ["default", "custom"])
@pytest.mark.parametrize("log2n,comp", [(2, 0), (2, 1), (3, 0), (3, 1),
                                        (4, 0), (5, 0)])
def test_quant_dequant_with_lists_match_reference(kind, log2n, comp,
                                                  tmp_path):
    qm, dm = _tables(kind, log2n, comp, tmp_path)
    coef, intra, qp = _case(log2n)
    exp = np.asarray(jt.quant_dyn(jnp.asarray(coef), jnp.asarray(intra),
                                  jnp.asarray(qp), log2n, 8,
                                  jnp.asarray(qm)))
    got = tt.quant_dyn(_t(coef), _t(intra), _t(qp), log2n, 8,
                       _t(qm)).numpy()
    np.testing.assert_array_equal(got, exp)
    assert np.any(exp != np.asarray(jt.quant_dyn(
        jnp.asarray(coef), jnp.asarray(intra), jnp.asarray(qp), log2n,
        8))) or (kind == "default" and log2n == 2)
    exp_d = np.asarray(jt.dequant_dyn(jnp.asarray(exp), jnp.asarray(qp),
                                      log2n, 8, jnp.asarray(dm),
                                      jnp.asarray(intra)))
    got_d = tt.dequant_dyn(_t(exp), _t(qp), log2n, 8, _t(dm),
                           _t(intra)).numpy()
    np.testing.assert_array_equal(got_d, exp_d)


@pytest.mark.parametrize("kind", ["default", "custom"])
@pytest.mark.parametrize("log2n,c_idx", [(2, 0), (3, 1), (4, 0), (5, 0)])
@pytest.mark.parametrize("init_type", [None, 1])
def test_rdoq_with_lists_matches_reference(kind, log2n, c_idx, init_type,
                                           tmp_path):
    qm, dm = _tables(kind, log2n, 1 if c_idx else 0, tmp_path)
    coef, intra, qp = _case(log2n, seed=5)
    it_j = None if init_type is None else jnp.int32(init_type)
    exp = np.asarray(jr.rdoq_levels(
        jnp.asarray(coef), jnp.asarray(intra), jnp.asarray(qp), log2n, 8,
        c_idx, it_j, qmats=jnp.asarray(qm), rawmats=jnp.asarray(dm)))
    got = tr.rdoq_levels(_t(coef), _t(intra), _t(qp), log2n, 8, c_idx,
                         init_type, qmats=_t(qm), rawmats=_t(dm)).numpy()
    np.testing.assert_array_equal(got, exp)


def test_default_lists_with_b_and_wpp_stream_matches_reference():
    frames = moving_scene(96, 64, 5, seed=4)
    _s, e = encode_both(lambda: default_params(
        96, 64, qp=30, keyframe_max=250, bframes=2,
        scaling_list="default", wpp=True), frames)
    assert "B" in [f.slice_type for f in e]


def test_custom_list_rdoq_stream_matches_reference(tmp_path):
    path = _write_custom_file(str(tmp_path / "lists.txt"))

    def p_fn():
        p = default_params(96, 64, qp=28, keyframe_max=250, bframes=0)
        p.scaling_list = path
        p.rdoq_level = 2
        return p
    encode_both(p_fn, moving_scene(96, 64, 2, seed=6))


def _decodes(stream, encoded):
    try:
        check_decodes(stream, encoded)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("route", ["fixed_tu4", "tree"])
def test_nxn_with_distinct_custom_lists_decodes(route, tmp_path):
    """The repair: each NxN sub-TU takes its own list (luma 8x8, luma
    4x4 DST, chroma 4x4), so the port's stream decodes to its recon,
    where the reference's stream on the same file and clip does not."""
    path = write_distinct_lists(str(tmp_path / "lists.txt"))
    if route == "fixed_tu4":
        frames = [detail_frame()]
        kw = dict(qp=30, tu_intra_depth=2, rdoq_level=2)
        w = h = 64
    else:
        y = micro_pattern(96, 64)
        frames = [(y, np.full((32, 48), 110, np.uint8),
                   np.full((32, 48), 140, np.uint8))]
        kw = dict(qp=28)
        w, h = 96, 64

    def p_fn():
        p = default_params(w, h, keyframe_max=1, nxn_intra=True, **kw)
        p.scaling_list = path
        return p
    enc = ttop.Encoder(p_fn(), "cpu")
    assert enc.recon.mats_nxn[2] is not None      # 4x4 lists not flat
    s, e = ttop.encode_sequence(p_fn(), frames, "cpu")
    check_decodes(s, e)
    s_ref, e_ref = jtop.encode_sequence(p_fn(), frames)
    assert not _decodes(s_ref, e_ref), \
        "the reference decodes here: the port's departure is not needed"
