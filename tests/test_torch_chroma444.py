"""4:4:4 chroma (Main 4:4:4, RExt) in the PyTorch port against the JAX
reference, on the same seeded numpy inputs:

* op parity at 8, 10 and 12 bits: deblocking of the full-size chroma
  planes (chroma edges on the luma 8-grid, QpC clipped at 51) under a
  scalar QP and a per-CTU QP map, with the QpC edge maps; SAO on the
  full-size chroma CTU tiles; the 16x16 chroma intra prediction with
  its reference samples filtered as luma's (spec 8.4.4.2.3); the chroma
  MC of 16x16 blocks with the quarter-pel MVs doubled into the
  eighth-pel chroma filter;
* IntraReconstructor.run for an I and a P picture at 64x64 (16x16
  chroma TBs);
* analyse_p_frame / analyse_b_frame decisions and MC planes;
* streams at 96x64 on tests/test_444.py's synth444 clip (seed 5, motion
  3 px a frame, six frames, I P B B B B with the pyramid): the repo
  defaults at 8 bits and CRF 28 + AQ 2 + cuTree at 10 bits, byte-
  identical to the JAX encoder and decoded by the port's decoder with
  the MD5 SEI matching;
* --scaling-list in 4:4:4, which the reference cannot encode and the
  port refuses by name.

The helpers are tests/test_torch_chroma422.py's.

Tolerance: exact (integers, levels, pixels, bytes)."""
import pytest

from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_444 import synth444
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401
from tests.test_torch_chroma422 import (
    H, W, DEPTHS, check_analysis, check_chroma_mc, check_chroma_qp_edge_maps,
    check_deblock, check_intra, check_recon, check_sao, check_stream_bytes,
    check_stream_decodes, encode_both)

CSP = 3


@pytest.mark.parametrize("bd", DEPTHS)
@pytest.mark.parametrize("qmap", [0, 1])
def test_deblock_444_matches_reference(bd, qmap):
    check_deblock(CSP, bd, qmap)


def test_chroma_qp_edge_maps_444():
    check_chroma_qp_edge_maps(CSP)


@pytest.mark.parametrize("bd", DEPTHS)
def test_sao_on_full_size_chroma_tiles(bd):
    check_sao(64, H, W, bd)


@pytest.mark.parametrize("bd", DEPTHS)
@pytest.mark.parametrize("log2n", [3, 4])
def test_filtered_chroma_intra_444(bd, log2n):
    check_intra(log2n, bd, lambda m: m, True)


@pytest.mark.parametrize("bd", DEPTHS)
def test_doubled_mv_chroma_mc_444(bd):
    check_chroma_mc(CSP, bd)


@pytest.mark.parametrize("kind", ["I", "P"])
def test_recon_run_444_matches_reference(kind):
    check_recon(CSP, kind)


@pytest.mark.parametrize("kind", ["P", "B"])
def test_analysis_444_matches_reference(kind):
    check_analysis(CSP, kind)


STREAMS = {
    "defaults8": (dict(), 8),
    "crf28_aq2_cutree10": (dict(rc_mode="crf", crf=28.0, aq_mode=2), 10),
}


@pytest.fixture(scope="module")
def streams():
    cache = {}

    def get(case):
        if case not in cache:
            kw, bd = STREAMS[case]
            frames = [synth444(W, H, seed=5, motion=3 * i) for i in range(6)]
            cache[case] = encode_both(CSP, kw, bd, frames)
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_444_stream_equals_jax(streams, case):
    check_stream_bytes(streams(case), CSP)


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_444_stream_decodes(streams, case):
    check_stream_decodes(streams(case), CSP, STREAMS[case][1])


def test_scaling_list_444_refused_where_the_reference_fails():
    """The reference quantizes the 16x16 chroma TBs of 4:4:4 with its 8x8
    chroma lists and fails on the shape; the port refuses the
    combination by name.  Should the reference start to encode it, this
    test fails and the refusal is to be lifted."""
    frames = [synth444(W, H, seed=5, motion=0)]
    params = lambda: default_params(W, H, internal_csp=CSP, total_frames=1,
                                    scaling_list="default")
    with pytest.raises(TypeError, match="incompatible shapes"):
        jtop.encode_sequence(params(), frames)
    with pytest.raises(NotImplementedError, match="--scaling-list in 4:4:4"):
        ttop.encode_sequence(params(), frames, "cpu")
