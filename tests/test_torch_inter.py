"""analysis/inter_mode.py (P analysis) of the PyTorch port against the JAX
reference's analyse_p_frame and _me_one_ref on the same planes,
references, weights and collocated motion.

Tolerance: modes, inter mask, MVs, reference picks and the MC
predictions are integers and must match exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x265_mod_by_patman_tpu.analysis import inter_mode as jim
from x265_mod_by_patman_tpu.bitstream.headers import build_sps_info
from x265_mod_by_patman_tpu.entropy.mv_pred import ColMotion
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.analysis import inter_mode as tim
from x265_mod_by_patman_tpu_torch.convert import to_numpy, to_torch
from tests.test_e2e_inter import moving_scene
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _col(nby, nbx, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random((nby, nbx)) < 0.8).astype(np.int8)
    mv = np.zeros((nby, nbx, 2, 2), np.int32)
    mv[..., 0, :] = rng.integers(-12, 13, (nby, nbx, 2))
    rp = np.zeros((nby, nbx, 2), np.int64)
    return ColMotion(1, d, mv, rp)


@pytest.mark.parametrize("case", ["plain", "weighted_tmvp"])
def test_analyse_p_frame_matches_reference(case):
    w, h, qp = 96, 64, 30
    frames = moving_scene(w, h, 3, seed=4)
    sps = build_sps_info(default_params(w, h).validate())
    refs = [frames[1], frames[0]]
    kw = dict(search_range=16, subme=2, pad_refs=3, rounds=(2, 1))
    if case == "weighted_tmvp":
        kw.update(weights=[(70, -6), None],
                  chroma_weights=[((60, 4), (64, 0)), None],
                  col=_col(h // 16, w // 16, 1), ref_pocs=((1, 0), ()),
                  cur_poc=2)
    y, u, v = frames[2]
    exp = jim.analyse_p_frame(y, u, v, refs, sps, qp, **kw)
    got = tim.analyse_p_frame(y, u, v, refs, sps, qp, CPU, **kw)
    names = ("modes", "inter_mask", "mvs", "ref_sel", "mc", "part", "mvs_b")
    for name, a, b in zip(names, got, exp):
        if name == "mc":
            for pa, pb in zip(a, b):
                np.testing.assert_array_equal(pa.numpy(), np.asarray(pb))
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)
    assert np.asarray(got[1]).any(), "premise: inter blocks chosen"


@pytest.mark.parametrize("subme,sr", [(1, 8), (2, 16)])
def test_me_one_ref_matches_reference(subme, sr):
    w, h, n = 96, 64, 16
    frames = moving_scene(w, h, 2, seed=7)
    oy = frames[1][0].astype(np.int32)
    ry = frames[0][0].astype(np.int32)
    bys, bxs = np.mgrid[0:h // n, 0:w // n]
    bx = (bxs.ravel() * n).astype(np.int32)
    by = (bys.ravel() * n).astype(np.int32)
    exp = jim._me_one_ref(jnp.asarray(oy), jnp.asarray(ry), jnp.asarray(bx),
                          jnp.asarray(by), n, 300, sr, 8, use_pallas=False,
                          subme=subme)
    t = lambda a: to_torch(a, CPU)
    got = tim._me_one_ref(t(oy), t(ry), t(bx), t(by), n, 300, sr, 8, subme)
    for name, a, b in zip(("mvx", "mvy", "cost", "org"), got, exp):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b),
                                      err_msg=name)
    assert np.asarray(exp[0]).any(), "premise: non-zero motion found"


def test_temporal_merge_field_and_lambda_are_reference_functions():
    col = _col(4, 6, 3)
    args = (col, 4, 6, 16, 96, 64, 6, 0, 1, 2, True)
    for a, b in zip(tim.temporal_merge_field(*args),
                    jim.temporal_merge_field(*args)):
        np.testing.assert_array_equal(a, b)
    for qp in (0, 22, 51):
        assert tim.lambda_qp(qp) == jim.lambda_qp(qp)
