"""Analysis save/load (--analysis-save / --analysis-load) in the PyTorch
port, on the CPU:

* save then load in the port gives identical bytes, at the reference
  test's settings (tests/test_analysis_reuse.py: CQP 30, 2 B-frames)
  and on the CU-tree route with NxN intra PUs;
* the file holds only numpy arrays, so a file the JAX encoder saved
  loads in the port, and the replay gives the JAX encoder's bytes;
* the replay's MC (mc_for_p / mc_for_b over the port's K2 path) equals
  the reference's on stored decisions.

The info SEI is off wherever bytes are compared: it prints the analysis
file's path.  Tolerance: exact (bytes, predictions)."""
import pickle

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from x265_mod_by_patman_tpu.analysis import reuse as jre
from x265_mod_by_patman_tpu.bitstream.headers import build_sps_info
from x265_mod_by_patman_tpu.encoder import top as jtop
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu_torch.analysis import reuse as tre
from x265_mod_by_patman_tpu_torch.encoder import top as ttop
from tests.test_e2e_inter import moving_scene
from tests.test_torch_bframes import _one_torch_thread  # noqa: F401
from tests.test_torch_nxn import check_decodes

CPU = torch.device("cpu")
W, H = 96, 64


def _run(top, frames, save="", load="", device=(), **kw):
    kw = {"bframes": 2, **kw}
    p = default_params(W, H, qp=30, keyframe_max=250, analysis_save=save,
                       analysis_load=load, info_sei=False, **kw)
    enc = top.Encoder(p, *device)
    out = []
    for f in frames:
        out.extend(enc.encode_frame(*f))
    out.extend(enc.flush())
    enc.write_stats()
    return b"".join(f.bitstream for f in out), out


@pytest.mark.parametrize("kw", [{}, dict(nxn_intra=True, bframes=0)],
                         ids=["defaults", "nxn_tree"])
def test_port_save_then_load_is_identical(tmp_path, kw):
    frames = moving_scene(W, H, 6, seed=12)
    path = str(tmp_path / "a.bin")
    s1, _ = _run(ttop, frames, save=path, device=("cpu",), **kw)
    s2, e2 = _run(ttop, frames, load=path, device=("cpu",), **kw)
    assert s1 == s2
    check_decodes(s2, e2)
    with open(path, "rb") as fh:
        assert pickle.load(fh) == tre.MAGIC
        rec = pickle.load(fh)
    assert all(v is None or isinstance(v, (np.ndarray, int, str))
               for v in rec.values())


def test_jax_file_loads_in_the_port(tmp_path):
    frames = moving_scene(W, H, 4, seed=12)
    path = str(tmp_path / "jax.bin")
    s_jax, _ = _run(jtop, frames, save=path)
    s_pt, e_pt = _run(ttop, frames, load=path, device=("cpu",))
    assert s_pt == s_jax
    check_decodes(s_pt, e_pt)


def test_replay_mc_matches_reference():
    rng = np.random.default_rng(4)
    frames = moving_scene(W, H, 3, seed=12)
    sps = build_sps_info(default_params(W, H).validate())
    nby, nbx = H // 16, W // 16
    mvs = rng.integers(-40, 41, (nby, nbx, 2)).astype(np.int32)
    mvs1 = rng.integers(-40, 41, (nby, nbx, 2)).astype(np.int32)
    sel = rng.integers(0, 2, (nby, nbx)).astype(np.int32)
    dirs = rng.integers(1, 4, (nby, nbx)).astype(np.int32)
    refs = [frames[1], frames[2]]
    wp = [(40, 3), None]
    exp = jre.mc_for_p(refs, mvs, sel, sps, wp)
    got = tre.mc_for_p(refs, mvs, sel, sps, CPU, wp)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    exp = jre.mc_for_b([frames[0]], refs, dirs, mvs, mvs1, sps,
                       ref_sel1=sel)
    got = tre.mc_for_b([frames[0]], refs, dirs, mvs, mvs1, sps, CPU,
                       ref_sel1=sel)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(jnp.asarray(b)))
