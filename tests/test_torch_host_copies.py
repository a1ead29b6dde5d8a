"""The port's own copies of the reference's jax-free host modules
(params, bitstream, entropy, rc, constants, frame.zscan, utils.trace,
the CLI's io and metrics modules, the native C entropy engine, the host
half of analysis.weightp) must stay
verbatim: each copy's source equals the reference's once the package name
is substituted.  The native loader is the one module that differs (it
builds under build/ with a per-process temporary name); its bindings
from get_lib() on are still verbatim.  The port's native engine must
give the pure-Python engine's bytes.

Tolerance: exact (source text, bytes)."""
import ast
import os

import numpy as np
import pytest

from x265_mod_by_patman_tpu_torch import native
from x265_mod_by_patman_tpu_torch.bitstream.bitwriter import BitWriter
from x265_mod_by_patman_tpu_torch.entropy.cabac import CabacEncoder
from x265_mod_by_patman_tpu_torch.entropy.contexts import (NUM_CONTEXTS,
                                                           init_states)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "x265_mod_by_patman_tpu"
PORT = "x265_mod_by_patman_tpu_torch"

VERBATIM = (
    "params.py", "bitstream/bitreader.py", "bitstream/bitwriter.py",
    "bitstream/headers.py", "bitstream/level.py", "bitstream/nal.py",
    "bitstream/sei.py", "constants/hevc_tables.py", "constants/scaling.py",
    "entropy/binir.py", "entropy/cabac.py", "entropy/contexts.py",
    "entropy/cu_syntax.py", "entropy/est_bits.py", "entropy/mv_pred.py",
    "entropy/residual.py", "rc/ratecontrol.py", "frame/zscan.py",
    "utils/trace.py", "native/entropy_kernels.c", "io/__init__.py",
    "io/y4m.py", "io/script_input.py", "io/gop_output.py",
    "io/reconplay.py", "utils/metrics.py", "utils/vmaf.py")


def _read(pkg: str, rel: str) -> str:
    with open(os.path.join(ROOT, pkg, rel), encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_module_is_a_verbatim_copy(rel):
    assert _read(PORT, rel) == _read(REF, rel).replace(REF, PORT)


def test_native_loader_bindings_are_verbatim():
    ref, port = _read(REF, "native/__init__.py"), _read(PORT,
                                                         "native/__init__.py")
    cut = "def get_lib()"
    assert port[port.index(cut):] == ref[ref.index(cut):]


def test_weightp_host_functions_are_verbatim():
    def defs(src):
        tree = ast.parse(src)
        return {n.name: ast.get_source_segment(src, n) for n in tree.body
                if isinstance(n, ast.FunctionDef)}, \
            [ast.get_source_segment(src, n) for n in tree.body
             if isinstance(n, ast.Assign)]
    ref_f, ref_a = defs(_read(REF, "analysis/weightp.py"))
    port_f, port_a = defs(_read(PORT, "analysis/weightp.py"))
    for name in ("analyse_weightp", "analyse_weightp_chroma"):
        assert port_f[name] == ref_f[name], name
    assert port_a == ref_a                      # LUMA_DENOM
    assert "weighted_plane" in port_f and "weighted_plane_jnp" not in port_f


def test_native_engine_equals_python_engine(tmp_path, monkeypatch):
    """A fresh build of the port's C engine (into a temporary build
    directory) against the pure-Python engine."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    for name, fresh in (("_lib", None), ("_tried", False), ("_native", None)):
        monkeypatch.setattr(native, name, fresh)
    nat = native.native_entropy()
    assert nat.available, "the port's native entropy engine did not build"
    rng = np.random.default_rng(0)
    for trial in range(3):
        n = int(rng.integers(100, 5000))
        bins = rng.integers(0, 2, n).astype(np.uint8)
        ctx = rng.integers(-1, NUM_CONTEXTS, n).astype(np.int32)
        bins[-1] = 1
        ctx[-1] = -2                       # terminate(1)
        st_py = init_states(2, 30)
        st_c = st_py.copy()
        bw = BitWriter()
        enc = CabacEncoder(bw)
        enc.encode_stream(bins, ctx, st_py)
        enc.finish()
        bw.rbsp_trailing_bits()
        data, tail_val, tail_n = nat.cabac_encode(bins, ctx, st_c)
        bw2 = BitWriter()
        bw2.write_bytes(data)
        bw2.u(tail_val, tail_n)
        bw2.rbsp_trailing_bits()
        assert bw2.get_bytes() == bw.get_bytes(), trial
        assert np.array_equal(st_py, st_c), trial
