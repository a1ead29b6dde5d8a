"""The port's own copies of the reference's jax-free host modules
(params, bitstream, entropy, rc, constants, frame.zscan, utils.trace,
the CLI's io and metrics modules, bitstream.hdr10plus, the native C
entropy engine, the host half of analysis.weightp, the validation
decoder and the numpy goldens it imports, the SEA search's goldens,
the analysis file's writer and reader, the cuTree share's shm ring and
its record format) must stay verbatim:
each copy's source equals the reference's once the package name is
substituted, and so must the host blocks copied into encoder/top.py's
rewritten methods (the Dolby Vision RPU split, the HDR10+ and HRD
SEIs, the noise-reduction state, the analysis file handles).  The native loader is the one module that differs (it
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
    "io/reconplay.py", "utils/metrics.py", "utils/vmaf.py",
    "bitstream/hdr10plus.py", "decoder/__init__.py", "decoder/decoder.py",
    "utils/ringmem.py", "analysis/cutree_share.py")

# the numpy goldens decoder/decoder.py (and the SEA search's golden)
# imports from the reference's jax-importing ops modules, with the
# helpers they call, copied unchanged into the port's counterpart
# modules under the same names
DECODER_GOLDENS = (
    ("ops/interp.py", ("_filt1d_ref", "mc_block_ref", "mc_block_ref_14",
                       "bi_combine_ref", "wp_apply_ref",
                       "wp_bi_combine_ref")),
    ("ops/intra.py", ("substitute_refs", "filter_refs",
                      "strong_smoothing_condition", "_refs_from_s",
                      "intra_pred_ref", "predict_block_ref")),
    ("ops/transform.py", ("_rshift_round", "idct_ref", "dequant_ref")),
    ("ops/deblock.py", ("_clip3", "_filter_luma_edge_ref",
                        "deblock_luma_ref", "deblock_chroma_ref",
                        "chroma_on_maps")),
    ("ops/sao.py", ("sao_apply_ref", "SaoParams")),
    ("frame/recon_intra.py", ("chroma_qp",)),
    # the SEA search's numpy goldens and the helper they call
    ("ops/sea.py", ("integral_ref", "sea_search_ref")),
    ("ops/me.py", ("mv_bits_np",)),
)


def _read(pkg: str, rel: str) -> str:
    with open(os.path.join(ROOT, pkg, rel), encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_module_is_a_verbatim_copy(rel):
    assert _read(PORT, rel) == _read(REF, rel).replace(REF, PORT)


def _top_defs(src):
    tree = ast.parse(src)
    return {n.name: ast.get_source_segment(src, n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("rel,name", [(rel, name)
                                      for rel, names in DECODER_GOLDENS
                                      for name in names])
def test_decoder_golden_is_verbatim(rel, name):
    assert _top_defs(_read(PORT, rel))[name] == \
        _top_defs(_read(REF, rel))[name]


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


def _block(src: str, start: str, end: str) -> str:
    """The lines of `src` from the one holding `start` through the one
    holding `end` (its first occurrence after `start`)."""
    i = src.rindex("\n", 0, src.index(start)) + 1
    j = src.index("\n", src.index(end, i)) + 1
    return src[i:j]


@pytest.mark.parametrize("start,end", [
    # the Dolby Vision RPU side file split into per-picture NALs
    ("# Dolby Vision RPU passthrough", "self._rpus.append(data[s0:e])"),
    # the per-picture HDR10+ SEI
    ("if self._dhdr10:", "write_dhdr10_sei(self._dhdr10[disp_i]))"),
    # pic_struct, and the HRD buffering-period / picture-timing SEIs
    ("# interlace signaling (reference frameencoder.cpp",
     "write_pic_timing(pic_struct=pic_struct))"),
    # the per-picture RPU NAL after the slice
    ("if self._rpus:", "out += self._rpus[min(disp_i"),
    # the noise-reduction running state
    ("# DCT-domain noise reduction running state",
     '"cnt": np.zeros(4, np.int64)}'),
    # the analysis save/load handles
    ("self._ana_store = self._ana_load = None",
     "self._ana_load = AnalysisLoad(self.p.analysis_load)"),
])
def test_encoder_host_blocks_are_verbatim(start, end):
    """Host blocks of encoder/top.py's Encoder that sit inside methods the
    port rewrites (__init__, _encode_picture) are copied unchanged."""
    rel = "encoder/top.py"
    assert _block(_read(PORT, rel), start, end) == \
        _block(_read(REF, rel), start, end)


@pytest.mark.parametrize("name", ["AnalysisStore", "AnalysisLoad"])
def test_analysis_file_classes_are_verbatim(name):
    """The analysis file's writer and reader (host code in a module that
    imports jax) are copied unchanged, with its magic string, so that a
    file either package writes loads in the other."""
    rel = "analysis/reuse.py"
    port, ref = _read(PORT, rel), _read(REF, rel)
    assert _top_defs(port)[name] == _top_defs(ref)[name]
    magic = [ln for ln in ref.splitlines() if ln.startswith("MAGIC = ")]
    assert len(magic) == 1 and magic[0] in port.splitlines()


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
