"""The PyTorch port must import and encode with JAX unavailable (the GPU
machine has no JAX) and without the JAX package: a subprocess blocks
`jax` and `x265_mod_by_patman_tpu` and encodes a 96x64 y4m through the
port's CLI on the CPU, at the repo defaults (B pictures, the slicetype
lookahead) under CRF with AQ 2 and cuTree, and a scan of the sources
finds no import of either."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["x265_mod_by_patman_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)        # tiny tensors: one thread is fastest
import x265_mod_by_patman_tpu_torch
from x265_mod_by_patman_tpu_torch import cli
from x265_mod_by_patman_tpu_torch.io.y4m import VideoInfo, Y4MWriter
out = sys.argv[1]
rng = np.random.default_rng(0)
base = rng.integers(0, 256, (96, 128)).astype(np.uint8)
wr = Y4MWriter(out + "/in.y4m", VideoInfo(96, 64, total_frames=6))
for i in range(6):
    wr.write(base[i:i + 64, 2 * i:2 * i + 96].copy(),
             np.full((32, 48), 120, np.uint8), np.full((32, 48), 130, np.uint8))
wr.close()
assert cli.main(["--input", out + "/in.y4m", "-o", out + "/out.hevc",
                 "--crf", "28", "--aq-mode", "2", "--no-progress",
                 "--csv", out + "/log.csv", "--recon", out + "/rec.y4m",
                 "--device", "cpu"]) == 0
types = [r.split(",")[1] for r in open(out + "/log.csv").read().split()[1:]]
assert types[:2] == ["I", "P"] and "B" in types, types
assert len(open(out + "/out.hevc", "rb").read()) > 100
from x265_mod_by_patman_tpu_torch.decoder.decoder import Decoder
from x265_mod_by_patman_tpu_torch.io.y4m import Y4MReader
pics = Decoder().decode(open(out + "/out.hevc", "rb").read())
recs = list(Y4MReader(out + "/rec.y4m"))
assert len(pics) == len(recs) == 6, (len(pics), len(recs))
for pic, rec in zip(sorted(pics, key=lambda p: p.poc), recs):
    assert pic.sei_md5 == pic.md5
    for a, b in zip((pic.y, pic.u, pic.v), rec):
        assert np.array_equal(a, b)
assert not any(m.split(".")[0] in ("jax", "x265_mod_by_patman_tpu")
               for m, v in sys.modules.items() if v is not None)
print("OK", types)
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.startswith("OK"), res.stdout


def test_port_sources_never_import_jax():
    pkg = os.path.join(ROOT, "x265_mod_by_patman_tpu_torch")
    offenders, scanned = [], []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                for line in open(path, encoding="utf-8"):
                    s = line.strip()
                    if s.startswith(("import jax", "from jax")):
                        offenders.append(path)
                scanned.append(os.path.relpath(path, pkg))
    assert os.path.join("ops", "sea.py") in scanned
    assert os.path.join("analysis", "reuse.py") in scanned
    for rel in (("analysis", "mcstf.py"), ("analysis", "cutree_share.py"),
                ("utils", "scaler.py"), ("utils", "ringmem.py"),
                ("parallel", "ladder.py"), ("abrenc.py",)):
        assert os.path.join(*rel) in scanned, rel
    assert not offenders, offenders


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def test_port_sources_never_import_the_jax_package():
    """Every import in the package and in chip_smoke.py, lazy ones
    included: the JAX package is the reference, never a dependency."""
    pkg = os.path.join(ROOT, "x265_mod_by_patman_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    offenders = [(p, m) for p in paths for m in _imported_modules(p)
                 if m.split(".")[0] in ("jax", "x265_mod_by_patman_tpu")]
    assert not offenders, offenders
