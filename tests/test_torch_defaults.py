"""The port's entry points run on the card unless the caller asks for the
CPU, and raise (never fall back) when the card is missing; the port's
native entropy engine builds under the repository's build/ tree through
a per-process temporary name."""
import inspect
import os
import subprocess

import pytest
import torch

from x265_mod_by_patman_tpu_torch import native
from x265_mod_by_patman_tpu_torch.encoder import top
from x265_mod_by_patman_tpu_torch.params import default_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("fn", [top.Encoder.__init__, top.encode_sequence])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        top.Encoder(default_params(64, 64, bframes=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        top.encode_sequence(default_params(64, 64, bframes=0), [])


def test_native_library_lives_under_build():
    assert native.BUILD_DIR == os.path.join(ROOT, "build", "native")
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert "x265tpu_entropy" not in path      # not the reference's name


def test_native_build_uses_a_per_process_temporary(tmp_path, monkeypatch):
    if native._cc() is None:
        pytest.skip("no C compiler")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    cmds = []
    real_run = subprocess.run

    def run(cmd, **kw):
        cmds.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", run)
    so = native._build()
    assert so == native.library_path()
    assert so.startswith(str(tmp_path)) and os.path.exists(so)
    assert cmds[0][cmds[0].index("-o") + 1] == f"{so}.tmp{os.getpid()}"
    assert os.listdir(tmp_path / "native") == [os.path.basename(so)]
    assert native._build() == so and len(cmds) == 1     # reused, not rebuilt
