"""The port's stream- and GOP-level entry points on the CPU against the
JAX package: MultiStreamIntraEncoder (the streams batched through the
multi-frame wavefront), MultiStreamEncoder (independent I/P/B streams),
encode_gop_parallel and ElasticGopEncoder (retry and spool resume) give
the reference's bytes, and their streams decode in the port's decoder
with the MD5 SEI matching; the stream encoders take a port mesh of one
logical shard per stream.  The copied host logic of parallel/gop.py and
parallel/elastic.py is held to the reference's source.

Tolerance: exact (bytes)."""
import threading

import numpy as np
import pytest
import torch

from x265_mod_by_patman_tpu.encoder.top import Encoder as JEncoder
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu.parallel import elastic as jel
from x265_mod_by_patman_tpu.parallel import gop as jgop
from x265_mod_by_patman_tpu_torch.decoder.decoder import Decoder
from x265_mod_by_patman_tpu_torch.encoder.top import Encoder as TEncoder
from x265_mod_by_patman_tpu_torch.parallel import elastic as tel
from x265_mod_by_patman_tpu_torch.parallel import gop as tgop
from x265_mod_by_patman_tpu_torch.parallel.mesh import make_mesh
from x265_mod_by_patman_tpu_torch.parallel.streams import (
    MultiStreamEncoder, MultiStreamIntraEncoder)
from tests.test_e2e_inter import moving_scene
from tests.test_e2e_intra import synth_frame
from tests.test_elastic import _frames, _params
from tests.test_torch_bframes import _defs, _one_torch_thread  # noqa: F401

W, H = 96, 64


def _decodes(stream: bytes, n: int):
    pics = Decoder().decode(stream)
    assert len(pics) == n
    for pc in pics:
        assert pc.md5 == pc.sei_md5


def test_multistream_intra_equals_reference_per_stream():
    """4 streams x 2 steps through one batched wavefront, each stream
    byte-identical to the JAX encoder's encode_frame on that stream."""
    n = 4
    p = default_params(W, H, qp=32, keyframe_max=1, rd_level=2)
    streams = [[synth_frame(W, H, seed=s * 7 + t, motion=t)
                for t in range(2)] for s in range(n)]
    ms = MultiStreamIntraEncoder(p, n, device="cpu")
    got = [ms.encode_step([streams[s][t] for s in range(n)])
           for t in range(2)]
    for s in range(n):
        enc = JEncoder(default_params(W, H, qp=32, keyframe_max=1,
                                      rd_level=2))
        for t in range(2):
            [f] = enc.encode_frame(*streams[s][t])
            assert f.bitstream == got[t][s].bitstream, (s, t)
            assert f.md5 == got[t][s].md5
        _decodes(b"".join(got[t][s].bitstream for t in range(2)), 2)


def test_multistream_equals_reference_per_stream():
    """2 streams of 4 frames at the repo defaults (B pictures, lookahead):
    each stream byte-identical to a JAX encoder run alone."""
    n, nf = 2, 4
    p = default_params(W, H, qp=30)
    streams = [moving_scene(W, H, nf, seed=20 + s) for s in range(n)]
    ms = MultiStreamEncoder(p, n, device="cpu")
    got = [[] for _ in range(n)]
    for t in range(nf):
        for s, out in enumerate(ms.encode_step([streams[s][t]
                                                for s in range(n)])):
            got[s].extend(out)
    for s, out in enumerate(ms.flush()):
        got[s].extend(out)
    for s in range(n):
        enc = JEncoder(default_params(W, H, qp=30))
        ref = []
        for fr in streams[s]:
            ref.extend(enc.encode_frame(*fr))
        ref.extend(enc.flush())
        assert [f.bitstream for f in got[s]] == [f.bitstream for f in ref]
        _decodes(b"".join(f.bitstream for f in got[s]), nf)


@pytest.mark.parametrize("cls", [MultiStreamEncoder,
                                 MultiStreamIntraEncoder])
def test_multistream_refuses_a_mesh(cls):
    """A port mesh of one logical shard per stream is taken: the streams
    run on its device, encode and decode.  Any other object, or a mesh
    of another size, is refused."""
    p = default_params(W, H, qp=32, keyframe_max=1)
    for bad in (object(), make_mesh(3, "stream", "cpu")):
        with pytest.raises(NotImplementedError, match="mesh"):
            cls(p, 2, mesh=bad, device="cpu")
    ms = cls(p, 2, mesh=make_mesh(2, "stream", "cpu"))
    assert ms.device == torch.device("cpu")
    streams = [moving_scene(W, H, 2, seed=20 + s) for s in range(2)]
    got = [[], []]
    for k in range(2):
        out = ms.encode_step([streams[0][k], streams[1][k]])
        for s in range(2):
            got[s].extend(out[s] if isinstance(out[s], list) else [out[s]])
    if cls is MultiStreamEncoder:
        for s, out in enumerate(ms.flush()):
            got[s].extend(out)
    for s in range(2):
        _decodes(b"".join(f.bitstream for f in got[s]), 2)


def test_gop_parallel_equals_reference():
    frames = moving_scene(W, H, 8, seed=14)
    p = default_params(W, H, qp=30, keyframe_max=250, bframes=2)
    ref, ref_fr = jgop.encode_gop_parallel(p, frames, chunk_len=4)
    got, got_fr = tgop.encode_gop_parallel(p, frames, chunk_len=4,
                                           device="cpu")
    assert got == ref
    assert [f.md5 for f in got_fr] == [f.md5 for f in ref_fr]
    _decodes(got, 8)


def _cpu_worker(params, chunk, first):
    return tel.default_worker(params, chunk, first, "cpu")


def test_elastic_survives_preemption_and_equals_reference():
    frames = _frames(8)
    ref, _ = jgop.encode_gop_parallel(_params(), frames, chunk_len=4)
    fails = {"n": 0}
    lock = threading.Lock()

    def flaky(params, chunk, first):
        with lock:
            if not first and fails["n"] < 1:
                fails["n"] += 1
                raise tel.WorkerFailure("worker preempted (simulated)")
        return _cpu_worker(params, chunk, first)

    enc = tel.ElasticGopEncoder(_params(), chunk_len=4, workers=2,
                                max_retries=2, worker_fn=flaky)
    stream, report = enc.encode(frames)
    assert fails["n"] == 1 and sum(report["retries"].values()) == 1
    assert stream == ref
    _decodes(stream, 8)


def test_elastic_resumes_from_its_spool(tmp_path):
    frames = _frames(8)
    ref, _ = jgop.encode_gop_parallel(_params(), frames, chunk_len=4)
    spool = str(tmp_path / "spool")
    calls = {"n": 0}

    def dies_after_first(params, chunk, first):
        calls["n"] += 1
        if calls["n"] > 1:
            raise OSError("scheduler lost its worker")
        return _cpu_worker(params, chunk, first)

    with pytest.raises(tel.WorkerFailure):
        tel.ElasticGopEncoder(_params(), chunk_len=4, workers=1,
                              max_retries=0, spool_dir=spool,
                              worker_fn=dies_after_first).encode(frames)
    stream, report = tel.ElasticGopEncoder(
        _params(), chunk_len=4, workers=1, max_retries=0, spool_dir=spool,
        device="cpu").encode(frames)
    assert report["resumed"] == 1
    assert stream == ref


def test_elastic_abr_drift_bias_as_reference():
    """The ABR drift correction steers each chunk's bitrate as the
    reference's scheduler does (host logic, recorded workers)."""
    frames = _frames(12)
    p = default_params(64, 48, rc_mode="abr", bitrate_kbps=300,
                       keyframe_max=4, bframes=0)
    seen = {}

    def recorder(tag):
        def fn(params, chunk, first):
            seen.setdefault(tag, []).append(params.bitrate_kbps)
            if len(seen[tag]) == 2:
                raise OSError("preempted")   # a retry wave with a bias
            return b"x" * 10, {"frames": len(chunk), "bits": 9000,
                               "qps": [], "types": []}
        return fn

    jel.ElasticGopEncoder(p, chunk_len=4, workers=1, max_retries=1,
                          worker_fn=recorder("j")).encode(frames)
    tel.ElasticGopEncoder(p, chunk_len=4, workers=1, max_retries=1,
                          worker_fn=recorder("t")).encode(frames)
    assert seen["t"] == seen["j"]
    assert len(set(seen["t"])) > 1


@pytest.mark.parametrize("rel,names", [
    ("parallel/gop.py", ("chunk_bounds",)),
    ("parallel/elastic.py", ("_spool_path", "_spool_load", "_spool_store",
                             "_run_chunk", "encode")),
])
def test_parallel_host_logic_is_verbatim(rel, names):
    ref = _defs("x265_mod_by_patman_tpu/" + rel)
    port = _defs("x265_mod_by_patman_tpu_torch/" + rel)
    for name in names:
        assert port[name] == ref[name], name
