"""Elastic GOP-granular encoding with failure detection + re-dispatch
(port of x265_mod_by_patman_tpu/parallel/elastic.py: the chunks run
through the port's Encoder on the device the scheduler was given).

The reference is an in-process library whose only failure handling is
the m_aborted fatal latch (encoder.h:239) and the CLI Ctrl-C flush
(abrEncApp.cpp:1175).  A pod-scale TPU deployment needs more (SURVEY
§5): workers (hosts/slices) can be preempted mid-segment, so the unit
of recovery is the closed-GOP chunk — idempotent, order-independent,
and re-dispatchable to any surviving worker.

Model:
  - the sequence splits into closed-GOP chunks (parallel/gop.py);
  - a scheduler hands chunks to workers (any callable transport —
    in-process, thread, subprocess, or a pod RPC shim);
  - a worker failure (exception, timeout, or death) marks the chunk
    failed and re-enqueues it, up to max_retries per chunk;
  - finished chunk payloads spool to disk (the checkpoint), so a
    *driver* death resumes by re-reading the spool and re-dispatching
    only the missing chunks — the "checkpoint = RC state + chunk list"
    design from SURVEY §5;
  - cross-chunk ABR drift correction: each dispatch carries the
    accumulated (target - actual) bit error and biases its chunk
    bitrate to compensate (the chunked analog of the reference ABR
    feedback loop, ratecontrol.cpp rateEstimateQscale).
"""
from __future__ import annotations

import functools
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..params import EncoderParams
from .gop import chunk_bounds, encode_chunk


class WorkerFailure(RuntimeError):
    """A worker died / was preempted while encoding a chunk."""


def default_worker(params: EncoderParams, frames, first_chunk: bool,
                   device="cuda") -> Tuple[bytes, dict]:
    """In-process worker (transport shims wrap this)."""
    bs, fr = encode_chunk(params, frames, first_chunk, device)
    meta = {"frames": len(fr), "bits": sum(f.bits for f in fr),
            "qps": [f.qp for f in fr],
            "types": [f.slice_type for f in fr]}
    return bs, meta


class ElasticGopEncoder:
    """Chunk scheduler with failure detection and re-dispatch."""

    def __init__(self, params: EncoderParams, chunk_len: int = 32,
                 workers: int = 2, max_retries: int = 2,
                 spool_dir: Optional[str] = None,
                 worker_fn: Optional[Callable] = None,
                 timeout_s: Optional[float] = None,
                 device="cuda") -> None:
        """worker_fn(params, frames, first_chunk) encodes one chunk; by
        default default_worker on `device`."""
        self.params = params
        self.chunk_len = chunk_len
        self.workers = max(1, workers)
        self.max_retries = max_retries
        self.spool_dir = spool_dir
        self.worker_fn = worker_fn or functools.partial(default_worker,
                                                        device=device)
        self.timeout_s = timeout_s
        self.attempts: Dict[int, int] = {}
        self.events: List[tuple] = []      # (ts, kind, chunk, detail)

    # -- spool checkpointing -------------------------------------------------

    def _spool_path(self, idx: int) -> Optional[str]:
        if not self.spool_dir:
            return None
        return os.path.join(self.spool_dir, f"chunk_{idx:05d}.bin")

    def _spool_load(self, idx: int) -> Optional[Tuple[bytes, dict]]:
        path = self._spool_path(idx)
        if not path or not os.path.exists(path + ".json"):
            return None
        try:
            meta = json.load(open(path + ".json"))
            data = open(path, "rb").read()
            if len(data) != meta.get("nbytes", -1):
                return None                 # torn write: re-encode
            return data, meta
        except Exception:
            return None

    def _spool_store(self, idx: int, data: bytes, meta: dict) -> None:
        path = self._spool_path(idx)
        if not path:
            return
        os.makedirs(self.spool_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)               # atomic: no torn chunks
        meta = dict(meta, nbytes=len(data))
        mt = path + ".json.tmp"
        with open(mt, "w") as f:
            json.dump(meta, f)
        os.replace(mt, path + ".json")

    # -- scheduling ----------------------------------------------------------

    def _run_chunk(self, idx: int, frames, first: bool,
                   bias: float) -> Tuple[int, bytes, dict]:
        import copy
        p = copy.deepcopy(self.params)
        if p.rc_mode == "abr" and p.bitrate_kbps > 0 and bias:
            # ABR drift correction: steer this chunk's target by the
            # accumulated error of the finished chunks
            p.bitrate_kbps = max(1, int(round(p.bitrate_kbps *
                                              (1.0 + bias))))
        data, meta = self.worker_fn(p, frames, first)
        return idx, data, meta

    def encode(self, frames: Sequence[tuple]) -> Tuple[bytes, dict]:
        """Encode the sequence; survives worker failures and resumes
        from the spool.  Returns (stream_bytes, report)."""
        bounds = chunk_bounds(len(frames), self.chunk_len)
        results: Dict[int, Tuple[bytes, dict]] = {}
        pending: List[int] = []
        for i in range(len(bounds)):
            got = self._spool_load(i)
            if got is not None:
                results[i] = got
                self.events.append((time.time(), "resume", i, "spool"))
            else:
                pending.append(i)

        bias = 0.0
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            while pending:
                wave = {}
                for i in pending:
                    s, e = bounds[i]
                    wave[pool.submit(self._run_chunk, i,
                                     frames[s:e], i == 0, bias)] = i
                failed: List[int] = []
                for fut in as_completed(wave, timeout=self.timeout_s):
                    i = wave[fut]
                    try:
                        idx, data, meta = fut.result()
                    except Exception as exc:   # worker died / preempted
                        self.attempts[i] = self.attempts.get(i, 0) + 1
                        self.events.append(
                            (time.time(), "fail", i, repr(exc)))
                        if self.attempts[i] > self.max_retries:
                            raise WorkerFailure(
                                f"chunk {i} failed "
                                f"{self.attempts[i]} times") from exc
                        failed.append(i)
                        continue
                    results[idx] = (data, meta)
                    self._spool_store(idx, data, meta)
                    self.events.append((time.time(), "done", idx,
                                        meta.get("bits", 0)))
                pending = failed
                if self.params.rc_mode == "abr" and \
                        self.params.bitrate_kbps > 0 and results:
                    fps = self.params.fps_num / \
                        max(1, self.params.fps_denom)
                    tgt_bits = sum(
                        m["frames"] for _, m in results.values()) \
                        / fps * self.params.bitrate_kbps * 1000.0
                    got_bits = sum(m["bits"]
                                   for _, m in results.values())
                    if tgt_bits > 0:
                        bias = max(-0.5, min(0.5, (tgt_bits - got_bits)
                                             / tgt_bits))

        stream = b"".join(results[i][0] for i in range(len(bounds)))
        report = {
            "chunks": len(bounds),
            "retries": dict(self.attempts),
            "resumed": sum(1 for (_, k, _, _) in self.events
                           if k == "resume"),
            "bits": sum(m["bits"] for _, m in results.values()),
            "frames": sum(m["frames"] for _, m in results.values()),
        }
        return stream, report
