"""Multi-stream batch encode on one device (port of
x265_mod_by_patman_tpu/parallel/streams.py).

S independent streams advance in lockstep.  For all-intra streams the
heavy per-frame device work (the batched mode decision and the
multi-frame recon wavefront) runs once over the S streams' current
frames, the stream axis being the batch axis; host entropy then runs per
stream, as the reference keeps CABAC per stream.  The reference shards
that axis over a device mesh; the port runs on one card, where a `mesh`
(parallel.mesh.make_mesh, one shard per stream) is a set of logical
shards of that card, and the streams run on its device.
"""
from __future__ import annotations

import concurrent.futures as cf
import copy
from typing import List, Sequence

import numpy as np

from ..analysis.intra_mode import decide_modes_batch
from ..encoder.top import EncodedFrame, Encoder
from ..params import EncoderParams, default_params
from .mesh import Mesh
from ..utils.device import resolve


def _mesh_device(mesh, n_streams: int, device):
    """The device the streams run on: `device`, or a mesh's (a port Mesh
    of one shard per stream, which on one card is a set of logical
    shards of that device)."""
    if mesh is None:
        return resolve(device)
    if not isinstance(mesh, Mesh) or mesh.size != n_streams:
        raise NotImplementedError(
            "not ported: a mesh other than parallel.mesh.make_mesh's with "
            f"one shard per stream ({n_streams})")
    return mesh.device


class MultiStreamEncoder:
    """General multi-stream encoder: S independent I/P/B streams on one
    device, each a full Encoder (own headers, RC, DPB, lookahead);
    encode_step advances every stream by one source frame, the streams'
    host work overlapping in threads, and returns each stream's newly
    emitted frames.  The output is byte-identical to running each
    Encoder alone."""

    def __init__(self, params: EncoderParams, n_streams: int,
                 mesh=None, device="cuda") -> None:
        self.n = n_streams
        self.device = _mesh_device(mesh, n_streams, device)
        self.encoders = [Encoder(copy.deepcopy(params), self.device)
                         for _ in range(n_streams)]

    def _advance(self, i: int, frame):
        enc = self.encoders[i]
        if frame is None:
            return enc.flush()
        return enc.encode_frame(*frame)

    def encode_step(self, frames: Sequence) -> List[List[EncodedFrame]]:
        """frames: one (y, u, v) per stream (None = flush that stream).
        Returns the per-stream lists of emitted frames."""
        assert len(frames) == self.n
        with cf.ThreadPoolExecutor(max_workers=self.n) as ex:
            return list(ex.map(lambda iv: self._advance(*iv),
                               enumerate(frames)))

    def flush(self) -> List[List[EncodedFrame]]:
        return self.encode_step([None] * self.n)


class MultiStreamIntraEncoder:
    """All-intra lockstep encoder for S streams on one device.

    Each stream keeps its own Encoder (headers, RC, entropy state); the
    mode decision and the wavefront of all streams' current frames run
    as one batch (decide_modes_batch, IntraReconstructor.run_batch)."""

    def __init__(self, params: EncoderParams, n_streams: int,
                 mesh=None, device="cuda") -> None:
        assert params.keyframe_max == 1, "multi-stream v1 is all-intra"
        self.n = n_streams
        self.device = _mesh_device(mesh, n_streams, device)
        self.encoders = [Encoder(default_params(
            params.source_width, params.source_height, qp=params.qp,
            keyframe_max=1, sao=params.sao, deblock=params.deblock,
            wpp=params.wpp, ctu_size=params.ctu_size,
            # the batched wavefront is the fixed-grid (rd-2) analysis;
            # pin it so headers match a rd-2 streaming encoder
            rd_level=min(params.rd_level, 2)), self.device)
            for _ in range(n_streams)]

    def encode_step(self, frames: Sequence[tuple]) -> List[EncodedFrame]:
        """frames: one (y, u, v) per stream.  Returns one EncodedFrame per
        stream (same order)."""
        assert len(frames) == self.n
        enc0 = self.encoders[0]
        padded = [(e._pad(y, 0), e._pad(u, 1), e._pad(v, 1))
                  for e, (y, u, v) in zip(self.encoders, frames)]
        ys = np.stack([f[0] for f in padded])
        us = np.stack([f[1] for f in padded])
        vs = np.stack([f[2] for f in padded])
        qp = enc0.rc.frame_qp("I", 0.0)      # CQP: stateless

        # device phase: the streams' batched mode decision + wavefront
        modes = decide_modes_batch(ys, enc0.sps, self.device, block=16,
                                   qp=qp)
        results = enc0.recon.run_batch(ys, us, vs, modes, qp=qp)

        # host phase: per-stream filters + entropy via each Encoder
        out: List[EncodedFrame] = []
        for i, enc in enumerate(self.encoders):
            r = results[i]
            inter_mask = np.zeros(modes[i].shape, bool)
            mvs = np.zeros(modes[i].shape + (2,), np.int32)
            enc._deblock(r, inter_mask, mvs, None, None, ((), ()),
                         qp, enc.recon)
            rbsp, md5 = enc._intra_slice(modes[i], r, (ys[i], us[i], vs[i]),
                                         qp)
            nal_bytes = enc._idr_nal(rbsp, md5)
            out.append(EncodedFrame(
                0, nal_bytes, (r["recon_y"], r["recon_u"], r["recon_v"]),
                bits=len(nal_bytes) * 8, md5=md5, slice_type="I"))
        return out
