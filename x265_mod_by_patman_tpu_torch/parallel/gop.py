"""GOP-parallel chunked encoding (port of
x265_mod_by_patman_tpu/parallel/gop.py over the port's Encoder on a
torch device).

Analog of the reference's chunk encoding (x265 --chunk-start/--chunk-end,
encoder.cpp:1505): a long sequence is split into closed-GOP segments,
each encoded independently (every segment starts at an IDR), and the
bitstreams concatenate into one conformant stream.  Independence makes
the segments trivially parallel across processes/hosts/pod chips — the
"north-star GOP-parallel" distribution; here segments run sequentially
on the one attached device but through separate Encoder instances,
proving the bitstream-level contract.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from ..params import EncoderParams
from ..encoder.top import Encoder, EncodedFrame


def chunk_bounds(n_frames: int, chunk_len: int) -> List[Tuple[int, int]]:
    return [(s, min(s + chunk_len, n_frames))
            for s in range(0, n_frames, chunk_len)]


def encode_chunk(params: EncoderParams, frames: Sequence[tuple],
                 first_chunk: bool, device="cuda"
                 ) -> Tuple[bytes, List[EncodedFrame]]:
    """Encode one segment with a fresh Encoder.  Non-first chunks skip
    the duplicate parameter-set headers so the concatenation carries
    one VPS/SPS/PPS (decoders tolerate repeats; this mirrors the
    reference's chunk behavior with repeat-headers off)."""
    import copy
    p = copy.deepcopy(params)
    enc = Encoder(p, device)
    if not first_chunk:
        enc._headers_sent = True        # headers come from chunk 0
    out: List[EncodedFrame] = []
    for (y, u, v) in frames:
        out.extend(enc.encode_frame(y, u, v))
    out.extend(enc.flush())
    return b"".join(f.bitstream for f in out), out


def encode_gop_parallel(params: EncoderParams, frames: Sequence[tuple],
                        chunk_len: int = 32, device="cuda"):
    """Full-sequence chunked encode; returns (stream_bytes, frames)."""
    stream = b""
    all_frames: List[EncodedFrame] = []
    for i, (s, e) in enumerate(chunk_bounds(len(frames), chunk_len)):
        bs, fr = encode_chunk(params, frames[s:e], i == 0, device)
        stream += bs
        all_frames.extend(fr)
    return stream, all_frames
