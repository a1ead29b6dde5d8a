"""gop+ chunked output (reference output/gop.h / gop_engine.hpp).

The Patman mod's GOP output splits the elementary stream into
per-keyframe segment files plus an index, for segment-parallel
downstream muxing:

  <name>.gop            index: '#options'/'#headers' lines, then one
                        data-file name per IDR segment, '#' trailer
  <name>.options        key-value encode description
  <name>.headers        VPS/SPS/PPS (length-prefixed NALs)
  <name>-NNNNNN.hevc-gop-data
                        per frame: 4-byte marker {0,0,0,16}, int64 pts,
                        int64 dts, then the AU's NALs, each with a
                        4-byte big-endian length prefix (bAnnexB=false
                        form, gop_engine.hpp:115 WriteFrame)
"""
from __future__ import annotations

import os
import struct
from typing import List, Optional


def _annexb_to_length_prefixed(data: bytes) -> bytes:
    """Convert an Annex-B AU to 4-byte-BE length-prefixed NALs."""
    out = bytearray()
    i, n = 0, len(data)
    starts = []
    while i < n - 3:
        if data[i:i + 3] == b"\x00\x00\x01":
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        if k + 1 == len(starts):
            e = len(data)
        else:
            e = starts[k + 1] - 3
            if e > s and data[e - 1] == 0:      # 4-byte start code's 00
                e -= 1
        nal = data[s:e]
        out += struct.pack(">I", len(nal)) + nal
    return bytes(out)


class GOPOutput:
    """Segment-per-IDR stream writer (GOPEngine analog)."""

    def __init__(self, path: str, params, frame_offset: int = 0) -> None:
        if "?" in path:
            path, _, args = path.partition("?")
            for kv in args.split("&"):
                k, _, v = kv.partition("=")
                if k == "start":
                    frame_offset = int(v or "1")
        self.dir = os.path.dirname(path) or "."
        base = os.path.basename(path)
        self.prefix = base[:base.rfind(".")] if "." in base else base
        self.frame_offset = frame_offset
        self.n = 0
        self._data = None
        self.gop_fp = open(path, "w")
        self.gop_fp.write(f"#options {self.prefix}.options\n")
        self._write_options(params)

    def _write_options(self, p) -> None:
        with open(os.path.join(self.dir, self.prefix + ".options"),
                  "w") as f:
            f.write(f"b-frames {p.bframes}\n")
            f.write(f"b-pyramid {1 if p.b_pyramid else 0}\n")
            f.write(f"input-timebase-num {p.fps_denom}\n")
            f.write(f"input-timebase-den {p.fps_num}\n")
            f.write(f"output-fps-num {p.fps_num}\n")
            f.write(f"output-fps-den {p.fps_denom}\n")
            f.write(f"source-width {p.source_width}\n")
            f.write(f"source-height {p.source_height}\n")
            sar = (0, 0)
            if p.sar:
                t = p.sar.replace("/", ":").split(":")
                if len(t) == 2:
                    sar = (int(t[0]), int(t[1]))
            f.write(f"sar-width {sar[0]}\n")
            f.write(f"sar-height {sar[1]}\n")
            f.write(f"primaries-index {p.colorprim}\n")
            f.write(f"transfer-index {p.transfer}\n")
            f.write(f"matrix-index {p.colormatrix}\n")
            f.write(f"full-range {1 if p.video_full_range else 0}\n")

    def write_headers(self, annexb_headers: bytes) -> None:
        with open(os.path.join(self.dir, self.prefix + ".headers"),
                  "wb") as f:
            f.write(_annexb_to_length_prefixed(annexb_headers))
        self.gop_fp.write(f"#headers {self.prefix}.headers\n")

    def write_frame(self, annexb_au: bytes, is_idr: bool,
                    pts: int = 0, dts: int = 0) -> None:
        if is_idr:
            if self._data:
                self._data.close()
            name = (f"{self.prefix}-"
                    f"{self.n + self.frame_offset:06d}.hevc-gop-data")
            self._data = open(os.path.join(self.dir, name), "wb")
            self.gop_fp.write(name + "\n")
            self.gop_fp.flush()
        assert self._data is not None, "stream must start at an IDR"
        self._data.write(bytes((0, 0, 0, 16)))
        self._data.write(struct.pack("<qq", pts, dts))
        self._data.write(_annexb_to_length_prefixed(annexb_au))
        self.n += 1

    def close(self) -> None:
        if self._data:
            self._data.close()
        self.gop_fp.write(f"# {self.n} frames written, last frame "
                          f"{self.n + self.frame_offset}\n")
        self.gop_fp.close()


def read_gop_stream(gop_path: str) -> bytes:
    """Reassemble a gop+ output back into one Annex-B stream (for
    validation; the inverse of the writer)."""
    d = os.path.dirname(gop_path) or "."
    headers = b""
    segs: List[str] = []
    for line in open(gop_path):
        line = line.strip()
        if line.startswith("#headers"):
            headers = open(os.path.join(
                d, line.split()[1]), "rb").read()
        elif line and not line.startswith("#"):
            segs.append(line)

    def lp_to_annexb(data: bytes) -> bytes:
        out = bytearray()
        i = 0
        while i + 4 <= len(data):
            ln = struct.unpack(">I", data[i:i + 4])[0]
            out += b"\x00\x00\x00\x01" + data[i + 4:i + 4 + ln]
            i += 4 + ln
        return bytes(out)

    stream = lp_to_annexb(headers)
    for seg in segs:
        raw = open(os.path.join(d, seg), "rb").read()
        i = 0
        while i < len(raw):
            assert raw[i:i + 4] == bytes((0, 0, 0, 16))
            i += 4 + 16                       # marker + pts + dts
            # NALs run until the next frame marker or EOF
            j = i
            while j + 4 <= len(raw):
                if raw[j:j + 4] == bytes((0, 0, 0, 16)) and \
                        j + 20 <= len(raw):
                    break
                ln = struct.unpack(">I", raw[j:j + 4])[0]
                stream += b"\x00\x00\x00\x01" + raw[j + 4:j + 4 + ln]
                j += 4 + ln
            i = j
    return stream
