"""Y4M and raw YUV file I/O.

Analog of the reference's input/output layer (x265 source/input/y4m.cpp,
source/input/yuv.cpp, source/output/{y4m,yuv}.cpp), including the Patman
mod's XLENGTH y4m header tag (total frame count for progress/planning,
reference input/y4m.cpp:277).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass
class VideoInfo:
    width: int = 0
    height: int = 0
    fps_num: int = 25
    fps_denom: int = 1
    csp: str = "420"
    bit_depth: int = 8
    total_frames: int = 0     # 0 = unknown; y4m XLENGTH fills this


class Y4MReader:
    """Iterates (y, u, v) uint8 planes from a .y4m file."""

    def __init__(self, path: str) -> None:
        self.f = open(path, "rb")
        header = b""
        while not header.endswith(b"\n"):
            c = self.f.read(1)
            if not c:
                raise EOFError("truncated y4m header")
            header += c
        if not header.startswith(b"YUV4MPEG2"):
            raise ValueError("not a y4m file")
        self.info = VideoInfo()
        for tok in header.decode().split()[1:]:
            tag, val = tok[0], tok[1:]
            if tag == "W":
                self.info.width = int(val)
            elif tag == "H":
                self.info.height = int(val)
            elif tag == "F":
                n, d = val.split(":")
                self.info.fps_num, self.info.fps_denom = int(n), int(d)
            elif tag == "C":
                m = re.match(r"(\d+)(p(\d+))?", val)
                self.info.csp = m.group(1)
                if m.group(3):
                    self.info.bit_depth = int(m.group(3))
            elif tag == "X" and val.startswith("LENGTH="):
                # Patman mod: XLENGTH frame-count tag
                self.info.total_frames = int(val[len("LENGTH="):])
        assert self.info.csp in ("420", "422", "444"), \
            "4:2:0 / 4:2:2 / 4:4:4 only"
        w, h = self.info.width, self.info.height
        self._spp = 2 if self.info.bit_depth > 8 else 1  # bytes per sample
        self._cden = {"420": 4, "422": 2, "444": 1}[self.info.csp]
        self._fsize = (w * h + 2 * (w * h // self._cden)) * self._spp

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        w, h = self.info.width, self.info.height
        dt = np.dtype("<u2") if self._spp == 2 else np.uint8
        while True:
            line = b""
            while not line.endswith(b"\n"):
                c = self.f.read(1)
                if not c:
                    return
                line += c
            if not line.startswith(b"FRAME"):
                raise ValueError("bad frame header")
            data = self.f.read(self._fsize)
            if len(data) < self._fsize:
                return
            buf = np.frombuffer(data, dt)
            cs = w * h // self._cden
            cw = w if self._cden == 1 else w // 2
            chh = h // 2 if self._cden == 4 else h
            y = buf[:w * h].reshape(h, w)
            u = buf[w * h:w * h + cs].reshape(chh, cw)
            v = buf[w * h + cs:].reshape(chh, cw)
            yield y, u, v

    def close(self) -> None:
        self.f.close()


class YUVReader:
    """Raw planar 4:2:0 reader; dimensions supplied by the caller."""

    def __init__(self, path: str, width: int, height: int,
                 fps: Tuple[int, int] = (25, 1)) -> None:
        self.f = open(path, "rb")
        self.info = VideoInfo(width=width, height=height,
                              fps_num=fps[0], fps_denom=fps[1])
        self._fsize = width * height * 3 // 2
        size = os.fstat(self.f.fileno()).st_size
        self.info.total_frames = size // self._fsize

    def __iter__(self):
        w, h = self.info.width, self.info.height
        while True:
            data = self.f.read(self._fsize)
            if len(data) < self._fsize:
                return
            buf = np.frombuffer(data, np.uint8)
            yield (buf[:w * h].reshape(h, w),
                   buf[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
                   buf[w * h * 5 // 4:].reshape(h // 2, w // 2))

    def close(self) -> None:
        self.f.close()


class Y4MWriter:
    """Recon writer (x265 --recon analog), with XLENGTH when known."""

    def __init__(self, path: str, info: VideoInfo) -> None:
        self.f = open(path, "wb")
        self.dt = np.dtype("<u2") if info.bit_depth > 8 else np.uint8
        base = getattr(info, "csp", "420") or "420"
        csp = base if info.bit_depth == 8 else f"{base}p{info.bit_depth}"
        hdr = f"YUV4MPEG2 W{info.width} H{info.height} " \
              f"F{info.fps_num}:{info.fps_denom} Ip A1:1 C{csp}"
        if info.total_frames:
            hdr += f" XLENGTH={info.total_frames}"
        self.f.write((hdr + "\n").encode())

    def write(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> None:
        self.f.write(b"FRAME\n")
        self.f.write(y.astype(self.dt).tobytes())
        self.f.write(u.astype(self.dt).tobytes())
        self.f.write(v.astype(self.dt).tobytes())

    def close(self) -> None:
        self.f.close()


def open_input(path: str, width: int = 0, height: int = 0,
               fps: Tuple[int, int] = (25, 1), avs_library: str = "",
               vs_library: str = ""):
    if path.endswith(".y4m"):
        return Y4MReader(path)
    if path.endswith(".vpy"):
        from .script_input import VPYReader
        return VPYReader(path, library=vs_library)
    if path.endswith(".avs"):
        from .script_input import AVSReader
        return AVSReader(path, library=avs_library)
    assert width and height, "--input-res required for raw yuv"
    return YUVReader(path, width, height, fps)
