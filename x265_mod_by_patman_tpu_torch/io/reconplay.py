"""Reconstruction playback pipe (reference output/reconplay.cpp).

Spawns a player command line and streams the encoder's reconstructed
pictures to its stdin as y4m, in display order with a bounded reorder
buffer — so `--recon-play 'ffplay -'` shows the encode live, exactly
like the reference's ReconPlay thread."""
from __future__ import annotations

import shlex
import subprocess
from typing import Dict, Optional

import numpy as np


class ReconPlay:
    RECON_BUF_SIZE = 40              # reference reconplay.h:49

    def __init__(self, command: str, width: int, height: int,
                 fps_num: int, fps_denom: int,
                 bit_depth: int = 8) -> None:
        self.proc = subprocess.Popen(
            shlex.split(command), stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        csp = "420" if bit_depth == 8 else f"420p{bit_depth}"
        hdr = (f"YUV4MPEG2 W{width} H{height} "
               f"F{fps_num}:{fps_denom} Ip A1:1 C{csp}\n")
        self._w(hdr.encode())
        self._next = 0
        self._buf: Dict[int, tuple] = {}
        self.alive = True

    def _w(self, data: bytes) -> None:
        try:
            self.proc.stdin.write(data)
        except (BrokenPipeError, OSError):
            self.alive = False

    def write_picture(self, disp: int, planes) -> None:
        """Buffer decode-order pictures; flush contiguous display
        order (the reference's poc-indexed ring)."""
        if not self.alive:
            return
        self._buf[disp] = planes
        while self._next in self._buf:
            y, u, v = self._buf.pop(self._next)
            self._w(b"FRAME\n")
            for pl in (y, u, v):
                self._w(np.ascontiguousarray(pl).tobytes())
            self._next += 1
        if len(self._buf) > self.RECON_BUF_SIZE:   # runaway reorder
            self._buf.clear()
            self.alive = False

    def close(self) -> None:
        try:
            self.proc.stdin.close()
        except Exception:
            pass
        try:
            self.proc.wait(timeout=5)
        except Exception:
            self.proc.kill()
