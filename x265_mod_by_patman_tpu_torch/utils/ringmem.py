"""Named cross-process shared-memory ring buffer.

Analog of the reference's RingMem (common/ringmem.cpp: named shm +
semaphores used to share cuTree stats between ABR-ladder processes,
ratecontrol.cpp initCUTreeSharedMem:380).  Built on
multiprocessing.shared_memory with an fcntl file lock standing in for
the reference's named semaphores.

Layout: [head u64][tail u64][capacity u64][rec_size u64] then
capacity * rec_size bytes of payload slots.  Writers block-free drop
when full (the reference's rowInBlocking=false mode).
"""
from __future__ import annotations

import fcntl
import os
import struct
from multiprocessing import shared_memory
from typing import Optional

_HDR = struct.Struct("<QQQQ")


class RingMem:
    def __init__(self, name: str, rec_size: int = 0, capacity: int = 0,
                 create: bool = False) -> None:
        self.name = name
        self._lockpath = f"/tmp/x265tpu_ring_{name}.lock"
        if create:
            size = _HDR.size + rec_size * capacity
            try:
                shared_memory.SharedMemory(name=name,
                                           create=False).unlink()
            except FileNotFoundError:
                pass
            self.shm = shared_memory.SharedMemory(name=name, create=True,
                                                  size=size)
            _HDR.pack_into(self.shm.buf, 0, 0, 0, capacity, rec_size)
            open(self._lockpath, "a").close()
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        _, _, self.capacity, self.rec_size = _HDR.unpack_from(
            self.shm.buf, 0)

    def _locked(fn):
        def wrap(self, *a, **k):
            with open(self._lockpath, "a+") as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                try:
                    return fn(self, *a, **k)
                finally:
                    fcntl.flock(lf, fcntl.LOCK_UN)
        return wrap

    @_locked
    def push(self, rec: bytes) -> bool:
        """Append one record; False when the ring is full (dropped)."""
        assert len(rec) <= self.rec_size
        head, tail, cap, rs = _HDR.unpack_from(self.shm.buf, 0)
        if head - tail >= cap:
            return False
        slot = _HDR.size + (head % cap) * rs
        self.shm.buf[slot:slot + len(rec)] = rec
        if len(rec) < rs:
            self.shm.buf[slot + len(rec):slot + rs] = \
                bytes(rs - len(rec))
        _HDR.pack_into(self.shm.buf, 0, head + 1, tail, cap, rs)
        return True

    @_locked
    def pop(self) -> Optional[bytes]:
        head, tail, cap, rs = _HDR.unpack_from(self.shm.buf, 0)
        if tail >= head:
            return None
        slot = _HDR.size + (tail % cap) * rs
        rec = bytes(self.shm.buf[slot:slot + rs])
        _HDR.pack_into(self.shm.buf, 0, head, tail + 1, cap, rs)
        return rec

    def close(self) -> None:
        self.shm.close()

    def unlink(self) -> None:
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass
        try:
            os.unlink(self._lockpath)
        except FileNotFoundError:
            pass
