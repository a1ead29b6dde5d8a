"""Lightweight phase tracing (Chrome trace-event format).

Analog of the reference's opt-in PPA/VTune instrumentation
(source/profile/, ProfileScopeEvent macros in common/common.h:51-66 and
the event list in profile/cpuEvents.h): scoped events around the
encoder's phases, written as a chrome://tracing / Perfetto-loadable
JSON when X265TPU_TRACE=<path> is set; zero overhead otherwise.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import List

_events: List[dict] = []
_path = os.environ.get("X265TPU_TRACE")
_lock = threading.Lock()
_t0 = time.perf_counter()


def enabled() -> bool:
    return _path is not None


@contextmanager
def scope(name: str, **args):
    """Scoped duration event (frameRead/ME/wavefront/CABAC/...)."""
    if _path is None:
        yield
        return
    start = (time.perf_counter() - _t0) * 1e6
    try:
        yield
    finally:
        end = (time.perf_counter() - _t0) * 1e6
        with _lock:
            _events.append({
                "name": name, "ph": "X", "ts": start,
                "dur": end - start, "pid": os.getpid(),
                "tid": threading.get_ident() % 100000,
                "args": args or {},
            })


def instant(name: str, **args) -> None:
    if _path is None:
        return
    with _lock:
        _events.append({
            "name": name, "ph": "i", "s": "g",
            "ts": (time.perf_counter() - _t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() % 100000,
            "args": args or {},
        })


def _flush() -> None:
    if _path and _events:
        with open(_path, "w") as f:
            json.dump({"traceEvents": _events}, f)


atexit.register(_flush)
