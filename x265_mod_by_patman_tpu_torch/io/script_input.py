"""Script inputs: AviSynth (.avs) and VapourSynth (.vpy).

Analog of the reference's input/avs.cpp (AVS+ dynamic loading, frame
server hand-off) and the common VapourSynth pipe usage: the loaders
bind the frame-server runtime when it is present on this machine and
fail with an actionable error when it is not (the reference likewise
degrades: avs.cpp:78 logs 'AVS+ library not found' and rejects the
input).  Both yield (y, u, v) planes and a VideoInfo like the y4m
reader, so `open_input` treats every source uniformly."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from .y4m import VideoInfo


class VPYReader:
    """VapourSynth script input (.vpy): evaluates the script and
    iterates the output node's frames."""

    def __init__(self, path: str, library: str = "") -> None:
        if library:
            # Patman mod --vs-library: preload a user-specified VSScript
            # runtime before importing the module (avs.h:92-104 analog)
            import ctypes
            ctypes.CDLL(library)
        try:
            import vapoursynth as vs
        except ImportError as exc:
            raise RuntimeError(
                "VapourSynth runtime not available — install the "
                "vapoursynth python module to use .vpy inputs "
                "(reference: VPY input support)") from exc
        core = vs.core
        env = {}
        with open(path) as f:
            exec(compile(f.read(), path, "exec"), env)
        clip = env.get("clip")
        if clip is None:
            import vapoursynth as vs2
            clip = vs2.get_output(0)
        self.clip = clip
        self.info = VideoInfo()
        self.info.width = clip.width
        self.info.height = clip.height
        self.info.fps_num = clip.fps.numerator
        self.info.fps_denom = clip.fps.denominator
        self.info.total_frames = clip.num_frames
        self.info.bit_depth = clip.format.bits_per_sample

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        for frame in self.clip.frames():
            planes = [np.asarray(frame[i]) for i in range(3)]
            yield tuple(planes)

    def close(self) -> None:
        pass


class _AVSValue:
    """AVS_Value (avisynth_c.h): {short type; short array_size;
    union d} — built lazily so importing this module never needs
    ctypes structure setup."""


def _avs_value_struct():
    import ctypes

    class AVSValue(ctypes.Structure):
        _fields_ = [("type", ctypes.c_short),
                    ("array_size", ctypes.c_short),
                    ("d", ctypes.c_void_p)]
    return AVSValue


class AVSReader:
    """AviSynth script input (.avs) via the avisynth C API, bound with
    ctypes (the reference's dynamic loading in input/avs.cpp:78
    h->func.avs_* table): create a script environment, Import the
    script, take the clip, and serve planar YUV frames through
    avs_get_frame / avs_get_read_ptr_p."""

    def __init__(self, path: str, library: str = "") -> None:
        import ctypes
        import ctypes.util
        # Patman mod --avs-library: user-specified AVS+ runtime path
        # takes precedence over system discovery (avs.cpp:78-79)
        lib = library or (ctypes.util.find_library("avisynth")
                          or ctypes.util.find_library("AviSynth"))
        if not lib:
            raise RuntimeError(
                "AviSynth+ library not found — install AVS+ to use "
                ".avs inputs (reference input/avs.cpp:78 rejects the "
                "input the same way)")
        L = ctypes.CDLL(lib)
        AVSValue = _avs_value_struct()
        self._ct = ctypes
        self._AVSValue = AVSValue
        self._L = L
        L.avs_create_script_environment.restype = ctypes.c_void_p
        L.avs_create_script_environment.argtypes = [ctypes.c_int]
        L.avs_invoke.restype = AVSValue
        L.avs_invoke.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 AVSValue, ctypes.c_void_p]
        L.avs_take_clip.restype = ctypes.c_void_p
        L.avs_take_clip.argtypes = [AVSValue, ctypes.c_void_p]
        L.avs_get_video_info.restype = ctypes.POINTER(ctypes.c_int)
        L.avs_get_video_info.argtypes = [ctypes.c_void_p]
        L.avs_get_frame.restype = ctypes.c_void_p
        L.avs_get_frame.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for name, res, args in (
                ("avs_get_pitch_p", ctypes.c_int,
                 [ctypes.c_void_p, ctypes.c_int]),
                ("avs_get_row_size_p", ctypes.c_int,
                 [ctypes.c_void_p, ctypes.c_int]),
                ("avs_get_height_p", ctypes.c_int,
                 [ctypes.c_void_p, ctypes.c_int]),
                ("avs_release_video_frame", None, [ctypes.c_void_p]),
                ("avs_release_clip", None, [ctypes.c_void_p]),
                ("avs_release_value", None, [AVSValue])):
            f = getattr(L, name, None)
            if f is not None:
                f.restype = res
                f.argtypes = args
        L.avs_get_read_ptr_p.restype = ctypes.POINTER(ctypes.c_ubyte)
        L.avs_get_read_ptr_p.argtypes = [ctypes.c_void_p, ctypes.c_int]
        self.env = L.avs_create_script_environment(6)
        if not self.env:
            raise RuntimeError("AVS+ environment creation failed")
        arg = AVSValue()
        arg.type = ord("s")
        arg.d = ctypes.cast(ctypes.c_char_p(path.encode()),
                            ctypes.c_void_p)
        res = L.avs_invoke(self.env, b"Import", arg, None)
        if res.type == ord("e"):
            msg = ctypes.cast(res.d, ctypes.c_char_p).value
            raise RuntimeError(f"AVS Import failed: {msg!r}")
        if res.type != ord("c"):
            raise RuntimeError("AVS script did not return a clip")
        self.clip = L.avs_take_clip(res, self.env)
        # AVS_VideoInfo head: int width, height; unsigned fps_num,
        # fps_den; int num_frames; int pixel_type (avisynth_c.h)
        vi = L.avs_get_video_info(self.clip)
        self._vi = vi
        self.info = VideoInfo()
        self.info.width = vi[0]
        self.info.height = vi[1]
        self.info.fps_num = vi[2]
        self.info.fps_denom = vi[3]
        self.info.total_frames = vi[4]
        bpc = getattr(L, "avs_bits_per_component", None)
        if bpc is not None:
            bpc.restype = ctypes.c_int
            bpc.argtypes = [ctypes.POINTER(ctypes.c_int)]
            self.info.bit_depth = int(bpc(vi)) or 8
        else:
            self.info.bit_depth = 8

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        ct = self._ct
        L = self._L
        PLANES = (1 << 0, 1 << 1, 1 << 2)        # AVS_PLANAR_Y/U/V
        bps = 2 if self.info.bit_depth > 8 else 1
        dt = np.uint16 if bps == 2 else np.uint8
        for n in range(self.info.total_frames):
            fr = L.avs_get_frame(self.clip, n)
            if not fr:
                raise RuntimeError(f"avs_get_frame({n}) failed")
            planes = []
            for pl in PLANES:
                pitch = L.avs_get_pitch_p(fr, pl)
                rows = L.avs_get_height_p(fr, pl)
                rowsz = L.avs_get_row_size_p(fr, pl)
                ptr = L.avs_get_read_ptr_p(fr, pl)
                buf = np.ctypeslib.as_array(ptr, (rows, pitch))
                planes.append(buf[:, :rowsz].copy().view(dt)
                              .reshape(rows, rowsz // bps))
            rel = getattr(L, "avs_release_video_frame", None)
            if rel is not None:
                rel(fr)
            yield tuple(planes)

    def close(self) -> None:
        rel = getattr(self._L, "avs_release_clip", None)
        if rel is not None and getattr(self, "clip", None):
            rel(self.clip)
            self.clip = None
