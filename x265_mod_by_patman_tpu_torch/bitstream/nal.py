"""NAL unit packaging (Annex B byte streams).

Analog of x265 source/encoder/nal.cpp: header + emulation prevention +
start codes.  NAL unit type constants from spec Table 7-1.
"""
from __future__ import annotations

from .bitwriter import BitWriter, anti_emulation

# nal_unit_type values (spec Table 7-1)
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_TSA_N = 2
NAL_TSA_R = 3
NAL_RASL_N = 8
NAL_RASL_R = 9
NAL_BLA_W_LP = 16
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA_NUT = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_EOS = 36
NAL_EOB = 37
NAL_FD = 38
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


def nal_unit(nal_type: int, rbsp: bytes, temporal_id: int = 0,
             layer_id: int = 0) -> bytes:
    """Build nal_unit_header + EBSP (no start code)."""
    hdr = BitWriter()
    hdr.u(0, 1)                      # forbidden_zero_bit
    hdr.u(nal_type, 6)
    hdr.u(layer_id, 6)
    hdr.u(temporal_id + 1, 3)
    return hdr.get_bytes() + anti_emulation(rbsp)


def annexb(nal_type: int, rbsp: bytes, long_start_code: bool = True,
           temporal_id: int = 0) -> bytes:
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return start + nal_unit(nal_type, rbsp, temporal_id)


def is_irap(nal_type: int) -> bool:
    return NAL_BLA_W_LP <= nal_type <= 23


def is_idr(nal_type: int) -> bool:
    return nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)


def split_annexb(stream: bytes):
    """Split an Annex-B stream into raw NAL units (without start codes).

    Used by the validation decoder and tests.
    """
    units = []
    i = 0
    n = len(stream)
    starts = []
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # strip a trailing zero that belonged to the next 4-byte start code
        while e > s and e - 3 >= 0 and k + 1 < len(starts) and stream[e - 1] == 0 \
                and e - 1 >= starts[k + 1] - 4:
            e -= 1
        units.append(stream[s:e])
    return units


def remove_emulation(ebsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    i = 0
    while i < len(ebsp):
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < len(ebsp) and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)
