"""HDR10+ dynamic metadata: JSON -> SMPTE ST 2094-40 ITU-T T.35 SEI.

Analog of the reference's dynamicHDR10 module (hdr10plus.h,
metadataFromJson.cpp: json11-parsed per-scene metadata packed into
user_data_registered_itu_t_t35 SEI payloads, one per frame).  Consumes
the same JSON schema the reference's --dhdr10-info option does
(SceneInfo records with LuminanceParameters / BezierCurveData).
"""
from __future__ import annotations

import json
from typing import List, Optional

from .bitwriter import BitWriter

SEI_USER_DATA_REGISTERED_T35 = 4

COUNTRY_CODE = 0xB5                 # United States
PROVIDER_CODE = 0x003C              # Samsung (ST 2094-40 carriage)
PROVIDER_ORIENTED_CODE = 0x0001
APPLICATION_ID = 4
APPLICATION_VERSION = 1


def load_dhdr10_json(path: str) -> List[dict]:
    """Per-frame metadata records in display order (SceneInfo array)."""
    with open(path) as f:
        doc = json.load(f)
    return doc.get("SceneInfo", doc if isinstance(doc, list) else [])


def pack_st2094_40(rec: dict) -> bytes:
    """One frame's ST 2094-40 terminal-provider payload."""
    bw = BitWriter()
    bw.u(APPLICATION_ID, 8)
    bw.u(APPLICATION_VERSION, 8)
    num_windows = int(rec.get("NumberOfWindows", 1))
    bw.u(num_windows, 2)
    # processing windows beyond the first carry ellipse geometry —
    # single-window metadata is what the reference's JSONs use
    assert num_windows == 1, "multi-window HDR10+ unsupported"
    tsd = int(rec.get("TargetedSystemDisplayMaximumLuminance", 0))
    bw.u(tsd, 27)
    bw.u(0, 1)                       # targeted..actual_peak_luminance_flag
    lum = rec.get("LuminanceParameters", {})
    maxscl = lum.get("MaxScl", [0, 0, 0])
    for c in range(3):
        bw.u(int(maxscl[c]), 17)
    bw.u(int(lum.get("AverageRGB", 0)), 17)
    dist = lum.get("LuminanceDistributions", {})
    idx = dist.get("DistributionIndex", [])
    val = dist.get("DistributionValues", [])
    bw.u(len(idx), 4)
    for i, v in zip(idx, val):
        bw.u(int(i), 7)
        bw.u(int(v), 17)
    bw.u(0, 10)                      # fraction_bright_pixels
    bw.u(0, 1)                       # mastering..actual_peak_luminance_flag
    bez = rec.get("BezierCurveData")
    bw.u(1 if bez else 0, 1)         # tone_mapping_flag
    if bez:
        bw.u(int(bez.get("KneePointX", 0)), 12)
        bw.u(int(bez.get("KneePointY", 0)), 12)
        anchors = bez.get("Anchors", [])
        bw.u(len(anchors), 4)
        for a in anchors:
            bw.u(int(a), 10)
    bw.u(0, 1)                       # color_saturation_mapping_flag
    bw.byte_align_zero()
    return bw.get_bytes()


def write_dhdr10_sei(rec: dict) -> bytes:
    """Full prefix-SEI RBSP carrying one frame's HDR10+ T.35 payload."""
    from .sei import _sei_rbsp
    body = bytes([COUNTRY_CODE]) + \
        PROVIDER_CODE.to_bytes(2, "big") + \
        PROVIDER_ORIENTED_CODE.to_bytes(2, "big") + pack_st2094_40(rec)
    return _sei_rbsp(SEI_USER_DATA_REGISTERED_T35, body)
