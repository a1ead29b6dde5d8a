"""Profile/tier/level determination and enforcement (spec Annex A).

Analog of the reference's encoder/level.cpp:45 LevelSpec table and
determineLevel(): pick the smallest level whose luma-samples,
samples-per-second, bitrate and DPB constraints the configuration
fits, choose the tier from the VBV rate, and clamp reference counts
to the A.4.2 MaxDpbSize."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

MAX = float("inf")


@dataclass(frozen=True)
class LevelSpec:
    max_luma_samples: int
    max_luma_samples_per_sec: float
    max_bitrate_main: float          # kbps
    max_bitrate_high: float
    max_cpb_main: float              # kbit
    max_cpb_high: float
    max_dpb_pic_buf: int
    name: str
    idc: int                         # general_level_idc (level * 30)


# spec Table A.8/A.9 (values match reference level.cpp:45; levels 6.3+
# are the reference's 8K extensions)
LEVELS = (
    LevelSpec(36864, 552960, 128, MAX, 350, MAX, 2, "1", 30),
    LevelSpec(122880, 3686400, 1500, MAX, 1500, MAX, 2, "2", 60),
    LevelSpec(245760, 7372800, 3000, MAX, 3000, MAX, 2, "2.1", 63),
    LevelSpec(552960, 16588800, 6000, MAX, 6000, MAX, 2, "3", 90),
    LevelSpec(983040, 33177600, 10000, MAX, 10000, MAX, 2, "3.1", 93),
    LevelSpec(2228224, 66846720, 12000, 30000, 12000, 30000, 4,
              "4", 120),
    LevelSpec(2228224, 133693440, 20000, 50000, 20000, 50000, 4,
              "4.1", 123),
    LevelSpec(8912896, 267386880, 25000, 100000, 25000, 100000, 6,
              "5", 150),
    LevelSpec(8912896, 534773760, 40000, 160000, 40000, 160000, 8,
              "5.1", 153),
    LevelSpec(8912896, 1069547520, 60000, 240000, 60000, 240000, 8,
              "5.2", 156),
    LevelSpec(35651584, 1069547520, 60000, 240000, 60000, 240000, 8,
              "6", 180),
    LevelSpec(35651584, 2139095040, 120000, 480000, 120000, 480000, 8,
              "6.1", 183),
    LevelSpec(35651584, 4278190080, 240000, 800000, 240000, 800000, 6,
              "6.2", 186),
)


def max_dpb_size(pic_samples: int, max_luma_ps: int) -> int:
    """A.4.2 MaxDpbSize with maxDpbPicBuf = 6."""
    if pic_samples <= (max_luma_ps >> 2):
        return min(4 * 6, 16)
    if pic_samples <= (max_luma_ps >> 1):
        return min(2 * 6, 16)
    if pic_samples <= (3 * max_luma_ps) >> 2:
        return min((4 * 6) // 3, 16)
    return 6


def level_name(idc: int) -> str:
    for lv in LEVELS:
        if lv.idc == idc:
            return lv.name
    return str(idc / 30.0)


def determine_level(width: int, height: int, fps: float,
                    vbv_maxrate_kbps: int = 0, vbv_bufsize_kbit: int = 0,
                    n_refs: int = 1, forced_idc: int = 0
                    ) -> Tuple[int, bool, int]:
    """Returns (general_level_idc, high_tier, dpb_limit).

    With forced_idc (--level-idc), verifies the configuration fits and
    raises ValueError when it cannot (the reference logs and fails the
    open, api.cpp -> Encoder::configure)."""
    samples = width * height
    sps = samples * fps
    for lv in LEVELS:
        if forced_idc and lv.idc != forced_idc:
            continue
        if samples > lv.max_luma_samples or sps > lv.max_luma_samples_per_sec:
            if forced_idc:
                raise ValueError(
                    f"level {lv.name}: picture rate exceeds limits")
            continue
        # spec A.4.1: width/height each <= sqrt(8 * MaxLumaPs)
        if width * width > 8 * lv.max_luma_samples or \
                height * height > 8 * lv.max_luma_samples:
            if forced_idc:
                raise ValueError(f"level {lv.name}: dimension too large")
            continue
        dpb = max_dpb_size(samples, lv.max_luma_samples)
        if n_refs + 1 > dpb:
            if forced_idc:
                raise ValueError(
                    f"level {lv.name}: {n_refs} references exceed "
                    f"MaxDpbSize {dpb}")
            continue
        high = False
        if vbv_maxrate_kbps > lv.max_bitrate_main or \
                vbv_bufsize_kbit > lv.max_cpb_main:
            if vbv_maxrate_kbps <= lv.max_bitrate_high and \
                    vbv_bufsize_kbit <= lv.max_cpb_high:
                high = True
            else:
                if forced_idc:
                    raise ValueError(
                        f"level {lv.name}: VBV rate exceeds high tier")
                continue
        return lv.idc, high, dpb
    raise ValueError("no HEVC level fits this configuration")
