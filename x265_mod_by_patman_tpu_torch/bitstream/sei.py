"""SEI message writers/parsers (spec Annex D).

Analog of x265's SEI class zoo (source/encoder/sei.h): the
decoded-picture-hash (MD5) message — the bit-exactness mechanism the
whole validation strategy hangs on (reference sei.h:729,
frameencoder.cpp:1343) — plus HDR signalling (mastering display
sei.h:676, content light level sei.h:712), user-data-unregistered
encoder info (sei.h:392) and recovery point (sei.h:867).
"""
from __future__ import annotations

import hashlib

from .bitwriter import BitWriter
from .bitreader import BitReader

SEI_RECOVERY_POINT = 6
SEI_USER_DATA_UNREGISTERED = 5
SEI_FILM_GRAIN_CHARACTERISTICS = 19
SEI_DECODED_PICTURE_HASH = 132
SEI_MASTERING_DISPLAY = 137
SEI_CONTENT_LIGHT_LEVEL = 144
HASH_MD5 = 0

# x265's user-data UUID (public constant in the bitstream of every x265
# encode; sei.h SEIuserDataUnregistered)
X265_USER_DATA_UUID = bytes((
    0x2C, 0xA2, 0xDE, 0x09, 0xB5, 0x17, 0x47, 0xDB,
    0xBB, 0x55, 0xA4, 0xFE, 0x7F, 0xC2, 0xFC, 0x4E))


def _sei_rbsp(ptype: int, payload: bytes) -> bytes:
    """Wrap one SEI payload into an RBSP (payload type/size coding)."""
    bw = BitWriter()
    t = ptype
    while t >= 255:
        bw.u(255, 8)
        t -= 255
    bw.u(t, 8)
    size = len(payload)
    while size >= 255:
        bw.u(255, 8)
        size -= 255
    bw.u(size, 8)
    for b in payload:
        bw.u(b, 8)
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def parse_master_display(s: str):
    """x265 --master-display string:
    G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min) with 0.00002-unit primaries and
    0.0001-nit luminance (reference param.cpp parsing)."""
    import re
    m = re.match(r"G\((\d+),(\d+)\)B\((\d+),(\d+)\)R\((\d+),(\d+)\)"
                 r"WP\((\d+),(\d+)\)L\((\d+),(\d+)\)", s)
    if not m:
        raise ValueError(f"bad master-display string {s!r}")
    return tuple(int(g) for g in m.groups())


def write_mastering_display(vals) -> bytes:
    """vals: (gx, gy, bx, by, rx, ry, wx, wy, lmax, lmin).  Spec order is
    display_primaries[0..2] = G, B, R (matches the CLI string)."""
    bw = BitWriter()
    for v in vals[:8]:
        bw.u(v, 16)
    bw.u(vals[8], 32)
    bw.u(vals[9], 32)
    return _sei_rbsp(SEI_MASTERING_DISPLAY, bw.get_bytes())


def write_content_light_level(max_cll: int, max_fall: int) -> bytes:
    bw = BitWriter()
    bw.u(max_cll, 16)
    bw.u(max_fall, 16)
    return _sei_rbsp(SEI_CONTENT_LIGHT_LEVEL, bw.get_bytes())


def write_user_data_info(text: str) -> bytes:
    """Encoder-info user data (x265 writes its param2string here)."""
    return _sei_rbsp(SEI_USER_DATA_UNREGISTERED,
                     X265_USER_DATA_UUID + text.encode())


def parse_film_grain_json(path: str) -> dict:
    """Load a film-grain characteristics description (JSON).

    The reference feeds this SEI from a packed binary side-file
    (frameencoder.h:120 FilmGrain + ColourDescription + per-component
    intensity intervals, --film-grain); here the same fields arrive as
    JSON — documented deviation, same SEI on the wire.  Schema:
    {"model_id":0, "blending_mode_id":0, "log2_scale_factor":4,
     "comp_models": [  # up to 3 entries (Y, Cb, Cr); null = absent
        {"num_model_values":1, "intervals": [
            {"lower":0, "upper":255, "values":[64]} ]} , null, null]}
    """
    import json
    with open(path) as f:
        return json.load(f)


def write_film_grain(fg: dict) -> bytes:
    """film_grain_characteristics SEI (spec D.2.21 / D.3.21; reference
    sei.h:77 FilmGrainCharacteristics::writeSEI field-for-field)."""
    bw = BitWriter()
    cancel = bool(fg.get("cancel", False))
    bw.flag(cancel)
    if not cancel:
        bw.u(int(fg.get("model_id", 0)), 2)
        sep = "bit_depth_luma" in fg
        bw.flag(sep)
        if sep:
            bw.u(int(fg.get("bit_depth_luma", 8)) - 8, 3)
            bw.u(int(fg.get("bit_depth_chroma", 8)) - 8, 3)
            bw.flag(bool(fg.get("full_range", False)))
            bw.u(int(fg.get("colour_primaries", 2)), 8)
            bw.u(int(fg.get("transfer_characteristics", 2)), 8)
            bw.u(int(fg.get("matrix_coeffs", 2)), 8)
        bw.u(int(fg.get("blending_mode_id", 0)), 2)
        bw.u(int(fg.get("log2_scale_factor", 0)), 4)
        comps = list(fg.get("comp_models", []))[:3]
        comps += [None] * (3 - len(comps))
        for c in comps:
            bw.flag(bool(c and c.get("intervals")))
        for c in comps:
            if not (c and c.get("intervals")):
                continue
            iv = c["intervals"]
            nmv = int(c.get("num_model_values",
                            len(iv[0]["values"]) if iv else 1))
            bw.u(len(iv) - 1, 8)     # num_intensity_intervals_minus1
            bw.u(nmv - 1, 3)         # num_model_values_minus1
            for it in iv:
                bw.u(int(it["lower"]), 8)
                bw.u(int(it["upper"]), 8)
                vals = list(it["values"])[:nmv]
                vals += [0] * (nmv - len(vals))
                for v in vals:
                    bw.se(int(v))
        bw.flag(bool(fg.get("persistence", True)))
    bw.rbsp_trailing_bits()      # sei payload byte alignment (D.3.21)
    return _sei_rbsp(SEI_FILM_GRAIN_CHARACTERISTICS, bw.get_bytes())


def parse_film_grain(payload: bytes) -> dict:
    """Round-trip parser for the validation side."""
    br = BitReader(payload)
    out: dict = {"cancel": bool(br.flag())}
    if out["cancel"]:
        return out
    out["model_id"] = br.u(2)
    if br.flag():
        out["bit_depth_luma"] = br.u(3) + 8
        out["bit_depth_chroma"] = br.u(3) + 8
        out["full_range"] = bool(br.flag())
        out["colour_primaries"] = br.u(8)
        out["transfer_characteristics"] = br.u(8)
        out["matrix_coeffs"] = br.u(8)
    out["blending_mode_id"] = br.u(2)
    out["log2_scale_factor"] = br.u(4)
    present = [bool(br.flag()) for _ in range(3)]
    comps = []
    for pr in present:
        if not pr:
            comps.append(None)
            continue
        n_iv = br.u(8) + 1
        nmv = br.u(3) + 1
        ivs = []
        for _ in range(n_iv):
            lo, hi = br.u(8), br.u(8)
            vals = [br.se() for _ in range(nmv)]
            ivs.append({"lower": lo, "upper": hi, "values": vals})
        comps.append({"num_model_values": nmv, "intervals": ivs})
    out["comp_models"] = comps
    out["persistence"] = bool(br.flag())
    return out


def write_recovery_point(recovery_poc_cnt: int = 0,
                         exact_match: bool = True) -> bytes:
    bw = BitWriter()
    bw.se(recovery_poc_cnt)
    bw.u(1 if exact_match else 0, 1)     # exact_match_flag
    bw.u(0, 1)                           # broken_link_flag
    # payload must be byte-aligned: bit_equal_to_one + zeros
    bw.u(1, 1)
    while not bw.byte_aligned:
        bw.u(0, 1)
    return _sei_rbsp(SEI_RECOVERY_POINT, bw.get_bytes())


def write_buffering_period(initial_delay_90k: int,
                           initial_offset_90k: int) -> bytes:
    """Buffering-period SEI (D.2.2; reference SEIBufferingPeriod,
    sei.h:796): one NAL-HRD CPB, no sub-pic params.  Delays in 90 kHz
    units with the 24-bit field length signaled in hrd_parameters."""
    from .headers import HRD_INIT_LEN, HRD_AU_LEN
    bw = BitWriter()
    bw.ue(0)                              # bp_seq_parameter_set_id
    bw.flag(0)                            # irap_cpb_params_present_flag
    bw.flag(0)                            # concatenation_flag
    bw.u(0, HRD_AU_LEN)                   # au_cpb_removal_delay_delta_m1
    bw.u(initial_delay_90k, HRD_INIT_LEN)
    bw.u(initial_offset_90k, HRD_INIT_LEN)
    bw.rbsp_trailing_bits()
    return _sei_rbsp(0, bw.get_bytes())


def write_pic_timing(au_cpb_removal_delay_minus1: int = None,
                     pic_dpb_output_delay: int = 0,
                     pic_struct: int = None) -> bytes:
    """Picture-timing SEI (D.2.3; reference SEIPictureTiming,
    sei.h:830): the frame_field_info block (pic_struct /
    source_scan_type / duplicate_flag — interlace signaling) and/or
    the CpbDpbDelays block, per what the VUI declared."""
    bw = BitWriter()
    if pic_struct is not None:
        bw.u(pic_struct, 4)
        bw.u(0, 2)                    # source_scan_type: interlaced
        bw.flag(0)                    # duplicate_flag
    if au_cpb_removal_delay_minus1 is not None:
        from .headers import HRD_AU_LEN, HRD_DPB_LEN
        bw.u(au_cpb_removal_delay_minus1, HRD_AU_LEN)
        bw.u(pic_dpb_output_delay, HRD_DPB_LEN)
    bw.rbsp_trailing_bits()
    return _sei_rbsp(1, bw.get_bytes())


def plane_md5(*planes, bit_depth: int = 8) -> bytes:
    """Concatenated per-plane MD5 of decoded samples (spec D.3.19: one
    byte per sample for 8-bit, little-endian 16-bit above)."""
    out = b""
    for p in planes:
        if bit_depth > 8:
            out += hashlib.md5(p.astype("<u2").tobytes()).digest()
        else:
            out += hashlib.md5(p.astype("uint8").tobytes()).digest()
    return out


def write_decoded_picture_hash(md5_planes: bytes) -> bytes:
    """RBSP of a suffix SEI carrying hash_type=MD5 + per-plane digests."""
    bw = BitWriter()
    payload = bytes([HASH_MD5]) + md5_planes
    bw.u(SEI_DECODED_PICTURE_HASH, 8)
    size = len(payload)
    while size >= 255:
        bw.u(255, 8)
        size -= 255
    bw.u(size, 8)
    for b in payload:
        bw.u(b, 8)
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def parse_sei(rbsp: bytes):
    """Parse SEI messages -> list of (payload_type, payload bytes)."""
    br = BitReader(rbsp)
    out = []
    while True:
        ptype = 0
        while True:
            b = br.u(8)
            ptype += b
            if b != 255:
                break
        psize = 0
        while True:
            b = br.u(8)
            psize += b
            if b != 255:
                break
        payload = bytes(br.u(8) for _ in range(psize))
        out.append((ptype, payload))
        if not br.more_rbsp_data():
            break
    return out
