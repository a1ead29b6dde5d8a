"""ABR-ladder multi-encode app (port of x265_mod_by_patman_tpu/abrenc.py
on a torch device; reference abrEncApp.cpp AbrEncoder +
x265.cpp:93-161 checkAbrLadder/parseAbrConfig).

Invoked through the main CLI as

  python -m x265_mod_by_patman_tpu_torch.cli --abr-ladder ladder.conf

where every non-comment line of `ladder.conf` is a full single-encode
command line (the reference's format), e.g.::

  # rung 0 (master): full res, drives the shared lookahead
  --input in.y4m -o out_1080.hevc --preset fast --crf 22 cutree-share-write=ladder0
  --input in.y4m -o out_720.hevc --input-res 1280x720 --preset fast --crf 24 cutree-share-read=ladder0
  --input in.y4m -o out_360.hevc --input-res 640x360 --preset fast --crf 26 cutree-share-read=ladder0

All lines must name the same --input and the same --device (default
cuda): the source is read ONCE and each rung consumes a shared
(per-resolution polyphase-scaled, on that device) copy — the
reference's shared Reader thread + Scaler.  `--input-res` on a rung
line selects the rung's encode resolution.  cuTree sharing between the
master and slave rungs rides the RingMem params (cutree_share_write /
cutree_share_read), exactly as the library-level
`parallel.ladder.AbrLadder` wires it.

Two departures from the reference: a scaled rung is scaled at the
rung's own bit depth (the reference scales at 8 bits and so clips a
10- or 12-bit source at 255), and a rung whose resolution differs from
the source's is refused outside 4:2:0 (the scaler is 4:2:0-only; the
reference hands the encoder chroma of the wrong shape).
"""
from __future__ import annotations

import shlex
import sys
import time
from typing import List


def _params_for(args, info, w, h):
    from .params import default_params
    p = default_params(w, h)
    p.fps_num, p.fps_denom = info.fps_num, info.fps_denom
    p.total_frames = info.total_frames
    if getattr(info, "csp", "420") == "444":
        p.internal_csp = 3
    elif getattr(info, "csp", "420") == "422":
        p.internal_csp = 2
    if getattr(info, "bit_depth", 8) > 8:
        p.internal_bit_depth = info.bit_depth
    if args.preset:
        p.apply_preset(args.preset)
    if args.tune:
        p.apply_tune(args.tune)
    p.qp = args.qp
    p.rc_mode = "cqp"
    for kv in args.params:
        k, _, v = kv.partition("=")
        p.parse(k, v or "1")
    return p


def run_ladder(config_path: str) -> int:
    from .cli import build_parser, rewrite_argv, progress_line
    from .encoder.top import Encoder
    from .io.y4m import open_input
    from .parallel.ladder import close_shares
    from .utils.scaler import scale_frame

    ap = build_parser()
    with open(config_path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.strip().startswith("#")]
    if not lines:
        print(f"abr-ladder: no encodes in {config_path}",
              file=sys.stderr)
        return 1
    rungs = [ap.parse_intermixed_args(rewrite_argv(ap, shlex.split(ln)))
             for ln in lines]
    if len({r.input for r in rungs}) != 1:
        print("abr-ladder: all rungs must share one --input "
              "(the shared-reader design)", file=sys.stderr)
        return 1
    if len({r.device for r in rungs}) != 1:
        print("abr-ladder: all rungs must name one --device",
              file=sys.stderr)
        return 1
    device = rungs[0].device

    src = open_input(rungs[0].input, 0, 0, (25, 1))
    info = src.info
    encs: List[Encoder] = []
    dims = []
    outs = []
    try:
        for r in rungs:
            if r.input_res:
                w, h = (int(t) for t in r.input_res.lower().split("x"))
            else:
                w, h = info.width, info.height
            p = _params_for(r, info, w, h).validate()
            if (w, h) != (info.width, info.height) and \
                    p.internal_csp != 1:
                raise NotImplementedError(
                    "not ported: a scaled --abr-ladder rung outside 4:2:0 "
                    f"({r.output}: {info.width}x{info.height} -> {w}x{h}; "
                    "the scaler is 4:2:0-only)")
            encs.append(Encoder(p, device))
            dims.append((w, h))
            outs.append(open(r.output, "wb"))

        t0 = time.time()
        done = [0] * len(rungs)
        out_bytes = [0] * len(rungs)
        total = (rungs[0].frames or info.total_frames)
        fed = 0
        show = not any(getattr(r, "no_progress", False) for r in rungs)

        def feed(i, planes):
            for f in encs[i].encode_frame(*planes):
                out_bytes[i] += len(f.bitstream)
                outs[i].write(f.bitstream)
                done[i] += 1

        for planes in src:
            for i, (w, h) in enumerate(dims):
                if (w, h) != (info.width, info.height):
                    planes_i = scale_frame(planes, w, h,
                                           encs[i].p.internal_bit_depth,
                                           device)
                else:
                    planes_i = planes
                feed(i, planes_i)
            fed += 1
            if show and fed % 5 == 0:
                line = progress_line(sum(done), total * len(rungs), t0,
                                     sum(out_bytes), info.fps_num,
                                     info.fps_denom)
                print("\r" + line, end="", file=sys.stderr, flush=True)
            if rungs[0].frames and fed >= rungs[0].frames:
                break
        for i, enc in enumerate(encs):
            for f in enc.flush():
                out_bytes[i] += len(f.bitstream)
                outs[i].write(f.bitstream)
                done[i] += 1
    finally:
        for f in outs:
            f.close()
        close_shares(encs)
    if show:
        print("", file=sys.stderr)
    elapsed = max(time.time() - t0, 1e-6)
    for i, r in enumerate(rungs):
        kbps = out_bytes[i] * 8 * info.fps_num / info.fps_denom \
            / max(done[i], 1) / 1000.0
        print(f"rung {i}: {r.output} {dims[i][0]}x{dims[i][1]} "
              f"{done[i]} frames, {kbps:.2f} kb/s, "
              f"{done[i] / elapsed:.2f} fps")
    return 0
