"""Command-line encoder app (port of x265_mod_by_patman_tpu/cli.py on
an explicit torch device: --device, "cuda" unless asked for "cpu").

Analog of the reference CLI (x265 source/x265.cpp + x265cli.cpp) with the
x265 option namespace, including the Patman mod's extended progress line:
percent, frames a/b, fps, kb/s, elapsed + ETA, current & estimated final
file size (reference x265cli.cpp:628-690).

Usage:
  python -m x265_mod_by_patman_tpu_torch.cli --input in.y4m --output out.hevc \
      --crf 28 --aq-mode 2 [--frames N] [--recon recon.y4m] \
      [--preset medium] [--device cpu] [k=v ...]
"""
from __future__ import annotations

import argparse
import sys
import time

from .params import default_params
from .encoder.top import Encoder
from .io.y4m import Y4MWriter, open_input


def _fmt_size(nbytes: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if nbytes < 1024 or unit == "GiB":
            return f"{nbytes:.2f} {unit}"
        nbytes /= 1024
    return f"{nbytes:.2f} GiB"


def _fmt_time(seconds: float) -> str:
    s = int(seconds)
    return f"{s // 3600:02d}:{(s % 3600) // 60:02d}:{s % 60:02d}"


def progress_line(done: int, total: int, t0: float, out_bytes: int,
                  fps_num: int, fps_denom: int) -> str:
    """The mod's extended progress bar."""
    elapsed = max(time.time() - t0, 1e-6)
    fps = done / elapsed
    kbps = out_bytes * 8 * fps_num / max(1, fps_denom) / max(done, 1) / 1000
    line = f"[{100 * done / total:5.1f}%] " if total else ""
    line += f"{done}/{total or '?'} frames, {fps:.2f} fps, {kbps:.2f} kb/s"
    line += f", elapsed {_fmt_time(elapsed)}"
    if total and done:
        eta = elapsed * (total - done) / done
        est_size = out_bytes * total / done
        line += f", ETA {_fmt_time(eta)}, {_fmt_size(out_bytes)}" \
                f" (est. {_fmt_size(est_size)})"
    else:
        line += f", {_fmt_size(out_bytes)}"
    return line


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="x265-tpu", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--version", "-V", action="version",
                    version="x265-tpu 0.1 (HEVC encoder, "
                            "PyTorch/CUDA build)")
    ap.add_argument("--input", required=True, help=".y4m or raw .yuv")
    ap.add_argument("--output", "-o", required=True, help="Annex-B .hevc")
    ap.add_argument("--input-res", default=None, help="WxH for raw yuv")
    ap.add_argument("--fps", default="25", help="num or num/denom (raw yuv)")
    ap.add_argument("--frames", "-f", type=int, default=0,
                    help="max frames to encode")
    ap.add_argument("--qp", "-q", type=int, default=32)
    ap.add_argument("--preset", "-p", default=None)
    ap.add_argument("--tune", "-t", default=None)
    ap.add_argument("--recon", "-r", default=None, help="recon .y4m out")
    ap.add_argument("--no-progress", action="store_true")
    ap.add_argument("--psnr", action="store_true",
                    help="compute/report PSNR")
    ap.add_argument("--ssim", action="store_true",
                    help="compute/report SSIM")
    ap.add_argument("--csv", default=None, help="per-frame CSV log")
    ap.add_argument("--csv-log-level", type=int, default=1,
                    help="1 = summary columns, 2 = + CU/MV/VBV frame "
                         "stats (x265 --csv-log-level analog)")
    ap.add_argument("--recon-play", default=None, metavar="CMD",
                    help="pipe display-order recon as y4m into this "
                         "player command (reference reconplay)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to encode on (default cuda; "
                         "no fallback when the card is missing)")
    ap.add_argument("--vmaf", action="store_true",
                    help="compute VMAF of recon vs source (needs a "
                         "vmaf binary on PATH)")
    ap.add_argument("params", nargs="*",
                    help="extra key=value options; any x265-style "
                         "'--key value' / '--key=value' / '--no-key' "
                         "flag is also accepted and routed through "
                         "the x265-namespace param parser")
    return ap


def rewrite_argv(ap, argv):
    """x265 CLI compatibility prepass (shared with the ABR-ladder
    app): rewrite x265-style flags into key=value positionals."""
    # x265 CLI compatibility prepass: rewrite x265-style '--key value'
    # / '--key=value' / '--no-key' flags that argparse doesn't own into
    # 'key=value' positionals for the x265-namespace param parser
    # (x265cli.cpp's long-option table collapses onto x265_param_parse
    # the same way)
    known = set()
    for act in ap._actions:
        known.update(act.option_strings)
    from .params import EncoderParams as _EP
    import dataclasses as _dc
    _fields = {f.name: f.type for f in _dc.fields(_EP)}
    _alias_bools = {"signhide", "cutree", "w", "info"}
    rewritten = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--") or tok.split("=")[0] in known:
            rewritten.append(tok)
            i += 1
            continue
        key = tok[2:]
        if "=" in key:
            k, _, v = key.partition("=")
            rewritten.append(f"{k}={v}")
            i += 1
            continue
        if key.startswith("no-"):
            rewritten.append(f"{key.replace('no-', 'no_', 1)}=1")
            i += 1
            continue
        attr = key.replace("-", "_")
        is_bool = _fields.get(attr) in (bool, "bool") or \
            attr in _alias_bools
        if not is_bool and i + 1 < len(argv) and \
                not argv[i + 1].startswith("--"):
            rewritten.append(f"{key}={argv[i + 1]}")
            i += 2
        else:
            rewritten.append(f"{key}=1")
            i += 1
    return rewritten


def main(argv=None) -> int:
    import sys as _sys
    argv = list(_sys.argv[1:]) if argv is None else list(argv)
    # --abr-ladder <config>: the multi-encode app (reference
    # checkAbrLadder, x265.cpp:93 — the ladder config supersedes the
    # single-encode options on the command line)
    if "--abr-ladder" in argv:
        from .abrenc import run_ladder
        cfg = argv[argv.index("--abr-ladder") + 1]
        return run_ladder(cfg)
    ap = build_parser()
    args = ap.parse_intermixed_args(rewrite_argv(ap, argv))

    w = h = 0
    if args.input_res:
        w, h = (int(t) for t in args.input_res.lower().split("x"))
    fps = (int(float(args.fps) * 1000), 1000) if "/" not in args.fps else \
        tuple(int(t) for t in args.fps.split("/"))
    _libs = {"avs_library": "", "vs_library": ""}
    for kv in args.params:
        k, _, v = kv.partition("=")
        k = k.replace("-", "_")
        if k in _libs:
            _libs[k] = v
    src = open_input(args.input, w, h, fps,
                     avs_library=_libs["avs_library"],
                     vs_library=_libs["vs_library"])
    info = src.info

    p = default_params(info.width, info.height)
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

    enc = Encoder(p, args.device)
    gop_out = None
    out = None
    if args.output.endswith(".gop"):
        # gop+ chunked output (reference output/gop.h): segment files
        # per IDR + index; headers go to their own side file
        from .io.gop_output import GOPOutput
        gop_out = GOPOutput(args.output, p)
        gop_out.write_headers(enc.headers())
        enc._headers_sent = True
    else:
        out = open(args.output, "wb")
    recon_w = Y4MWriter(args.recon, info) if args.recon else None
    rplay = None
    if args.recon_play:
        from .io.reconplay import ReconPlay
        rplay = ReconPlay(args.recon_play, info.width, info.height,
                          info.fps_num, info.fps_denom,
                          p.internal_bit_depth)
    csv = open(args.csv, "w") if args.csv else None
    _STATS2 = ("cu_intra_pct", "cu_inter_pct", "cu_skip_pct",
               "cu_rect_pct", "cu_amp_pct", "avg_mv", "max_mv",
               "vbv_fill_pct")
    if csv:
        hdr = "poc,type,qp,bits,psnr_y,psnr_u,psnr_v,ssim,md5"
        if args.csv_log_level >= 2:
            hdr += "," + ",".join(_STATS2)
        csv.write(hdr + "\n")

    total = args.frames or info.total_frames
    t0 = time.time()
    done = 0
    out_bytes = 0
    want_metrics = args.psnr or args.ssim or csv or args.vmaf
    vmaf_pairs = {} if args.vmaf else None     # disp -> (src, rec)
    srcs = {}                      # disp idx -> (y, u, v) until encoded
    mses = [0.0, 0.0, 0.0]
    npix = [0, 0, 0]
    ssim_sum = 0.0
    qp_sum = 0.0
    if want_metrics:
        from .utils.metrics import frame_mse, psnr as psnr_fn, ssim as \
            ssim_fn, global_psnr

    recon_buf = {}                 # disp idx -> recon planes (reorder)
    next_recon = [0]

    def emit(frames):
        nonlocal done, out_bytes, ssim_sum, qp_sum
        for f in frames:
            if gop_out is not None:
                gop_out.write_frame(f.bitstream,
                                    f.slice_type == "I",
                                    pts=f.disp, dts=done)
            else:
                out.write(f.bitstream)
            out_bytes += len(f.bitstream)
            if rplay is not None:
                rplay.write_picture(f.disp, f.recon)
            if vmaf_pairs is not None and f.disp in srcs:
                vmaf_pairs[f.disp] = (srcs[f.disp], f.recon)
            if recon_w:
                # recon file is display-ordered (reference x265 --recon)
                recon_buf[f.disp] = f.recon
                while next_recon[0] in recon_buf:
                    recon_w.write(*recon_buf.pop(next_recon[0]))
                    next_recon[0] += 1
            qp_sum += f.qp
            py = pu = pv = sv = 0.0
            if want_metrics and f.disp in srcs:
                sy, su, sv_ = srcs.pop(f.disp)
                ry = f.recon[0][:sy.shape[0], :sy.shape[1]]
                ru = f.recon[1][:su.shape[0], :su.shape[1]]
                rv = f.recon[2][:sv_.shape[0], :sv_.shape[1]]
                bd = p.internal_bit_depth
                for i, (a, b) in enumerate(((sy, ry), (su, ru),
                                            (sv_, rv))):
                    mses[i] += frame_mse(a, b)
                    npix[i] += a.size
                py, pu, pv = (psnr_fn(sy, ry, bd), psnr_fn(su, ru, bd),
                              psnr_fn(sv_, rv, bd))
                sv = ssim_fn(sy, ry, bd)
                ssim_sum += sv
            if csv:
                row = (f"{f.poc},{f.slice_type},{f.qp},{f.bits},"
                       f"{py:.4f},{pu:.4f},{pv:.4f},{sv:.6f},"
                       f"{f.md5.hex()}")
                if args.csv_log_level >= 2:
                    row += "," + ",".join(
                        str(f.stats.get(k, "")) for k in _STATS2)
                csv.write(row + "\n")
            done += 1
            if not args.no_progress:
                sys.stderr.write("\r" + progress_line(
                    done, total, t0, out_bytes, info.fps_num,
                    info.fps_denom))
                sys.stderr.flush()

    fed = 0
    for (y, u, v) in src:
        if want_metrics:
            srcs[fed] = (y, u, v)
        emit(enc.encode_frame(y, u, v))
        fed += 1
        if args.frames and fed >= args.frames:
            break
    emit(enc.flush())
    enc.write_stats()
    if not args.no_progress:
        sys.stderr.write("\n")
    elapsed = time.time() - t0
    # x265-style summary line (reference encoder.cpp printSummary)
    line = (f"encoded {done} frames in {elapsed:.2f}s "
            f"({done / max(elapsed, 1e-6):.2f} fps), "
            f"{out_bytes * 8 * info.fps_num / max(1, info.fps_denom) / max(done, 1) / 1000:.2f} kb/s, "
            f"Avg QP:{qp_sum / max(done, 1):.2f}")
    if args.psnr and sum(npix):
        bd = p.internal_bit_depth
        gp = [global_psnr([m], n, bd) for m, n in zip(mses, npix)]
        gall = global_psnr(mses, sum(npix), bd)
        line += (f", Global PSNR: {gall:.3f} "
                 f"(Y:{gp[0]:.3f} U:{gp[1]:.3f} V:{gp[2]:.3f})")
    if args.ssim and done:
        import math
        ms = ssim_sum / done
        db = -10.0 * math.log10(max(1.0 - ms, 1e-10))
        line += f", SSIM Mean Y: {ms:.7f} ({db:.3f} dB)"
    if vmaf_pairs:
        from .utils.vmaf import compute_vmaf
        pairs = [vmaf_pairs[d] for d in sorted(vmaf_pairs)]
        score = compute_vmaf([s for s, _ in pairs],
                             [r for _, r in pairs],
                             info.width, info.height,
                             p.internal_bit_depth)
        line += f", VMAF: {score:.4f}"
    sys.stderr.write(line + "\n")
    if gop_out is not None:
        gop_out.close()
    else:
        out.close()
    if rplay is not None:
        rplay.close()
    src.close()
    if recon_w:
        recon_w.close()
    if csv:
        csv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
