"""Command-line apps of the port (counterpart of gf3x/cli.py): gf3x's
subcommands, options and exit codes, on the card unless `--device cpu`.

    gf3x-torch transmit FILE -o tx.wav [--preset gf3] [--play]
    gf3x-torch receive rx.wav [-o DIR] [--preset gf3] [--json]
    gf3x-torch sweep --snrs 0 2 4 6 8 [--preset gf3] [--trials 16]
    gf3x-torch adapt probe.wav -o table.json [--margin 2]
    gf3x-torch info [--preset gf3]
    gf3x-torch bench [--batch 1024]
    (or python -m gf3x_torch.cli ...; every one takes --device cuda|cpu)
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _select_device(args) -> None:
    """Every subcommand runs where `--device` says: the card by default,
    the CPU only when asked. Without a CUDA device, `--device cuda` ends
    the command with an error, never on the CPU."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gf3x-torch: torch has no CUDA device here; pass "
                         "--device cpu to run on the CPU")


def _modem(args):
    from .config import preset
    from .models import Modem

    cfg = preset(args.preset)
    if args.qam:
        cfg = cfg.replace(bits_per_symbol={4: 2, 16: 4, 64: 6}[args.qam])
    if getattr(args, "loading", None):
        doc = json.loads(Path(args.loading).read_text())
        table = doc.get("bit_loading") if isinstance(doc, dict) else doc
        if not table:
            raise SystemExit(
                f"{args.loading} carries no bit_loading table"
                + (f" ({doc['bit_loading_error']})"
                   if isinstance(doc, dict) and "bit_loading_error" in doc
                   else ""))
        if isinstance(doc, dict) and "table_rate" in doc:
            # a table is margined for ONE code rate (gf3x.ops.adapt
            # RATE_OFFSET_DB); using it at a higher rate silently eats
            # 2.5-6 dB of margin — refuse instead
            want = cfg.ldpc_rate if cfg.fec == "ldpc" else "uncoded"
            if doc["table_rate"] != want:
                raise SystemExit(
                    f"{args.loading} was calibrated for rate "
                    f"{doc['table_rate']}, but this config runs {want}; "
                    f"regenerate with `gf3x-torch adapt --rate {want}`")
        cfg = cfg.replace(bit_loading=tuple(int(b) for b in table))
    return Modem(cfg, device=args.device)


def cmd_transmit(args) -> int:
    from .io import have_live_audio, play, write_wav
    from .models.stream import encode_file, frame_capacity

    modem = _modem(args)
    path = Path(args.file)
    data = path.read_bytes()
    name = args.filename or path.name
    wav = encode_file(modem, data, name, gap_s=args.gap)
    n_frames = -(-len(data) // frame_capacity(modem, name)) if data else 1
    out = args.output or (path.name + ".wav")
    write_wav(out, wav, modem.cfg.fs)
    dur = len(wav) / modem.cfg.fs
    print(f"wrote {out}: {len(data)} bytes in {n_frames} frame(s), "
          f"{dur:.2f}s of audio ({8 * len(data) / max(dur, 1e-9):.0f} bit/s)")
    if args.play:
        if not have_live_audio():
            print("no live audio stack on this host; play the WAV externally",
                  file=sys.stderr)
            return 1
        play(wav, modem.cfg.fs)
    return 0


def cmd_receive(args) -> int:
    from .io import read_wav
    from .models.stream import decode_stream
    from .utils.bits import safe_filename

    modem = _modem(args)
    rx, _ = read_wav(args.wav, expect_fs=modem.cfg.fs if args.strict_fs else None)
    res = decode_stream(modem, rx, threshold=args.threshold, sfo=args.sfo)

    report = {
        "frames_detected": int(res.starts.size),
        "frames_crc_ok": sum(1 for r in res.frames if r.crc_ok),
        "complete": res.complete,
        "filename": res.filename,
        "bytes": len(res.payload) if res.payload is not None else 0,
        "missing_seqs": res.missing,
        "starts": [int(s) for s in res.starts],
        "evm": [round(float(r.diag.evm), 5) for r in res.frames if r.diag is not None],
        # FEC decoder stress (SURVEY.md §6.5): message passes run and
        # codewords left unsatisfied, per frame
        "fec_iters": [int(r.diag.fec_iters) for r in res.frames
                      if r.diag is not None],
        "fec_unsat": [int(r.diag.fec_unsat) for r in res.frames
                      if r.diag is not None],
        # |LLR| histogram per frame (SURVEY.md §6.5): 16 log2-spaced bins,
        # bin k = [2^(k-2), 2^(k-1)) on a 1/8 subsample of the coded bits
        "llr_hist": [[int(c) for c in np.asarray(r.diag.llr_hist)]
                     for r in res.frames if r.diag is not None],
    }
    if args.json:
        print(json.dumps(report))
    else:
        for k, v in report.items():
            print(f"{k}: {v}")
    if args.constellation and res.starts.size:
        from .bench.plots import save_constellation
        syms = modem.equalized_symbols(rx, start=int(res.starts[0]))
        save_constellation(syms, args.constellation)
        print(f"wrote {args.constellation}")
    if args.channel_plot and res.frames and res.frames[0].diag is not None:
        from .bench.plots import save_channel_response
        save_channel_response(res.frames[0].diag.H, modem.cfg, args.channel_plot)
        print(f"wrote {args.channel_plot}")
    if not res.complete:
        return 2
    outdir = Path(args.output or ".")
    outdir.mkdir(parents=True, exist_ok=True)
    # the decoded filename is untrusted (it came out of the air): strip any
    # directory components so a malicious transmission cannot write outside
    # the output directory
    out = outdir / safe_filename(res.filename)
    out.write_bytes(res.payload)
    print(f"wrote {out}")
    return 0


def cmd_retransmit(args) -> int:
    from .io import write_wav
    from .models.stream import encode_frames

    modem = _modem(args)
    path = Path(args.file)
    data = path.read_bytes()
    name = args.filename or path.name
    wav = encode_frames(modem, data, args.seqs, name, gap_s=args.gap)
    out = args.output or (path.name + f".retx{'-'.join(map(str, args.seqs))}.wav")
    write_wav(out, wav, modem.cfg.fs)
    print(f"wrote {out}: frames {args.seqs} of {path.name}")
    return 0


def cmd_sweep(args) -> int:
    from .bench.ber import ber_sweep

    modem = _modem(args)
    from .utils.profiling import maybe_trace
    with maybe_trace():
        res = ber_sweep(modem, snrs_db=args.snrs, n_trials=args.trials)
    rows = zip(res["snr_db"], res["ber_pre_fec"], res["ber_post_fec"], res["fer"])
    if args.json:
        print(json.dumps({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                          for k, v in res.items()}))
    else:
        print(f"{'SNR dB':>8} {'pre-FEC BER':>12} {'post-FEC BER':>13} {'FER':>8}")
        for s, pre, post, fer in rows:
            print(f"{s:8.1f} {pre:12.2e} {post:13.2e} {fer:8.3f}")
    if args.plot:
        from .bench.plots import save_ber_plot
        save_ber_plot(res, args.plot,
                      title=f"{args.preset}: BER vs SNR ({2**modem.cfg.bits_per_symbol}-QAM)")
        print(f"wrote {args.plot}")
    return 0


def cmd_info(args) -> int:
    modem = _modem(args)
    cfg = modem.cfg
    from .models.stream import frame_capacity

    print(f"preset           : {args.preset}")
    print(f"fs               : {cfg.fs} Hz")
    print(f"FFT / CP         : {cfg.n_fft} / {cfg.cp}")
    print(f"used bins        : {cfg.bin_lo}..{cfg.bin_hi} "
          f"({cfg.n_used} = {cfg.n_pilots} pilots + {cfg.n_data_bins} data)")
    print(f"band             : {cfg.bin_lo * cfg.fs / cfg.n_fft:.0f}"
          f"-{cfg.bin_hi * cfg.fs / cfg.n_fft:.0f} Hz")
    if cfg.bit_loading is not None:
        counts = {m: sum(1 for b in cfg.bit_loading if b == m)
                  for m in (0, 2, 4, 6)}
        print(f"constellation    : per-bin loading "
              f"({cfg.bits_per_ofdm_symbol} bits/sym: "
              f"{counts[0]} null / {counts[2]} QPSK / "
              f"{counts[4]} 16-QAM / {counts[6]} 64-QAM bins)")
    else:
        print(f"constellation    : {2 ** cfg.bits_per_symbol}-QAM")
    print(f"frame            : chirp {cfg.chirp_len} + SC {cfg.sc_len} + "
          f"{cfg.n_known_symbols} known + {cfg.n_data_symbols} data symbols "
          f"= {cfg.frame_len} samples ({cfg.frame_len / cfg.fs:.3f}s)")
    if cfg.fec == "ldpc":
        print(f"FEC              : LDPC rate {cfg.ldpc_rate} "
              f"(n={cfg.ldpc_n}, k={cfg.ldpc_k}) z={cfg.ldpc_z}, "
              f"{cfg.n_codewords} codewords, {cfg.ldpc_iters} iters")
    else:
        print("FEC              : none")
    dur = cfg.frame_len / cfg.fs
    print(f"payload capacity : {frame_capacity(modem)} bytes/frame "
          f"({cfg.payload_bits_per_frame / dur:.0f} bit/s = "
          f"{cfg.payload_bits_per_frame / 8 / dur:.0f} B/s raw)")
    return 0


def cmd_adapt(args) -> int:
    """Probe a recorded transmission → preset recommendation + optional
    per-bin bit-loading table (link adaptation, gf3x_torch.ops.adapt)."""
    from .io import read_wav
    from .ops.adapt import (bit_loading_from_probe, data_bin_snr_db,
                            effective_snr_db, recommend_preset)

    modem = _modem(args)
    rx, _ = read_wav(args.wav, expect_fs=modem.cfg.fs if args.strict_fs else None)
    res = modem.decode(rx)
    if res.diag is None or not res.crc_ok:
        # a mis-synced or undecodable probe yields a garbage Ĥ — a table
        # built from it would be adopted by BOTH ends; refuse instead of
        # recommending from noise
        print("probe did not decode (crc failed) — refusing to adapt from "
              "an untrusted channel estimate; re-record the probe or use a "
              "more robust probe preset", file=sys.stderr)
        return 2
    diag = res.diag
    rate = args.rate or (modem.cfg.ldpc_rate if modem.cfg.fec == "ldpc"
                         else "uncoded")
    name, report = recommend_preset(diag, modem.cfg, margin_db=args.margin)
    out = {
        "probe_preset": args.preset,
        "probe_crc_ok": bool(res.crc_ok),
        "effective_snr_db": report["effective_snr_db"],
        "recommended_preset": name,
        "recommendation": report,
        "table_rate": rate,
    }
    try:
        table = bit_loading_from_probe(diag, modem.cfg,
                                       margin_db=args.margin, rate=rate)
        snr = data_bin_snr_db(diag, modem.cfg)
        out["bit_loading"] = list(table)
        out["loading_summary"] = {
            "bits_per_symbol_total": int(sum(table)),
            "bins_by_order": {str(m): int(sum(1 for b in table if b == m))
                              for m in (0, 2, 4, 6)},
            "min_bin_snr_db": round(float(snr.min()), 1),
            "max_bin_snr_db": round(float(snr.max()), 1),
        }
    except ValueError as e:
        out["bit_loading_error"] = str(e)
    if args.output:
        Path(args.output).write_text(json.dumps(out, indent=1))
        print(f"wrote {args.output}"
              + (" (recommendation only — no usable table, see "
                 "bit_loading_error)" if "bit_loading" not in out else ""))
    if args.json:
        print(json.dumps(out))
    else:
        print(f"effective SNR    : {out['effective_snr_db']} dB "
              f"(probe crc_ok={res.crc_ok})")
        print(f"recommended      : {name} "
              f"({report['net_kbps']} kbit/s, needs "
              f"{report['required_snr_db']}+{args.margin} dB)")
        if "bit_loading" in out:
            s = out["loading_summary"]
            print(f"bit-loading      : {s['bits_per_symbol_total']} bits/sym "
                  f"over {modem.cfg.n_data_bins} bins {s['bins_by_order']} "
                  f"at rate {rate}")
            print("use via          : gf3x-torch --loading TABLE.json "
                  "transmit/receive"
                  " (write with -o)")
        else:
            print(f"no loading table : {out['bit_loading_error']}")
    return 0 if "bit_loading" in out else 3


def cmd_bench(args) -> int:
    from .bench.step import run

    run(device=args.device, batch=args.batch)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gf3x-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="gf3",
                    help="config preset (gf3 | gf3-fast | gf3-hicap | "
                         "gf3-turbo | gf3-robust | loopback)")
    ap.add_argument("--qam", type=int, choices=[4, 16, 64], default=None,
                    help="override constellation order")
    ap.add_argument("--loading", default=None,
                    help="per-bin bit-loading table JSON (from `gf3x-torch "
                         "adapt -o`); both ends must use the same table")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where every tensor lives: the card (default; an "
                         "error without one) or the CPU")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("transmit", help="file -> WAV (optionally play)")
    t.add_argument("file")
    t.add_argument("-o", "--output")
    t.add_argument("--filename", help="name carried in the header (default: basename)")
    t.add_argument("--gap", type=float, default=0.05, help="inter-frame gap seconds")
    t.add_argument("--play", action="store_true")
    t.set_defaults(fn=cmd_transmit)

    r = sub.add_parser("receive", help="WAV -> file")
    r.add_argument("wav")
    r.add_argument("-o", "--output", help="output directory")
    r.add_argument("--threshold", type=float, default=0.4)
    r.add_argument("--sfo", choices=["off", "auto", "on"], default="auto",
                   help="sampling-clock-offset correction loop (auto: retry "
                        "through it when a frame fails or drifts)")
    r.add_argument("--strict-fs", action="store_true")
    r.add_argument("--json", action="store_true")
    r.add_argument("--constellation", help="save equalized-constellation PNG")
    r.add_argument("--channel-plot", help="save |H|/phase response PNG")
    r.set_defaults(fn=cmd_receive)

    rt = sub.add_parser("retransmit",
                        help="re-encode selected frames of FILE (recovery for "
                             "'missing_seqs' from receive)")
    rt.add_argument("file")
    rt.add_argument("--seqs", type=int, nargs="+", required=True)
    rt.add_argument("-o", "--output")
    rt.add_argument("--filename", help="name carried in the header (default: basename)")
    rt.add_argument("--gap", type=float, default=0.05)
    rt.set_defaults(fn=cmd_retransmit)

    s = sub.add_parser("sweep", help="BER-vs-SNR sweep (config 3)")
    s.add_argument("--snrs", type=float, nargs="+", default=[0, 2, 4, 6, 8, 12, 16, 20])
    s.add_argument("--trials", type=int, default=16)
    s.add_argument("--json", action="store_true")
    s.add_argument("--plot", help="save BER curve PNG")
    s.set_defaults(fn=cmd_sweep)

    a = sub.add_parser("adapt", help="probe WAV -> preset recommendation + "
                                     "per-bin bit-loading table")
    a.add_argument("wav")
    a.add_argument("-o", "--output", help="write the table JSON here")
    a.add_argument("--margin", type=float, default=2.0,
                   help="SNR margin (dB) over the measured operating points")
    a.add_argument("--rate", default=None,
                   choices=["1/2", "2/3", "3/4", "5/6", "uncoded"],
                   help="code rate to calibrate the table for "
                        "(default: the probe preset's rate)")
    a.add_argument("--strict-fs", action="store_true")
    a.add_argument("--json", action="store_true")
    a.set_defaults(fn=cmd_adapt)

    i = sub.add_parser("info", help="print frame geometry / capacity")
    i.set_defaults(fn=cmd_info)

    b = sub.add_parser("bench", help="time the config-5 step (data symbols/s)")
    b.add_argument("--batch", type=int, default=1024,
                   help="recordings per step")
    b.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    _select_device(args)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
