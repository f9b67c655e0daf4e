"""Robustness-envelope sweep on the port (tools/stress.py's): where the
GF3_STANDARD receiver works. Sweeps seven impairment axes independently at
a fixed operating SNR through `Modem.decode(sfo='auto')` and writes a
markdown table of frame success rates to `--out`:

    python -m gf3x_torch.bench.stress --out ROBUSTNESS.md [--trials 8]
        [--preset gf3] [--device cuda|cpu]

The recordings come from the port's copy of gf3x's channel sims, drawn
from one NumPy generator seeded 0, so the same trials reach gf3x's tool
and this one."""

from __future__ import annotations

import time

import numpy as np

from .. import Modem, preset
from ..channel import (awgn, clip, delay_gain, multipath, resample_sfo,
                       room_impulse_response, speaker_mic_fir)
from .reports import parse_args, write_report

__all__ = ["success_rate", "report", "main"]


def success_rate(modem, impair, rng, trials, snr_db, sfo="auto"):
    """Frames decoded CRC-ok with their payload, over `trials` random
    payloads through `impair(x, rng)`, a random delay and AWGN at
    `snr_db`, all in one recording length."""
    T = modem.cfg.frame_len + 12000
    ok = 0
    for _ in range(trials):
        cap = min(400, modem.cfg.payload_bits_per_frame // 8 - 40)
        payload = bytes(rng.integers(0, 256, cap, dtype=np.uint8))
        wav = modem.encode(payload, "s.bin")
        x = impair(np.asarray(wav, np.float64), rng)
        delay = int(rng.integers(500, 4000))
        rx = awgn(delay_gain(x[: T - delay], delay, 0.6, total_len=T),
                  snr_db, rng)
        r = modem.decode(rx.astype(np.float32), sfo=sfo)
        ok += int(r.crc_ok and r.payload == payload)
    return ok / trials


def report(preset_name: str, trials: int, device: str) -> list[str]:
    """The tool's seven tables, in its order and at its operating SNRs."""
    m = Modem(preset(preset_name), device=device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    lines = [
        f"# Measured robustness envelope ({preset_name}, gf3x_torch on "
        f"{device})",
        "",
        f"Frame success rate over {trials} random trials per cell "
        "(payload 400 B, random delay, `decode(sfo='auto')`). Generated by "
        "`python -m gf3x_torch.bench.stress`.",
        "",
    ]

    def table(title, header, rows):
        lines.extend([f"## {title}", "", f"| {header} | success |",
                      "|---|---|"])
        for label, rate in rows:
            lines.append(f"| {label} | {rate:.0%} |")
        lines.append("")

    # higher-order constellations need more operating SNR per cell
    bump = {2: 0, 4: 7, 6: 13}[m.cfg.bits_per_symbol]

    rows = []
    for ppm in (0, 500, 1000, 1500, 2000, 3000, -1500):
        rate = success_rate(m, lambda x, r, p=ppm: resample_sfo(x, p), rng,
                            trials, 18.0 + bump)
        rows.append((f"{ppm:+d} ppm", rate))
        print(f"sfo {ppm:+5d} ppm: {rate:.0%}", flush=True)
    table(f"Sampling-clock offset ({18 + bump} dB SNR)", "clock offset", rows)

    rows = []
    for rt60 in (0.0, 0.04, 0.08, 0.12, 0.20, 0.30):
        def imp(x, r, rt=rt60):
            if not rt:
                return x
            return multipath(x, room_impulse_response(r, rt60=rt, drr_db=5.0))
        rate = success_rate(m, imp, rng, trials, 15.0 + bump)
        rows.append((f"rt60 = {rt60:.2f} s", rate))
        print(f"rt60 {rt60:.2f}: {rate:.0%}", flush=True)
    table(f"Reverberation ({15 + bump} dB SNR, DRR 5 dB)", "room", rows)

    rows = []
    for snr in (4, 2, 1, 0, -1, -2):
        rate = success_rate(m, lambda x, r: x, rng, trials, float(snr) + bump)
        rows.append((f"{snr + bump} dB", rate))
        print(f"snr {snr} dB: {rate:.0%}", flush=True)
    table("AWGN-only SNR (rate-1/2 LDPC QPSK waterfall)", "SNR", rows)

    cfg = m.cfg
    rows = []
    for nsym in (1, 3, 5, 7, 9, 11):
        def imp(x, r, n=nsym):
            x = x.copy()
            pos = cfg.preamble_len + 6 * cfg.symbol_len
            x[pos: pos + n * cfg.symbol_len] += r.standard_normal(
                n * cfg.symbol_len)
            return x
        rate = success_rate(m, imp, rng, trials, 16.0 + bump)
        rows.append((f"{nsym} symbols (of {cfg.n_data_symbols}) destroyed",
                     rate))
        print(f"burst {nsym} sym: {rate:.0%}", flush=True)
    table(f"Impulse/burst interference ({16 + bump} dB SNR, 0 dB burst)",
          "burst", rows)

    rows = []
    for lvl in (0.5, 0.25, 0.1, 0.05, 0.03, 0.02):
        def imp(x, r, lv=lvl):
            return clip(x, lv * float(np.max(np.abs(x))))
        rate = success_rate(m, imp, rng, trials, 16.0 + bump)
        rows.append((f"clip at {lvl:.0%} of peak", rate))
        print(f"clip {lvl:.2f}: {rate:.0%}", flush=True)
    table(f"Hard clipping ({16 + bump} dB SNR)", "limiter", rows)

    rows = []
    for drift in (0, 25, 50, 100, 200, 400, -200):
        rate = success_rate(
            m, lambda x, r, d=drift: resample_sfo(
                x, 150.0, drift_ppm_per_s=d, wobble_ppm=10.0), rng,
            trials, 18.0 + bump)
        rows.append((f"{drift:+d} ppm/s", rate))
        print(f"drift {drift:+4d} ppm/s: {rate:.0%}", flush=True)
    table(f"Clock drift within the frame ({18 + bump} dB SNR, +150 ppm "
          "base, 10 ppm wobble)", "drift rate", rows)

    rows = []
    for lowcut in (150, 400, 800, 1200, 2000, 3000):
        def imp(x, r, lc=lowcut):
            return multipath(x, speaker_mic_fir(
                lowcut=float(lc), ripple_db=3.0, rng=r))
        rate = success_rate(m, imp, rng, trials, 15.0 + bump)
        rows.append((f"highpass corner {lowcut} Hz", rate))
        print(f"lowcut {lowcut:5d} Hz: {rate:.0%}", flush=True)
    table(f"Speaker/mic response ({15 + bump} dB SNR, 4th-order LP at 15 "
          "kHz, 3 dB ripple)", "transducer", rows)

    lines.append(f"_{trials} trials/cell, {time.time() - t0:.0f} s total._")
    return lines


def main(argv=None) -> None:
    args = parse_args(__doc__, 8, argv, lambda ap: ap.add_argument(
        "--preset", default="gf3", help="modem preset to sweep (gf3, "
        "gf3-fast, gf3-turbo, gf3-robust)"))
    lines = report(args.preset, args.trials, args.device)
    print("\n" + "\n".join(lines))
    write_report(args.out, lines)


if __name__ == "__main__":
    main()
