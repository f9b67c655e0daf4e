"""Measured link-adaptation report on the port (tools/adapt_report.py's),
written to `--out`. One fixed shaped channel — speaker/mic FIR with the
lowpass corner at 7 kHz (against the 13.05 kHz band edge) and ±4 dB
ripple. Two experiments:

1. Every uniform preset runs the FER sweep (`gf3x_torch.bench.ber`)
   through the channel: each config has one clearing SNR and one fixed
   rate — the uniform frontier.
2. The adaptive link: at each SNR a gf3 QPSK probe at that SNR (decoded by
   the golden model, `gf3x_torch.GoldenModem`) drives
   `bit_loading_from_probe` (margin 1 dB), and the resulting bit-loaded
   config is swept at that same SNR (kernels A and B on the card).

    python -m gf3x_torch.bench.adapt_report --out ADAPTATION.md
        [--trials 16] [--device cuda|cpu]
"""

from __future__ import annotations

import time

import numpy as np

from .. import GoldenModem, Modem, preset
from ..channel import awgn, delay_gain, multipath, speaker_mic_fir
from ..ops.adapt import bit_loading_from_probe
from . import ber
from .reports import parse_args, write_report

__all__ = ["SNRS", "UNIFORM", "net_kbps", "shaped_fir", "probe_table",
           "report", "main"]

SNRS = [8, 10, 12, 14, 16, 18, 20]
UNIFORM = ("gf3", "gf3-fast", "gf3-hicap", "gf3-turbo")
DELAY = 977              # samples before the frame in every sweep


def net_kbps(cfg) -> float:
    return cfg.payload_bits_per_frame / (cfg.frame_len / cfg.fs) / 1e3


def shaped_fir() -> np.ndarray:
    """The shaped channel, recentred: `ber_sweep` decodes at a known start,
    so the linear-phase FIR's group delay (taps // 2) is rolled out of it
    but for 48 acausal samples, inside the cp // 4 = 64 timing backoff."""
    rng = np.random.default_rng(3)
    fir = speaker_mic_fir(highcut=7000.0, ripple_db=4.0, rng=rng)
    return np.roll(fir, -(len(fir) // 2 - 48))


def probe_table(golden, probe_tx, fir, snr):
    """The adaptive link's table at `snr`: the probe through the channel
    (noise seeded 100 + snr), decoded by the golden model, then
    `bit_loading_from_probe` at 1 dB margin; None where the probe fails
    CRC or no table is viable."""
    prng = np.random.default_rng(100 + snr)
    rx = awgn(delay_gain(multipath(probe_tx, fir), DELAY, 1.0,
                         total_len=probe_tx.size + 4000), snr, prng)
    pres = golden.decode(rx)
    if not pres.crc_ok:
        return None
    try:
        return bit_loading_from_probe(pres.diag, golden.cfg, margin_db=1.0)
    except ValueError:
        return None


def report(trials: int, device: str) -> list[str]:
    t0 = time.time()
    fir = shaped_fir()
    f32 = fir.astype(np.float32)

    rows = {}
    for name in UNIFORM:
        res = ber.ber_sweep(Modem(preset(name), device=device), SNRS,
                            n_trials=trials, fir=f32, delay_samples=DELAY)
        rows[name] = res["fer"]
        print(f"{name}: {np.array2string(res['fer'], precision=2)}",
              flush=True)

    pcfg = preset("gf3")
    g = GoldenModem(pcfg)
    probe_tx = g.encode(b"probe", "p")
    adaptive = []                       # (snr, net_kbps | None, fer | None)
    for snr in SNRS:
        table = probe_table(g, probe_tx, fir, snr)
        if table is None:
            adaptive.append((snr, None, None))
            print(f"adaptive @{snr} dB: probe or table failed", flush=True)
            continue
        lcfg = pcfg.replace(bit_loading=table)
        res = ber.ber_sweep(Modem(lcfg, device=device), [float(snr)],
                            n_trials=trials, fir=f32, delay_samples=DELAY)
        adaptive.append((snr, net_kbps(lcfg), float(res["fer"][0])))
        print(f"adaptive @{snr} dB: {net_kbps(lcfg):.1f} kbit/s "
              f"FER {res['fer'][0]:.2f} ({sum(table)} bits/sym, "
              f"{sum(1 for b in table if b == 0)} nulled)", flush=True)

    lines = [
        "# Measured link adaptation (shaped channel)",
        "",
        "Channel: speaker/mic FIR, 4th-order lowpass at **7 kHz** against "
        "the 13.05 kHz band edge, ±4 dB midband ripple "
        "(`speaker_mic_fir(highcut=7000, ripple_db=4)`) — the top half of "
        "the band is 5–22 dB down. Frame-error rate over "
        f"{trials} frames per point (`python -m "
        f"gf3x_torch.bench.adapt_report` on {device}).",
        "",
        "## Uniform presets (fixed rate, one clearing SNR each)",
        "",
        "| config | net kbit/s | " + " | ".join(f"{s} dB" for s in SNRS)
        + " |",
        "|---|---|" + "---|" * len(SNRS),
    ]
    for name in UNIFORM:
        cells = " | ".join(f"{f:.2f}" for f in rows[name])
        lines.append(f"| {name} | {net_kbps(preset(name)):.1f} | {cells} |")
    lines += [
        "",
        "## Adaptive (probe at the operating SNR → per-bin table → run "
        "there)",
        "",
        "| SNR | net kbit/s | FER |",
        "|---|---|---|",
    ]
    for snr, kbps, fer in adaptive:
        if kbps is None:
            lines.append(f"| {snr} dB | — (probe/table failed) | — |")
        else:
            lines.append(f"| {snr} dB | {kbps:.1f} | {fer:.2f} |")
    lines += ["", f"_{time.time() - t0:.0f} s total._"]
    return lines


def main(argv=None) -> None:
    args = parse_args(__doc__, 16, argv)
    write_report(args.out, report(args.trials, args.device))


if __name__ == "__main__":
    main()
