"""Measured BER-vs-SNR waterfalls per preset on the port
(tools/perf_report.py's): for every preset, the BER sweep
(`gf3x_torch.bench.ber.ber_sweep`, the reference's benchmark config 3)
over AWGN and through a fixed simulated room, written as a markdown table
of pre- and post-FEC BER and FER to `--out`, with one curve PNG per preset
beside it (`--no-plots` leaves them out; they need matplotlib):

    python -m gf3x_torch.bench.perf_report --out PERFORMANCE.md
        [--trials 32] [--no-plots] [--device cuda|cpu]

Each preset's grid is one (snr, trial) batch on the device."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from .. import Modem, preset
from ..channel import room_impulse_response
from . import ber
from .reports import parse_args, write_report

__all__ = ["GRIDS", "fmt", "preset_rows", "report", "main"]

GRIDS = {
    "gf3-robust": [-2, -1, 0, 1, 2, 3, 4],
    "gf3": [-1, 0, 1, 2, 3, 4, 6],
    "gf3-fast": [4, 6, 7, 8, 9, 10, 12],
    "gf3-hicap": [8, 9, 10, 11, 12, 14, 16],
    "gf3-turbo": [10, 12, 13, 14, 15, 16, 18],
}
ROOM_DELAY = 977         # samples before the frame in the room sweep


def room_fir() -> np.ndarray:
    """The fixed simulated room (rt60 40 ms, DRR 6 dB, seed 3)."""
    rng = np.random.default_rng(3)
    return room_impulse_response(rng, rt60=0.04, drr_db=6.0).astype(
        np.float32)


def fmt(x: float, floor: float) -> str:
    return f"{max(x, 0):.1e}" if x > floor / 2 else f"<{floor:.0e}"


def preset_rows(name: str, trials: int, device: str, fir: np.ndarray):
    """One preset's sweep over its grid in AWGN and through the room:
    (the markdown heading and table rows, the AWGN result, the room
    result)."""
    snrs = GRIDS[name]
    m = Modem(preset(name), device=device)
    cfg = m.cfg
    res = ber.ber_sweep(m, snrs, n_trials=trials)
    room = ber.ber_sweep(m, snrs, n_trials=trials, fir=fir,
                         delay_samples=ROOM_DELAY)
    floor = 1.0 / res["bits_per_point"]
    rate = cfg.payload_bits_per_frame / (cfg.frame_len / cfg.fs)
    lines = [
        f"## {name} — {2 ** cfg.bits_per_symbol}-QAM, "
        f"rate-{cfg.ldpc_rate} LDPC, {rate / 1000:.1f} kbit/s net",
        "",
        "| SNR (dB) | pre-FEC BER | post-FEC BER | FER | room FER |",
        "|---|---|---|---|---|",
    ]
    for i, s in enumerate(snrs):
        lines.append(
            f"| {s} | {fmt(res['ber_pre_fec'][i], floor)} "
            f"| {fmt(res['ber_post_fec'][i], floor)} "
            f"| {res['fer'][i]:.2f} | {room['fer'][i]:.2f} |")
    lines.append("")
    return lines, res, room


def report(trials: int, device: str, plot_dir: Path | None) -> list[str]:
    """The tool's report: every preset of GRIDS in order; a PNG per preset
    into `plot_dir` unless it is None."""
    t0 = time.time()
    lines = [
        "# Measured link performance (AWGN, batched sweep harness)",
        "",
        f"Post-FEC BER and frame-error rate over {trials} independent "
        "frames per SNR point (`gf3x_torch.bench.ber.ber_sweep` — one "
        "(snr, trial) batch per preset; driver benchmark config 3). "
        f"Generated by `python -m gf3x_torch.bench.perf_report` on "
        f"{device}.",
        "",
        "The *room FER* column replays the same grid through a fixed "
        "simulated room with rt60 = 40 ms — ~7× the 5.8 ms cyclic prefix, "
        "a deliberate beyond-CP ISI stress.",
        "",
    ]
    fir = room_fir()
    for name in GRIDS:
        rows, res, _ = preset_rows(name, trials, device, fir)
        lines += rows
        print(f"{name}: done", flush=True)
        if plot_dir is not None:
            from .plots import save_ber_plot
            save_ber_plot(res, plot_dir / f"ber_{name}.png",
                          title=f"{name}: BER vs SNR (AWGN)")
            lines += [f"![{name} BER curve](ber_{name}.png)", ""]
    lines.append(f"_{time.time() - t0:.0f} s total._")
    return lines


def main(argv=None) -> None:
    args = parse_args(__doc__, 32, argv, lambda ap: ap.add_argument(
        "--no-plots", action="store_true"))
    out = Path(args.out)
    plot_dir = None if args.no_plots else out.parent
    if plot_dir is not None:
        plot_dir.mkdir(parents=True, exist_ok=True)
    write_report(out, report(args.trials, args.device, plot_dir))


if __name__ == "__main__":
    main()
