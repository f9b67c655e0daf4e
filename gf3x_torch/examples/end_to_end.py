"""End-to-end walkthrough: file → sound → (simulated room) → file, with
every diagnostic plotted (the port's counterpart of examples/end_to_end.py).

    python -m gf3x_torch.examples.end_to_end [outdir] [--device cuda|cpu]

The plots need matplotlib; without it they are skipped and said so, and
everything else runs."""

import importlib.util
import sys
from pathlib import Path

import numpy as np

from gf3x_torch import Modem, preset
from gf3x_torch.bench.ber import ber_sweep
from gf3x_torch.channel import (awgn, delay_gain, multipath,
                                room_impulse_response)
from gf3x_torch.examples import require_device, run
from gf3x_torch.io import read_wav, write_wav
from gf3x_torch.models.stream import decode_stream, encode_file


def main(outdir: str = "demo_out", device: str = "cuda"):
    dev = require_device(device)
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    modem = Modem(preset("gf3"), device=dev)

    # --- transmit: this script's own source, as sound
    payload = Path(__file__).read_bytes()
    wav = encode_file(modem, payload, "end_to_end.py")
    write_wav(out / "tx.wav", wav)
    print(f"TX: {len(payload)} bytes -> {len(wav)/44100:.2f}s of audio "
          f"({out/'tx.wav'})")

    # --- the air: a reverberant room, delay, speaker at 40%, 18 dB SNR
    rng = np.random.default_rng(2026)
    h = room_impulse_response(rng, rt60=0.05, drr_db=5.0)
    rx = awgn(delay_gain(multipath(wav.astype(np.float64), h), 9000, 0.4,
                         total_len=len(wav) + 25000), 18.0, rng)
    write_wav(out / "rx.wav", rx)

    # --- receive
    rec, _ = read_wav(out / "rx.wav")
    res = decode_stream(modem, rec)
    print(f"RX: {res.starts.size} frames at {list(map(int, res.starts))}, "
          f"complete={res.complete}")
    assert res.complete and res.payload == payload
    (out / res.filename).write_bytes(res.payload)
    print(f"recovered {res.filename} bit-exact")

    # --- diagnostics
    d0 = res.frames[0].diag
    print(f"frame 0: sync_metric={float(d0.sync_metric):.0f} "
          f"sc_metric={float(d0.sc_metric):.2f} evm={float(d0.evm):.4f} "
          f"noise_var={float(d0.noise_var):.5f} "
          f"sfo_slope={float(d0.pilot_slope[-1]):+.4f} rad/bin")
    syms = modem.equalized_symbols(rec, start=int(res.starts[0]))

    # --- the BER waterfall (config 3 workload, small for demo speed)
    sweep = ber_sweep(modem, snrs_db=[0, 2, 4, 6, 8, 10], n_trials=4)
    print("BER post-FEC: " + " ".join(
        f"{s:g} dB {b:.2e}" for s, b in zip(sweep["snr_db"],
                                          sweep["ber_post_fec"])))
    if importlib.util.find_spec("matplotlib") is None:
        print("plots skipped: matplotlib is not installed")
        return
    from gf3x_torch.bench.plots import (save_ber_plot, save_channel_response,
                                        save_constellation)
    save_channel_response(d0.H, modem.cfg, out / "channel.png")
    save_constellation(syms, out / "constellation.png")
    save_ber_plot(sweep, out / "ber.png", title="GF3 standard: BER vs SNR")
    print(f"plots: {out}/channel.png, constellation.png, ber.png")


if __name__ == "__main__":
    run(main, __doc__, sys.argv[1:])
