"""Adaptive link walkthrough (the port's counterpart of
examples/adaptive_link.py): probe a shaped channel, pick the operating
point, then transfer a file with a per-bin bit-loading table (SPEC.md §5b,
`gf3x_torch.ops.adapt`).

Channel: speaker/mic rolloff (9 kHz highcut against the 13 kHz band) with
±4 dB ripple + a mild room. The probe decode's channel estimate drives
both the preset recommendation and the loading table; the bit-loaded
transfer (kernels A and B on the card) then carries ~2-3× the probe
preset's payload through the exact channel that defeats a uniform
high-order constellation.

    python -m gf3x_torch.examples.adaptive_link [outdir] [--device cuda|cpu]
"""

import sys
from pathlib import Path

import numpy as np

from gf3x_torch import Modem, preset
from gf3x_torch.channel import (awgn, delay_gain, multipath,
                                room_impulse_response, speaker_mic_fir)
from gf3x_torch.examples import require_device, run
from gf3x_torch.io import read_wav, write_wav
from gf3x_torch.models.stream import decode_stream, encode_file
from gf3x_torch.ops.adapt import (bit_loading_from_probe, data_bin_snr_db,
                                  effective_snr_db, recommend_preset)


def through_air(wav, fir, rir, rng, snr_db=24.0, delay=6000):
    x = multipath(multipath(wav, fir), rir)
    return awgn(delay_gain(x, delay, 0.6, total_len=x.size + 12000),
                snr_db, rng)


def main(outdir: str = "demo_out", device: str = "cuda"):
    dev = require_device(device)
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(42)
    fir = speaker_mic_fir(highcut=9000.0, ripple_db=4.0, rng=rng)
    rir = room_impulse_response(rng, rt60=0.015, drr_db=8.0)

    # --- 1. probe: one robust QPSK frame through the channel
    probe_cfg = preset("gf3")
    probe_modem = Modem(probe_cfg, device=dev)
    tx = probe_modem.encode(b"channel probe", "probe")
    write_wav(out / "probe_rx.wav", through_air(tx, fir, rir, rng),
              probe_cfg.fs)
    rx, _ = read_wav(out / "probe_rx.wav")
    res = probe_modem.decode(rx)
    assert res.crc_ok, "probe failed to decode — channel worse than expected"

    # --- 2. adapt: effective SNR → preset pick; per-bin SNR → loading table
    eff = effective_snr_db(res.diag, probe_cfg)
    name, report = recommend_preset(res.diag, probe_cfg)
    table = bit_loading_from_probe(res.diag, probe_cfg, margin_db=1.5)
    snr = data_bin_snr_db(res.diag, probe_cfg)
    print(f"effective SNR {eff:.1f} dB → recommended preset: {name} "
          f"({report['net_kbps']} kbit/s)")
    print(f"bit-loading: {sum(table)} bits/sym over {len(table)} bins "
          f"(bin SNR {snr.min():.0f}..{snr.max():.0f} dB; "
          f"{sum(1 for b in table if b == 0)} nulled)")

    # --- 3. transfer with the loaded config (both ends share `table`)
    loaded = Modem(probe_cfg.replace(bit_loading=table), device=dev)
    payload = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    wav = encode_file(loaded, payload, "data.bin")
    write_wav(out / "loaded_rx.wav", through_air(wav, fir, rir, rng),
              probe_cfg.fs)
    rx2, _ = read_wav(out / "loaded_rx.wav")
    got = decode_stream(loaded, rx2)
    assert got.complete and got.payload == payload, got.missing
    gain = loaded.cfg.payload_bits_per_frame / probe_cfg.payload_bits_per_frame
    print(f"transferred {len(payload)} B in {got.starts.size} frames — "
          f"{gain:.1f}× the probe preset's per-frame payload, CRC clean")


if __name__ == "__main__":
    run(main, __doc__, sys.argv[1:])
