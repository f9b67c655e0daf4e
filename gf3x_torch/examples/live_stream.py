"""Live chunked-capture walkthrough (the port's counterpart of
examples/live_stream.py): a file streams across multiple GF3 frames, "air"
arrives in arbitrary-size audio chunks (as a sound card delivers them),
and the stateful StreamingReceiver decodes each frame as its samples
complete — O(frame) memory, no full-recording buffering. The reassembled
file is written into outdir.

With `sounddevice` installed the same receiver loop runs on real
microphone input (`gf3x_torch.io.record`); this walkthrough simulates the
capture so it works headless.

    python -m gf3x_torch.examples.live_stream [outdir] [--device cuda|cpu]
"""

import sys
from pathlib import Path

import numpy as np

from gf3x_torch import Modem, preset
from gf3x_torch.channel import (awgn, delay_gain, multipath,
                                room_impulse_response)
from gf3x_torch.examples import require_device, run
from gf3x_torch.models.stream import StreamingReceiver, encode_file


def main(outdir: str = "demo_out", device: str = "cuda"):
    dev = require_device(device)
    modem = Modem(preset("gf3"), device=dev)
    rng = np.random.default_rng(7)

    # --- transmit: one file -> several frames of sound
    payload = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
    wav = encode_file(modem, payload, "report.bin")
    print(f"transmitting {len(payload)} B as {wav.size} samples "
          f"({wav.size / modem.cfg.fs:.2f} s of audio)")

    # --- simulated air: room reverb, delay, 18 dB SNR
    h = room_impulse_response(rng, rt60=0.03, drr_db=6.0)
    air = awgn(delay_gain(multipath(wav.astype(np.float64), h), 9000, 0.5,
                          total_len=wav.size + 22050), 18.0, rng)

    # --- receive: feed arbitrary-size chunks as a sound card would deliver
    rcv = StreamingReceiver(modem)
    pos, decoded = 0, 0
    while pos < air.size:
        n = int(rng.integers(2048, 16384))          # ragged chunk sizes
        chunk = air[pos: pos + n].astype(np.float32)
        pos += n
        for res in rcv.feed(chunk):
            decoded += 1
            print(f"  frame {res.seq + 1}/{res.total} decoded at "
                  f"~{pos / modem.cfg.fs:.2f} s  crc_ok={res.crc_ok}  "
                  f"clock={float(np.max(res.diag.clock_ppm)):+.0f} ppm")

    out = rcv.result()
    assert out.payload == payload, "payload mismatch"
    print(f"reassembled {len(out.payload)} B as {out.filename!r} "
          f"from {decoded} frames — bit-exact")
    Path(outdir).mkdir(parents=True, exist_ok=True)
    (Path(outdir) / out.filename).write_bytes(out.payload)


if __name__ == "__main__":
    run(main, __doc__, sys.argv[1:])
