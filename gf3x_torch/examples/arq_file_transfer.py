"""ARQ session walkthrough (the port's counterpart of
examples/arq_file_transfer.py): selective-repeat + HARQ file transfer over
a lossy half-duplex acoustic link, with the FEEDBACK channel also carried
by the modem.

Forward link: data frames through a room channel where random bursts
obliterate entire frames. Reverse link: the receiver's NACK
(`ArqReceiver.nack`, serialized by `encode_nack`) is encoded as a tiny
gf3 frame and "played" back through its own noisy channel; the
transmitter decodes it and answers with exactly those frames
(`ArqSender.retransmit`). The receiver keeps every CRC-failed reception
and chase-combines repeated copies per seq, so even a damaged
retransmission can complete the transfer.

    python -m gf3x_torch.examples.arq_file_transfer [outdir] [--device cuda|cpu]
"""

import sys
from pathlib import Path

import numpy as np

from gf3x_torch import Modem, preset
from gf3x_torch.channel import (awgn, delay_gain, multipath,
                                room_impulse_response)
from gf3x_torch.examples import require_device, run
from gf3x_torch.io import write_wav
from gf3x_torch.models.arq import (ArqReceiver, ArqSender, decode_nack,
                                   encode_nack)
from gf3x_torch.models.stream import decode_stream, frame_capacity


def air(wav, rir, rng, snr_db=16.0, kill_spans=()):
    """Room + AWGN + frame-killing bursts at the given sample spans."""
    x = multipath(wav, rir)
    x = delay_gain(x, int(rng.integers(500, 3000)), 0.7,
                   total_len=x.size + 6000)
    x = awgn(x, snr_db, rng)
    for (a, b) in kill_spans:
        x[a: b] = rng.normal(0, 0.5, b - a)   # burst ≫ signal: frame dies
    return x


def main(outdir: str = "demo_out", device: str = "cuda"):
    dev = require_device(device)
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    rir = room_impulse_response(rng, rt60=0.015, drr_db=8.0)
    modem = Modem(preset("gf3"), device=dev)
    fl = modem.cfg.frame_len

    payload = bytes(rng.integers(0, 256, 4 * frame_capacity(modem, "data.bin"),
                                 dtype=np.uint8))
    tx = ArqSender(modem, payload, "data.bin")
    rx = ArqReceiver(modem)

    # ---- round 0: full transmission; two frames burst-destroyed in the air
    kill = [(int(1.2 * fl), int(1.5 * fl)), (int(3.3 * fl), int(3.6 * fl))]
    rx0 = air(tx.initial(), rir, rng, kill_spans=kill)
    write_wav(out / "arq_round0.wav", rx0, modem.cfg.fs)
    got = rx.feed(rx0)
    print(f"round 0: {sum(r.crc_ok for r in got.frames)}/{got.starts.size} "
          f"frames ok, nack {rx.nack()}")

    rounds = 0
    while not got.complete and rounds < 4:
        rounds += 1
        # ---- reverse link: the NACK as a real modem frame
        fb_rx = air(modem.encode(encode_nack(rx.nack(), "data.bin"),
                                 "nack.json"), rir, rng, snr_db=14.0)
        fb = decode_stream(modem, fb_rx)
        assert fb.complete, "feedback frame lost — ARQ would retry it"
        req, _ = decode_nack(fb.payload)
        print(f"round {rounds}: transmitter decoded NACK {req}")

        # ---- selective retransmission of exactly the NACKed frames
        rx1 = air(tx.retransmit(req), rir, rng)
        write_wav(out / f"arq_round{rounds}.wav", rx1, modem.cfg.fs)
        got = rx.feed(rx1, nacked=req)
        print(f"round {rounds}: merged — nack now {rx.nack()}")

    assert got.complete and got.payload == payload
    print(f"transfer complete after {rounds} retransmission round(s): "
          f"{len(payload)} B bit-exact")

    # ---- HARQ at work: a fresh two-round session where EVERY single
    # decode fails (0 dB), yet the stored failed copies combine per seq
    # and the transfer completes with no third round
    tx2 = ArqSender(modem, payload[: 2 * frame_capacity(modem, "h.bin")],
                    "h.bin")
    rx2 = ArqReceiver(modem, sfo="off")
    got2 = rx2.feed(air(tx2.initial(), rir, rng, snr_db=0.0))
    assert not any(f.crc_ok for f in got2.frames) and rx2.nack() == "all"
    got2 = rx2.feed(air(tx2.retransmit("all"), rir, rng, snr_db=0.0),
                    nacked="all")
    print(f"HARQ: two all-failed rounds at 0 dB → complete={got2.complete} "
          "(chase combining closed every frame)")
    assert got2.complete and got2.payload == tx2.payload


if __name__ == "__main__":
    run(main, __doc__, sys.argv[1:])
