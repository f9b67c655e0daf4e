"""The port's ARQ state machines (`gf3x_torch.models.arq`, a copy of
gf3x's onto the port's stream module) against gf3x's on the CPU: a
two-round session of tests/test_arq.py in which every single decode fails
and chase combining completes the transfer, and the host helpers on fixed
inputs.

Tolerance: none — NACKs, positions, payloads and waveform lengths are
compared exactly."""

import numpy as np
import pytest

from gf3x import Modem as JModem
from gf3x import preset as j_preset
from gf3x.channel import awgn, delay_gain
from gf3x.models import arq as jarq
from gf3x.models.stream import frame_capacity as j_frame_capacity

from gf3x_torch import Modem, preset
from gf3x_torch.models import arq as tarq
from gf3x_torch.models.stream import frame_capacity


def _air(wav, delay, seed, snr_db):
    rng = np.random.default_rng(seed)
    return awgn(delay_gain(wav, delay, 1.0, total_len=wav.size + 4000),
                snr_db, rng)


def test_session_matches_gf3x():
    """Round 0 at 0 dB: both receivers fail every frame and NACK "all";
    round 1, still 0 dB: both combine the stored copies and complete with
    the payload, NACK [] and no soft copies left. Each package's sender
    makes its own waveforms; the air is the same seeds."""
    jm, tm = JModem(j_preset("gf3")), Modem(preset("gf3"), device="cpu")
    assert frame_capacity(tm, "d.bin") == j_frame_capacity(jm, "d.bin")
    rng = np.random.default_rng(9)
    payload = bytes(rng.integers(0, 256, 2 * frame_capacity(tm, "d.bin"),
                                 dtype=np.uint8))
    sides = [(jarq.ArqSender(jm, payload, "d.bin"),
              jarq.ArqReceiver(jm, sfo="off")),
             (tarq.ArqSender(tm, payload, "d.bin"),
              tarq.ArqReceiver(tm, sfo="off"))]
    nacks = []
    for tx, rx in sides:
        assert tx.n_frames == 2
        got = rx.feed(_air(tx.initial(), 600, seed=51, snr_db=0.0))
        assert not got.complete and not any(f.crc_ok for f in got.frames)
        req, _ = tarq.decode_nack(tarq.encode_nack(rx.nack(), "d.bin"))
        got = rx.feed(_air(tx.retransmit(req), 900, seed=52, snr_db=0.0),
                      nacked=req)
        assert got.complete and got.payload == payload
        assert not rx._receptions and tx.retransmit(rx.nack()).size == 0
        nacks.append((req, rx.nack()))
    assert nacks[0] == nacks[1] == ("all", [])


def test_helpers_match_gf3x():
    """`attribute_positions` (mis-refined anchor, duplicate detection,
    stride-collapse guard, two disagreeing anchors, ±800 ppm), and the
    NACK encoding, on fixed inputs: equal to gf3x's."""
    stride = 31_385
    starts = np.asarray([400 + p * stride for p in range(40)])
    bad = starts.copy()
    bad[0] -= 256
    dup = starts.copy()
    dup[1] = dup[0]
    sfo = np.asarray([round(200 + p * stride * (1 + 800e-6))
                      for p in range(40)])
    cases = [(bad, [(i, i) for i in range(0, 40, 4)]),
             (bad, [(0, 0), (1, 1), (5, 5), (9, 9)]),
             (dup, [(0, 0), (1, 1), (2, 2)]), (dup, [(0, 0), (1, 1)]),
             (starts, [(3, 2), (20, 20)]), (sfo, [(3, 3), (20, 20), (31, 31)]),
             (sfo, [(3, 3)]), (starts, [])]
    for st, anchors in cases:
        assert (tarq.attribute_positions(st, anchors, stride)
                == jarq.attribute_positions(st, anchors, stride))
    for missing in ("all", [], [1, 3, 7]):
        wire = tarq.encode_nack(missing, "f.bin")
        assert wire == jarq.encode_nack(missing, "f.bin")
        assert tarq.decode_nack(wire) == jarq.decode_nack(wire)


def test_retransmit_out_of_range_refused():
    """A NACK naming a seq outside the transfer is refused, as in gf3x."""
    tm = Modem(preset("gf3"), device="cpu")
    tx = tarq.ArqSender(tm, b"x" * 10, "z.bin")
    with pytest.raises(ValueError, match="out of range"):
        tx.retransmit([0, 3])
