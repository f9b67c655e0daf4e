"""The traffic generator: every traffic file without a `channel` block makes
the inputs it made before the block existed, bit for bit; the block's FIR
is the program's speaker-and-room simulation at the same seed, refused
where it is longer than the cyclic prefix; and a narrow-band loaded cell
through a room is `correct`."""

import hashlib
import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference.channel import room_fir
from benchmark.traffic import make_inputs

# SHA-256 of make_inputs' tensors (the ring, the payload bits, the frame of
# each row, the onsets) for each traffic file at B = 8, a ring of 2, seed
# SEED on the CPU, written from the generator before it took a `channel`
# block: a traffic file without one keeps its inputs
SEED = 2_718_281_828_459
PINNED = {
    "gf3-8192.b1024-20db":
        "5081f31b987676d7c0bdcb3d20489adbe59fea2a0414aa7859f9502e4e0f5fac",
    "gf3-8192.b1024-30db":
        "300438c0f3aa9c26d49c338bb494efc43d43b7277307653e926d753c675a3261",
    "gf3-8192.clock150-30db":
        "7de26502608cdaea263e59b2f20c6852bfada3562446aa894577968419adcbe6",
}

# the wide band's room: a 513-tap speaker and microphone and a 30 ms room,
# 1835 taps against gf3-8192's CP of 2048
ROOM = {"room_seed": 11, "rt60_s": 0.03, "drr_db": 6.0, "lowcut_hz": 150,
        "highcut_hz": 15000, "ripple_db": 3.0, "taps": 513}
# a room the narrow band's CP of 256 holds: 65 + 176 − 1 = 240 taps
SMALL_ROOM = {"room_seed": 5, "rt60_s": 0.004, "drr_db": 6.0,
              "lowcut_hz": 150, "highcut_hz": 15000, "ripple_db": 3.0,
              "taps": 65}


def digest(inputs) -> str:
    h = hashlib.sha256()
    for t in list(inputs.ring) + [inputs.sent, inputs.frame_of_row]:
        h.update(t.contiguous().numpy().tobytes())
    h.update(inputs.onsets.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_traffic_without_a_channel_is_unchanged(name):
    cell = harness.load_cell(name)
    assert "channel" not in cell.traffic
    traffic = dict(cell.traffic, batch=8, ring=2)
    inputs = make_inputs(harness.reference_config(cell), traffic, SEED,
                         "cpu")
    assert digest(inputs) == PINNED[name]


@pytest.mark.parametrize("block", [ROOM, SMALL_ROOM])
def test_room_fir_is_the_programs_simulation(block):
    from gf3x_torch.channel import room_impulse_response, speaker_mic_fir

    rng = np.random.default_rng(block["room_seed"])
    spk = speaker_mic_fir(44100, block["lowcut_hz"], block["highcut_hz"],
                          block["ripple_db"], block["taps"], rng)
    room = room_impulse_response(rng, 44100, block["rt60_s"],
                                 drr_db=block["drr_db"])
    want = np.convolve(spk, room)
    got = room_fir(block, 44100)
    assert got.shape == want.shape == (block["taps"]
                                       + int(block["rt60_s"] * 44100) - 1,)
    assert np.max(np.abs(got - want)) <= 1e-12


def test_the_room_is_the_same_for_every_seed():
    """The channel is drawn from its room_seed alone: two run seeds put the
    same frames through the same FIR, so a frame's noiseless samples at its
    onset agree where their payloads do."""
    cell = harness.load_cell("gf3-8192.b1024-20db")
    cfg = harness.reference_config(cell)
    traffic = dict(cell.traffic, batch=2, ring=1, frames=2, snr_db=300.0,
                   payload_bytes=0, channel=ROOM)
    a, b = (make_inputs(cfg, traffic, s, "cpu") for s in (1, 2))
    assert a.sent.equal(b.sent)
    for r in range(2):
        ra = a.ring[0][r, a.onsets[0, r]:][:cfg.frame_len]
        rb = b.ring[0][r, b.onsets[0, r]:][:cfg.frame_len]
        n = min(ra.numel(), rb.numel())
        assert float((ra[:n] - rb[:n]).abs().max()) < 1e-6


def test_a_channel_longer_than_the_cp_is_refused():
    cell = harness.load_cell("gf3-8192.b1024-20db")
    traffic = dict(cell.traffic, batch=2, ring=1, frames=2,
                   channel=dict(ROOM, rt60_s=0.05))
    with pytest.raises(harness.RunError, match="cyclic prefix"):
        make_inputs(harness.reference_config(cell), traffic, 1, "cpu")


def test_a_narrow_loaded_cell_through_a_room_is_correct():
    """GF3's published frame with a loading table from the program's probe
    decode through SMALL_ROOM at 20 dB, every payload bit exact, judged by
    the 20 dB cell's limits."""
    from gf3x_torch import Modem
    from gf3x_torch.ops.adapt import bit_loading_from_probe

    cell = harness.load_cell("gf3-8192.b1024-20db")
    cell.config = {"preset": "gf3-standard", "replace": {}, "reduced": []}
    cell.traffic = dict(cell.traffic, batch=8, ring=1, frames=8,
                        margin=1024, payload_bytes=100, channel=SMALL_ROOM)
    cell.spec = dict(cell.spec, warmup_steps=1, sample_rows=8)
    pcfg, rcfg = harness._configs(cell)
    probe = make_inputs(rcfg, cell.traffic, 31, "cpu").ring[0]
    _, diag = Modem(pcfg, max_delay=1024 + pcfg.cp, device="cpu").demodulate(
        probe)
    table = bit_loading_from_probe(diag, pcfg, margin_db=1.0)
    assert len(set(table)) >= 3
    cell.config["replace"] = {"bit_loading": list(table)}
    result, lines = harness.run(cell, 2 ** 33 + 9, 0.01, False, "cpu",
                                time.perf_counter())
    assert result["checks"]["bits_sent"]["value"] == 0
    assert result["correct"] is True, "\n".join(lines)
