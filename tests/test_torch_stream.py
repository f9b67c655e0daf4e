"""The port's multi-frame receive side on the CPU: the six frozen captures
in tests/fixtures/ through gf3x_torch's `decode_stream` to their manifest
sha256 (as tests/test_captures.py runs gf3x's), the chunked
`StreamingReceiver`, and frame detection, the prewindowed decode and the
WAV reader against gf3x's."""

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gf3x import GF3_STANDARD
from gf3x import Modem as JModem
from gf3x.channel import awgn, resample_sfo
from gf3x.io import read_wav as j_read_wav
from gf3x.models.stream import find_frames as j_find_frames
from gf3x.utils.captures import capture_config as j_capture_config

from gf3x_torch import Modem
from gf3x_torch.io import read_wav, write_wav
from gf3x_torch.models.stream import (StreamingReceiver, StreamResult,
                                      decode_stream, find_frames,
                                      merge_streams)
from gf3x_torch.utils.captures import capture_config

FIXTURES = Path(__file__).parent / "fixtures"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
MULTI = next(c for c in MANIFEST["captures"] if c["n_frames"] > 1)


def check_capture(res, cap):
    assert res.complete, f"{cap['wav']}: missing frames {res.missing}"
    assert res.starts.size == cap["n_frames"]
    assert res.filename == cap["filename"]
    assert len(res.payload) == cap["payload_len"]
    assert hashlib.sha256(res.payload).hexdigest() == cap["payload_sha256"]


@pytest.mark.parametrize("cap", MANIFEST["captures"], ids=lambda c: c["wav"])
def test_capture_decodes_bit_exact(cap):
    """Each frozen capture through the port's `decode_stream` (default
    sfo='auto') with the config its manifest entry names: complete, the
    manifest's frame count, filename, length and sha256."""
    rx, _ = read_wav(FIXTURES / cap["wav"])
    cfg = capture_config(cap)
    assert (dataclasses.astuple(cfg)
            == dataclasses.astuple(j_capture_config(cap)))
    check_capture(decode_stream(Modem(cfg), rx), cap)


@pytest.mark.parametrize("sfo_correct", [False, True])
def test_demodulate_prewindowed_matches(sfo_correct):
    """The stream decoder's entry point, `demodulate_prewindowed`, on 4
    frame windows at 500 ppm with 25 dB AWGN, with and without the
    clock-offset loop: bits and unsatisfied-codeword counts equal to
    gf3x's, clock_ppm within 0.05 ppm."""
    cfg = GF3_STANDARD
    jm, tm = JModem(cfg), Modem(cfg)
    rng = np.random.default_rng(5)
    info = rng.integers(0, 2, (4, cfg.payload_bits_per_frame), np.uint8)
    wav = np.asarray(jm.modulate_frames(jnp.asarray(info)), np.float64)
    short = [resample_sfo(w, 500.0) for w in wav]    # compressed: shorter
    win = np.stack([awgn(np.pad(x, (0, cfg.frame_len - len(x))), 25.0, rng)
                    for x in short]).astype(np.float32)
    bits_r, d_r = jm.demodulate_prewindowed(jnp.asarray(win), sfo_correct)
    bits_t, d_t = tm.demodulate_prewindowed(torch.as_tensor(win),
                                            sfo_correct)
    assert np.array_equal(bits_t.numpy(), np.asarray(bits_r))
    assert np.max(np.abs(d_t.clock_ppm.numpy()
                         - np.asarray(d_r.clock_ppm))) <= 0.05
    assert np.array_equal(d_t.fec_unsat.numpy(), np.asarray(d_r.fec_unsat))


def test_streaming_receiver_uneven_chunks():
    """The multi-frame capture fed to `StreamingReceiver` in uneven chunks
    (prime sizes, one shorter than a chirp): every frame decodes once,
    and `result()` reassembles the manifest's payload."""
    rx, _ = read_wav(FIXTURES / MULTI["wav"])
    rcv = StreamingReceiver(Modem(capture_config(MULTI)))
    sizes = [7919, 104729, 2003, 31337]
    got, pos, i = [], 0, 0
    while pos < len(rx):
        n = sizes[i % len(sizes)]
        got += rcv.feed(rx[pos: pos + n])
        pos, i = pos + n, i + 1
    assert len(got) == MULTI["n_frames"] and all(r.crc_ok for r in got)
    assert sorted(r.seq for r in got) == list(range(MULTI["n_frames"]))
    check_capture(rcv.result(), MULTI)


def test_find_frames_matches_gf3x():
    """Frame onsets of the multi-frame capture: the same starts as gf3x's
    `find_frames`, NCC metrics within 1e-4."""
    rx, _ = read_wav(FIXTURES / MULTI["wav"])
    cfg = capture_config(MULTI)
    st_r, m_r = j_find_frames(JModem(j_capture_config(MULTI)), rx)
    st_t, m_t = find_frames(Modem(cfg), rx)
    assert np.array_equal(st_t, st_r) and st_t.size == MULTI["n_frames"]
    assert np.max(np.abs(m_t - m_r)) <= 1e-4


def test_merge_streams_reassembles_partial_receptions():
    """Two partial receptions of the multi-frame transfer (frames split
    between them) merge into the complete payload; one alone reports the
    missing seqs."""
    rx, _ = read_wav(FIXTURES / MULTI["wav"])
    full = decode_stream(Modem(capture_config(MULTI)), rx)
    a = StreamResult(None, "", False, full.frames[:1], full.starts[:1])
    b = StreamResult(None, "", False, full.frames[1:], full.starts[1:])
    assert merge_streams(a).missing == list(range(1, MULTI["n_frames"]))
    check_capture(merge_streams(b, a), MULTI)


def test_long_recording_is_not_ported_yet():
    """Above 1 000 000 samples gf3x scans on the device; the port raises
    and names the ROADMAP item."""
    m = Modem(capture_config(MULTI))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode_stream(m, np.zeros(1_000_001, np.float32))


def test_wav_roundtrip_matches_gf3x(tmp_path):
    """`read_wav` gives gf3x's samples on a fixture; `write_wav` → read is
    16-bit exact."""
    rx, fs = read_wav(FIXTURES / MULTI["wav"])
    ref, fs_r = j_read_wav(FIXTURES / MULTI["wav"])
    assert fs == fs_r == 44100 and np.array_equal(rx, ref)
    write_wav(tmp_path / "x.wav", rx[:5000])
    back, _ = read_wav(tmp_path / "x.wav")
    assert np.max(np.abs(back - rx[:5000])) <= 1.0 / 32767
