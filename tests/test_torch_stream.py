"""The port's multi-frame receive side on the CPU: the six frozen captures
in tests/fixtures/ through gf3x_torch's `decode_stream` to their manifest
sha256 (as tests/test_captures.py runs gf3x's), the chunked
`StreamingReceiver`, and frame detection (host and device scans, the
overlap-save matched filter), the prewindowed decode and the WAV reader
against gf3x's; and a recording above 1 000 000 samples through
`decode_stream`'s device-scan branch.

Tolerances: frame starts and decoded payloads exact; NCC metrics within
1e-4; the overlap-save correlation within 1e-5 of its peak magnitude
(float32 FFTs in two libraries)."""

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
from gf3x.models.stream import encode_file as j_encode_file
from gf3x.models.stream import find_frames as j_find_frames
from gf3x.models.stream import find_frames_device as j_find_frames_device
from gf3x.ops.chirp import make_chirp
from gf3x.ops.sync import streaming_matched_filter as j_streaming_mf
from gf3x.utils.captures import capture_config as j_capture_config

from gf3x_torch import Modem
from gf3x_torch.io import read_wav, write_wav
from gf3x_torch import preset
from gf3x_torch.models.stream import (MAX_HOST_SCAN, StreamingReceiver,
                                      StreamResult, decode_stream,
                                      encode_file, find_frames,
                                      find_frames_device, merge_streams)
from gf3x_torch.ops.sync import matched_filter, streaming_matched_filter
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
    check_capture(decode_stream(Modem(cfg, device="cpu"), rx), cap)


@pytest.mark.parametrize("sfo_correct", [False, True])
def test_demodulate_prewindowed_matches(sfo_correct):
    """The stream decoder's entry point, `demodulate_prewindowed`, on 4
    frame windows at 500 ppm with 25 dB AWGN, with and without the
    clock-offset loop: bits and unsatisfied-codeword counts equal to
    gf3x's, clock_ppm within 0.05 ppm."""
    cfg = GF3_STANDARD
    jm, tm = JModem(cfg), Modem(cfg, device="cpu")
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
    rcv = StreamingReceiver(Modem(capture_config(MULTI), device="cpu"))
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
    st_t, m_t = find_frames(Modem(cfg, device="cpu"), rx)
    assert np.array_equal(st_t, st_r) and st_t.size == MULTI["n_frames"]
    assert np.max(np.abs(m_t - m_r)) <= 1e-4


def test_merge_streams_reassembles_partial_receptions():
    """Two partial receptions of the multi-frame transfer (frames split
    between them) merge into the complete payload; one alone reports the
    missing seqs."""
    rx, _ = read_wav(FIXTURES / MULTI["wav"])
    full = decode_stream(Modem(capture_config(MULTI), device="cpu"), rx)
    a = StreamResult(None, "", False, full.frames[:1], full.starts[:1])
    b = StreamResult(None, "", False, full.frames[1:], full.starts[1:])
    assert merge_streams(a).missing == list(range(1, MULTI["n_frames"]))
    check_capture(merge_streams(b, a), MULTI)


def test_long_recording_is_not_ported_yet():
    """Above 1 000 000 samples `decode_stream` takes the device scan
    (gf3x's branch, no longer a `NotImplementedError`): a silent
    recording of that length finds no frame and reports an empty,
    incomplete result."""
    m = Modem(capture_config(MULTI), device="cpu")
    res = decode_stream(m, np.zeros(MAX_HOST_SCAN + 1, np.float32))
    assert not res.complete and res.starts.size == 0 and not res.frames


@pytest.mark.parametrize("chunk", [4096, 1 << 15])
def test_streaming_matched_filter_matches(chunk):
    """The overlap-save matched filter at a small chunk (several chunks,
    a ragged last one) against gf3x's and against the port's one-FFT
    filter: within 1e-5 of the peak magnitude."""
    cfg = GF3_STANDARD
    rng = np.random.default_rng(7)
    rx = rng.standard_normal(5 * chunk + 1234).astype(np.float32)
    rx[3000: 3000 + cfg.chirp_len] += make_chirp(cfg).astype(np.float32)
    chirp = make_chirp(cfg)
    ref = np.asarray(j_streaming_mf(jnp.asarray(rx), chirp, chunk))
    got = streaming_matched_filter(torch.as_tensor(rx), chirp, chunk).numpy()
    whole = matched_filter(torch.as_tensor(rx), chirp).numpy()
    peak = np.max(np.abs(ref))
    assert got.shape == ref.shape == rx.shape
    assert np.max(np.abs(got - ref)) <= 1e-5 * peak
    assert np.max(np.abs(got - whole)) <= 1e-5 * peak


@pytest.fixture(scope="module")
def long_recording():
    """Three loopback-preset frames of one `encode_file` transfer spread
    over 1 100 000 samples of noise (20 dB below the frames' power)."""
    cfg = preset("loopback")
    jm = JModem(cfg)
    rng = np.random.default_rng(12)
    cap = cfg.payload_bits_per_frame // 8 - 16 - len("long.bin")
    data = bytes(rng.integers(0, 256, 3 * cap - 100, dtype=np.uint8))
    wav = j_encode_file(jm, data, "long.bin")
    frames = wav.reshape(-1)
    stride = cfg.frame_len + int(round(0.05 * cfg.fs))
    rx = np.zeros(1_100_000, np.float32)
    onsets = [60_000, 480_000, 900_000]
    for i, o in enumerate(onsets):
        rx[o: o + cfg.frame_len] = frames[i * stride: i * stride
                                          + cfg.frame_len]
    p = float(np.mean(frames ** 2))
    rx += (rng.standard_normal(rx.size) * np.sqrt(p / 100)).astype(
        np.float32)
    return cfg, jm, data, rx, onsets


def test_find_frames_device_matches_gf3x(long_recording):
    """The per-segment device scan on the long recording, one FFT and
    overlap-save: the same starts as gf3x's `find_frames_device`, NCC
    metrics within 1e-4, each start within a CP of its planted onset."""
    cfg, jm, _, rx, onsets = long_recording
    tm = Modem(cfg, device="cpu")
    for chunk in (None, 1 << 17):
        st_r, m_r = j_find_frames_device(jm, rx, streaming_chunk=chunk)
        st_t, m_t = find_frames_device(tm, rx, streaming_chunk=chunk)
        assert np.array_equal(st_t, st_r) and st_t.size == 3
        assert np.max(np.abs(m_t - m_r)) <= 1e-4
        assert np.max(np.abs(st_t - np.asarray(onsets))) <= cfg.cp


def test_long_recording_decodes_through_device_scan(long_recording):
    """`decode_stream` of the 1.1 M-sample recording (the branch above
    1 000 000 samples): complete, the planted payload and filename; the
    port's `encode_file` gives gf3x's waveform within 1e-5."""
    cfg, jm, data, rx, _ = long_recording
    tm = Modem(cfg, device="cpu")
    res = decode_stream(tm, rx)
    assert res.complete and res.payload == data
    assert res.filename == "long.bin" and res.starts.size == 3
    ref = j_encode_file(jm, data, "long.bin")
    got = encode_file(tm, data, "long.bin")
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= 1e-5


def test_wav_roundtrip_matches_gf3x(tmp_path):
    """`read_wav` gives gf3x's samples on a fixture; `write_wav` → read is
    16-bit exact."""
    rx, fs = read_wav(FIXTURES / MULTI["wav"])
    ref, fs_r = j_read_wav(FIXTURES / MULTI["wav"])
    assert fs == fs_r == 44100 and np.array_equal(rx, ref)
    write_wav(tmp_path / "x.wav", rx[:5000])
    back, _ = read_wav(tmp_path / "x.wav")
    assert np.max(np.abs(back - rx[:5000])) <= 1.0 / 32767
