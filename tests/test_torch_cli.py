"""The port's command line (`gf3x_torch.cli`, the `gf3x-torch` script) on
the CPU through `main([..., "--device", "cpu", ...])`: every subcommand of
gf3x's CLI, held against gf3x's CLI on the same files where both produce
the same thing; and what the CLI needs — `Modem.equalized_symbols` against
gf3x's, the plots, the live-audio boundary under a fake `sounddevice`, and
the profiling hooks. Without a CUDA device every subcommand run without
`--device cpu` must fail, never fall back to the CPU."""

import json
import sys
import types

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from gf3x import Modem as JModem
from gf3x.channel import awgn, delay_gain
from gf3x.cli import main as jax_main

from gf3x_torch import GoldenModem, Modem, ModemConfig
from gf3x_torch.cli import main
from gf3x_torch.config import preset

CPU = ["--device", "cpu"]


def stdout_of(capsys, fn, argv):
    """(exit code, stdout) of one CLI call."""
    capsys.readouterr()
    rc = fn(argv)
    return rc, capsys.readouterr().out


def json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def test_transmit_receive_roundtrip_and_report(tmp_path, capsys):
    """tests/test_stream.py's CLI round trip on the port, then the same
    transmission through a channel (delay, gain, 25 dB AWGN): the file
    comes back byte-equal, and `receive --json` reports what gf3x's CLI
    reports on the same WAV — every count, start and pass count equal,
    evm within 1e-4 and each |LLR| histogram bin within 2 + 1 % of
    gf3x's (float32 LLRs at a bin edge can land on either side)."""
    rng = np.random.default_rng(3)
    f = tmp_path / "doc.bin"
    f.write_bytes(bytes(rng.integers(0, 256, size=700, dtype=np.uint8)))
    tx = tmp_path / "tx.wav"
    assert main(CPU + ["--preset", "gf3", "transmit", str(f), "-o",
                       str(tx)]) == 0
    out = tmp_path / "out"
    assert main(CPU + ["--preset", "gf3", "receive", str(tx), "-o",
                       str(out)]) == 0
    assert (out / "doc.bin").read_bytes() == f.read_bytes()

    # gf3x's transmit of the same file: the same samples within one LSB
    jtx = tmp_path / "jtx.wav"
    assert jax_main(["--device", "cpu", "--preset", "gf3", "transmit",
                     str(f), "-o", str(jtx)]) == 0
    a, b = wavfile.read(tx)[1], wavfile.read(jtx)[1]
    assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= 1

    fs, x = wavfile.read(tx)
    rx = awgn(delay_gain(x / 32767.0, 3000, 0.5, total_len=x.size + 9000),
              25.0, rng)
    rxw = tmp_path / "rx.wav"
    wavfile.write(rxw, fs, (np.clip(rx, -1, 1) * 32767).astype(np.int16))
    rc, got = stdout_of(capsys, main, CPU + ["receive", str(rxw), "--json",
                                             "-o", str(tmp_path / "o2")])
    assert rc == 0
    assert (tmp_path / "o2" / "doc.bin").read_bytes() == f.read_bytes()
    rc, ref = stdout_of(capsys, jax_main, ["--device", "cpu", "receive",
                                           str(rxw), "--json", "-o",
                                           str(tmp_path / "o3")])
    assert rc == 0
    got, ref = json_line(got), json_line(ref)
    assert got.keys() == ref.keys()
    for k in got:
        if k == "evm":
            assert np.allclose(got[k], ref[k], rtol=0, atol=1e-4)
        elif k == "llr_hist":
            g, r = np.asarray(got[k]), np.asarray(ref[k])
            assert np.all(np.abs(g - r) <= 2 + 0.01 * r)
        else:
            assert got[k] == ref[k], k
    assert got["complete"] and got["frames_crc_ok"] == 2


def test_retransmit_frames_decode(tmp_path, capsys):
    """`retransmit --seqs 1` writes frame 1 alone, which decodes to seq 1
    of the file (an incomplete reception: exit code 2)."""
    from gf3x_torch.models.stream import frame_capacity

    rng = np.random.default_rng(4)
    cap = frame_capacity(Modem(preset("gf3"), device="cpu"), "r.bin")
    f = tmp_path / "r.bin"
    f.write_bytes(bytes(rng.integers(0, 256, size=cap + 100, dtype=np.uint8)))
    retx = tmp_path / "retx.wav"
    assert main(CPU + ["retransmit", str(f), "--seqs", "1", "-o",
                       str(retx)]) == 0
    rc, out = stdout_of(capsys, main, CPU + ["receive", str(retx), "--json"])
    rep = json_line(out)
    assert rc == 2 and not rep["complete"]
    assert rep["frames_crc_ok"] == 1 and rep["missing_seqs"] == [0]


@pytest.mark.parametrize("argv", [["--preset", "gf3"], ["--preset", "loopback"],
                                  ["--preset", "gf3-turbo"],
                                  ["--preset", "gf3", "--qam", "16"]])
def test_info_equals_gf3x(argv, capsys):
    rc, got = stdout_of(capsys, main, CPU + argv + ["info"])
    rc_j, ref = stdout_of(capsys, jax_main, ["--device", "cpu"] + argv
                          + ["info"])
    assert rc == rc_j == 0 and got == ref


def test_adapt_rejects_probe_crc_failure_and_rate_mismatch(tmp_path):
    """tests/test_adapt.py's refusals on the port: a noise probe (exit 2),
    a table stamped for another rate, a table file with no table."""
    cfg = preset("gf3")
    rng = np.random.default_rng(3)
    noise = (rng.normal(0, 0.05, 80000) * 32767).astype(np.int16)
    noise_wav = tmp_path / "noise.wav"
    wavfile.write(noise_wav, cfg.fs, noise)
    assert main(CPU + ["adapt", str(noise_wav)]) == 2
    tbl = tmp_path / "tbl.json"
    tbl.write_text(json.dumps({
        "table_rate": "1/2", "bit_loading": [2] * cfg.n_data_bins}))
    with pytest.raises(SystemExit, match="calibrated for rate 1/2"):
        main(CPU + ["--preset", "gf3-hicap", "--loading", str(tbl), "info"])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"bit_loading_error": "channel too poor"}))
    with pytest.raises(SystemExit, match="no bit_loading table"):
        main(CPU + ["--loading", str(bad), "info"])


def test_adapt_cli_roundtrip(tmp_path):
    """adapt → table JSON → transmit --loading → receive --loading, on the
    port (the probe from the port's golden model), as in
    tests/test_adapt.py; the receive takes the split tail (kernels A, B)."""
    rng = np.random.default_rng(11)
    cfg = preset("gf3")
    probe = GoldenModem(cfg).encode(b"probe payload", "p.bin")
    rx = awgn(delay_gain(probe, 700, 0.9, total_len=probe.size + 3000),
              22.0, rng)
    probe_wav = tmp_path / "probe.wav"
    wavfile.write(probe_wav, cfg.fs,
                  (np.clip(rx, -1, 1) * 32767).astype(np.int16))
    table_json = tmp_path / "table.json"
    assert main(CPU + ["adapt", str(probe_wav), "-o", str(table_json),
                       "--margin", "1.0", "--json"]) == 0
    table = json.loads(table_json.read_text())
    assert "bit_loading" in table
    assert len(table["bit_loading"]) == cfg.n_data_bins

    payload_file = tmp_path / "data.bin"
    payload_file.write_bytes(bytes(rng.integers(0, 256, 96, dtype=np.uint8)))
    tx_wav = tmp_path / "tx.wav"
    assert main(CPU + ["--loading", str(table_json), "transmit",
                       str(payload_file), "-o", str(tx_wav)]) == 0
    fs, tx = wavfile.read(tx_wav)
    rx2 = awgn(delay_gain(tx / 32767.0, 300, 0.9,
                          total_len=tx.size + 2000), 24.0, rng)
    rx_wav = tmp_path / "rx.wav"
    wavfile.write(rx_wav, fs, (np.clip(rx2, -1, 1) * 32767).astype(np.int16))
    outdir = tmp_path / "out"
    assert main(CPU + ["--loading", str(table_json), "receive", str(rx_wav),
                       "-o", str(outdir)]) == 0
    assert (outdir / "data.bin").read_bytes() == payload_file.read_bytes()


def test_sweep_json_small_grid(tmp_path, capsys):
    """`sweep --json` on a small grid prints gf3x's keys, BERs in [0, 1]
    that fall with SNR, and a plot renders."""
    pytest.importorskip("matplotlib")
    png = tmp_path / "ber.png"
    rc, out = stdout_of(capsys, main, CPU + [
        "--preset", "loopback", "sweep", "--snrs", "0", "20", "--trials", "2",
        "--json", "--plot", str(png)])
    res = json_line(out)
    assert rc == 0
    assert set(res) == {"snr_db", "ber_pre_fec", "ber_post_fec", "fer",
                        "n_trials", "bits_per_point"}
    assert res["snr_db"] == [0.0, 20.0] and res["n_trials"] == 2
    assert res["ber_pre_fec"][0] > res["ber_pre_fec"][1] == 0.0
    assert png.stat().st_size > 5000


def test_bench_small_batch(capsys):
    rc, out = stdout_of(capsys, main, CPU + ["bench", "--batch", "8"])
    res = json_line(out)
    assert rc == 0 and res["batch"] == 8 and res["device"] == "cpu"
    assert res["metric"] > 0 and res["unit"] == "data symbols/s"
    assert res["metric"] == pytest.approx(
        8 * preset("gf3").n_data_symbols / (res["step_ms"] / 1e3))


@pytest.mark.parametrize("argv", [
    ["transmit", "x.bin"], ["receive", "x.wav"],
    ["retransmit", "x.bin", "--seqs", "0"], ["sweep"], ["adapt", "x.wav"],
    ["info"], ["bench"]])
def test_default_device_is_cuda_without_fallback(argv):
    """Every subcommand defaults to the card: without one it fails with a
    non-zero exit before touching its input."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code not in (0, None)
    with pytest.raises(SystemExit) as e:
        main(["--device", "cuda"] + argv)
    assert e.value.code not in (0, None)


OBS_CFG = ModemConfig(
    n_fft=256, cp=64, bin_lo=8, bin_hi=103, pilot_spacing=8,
    n_known_symbols=2, n_data_symbols=12, chirp_duration=0.02,
    fec="ldpc", ldpc_z=24, ldpc_iters=10,
).validate()


@pytest.mark.parametrize("given_start", [False, True])
def test_equalized_symbols_match_gf3x(given_start):
    """tests/test_observability.py's constellation check on the port, and
    the symbols against gf3x's `equalized_symbols` on the same recording:
    within 1e-4 of the constellation's unit power (float32 EQ and pilot
    tracking, summed in other orders), with or without a given start."""
    rng = np.random.default_rng(1)
    jm, tm = JModem(OBS_CFG), Modem(OBS_CFG, device="cpu")
    wav = tm.encode(b"constellation payload!")
    rx = awgn(delay_gain(wav.astype(np.float64), 300, 0.7,
                         total_len=len(wav) + 1500), 28.0, rng)
    start = 300 if given_start else None
    syms = tm.equalized_symbols(rx, start=start)
    assert syms.dtype == np.complex64
    assert syms.shape == (OBS_CFG.n_data_symbols, OBS_CFG.n_data_bins)
    ref_pts = np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / np.sqrt(2)
    d = np.min(np.abs(syms[..., None] - ref_pts), axis=-1)
    assert np.percentile(d, 99) < 0.25
    ref = jm.equalized_symbols(rx, start=start)
    assert np.max(np.abs(syms - ref)) <= 1e-4
    # a batch of two recordings keeps its lead axis (the batch's float32
    # sums may round apart from the single recording's: 1e-5)
    two = tm.equalized_symbols(np.stack([rx, rx]), start=start)
    assert two.shape == (2,) + syms.shape and np.array_equal(two[0], two[1])
    assert np.max(np.abs(two[0] - syms)) <= 1e-5


def test_plots_render(tmp_path):
    pytest.importorskip("matplotlib")
    from gf3x_torch.bench.ber import ber_sweep
    from gf3x_torch.bench.plots import (save_ber_plot, save_channel_response,
                                        save_constellation)

    modem = Modem(OBS_CFG, device="cpu")
    save_ber_plot(ber_sweep(modem, snrs_db=[4.0, 10.0], n_trials=2),
                  tmp_path / "ber.png")
    rng = np.random.default_rng(2)
    wav = modem.encode(b"plots")
    rx = awgn(delay_gain(wav.astype(np.float64), 100, 1.0,
                         total_len=len(wav) + 500), 30.0, rng)
    res = modem.decode(rx)
    save_channel_response(res.diag.H, OBS_CFG, tmp_path / "h.png")
    save_constellation(modem.equalized_symbols(rx), tmp_path / "c.png")
    for f in ("ber.png", "h.png", "c.png"):
        assert (tmp_path / f).stat().st_size > 5000


class FakeSoundDevice(types.ModuleType):
    """Minimal sounddevice twin (tests/test_live_audio.py's): play()
    captures, rec() serves a cursor over a prepared capture buffer."""

    def __init__(self, capture: np.ndarray):
        super().__init__("sounddevice")
        self.capture = np.asarray(capture, np.float32)
        self.cursor = 0
        self.played = []

    def play(self, x, fs):
        assert fs == 44100
        self.played.append(np.asarray(x))

    def rec(self, n, samplerate, channels, dtype):
        assert samplerate == 44100 and channels == 1 and dtype == "float32"
        seg = self.capture[self.cursor: self.cursor + n]
        self.cursor += n
        out = np.zeros((n, 1), np.float32)
        out[: seg.size, 0] = seg
        return out

    def wait(self):
        pass


def test_play_record_roundtrip(monkeypatch):
    from gf3x_torch import io

    rng = np.random.default_rng(0)
    wav = rng.standard_normal(4096).astype(np.float32) * 0.1
    sd = FakeSoundDevice(wav)
    monkeypatch.setitem(sys.modules, "sounddevice", sd)
    assert io.have_live_audio()
    io.play(wav, 44100)
    assert len(sd.played) == 1 and np.array_equal(sd.played[0], wav)
    got = io.record(4096 / 44100.0, 44100)
    assert got.shape == (4096,) and np.array_equal(got, wav)


def test_gated_error_without_sounddevice(monkeypatch):
    """Without the package play/record raise the documented guidance, not
    an opaque ImportError."""
    import builtins

    from gf3x_torch.io import audio

    monkeypatch.delitem(sys.modules, "sounddevice", raising=False)
    real_import = builtins.__import__

    def no_sd(name, *a, **k):
        if name == "sounddevice":
            raise ImportError("No module named 'sounddevice'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_sd)
    assert not audio.have_live_audio()
    with pytest.raises(RuntimeError, match="sounddevice"):
        audio.play(np.zeros(8), 44100)
    with pytest.raises(RuntimeError, match="sounddevice"):
        audio.record(0.01)


def test_profiling_hooks(tmp_path, monkeypatch):
    """`maybe_trace` writes a Chrome trace where GF3X_PROFILE names a
    directory, and nothing otherwise."""
    from gf3x_torch.utils.profiling import maybe_trace

    monkeypatch.delenv("GF3X_PROFILE", raising=False)
    with maybe_trace():
        torch.ones(4).sum()
    monkeypatch.setenv("GF3X_PROFILE", str(tmp_path / "tr"))
    with maybe_trace():
        torch.ones(4).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]
