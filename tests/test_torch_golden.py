"""The port's golden model (`gf3x_torch.golden`, a float64 NumPy copy of
gf3x's, wired to the port's NumPy helpers) against gf3x's: on the cases of
tests/test_golden.py every output equals gf3x's bit for bit (both run the
same float64 NumPy operations on the same tables; tolerance none), and on
the GF3 preset (LDPC, parity from the host projector) and a bit-loaded
config. Then tests/test_observability.py's fec-diag test against the
port's Modem: the Modem's pass count equals the golden decoder's."""

from dataclasses import fields

import numpy as np
import pytest

from gf3x.channel import (awgn, delay_gain, multipath, resample_sfo,
                          room_impulse_response)
from gf3x.golden import modem as jgolden

from gf3x_torch import GoldenModem, Modem, ModemConfig
from gf3x_torch.config import CONFIG1_LOOPBACK, layout, preset
from gf3x_torch.golden import modem as tgolden


def same(a, b) -> bool:
    """Equal values, arrays bit for bit (recursing through dicts, tuples
    and dataclasses)."""
    if hasattr(a, "__dataclass_fields__"):
        return type(a).__name__ == type(b).__name__ and all(
            same(getattr(a, f.name), getattr(b, f.name)) for f in fields(a))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
            a, b, equal_nan=a.dtype.kind in "fc")
    return a == b or (a != a and b != b)


def both(cfg):
    return GoldenModem(cfg), jgolden.GoldenModem(cfg)


@pytest.mark.parametrize("bps", [2, 4, 6])
def test_constellation_functions(bps):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, size=(500, bps), dtype=np.uint8)
    assert same(tgolden.pam_label_levels(bps // 2),
                jgolden.pam_label_levels(bps // 2))
    y = tgolden.qam_map(bits, bps)
    assert same(y, jgolden.qam_map(bits, bps))
    y = y + 0.3 * (rng.standard_normal(y.shape)
                   + 1j * rng.standard_normal(y.shape))
    nv = np.full(y.shape, 0.1)
    assert same(tgolden.qam_demap_llr(y, nv, bps),
                jgolden.qam_demap_llr(y, nv, bps))


def _ofdm(g):
    rng = np.random.default_rng(2)
    c = g.cfg
    sym = (rng.normal(size=(3, c.n_used))
           + 1j * rng.normal(size=(3, c.n_used))) / np.sqrt(2)
    x = g.ofdm_modulate(sym)
    return x, g.ofdm_demodulate(x), g.ofdm_demodulate(x, delta=3e-5)


def _sync(g):
    rng = np.random.default_rng(4)
    wav = g.encode(b"sync test payload")
    rx = awgn(delay_gain(wav, delay=3177, gain=0.3,
                         total_len=len(wav) + 8000), 15.0, rng)
    sc = g.schmidl_cox_metric(rx)
    o = 3177 + g.cfg.chirp_len + g.cfg.cp
    return (g.make_chirp(), g.find_frame_start(rx), sc,
            g.sc_clock_offset(rx[o: o + g.cfg.n_fft]))


def _chanest(g):
    cfg = g.cfg
    lay = layout(cfg)
    rng = np.random.default_rng(5)
    H = rng.normal(size=cfg.n_used) + 1j * rng.normal(size=cfg.n_used)
    Y = lay.known_syms * H[None, :] + 0.01 * rng.normal(size=(
        cfg.n_known_symbols, cfg.n_used))
    est = g.estimate_channel(Y)
    eq = g.equalize(Y, est[0])
    return est, g.estimate_channel(Y, delta=2e-5), g.pilot_phase_correct(
        eq, est[0]), g.slope_clock_offset(np.linspace(0, 1e-3, 7))


def _loopback(g):
    payload = b"The quick brown fox jumps over the lazy dog. " * 4
    wav = g.encode(payload, "fox.txt")
    return wav, g.decode(wav, start=0)


def _delay_gain(g):
    rng = np.random.default_rng(6)
    payload = bytes(rng.integers(0, 256, size=400, dtype=np.uint8))
    wav = g.encode(payload, "blob.bin")
    rx = delay_gain(wav, delay=12345, gain=0.21, total_len=len(wav) + 20000)
    return g.decode(awgn(rx, 25.0, rng))


def _room(g):
    rng = np.random.default_rng(7)
    payload = bytes(rng.integers(0, 256, size=300, dtype=np.uint8))
    wav = g.encode(payload, "room.bin")
    h = room_impulse_response(rng, fs=44100, rt60=0.015, drr_db=6.0)
    rx = multipath(wav, h)
    rx = delay_gain(rx, delay=2000, gain=1.0, total_len=len(rx) + 4000)
    return g.decode(awgn(rx, 30.0, rng))


def _sfo(g):
    rng = np.random.default_rng(8)
    payload = bytes(rng.integers(0, 256, size=200, dtype=np.uint8))
    rx = resample_sfo(g.encode(payload), ppm=40.0)
    rx = awgn(delay_gain(rx, delay=777, gain=0.8, total_len=len(rx) + 2000),
              30.0, rng)
    return g.decode(rx), g.decode(rx, sfo="on"), g.decode(rx, sfo="off")


def _noisy(payload_len, snr_db, seed):
    def run(g):
        rng = np.random.default_rng(seed)
        payload = bytes(rng.integers(0, 256, payload_len, dtype=np.uint8))
        wav = g.encode(payload, "n.bin")
        rx = awgn(delay_gain(wav, 1000, 0.5, total_len=len(wav) + 3000),
                  snr_db, rng)
        return wav, g.decode(rx), g.decode(rx[:5000])   # and a truncation
    return run


LOADED = ModemConfig(fec="none").replace(bit_loading=tuple(
    int(x) for x in np.random.default_rng(2).choice(
        [0, 2, 4, 6], size=ModemConfig().n_data_bins,
        p=[0.15, 0.4, 0.3, 0.15])))

# tests/test_golden.py's cases (its configs and draws), then the GF3 preset
# (LDPC encode and decode_diag) and a bit-loaded config
CASES = {
    "ofdm": (CONFIG1_LOOPBACK, _ofdm),
    "sync": (CONFIG1_LOOPBACK, _sync),
    "chanest": (CONFIG1_LOOPBACK, _chanest),
    "config1_loopback": (CONFIG1_LOOPBACK, _loopback),
    "config2_delay_gain": (CONFIG1_LOOPBACK, _delay_gain),
    "config3_room": (CONFIG1_LOOPBACK, _room),
    "sfo": (CONFIG1_LOOPBACK, _sfo),
    "16qam": (CONFIG1_LOOPBACK.replace(bits_per_symbol=4),
              _noisy(600, 30.0, 9)),
    "gf3_ldpc": (preset("gf3"), _noisy(500, 2.0, 10)),
    "bit_loaded": (LOADED, _noisy(200, 30.0, 11)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_golden_equals_gf3x_golden(case):
    cfg, run = CASES[case]
    got, ref = (run(g) for g in both(cfg))
    assert same(got, ref)


def test_golden_decodes_its_cases():
    """The cases above decode (tests/test_golden.py's gates), so the
    comparison is between working decoders."""
    for case in ("config1_loopback", "config2_delay_gain", "config3_room",
                 "16qam", "bit_loaded"):
        cfg, run = CASES[case]
        out = run(GoldenModem(cfg))
        res = out[1] if isinstance(out, tuple) else out
        assert res.crc_ok, case
    sfo = _sfo(GoldenModem(CONFIG1_LOOPBACK))
    assert sfo[0].crc_ok and sfo[1].crc_ok


FEC_CFG = ModemConfig(
    n_fft=256, cp=64, bin_lo=8, bin_hi=103, pilot_spacing=8,
    n_known_symbols=2, n_data_symbols=12, chirp_duration=0.02,
    fec="ldpc", ldpc_z=24, ldpc_iters=10,
).validate()


def test_fec_convergence_diag_matches_golden():
    """tests/test_observability.py's fec-diag test on the port: on a
    near-threshold frame (7 dB) the Modem's pass count equals the golden
    decoder's, both CRC-ok with no unsatisfied codeword; on junk the
    Modem reports stress."""
    modem, g = Modem(FEC_CFG, device="cpu"), GoldenModem(FEC_CFG)
    rng = np.random.default_rng(6)
    payload = bytes(rng.integers(0, 256, 60, dtype=np.uint8))
    wav = modem.encode(payload)
    rx = awgn(delay_gain(wav.astype(np.float64), 500, 0.6,
                         total_len=len(wav) + 2000), 7.0, rng)
    res = modem.decode(rx.astype(np.float32))
    gres = g.decode(rx)
    assert res.crc_ok and gres.crc_ok
    assert res.payload == gres.payload == payload
    assert int(res.diag.fec_unsat) == gres.diag["fec_unsat"] == 0
    assert int(res.diag.fec_iters) == gres.diag["ldpc_iters"]
    assert 1 <= int(res.diag.fec_iters) <= FEC_CFG.ldpc_iters

    junk = (rng.normal(size=rx.shape) * 0.1)
    rj = modem.decode(junk.astype(np.float32))
    assert not rj.crc_ok
    assert int(rj.diag.fec_unsat) >= 1
    assert int(rj.diag.fec_iters) == FEC_CFG.ldpc_iters


def test_golden_imports_nothing_of_gf3x():
    """Every import of the copy is NumPy's, the standard library's or the
    port's own (relative)."""
    import ast
    import inspect

    mods = set()
    for node in ast.walk(ast.parse(inspect.getsource(tgolden))):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add("." * node.level + (node.module or ""))
    assert all(m.startswith(".") or m in ("numpy", "__future__",
                                          "dataclasses", "typing")
               for m in mods), mods
