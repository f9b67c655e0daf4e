"""The port's HARQ surface against gf3x's on the CPU, on
tests/test_combining.py's recordings: `Modem.coded_llrs` (plain, the
per-reception loop and a known δ), `joint_clock_offset`,
`decode_stream_llr` and `chase_combine` in all four of that file's
scenarios.

Tolerances: coded-stream LLR signs equal and |ΔLLR| ≤ 2e-4·mean|LLR| (the
EQ/demap tail's bound, PERF.md); the joint δ̂ within 0.05 ppm of gf3x's
(float32 pilot fits); `decode_stream_llr` runs kernel 3's float32 min-sum
where gf3x runs NumPy float64, so CRC, unsat count and payload are compared
always and the bits where every codeword converged."""

import numpy as np
import pytest

from gf3x import Modem as JModem
from gf3x import preset as j_preset
from gf3x.channel import awgn, delay_gain, resample_sfo
from gf3x.models.stream import chase_combine as j_chase

from gf3x_torch import Modem, preset
from gf3x_torch.models.stream import chase_combine

SNR_FAIL = -0.5      # tests/test_combining.py: below the gf3 cliff


def _reception(wav, delay, seed, snr_db=SNR_FAIL):
    rng = np.random.default_rng(seed)
    return awgn(delay_gain(wav, delay, 1.0, total_len=wav.size + 2000),
                snr_db, rng), delay


@pytest.fixture(scope="module")
def modems():
    return JModem(j_preset("gf3")), Modem(preset("gf3"), device="cpu")


def _scenario(name, jm):
    """tests/test_combining.py's recordings: (payload, receptions, sfo)."""
    rng = np.random.default_rng({"two": 5, "three": 6, "sfo": 8,
                                 "single": 0}[name])
    if name == "two":
        payload = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
        wav = jm.encode(payload, "f.bin")
        return payload, [_reception(wav, 300, 1), _reception(wav, 700, 2)], \
            "off"
    if name == "three":
        payload = bytes(rng.integers(0, 256, 400, dtype=np.uint8))
        wav = jm.encode(payload, "g.bin")
        return payload, [_reception(wav, 200 + 150 * i, 10 + i, -2.5)
                         for i in range(3)], "off"
    if name == "sfo":
        payload = bytes(rng.integers(0, 256, 400, dtype=np.uint8))
        wav = jm.encode(payload, "k.bin")
        rcp = []
        for seed in (31, 32):
            r = np.random.default_rng(seed)
            rx = resample_sfo(awgn(delay_gain(wav.astype(np.float64), 300,
                                              1.0, total_len=wav.size + 3000),
                                   0.5, r), 800.0)
            rcp.append((rx.astype(np.float32), 300))
        return payload, rcp, "on"
    payload = b"one copy"
    wav = jm.encode(payload, "h.bin")
    return payload, [_reception(wav, 400, 3, 12.0)], "off"


@pytest.mark.parametrize("route", ["plain", "sfo_correct", "delta"])
def test_coded_llrs_match(route, modems):
    """One failed reception's coded-stream LLRs through both packages, on
    each route: signs equal, |ΔLLR| ≤ 2e-4·mean|LLR|."""
    jm, tm = modems
    _, rcp, _ = _scenario("two", jm)
    rx, s = rcp[0]
    kw = {"plain": {}, "sfo_correct": dict(sfo_correct=True),
          "delta": dict(delta=300e-6)}[route]
    ref = jm.coded_llrs(rx, s, **kw)
    got = tm.coded_llrs(rx, s, **kw)
    assert got.shape == ref.shape == (tm.cfg.raw_bits_per_frame,)
    assert np.array_equal(got < 0, ref < 0)
    assert np.max(np.abs(got - ref)) <= 2e-4 * np.mean(np.abs(ref))


def test_joint_clock_offset_matches(modems):
    """The +800 ppm pair: the port's joint δ̂ within 0.05 ppm of gf3x's,
    both near the true offset."""
    jm, tm = modems
    _, rcp, _ = _scenario("sfo", jm)
    ref = jm.joint_clock_offset(rcp)
    got = tm.joint_clock_offset(rcp)
    assert abs(got - ref) * 1e6 <= 0.05
    assert abs(got * 1e6 - 800.0) < 250.0


@pytest.mark.parametrize("name", ["two", "three", "sfo", "single"])
def test_chase_combine_matches(name, modems):
    """tests/test_combining.py's four scenarios: CRC and payload equal to
    gf3x's; where that file asserts a decode, both packages decode the
    payload. In "three" two copies do not suffice and three do; in "sfo"
    plain combining fails and the joint clock offset recovers the frame."""
    jm, tm = modems
    payload, rcp, sfo = _scenario(name, jm)
    ref = j_chase(jm, rcp, sfo=sfo)
    got = chase_combine(tm, rcp, sfo=sfo)
    assert got.crc_ok == ref.crc_ok and got.payload == ref.payload
    assert got.crc_ok and got.payload == payload
    if name == "three":
        assert not chase_combine(tm, rcp[:2]).crc_ok
    if name == "sfo":
        assert not chase_combine(tm, rcp, sfo="off").crc_ok
    if name == "single":
        direct = tm.decode(rcp[0][0], start=rcp[0][1], sfo="off")
        assert direct.crc_ok and np.array_equal(direct.bits, got.bits)
        with pytest.raises(ValueError):
            chase_combine(tm, [])


def test_decode_stream_llr_matches(modems):
    """The FEC tail on gf3x's own summed LLRs of the "two" scenario and on
    one reception alone (which fails): CRC, unsat-free convergence and
    payload equal; bits equal where the combined decode converged."""
    jm, tm = modems
    _, rcp, _ = _scenario("two", jm)
    llrs = [jm.coded_llrs(rx, s) for rx, s in rcp]
    for llr, converged in ((llrs[0] + llrs[1], True), (llrs[0], False)):
        ref = jm.decode_stream_llr(llr)
        got = tm.decode_stream_llr(llr)
        assert got.crc_ok == ref.crc_ok == converged
        assert got.payload == ref.payload
        if converged:
            assert np.array_equal(got.bits, ref.bits)
