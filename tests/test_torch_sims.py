"""`gf3x_torch.channel`, the port's copy of gf3x's channel simulators,
against `gf3x.channel` on the same inputs and seeds: bit for bit (both are
NumPy float64; tolerance none)."""

import numpy as np
import pytest

from gf3x import channel as jch

from gf3x_torch import channel as tch


def _x(seed=0, n=5000):
    return np.random.default_rng(seed).standard_normal(n)


CASES = {
    "awgn": lambda ch: ch.awgn(_x(), 7.5, np.random.default_rng(1)),
    "delay_gain": lambda ch: ch.delay_gain(_x(), 321, 0.4, total_len=6000),
    "delay_gain_cut": lambda ch: ch.delay_gain(_x(), 321, 0.4,
                                               total_len=4000),
    "room_impulse_response": lambda ch: ch.room_impulse_response(
        np.random.default_rng(2), rt60=0.02, drr_db=3.0),
    "multipath": lambda ch: ch.multipath(_x(), ch.room_impulse_response(
        np.random.default_rng(3))),
    "clip": lambda ch: ch.clip(3 * _x(), 1.0),
    "resample_sfo": lambda ch: ch.resample_sfo(_x(), 800.0),
    "resample_sfo_drift": lambda ch: ch.resample_sfo(
        _x(), -300.0, drift_ppm_per_s=50.0, wobble_ppm=20.0),
    "speaker_mic_fir": lambda ch: ch.speaker_mic_fir(
        ripple_db=2.0, rng=np.random.default_rng(4)),
    "chain": lambda ch: ch.Chain([
        ch.Impairment("awgn", lambda x, r: ch.awgn(x, 10.0, r)),
        ch.Impairment("clip", lambda x, r: ch.clip(x, 0.5))])(
            _x(), np.random.default_rng(5)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sims_bit_exact(name):
    ref, got = CASES[name](jch), CASES[name](tch)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)
