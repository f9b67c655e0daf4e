"""The port's device channel sims (`gf3x_torch.channel.torch_sims`) and BER
sweep (`gf3x_torch.bench.ber.ber_sweep`) against gf3x's `jax_sims` and
`ber_sweep` on the CPU, plus the curve-shape tests of
tests/test_ber_sweep.py on the port.

gf3x's sweep draws its payload bits and noise from jax.random; the parity
test reproduces those draws (`jax_draws`) and hands them to the port's
sweep as `info` and `noise`, so both run the same frames through the same
channel.

The configs are tests/test_ber_sweep.py's UNCODED and CODED — 93 used bins
at pilot spacing 8, a pilot layout that does not tile the band — and the
same with bin_hi = 103 (96 bins, a strided grid), so that the sweep is
held on both kinds of layout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gf3x import Modem as JModem
from gf3x.bench.ber import ber_sweep as jax_ber_sweep
from gf3x.channel import jax_sims
from gf3x.channel import room_impulse_response as jax_rir

from gf3x_torch import Modem
from gf3x_torch.bench.ber import ber_sweep
from gf3x_torch.channel import room_impulse_response, torch_sims

from test_ber_sweep import CODED as CODED_93
from test_ber_sweep import UNCODED as UNCODED_93

UNCODED = UNCODED_93.replace(bin_hi=103).validate()
CODED = CODED_93.replace(bin_hi=103).validate()


def _x(seed=0, shape=(3, 2, 4000)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _fir():
    return jax_rir(np.random.default_rng(0), fs=44100, rt60=0.004,
                   drr_db=8.0).astype(np.float32)


# each case: (gf3x's call, the port's call) on the same input, and the
# largest difference allowed relative to max |gf3x's output|: exact for the
# pure data moves; 1e-6 for awgn (float32 mean of x² summed in another
# order); 1e-5 for apply_fir (float32 FFTs of XLA and pocketfft)
SIMS = {
    "awgn": (lambda: jax_sims.awgn(jax.random.PRNGKey(3), jnp.asarray(_x()),
                                   jnp.asarray([[4.0], [9.0], [-2.0]])),
             lambda: torch_sims.awgn(
                 torch.as_tensor(_x()), torch.tensor([[4.0], [9.0], [-2.0]]),
                 noise=torch.as_tensor(np.array(jax.random.normal(
                     jax.random.PRNGKey(3), (3, 2, 4000), jnp.float32)))),
             1e-6),
    "apply_fir": (lambda: jax_sims.apply_fir(jnp.asarray(_x()),
                                             jnp.asarray(_fir())),
                  lambda: torch_sims.apply_fir(torch.as_tensor(_x()), _fir()),
                  1e-5),
    "delay": (lambda: jax_sims.delay(jnp.asarray(_x()), 777),
              lambda: torch_sims.delay(torch.as_tensor(_x()), 777), 0.0),
    "clip": (lambda: jax_sims.clip(jnp.asarray(3 * _x()), 0.7),
             lambda: torch_sims.clip(torch.as_tensor(3 * _x()), 0.7), 0.0),
}


@pytest.mark.parametrize("name", list(SIMS))
def test_torch_sims_match_jax_sims(name):
    ref_fn, got_fn, tol = SIMS[name]
    ref, got = np.asarray(ref_fn()), got_fn().numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref))


def test_awgn_generator_draws_on_device_of_input():
    """Without `noise`, the draw comes from the generator: one seed, one
    draw; the noise power follows snr_db per lead row."""
    x = torch.as_tensor(_x(shape=(2, 200000)))
    snr = torch.tensor([0.0, 10.0])
    a = torch_sims.awgn(x, snr, generator=torch.Generator().manual_seed(1))
    b = torch_sims.awgn(x, snr, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.device == x.device
    ratio = ((a - x) ** 2).mean(dim=-1) / (x ** 2).mean(dim=-1)
    assert np.allclose(ratio.numpy(), [1.0, 0.1], rtol=0.02)


def jax_draws(cfg, S, N, T, key=None):
    """gf3x's `ber_sweep` draws: the key split into (bits, noise), the
    payload bits (S, N, payload_bits) uint8 and unit noise (S, N, T)."""
    kbits, knoise = jax.random.split(key if key is not None
                                     else jax.random.PRNGKey(0))
    info = jax.random.bernoulli(kbits, 0.5, (S, N, cfg.payload_bits_per_frame)
                                ).astype(jnp.uint8)
    noise = jax.random.normal(knoise, (S, N, T), jnp.float32)
    return np.asarray(info), np.asarray(noise)


def counts(res, cfg):
    """A sweep's (pre-FEC bit errors, post-FEC bit errors, failed frames)
    per SNR point, as integers."""
    N = res["n_trials"]
    return (np.rint(res["ber_pre_fec"] * N * cfg.raw_bits_per_frame),
            np.rint(res["ber_post_fec"] * N * cfg.payload_bits_per_frame),
            np.rint(res["fer"] * N))


# (config, SNR grid, FIR, delay): tests/test_ber_sweep.py's three sweeps,
# and the coded config through the FIR and delay across its waterfall, at
# 96 bins; and tests/test_ber_sweep.py's own 93-bin configs (an irregular
# pilot layout) through the same sweeps
SWEEPS = {
    "uncoded": (UNCODED, [-4.0, 0.0, 6.0, 14.0, 24.0], False, 0),
    "coded": (CODED, [2.0, 5.0, 8.0], False, 0),
    "uncoded_fir": (UNCODED, [30.0], True, 50),
    "coded_fir": (CODED, [0.0, 2.0, 4.0, 6.0, 8.0], True, 50),
    "uncoded_93": (UNCODED_93, [-4.0, 0.0, 6.0, 14.0, 24.0], False, 0),
    "coded_93": (CODED_93, [2.0, 5.0, 8.0], False, 0),
    "coded_fir_93": (CODED_93, [0.0, 2.0, 4.0, 6.0, 8.0], True, 50),
}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_sweep_matches_gf3x_on_its_draws(case):
    """On gf3x's own payload and noise draws, the port's sweep counts the
    same errors. Tolerances: pre-FEC bit errors within 2 + 1e-3 of the
    count (hard decisions at the threshold can flip: the two float32
    pipelines round the AWGN power, the FFTs and the EQ differently);
    failed frames equal; post-FEC bit errors within 2 + 1 % of the count
    (a codeword that fails decodes to other wrong bits when the min-sum
    rounds differently — gf3x's XLA decoder contracts its update into an
    FMA, ROADMAP §3)."""
    cfg, snrs, fir, d = SWEEPS[case]
    h = _fir() if fir else None
    N = 8
    ref = jax_ber_sweep(JModem(cfg), snrs, n_trials=N, fir=h,
                        delay_samples=d)
    info, noise = jax_draws(cfg, len(snrs), N, cfg.frame_len + d)
    got = ber_sweep(Modem(cfg, device="cpu"), snrs, n_trials=N, fir=h,
                    delay_samples=d, info=info, noise=noise)
    assert np.array_equal(got["snr_db"], ref["snr_db"])
    assert got["n_trials"] == ref["n_trials"] == N
    assert got["bits_per_point"] == ref["bits_per_point"]
    (pre, post, fer), (rpre, rpost, rfer) = counts(got, cfg), counts(ref, cfg)
    assert np.all(np.abs(pre - rpre) <= 2 + 1e-3 * rpre)
    assert np.array_equal(fer, rfer)
    assert np.all(np.abs(post - rpost) <= 2 + 1e-2 * rpost)


def test_uncoded_qpsk_curve_shape():
    res = ber_sweep(Modem(UNCODED, device="cpu"),
                    snrs_db=[-4.0, 0.0, 6.0, 14.0, 24.0], n_trials=8)
    ber = res["ber_post_fec"]
    assert ber[0] > 0.05                       # noise-dominated end
    assert ber[-1] == 0.0                      # clean end
    assert all(ber[i] >= ber[i + 1] - 1e-3 for i in range(len(ber) - 1))
    assert np.array_equal(res["ber_pre_fec"], ber)   # fec='none'


def test_coding_gain_visible():
    """Post-FEC waterfall sits left of the raw curve (config 3's point)."""
    res = ber_sweep(Modem(CODED, device="cpu"), snrs_db=[2.0, 5.0, 8.0],
                    n_trials=8)
    assert res["ber_pre_fec"][1] > 0.0         # channel still makes raw errors
    assert res["ber_post_fec"][2] == 0.0       # code cleans up at modest SNR
    assert res["ber_post_fec"][1] <= res["ber_pre_fec"][1]


def test_sweep_with_multipath_fir():
    h = room_impulse_response(np.random.default_rng(0), fs=44100,
                              rt60=0.004, drr_db=8.0)
    res = ber_sweep(Modem(UNCODED, device="cpu"), snrs_db=[30.0], n_trials=8,
                    fir=h, delay_samples=50)
    assert res["ber_post_fec"][0] < 0.01
