"""The port's spectrum cut (`gf3x_torch.ops.sync`: `rx_spectrum`,
`matched_filter_spec`, `extract_windows_spec` and `sc_metric_at`'s R= /
nfft= form) against gf3x's on the CPU.

gf3x computes these with jnp.fft outside any kernel (its TPU route swaps in
a matmul FFT at Precision.HIGH for the window cut; on the CPU it runs
jnp.fft), so the port's are torch.fft — cuFFT on the card. Tolerances,
relative to the largest input sample: 1e-6 for the spectrum and the
matched filter (float32 FFTs of pocketfft and XLA:CPU, observed 2-3e-7),
2e-6 for the window cut against gf3x's and against the exact slice of the
recording (observed ≤ 2.5e-7)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gf3x.ops import sync as jsync

from gf3x_torch import GF3_STANDARD, Modem
from gf3x_torch.ops import sync
from gf3x_torch.ops.chirp import make_chirp

NFFT = 1 << 16
NEED = 1024


def recording(T=50000, B=3, seed=0):
    return np.random.default_rng(seed).standard_normal((B, T)).astype(
        np.float32)


def test_rx_spectrum_and_matched_filter_spec_match_gf3x():
    """The shared sync spectrum and the matched filter read from it, against
    gf3x's; the matched filter from the spectrum equals `matched_filter` at
    the same length bit for bit."""
    rx = recording()
    T, chirp = rx.shape[-1], make_chirp(GF3_STANDARD)
    R_j = jsync.rx_spectrum(jnp.asarray(rx), NFFT)
    R = sync.rx_spectrum(torch.as_tensor(rx), NFFT)
    assert R.shape == (3, NFFT // 2 + 1) and R.dtype == torch.complex64
    peak = np.max(np.abs(np.asarray(R_j)))
    assert np.max(np.abs(R.numpy() - np.asarray(R_j))) <= 1e-6 * peak
    M_j = np.asarray(jsync.matched_filter_spec(R_j, chirp, T, NFFT))
    M = sync.matched_filter_spec(R, chirp, T, NFFT)
    assert M.shape == (3, T) and M.dtype == torch.float32
    assert np.max(np.abs(M.numpy() - M_j)) <= 1e-6 * np.max(np.abs(M_j))
    assert torch.equal(M, sync.matched_filter(torch.as_tensor(rx), chirp,
                                              NFFT))


@pytest.mark.parametrize("starts", [[0, 1, 2], [31337, 40000, 48976],
                                    [NFFT - NEED, NFFT - NEED - 1, 65000]],
                         ids=["head", "inside", "past_the_end"])
def test_extract_windows_spec_matches_gf3x_and_the_slice(starts):
    """Windows cut from the spectrum at starts up to nfft − need (past the
    recording's end they read its zero padding) against gf3x's cut and the
    slice itself."""
    rx = recording()
    starts = np.asarray(starts[:2] + [min(starts[2], NFFT - NEED)])
    R_j = jsync.rx_spectrum(jnp.asarray(rx), NFFT)
    W_j = np.asarray(jsync.extract_windows_spec(
        R_j, jnp.asarray(starts, jnp.int32), NEED, NFFT))
    W = sync.extract_windows_spec(sync.rx_spectrum(torch.as_tensor(rx),
                                                   NFFT),
                                  torch.as_tensor(starts), NEED, NFFT)
    assert W.shape == (3, NEED) and W.dtype == torch.float32
    pad = np.zeros((3, NFFT + NEED), np.float32)
    pad[:, : rx.shape[-1]] = rx
    ref = np.stack([pad[i, s: s + NEED] for i, s in enumerate(starts)])
    scale = np.max(np.abs(rx))
    assert np.max(np.abs(W.numpy() - W_j)) <= 2e-6 * scale
    assert np.max(np.abs(W.numpy() - ref)) <= 2e-6 * scale


def test_extract_windows_spec_reduces_the_ramp_in_integers():
    """On a 2²² FFT start·k reaches 2⁴³: the ramp's index is reduced mod
    nfft before any float, so the cut still equals the slice (a float32
    angle would be off by radians); and an nfft that is not a power of two
    is refused."""
    nfft, T = 1 << 22, 4_000_000
    rx = recording(T=T, B=1, seed=1)
    starts = torch.tensor([nfft - NEED - 3])
    W = sync.extract_windows_spec(sync.rx_spectrum(torch.as_tensor(rx),
                                                   nfft), starts, NEED, nfft)
    pad = np.zeros(nfft, np.float32)
    pad[:T] = rx[0]
    ref = pad[int(starts): int(starts) + NEED]
    assert np.max(np.abs(W[0].numpy() - ref)) <= 1e-5 * np.max(np.abs(rx))
    with pytest.raises(ValueError, match="power of two"):
        sync.extract_windows_spec(torch.zeros(1, 3, dtype=torch.complex64),
                                  starts, 4, 6)


def test_sc_metric_at_from_the_spectrum():
    """`sc_metric_at(..., R=, nfft=)` on recordings holding a frame (M ≈ 1
    at the SC window, low elsewhere) against gf3x's spectrum form and the
    port's own gather form, within 1e-4 (the windows differ by float32 FFT
    rounding)."""
    cfg = GF3_STANDARD
    m = Modem(cfg, device="cpu")
    rng = np.random.default_rng(3)
    wav = m.encode(b"sc metric", "sc.bin")
    T = wav.size + 3000
    rx = np.zeros((2, T), np.float32)
    rx[0, 1000: 1000 + wav.size] = wav
    rx[1, 2500: 2500 + wav.size] = 0.5 * wav
    rx += rng.normal(0, 1e-3, rx.shape).astype(np.float32)
    sc_at = np.array([1000, 2500]) + cfg.chirp_len + cfg.cp
    nfft = sync.sync_nfft(T, cfg.chirp_len)
    d = np.stack([sc_at, sc_at + 700, np.array([0, T])])      # (3, 2)
    x = torch.as_tensor(np.broadcast_to(rx, (3, 2, T)).copy())
    R = sync.rx_spectrum(x, nfft)
    got = sync.sc_metric_at(cfg, x, torch.as_tensor(d), R=R, nfft=nfft)
    gather = sync.sc_metric_at(cfg, x, torch.as_tensor(d))
    ref = np.asarray(jsync.sc_metric_at(
        cfg_j(cfg), jnp.asarray(x.numpy()), jnp.asarray(d, jnp.int32),
        R=jsync.rx_spectrum(jnp.asarray(x.numpy()), nfft), nfft=nfft))
    assert got.shape == (3, 2)
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-4
    assert np.max(np.abs(got.numpy() - gather.numpy())) <= 1e-4
    assert np.all(got[0].numpy() > 0.9) and np.all(got[1].numpy() < 0.5)


def cfg_j(cfg):
    """gf3x's ModemConfig with the port's config's fields."""
    import dataclasses

    from gf3x import ModemConfig as JConfig

    return JConfig(**dataclasses.asdict(cfg)).validate()
