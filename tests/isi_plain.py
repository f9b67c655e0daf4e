"""A plain float64 copy of the port's ISI profile
(`gf3x_torch.ops.chanest.isi_profile`), for the tests that hold the port to
it where the profile departs from gf3x's: the anchor moves ahead of a
response that arrives before the phase-slope delay. Where the anchor stays
(`stays`), the profile is gf3x's, and the tests hold the port to gf3x
there. gf3x's host tables M and q (`_isi_operator`) are shared; everything
else is NumPy in float64.

The ramp's angle is formed as the port and gf3x form it, in float32
(k·2π/N first, then times the shift): at U = 280 its rounding moves Ĥ by up
to 6e-5 rad, more than the tolerances these tests hold the profile to."""

import numpy as np

from gf3x_torch.config import layout
from gf3x_torch.ops.chanest import _isi_operator

PEAK = 1e-3       # the onset clears this share of the energy peak
NOISE = 30.0      # and this many times the estimator noise's mean


def raw_estimate(cfg, known_rx, delta=None):
    """known_rx (B, K, U) → (raw LS Ĥ (B, U), noise_var (B,)), float64;
    `delta` derotates known symbol r by its window drift first."""
    Y = np.asarray(known_rx, np.complex128)
    if delta is not None:
        k = np.arange(cfg.bin_lo, cfg.bin_hi + 1)[None, :]
        r = np.arange(cfg.n_known_symbols)[:, None]
        Y = Y * np.exp(-2j * np.pi * k * float(np.float32(delta))
                       * cfg.symbol_len * r / cfg.n_fft)
    X = layout(cfg).known_syms.astype(np.complex128)
    H = np.mean(Y / X, axis=-2)
    nv = np.mean(np.abs(Y - H[:, None, :] * X) ** 2, axis=(-2, -1))
    return H, nv


def gf3x_anchor(cfg, H, t0):
    """gf3x's anchor ŝ − t0, ŝ read from Ĥ's adjacent-bin phase slope."""
    return np.round(-np.angle(np.sum(H[:, 1:] * np.conj(H[:, :-1]), -1))
                    * cfg.n_fft / (2 * np.pi)) - t0


def stays(cfg, H, nv):
    """(B,) bool: the rows whose anchor is gf3x's."""
    t0 = _isi_operator(cfg)[2]
    return anchor(cfg, H, nv, t0) == gf3x_anchor(cfg, H, t0)


def anchor(cfg, H, nv, t0):
    """The tap of each row's response moved to tap 0: ŝ − t0, unless the
    response's onset (the first sample of the Hann-tapered band-limited
    energy, at most cp − cp/4 − g taps before its peak, above PEAK of the
    peak and NOISE times the noise) lies before it: then the onset less
    g = min(2·t0, cp − cp/4)."""
    N, U = cfg.n_fft, cfg.n_used
    D = 1
    while N % (2 * D) == 0 and N // (2 * D) >= U:
        D *= 2
    n = N // D
    w = np.hanning(U + 2)[1:-1]
    out = gf3x_anchor(cfg, H, t0)
    e = np.abs(np.fft.ifft(H * w, n=n, axis=-1)) ** 2
    g = min(2 * t0, cfg.cp - cfg.cp // 4)
    span = (cfg.cp - cfg.cp // 4 - g) // D
    for b in range(len(H)):
        at = int(np.argmax(e[b]))
        thr = max(PEAK * e[b, at], NOISE * nv[b] / cfg.n_known_symbols
                  * np.sum(w ** 2) / n ** 2)
        hits = np.nonzero(e[b, (at - span + np.arange(span + 1)) % n]
                          >= thr)[0]
        if len(hits) == 0:
            continue
        onset = (at - span + hits[0]) * D
        if (onset - out[b] + N // 2) % N - N // 2 < 0:
            out[b] = (onset - g + N // 2) % N - N // 2
    return out


def isi_profile(cfg, H, nv):
    """Raw Ĥ (B, U) and noise_var (B,) → (isi_var (B, U), isi_ratio (B,))."""
    M, q, t0 = _isi_operator(cfg)
    a = anchor(cfg, H, nv, t0)
    k = np.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=np.float32)
    ang = (np.float32(2 * np.pi / cfg.n_fft) * k)[None, :] * a[:, None].astype(
        np.float32)
    Ht = (H * np.exp(1j * ang.astype(np.float64))) @ M.T.astype(np.complex128)
    isi = np.maximum(np.abs(Ht) ** 2 - (nv / cfg.n_known_symbols)[:, None]
                     * q.astype(np.float64), 0.0)
    return isi, np.mean(isi, -1) / np.maximum(np.mean(np.abs(H) ** 2, -1),
                                              1e-12)
