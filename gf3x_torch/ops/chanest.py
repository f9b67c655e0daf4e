"""Channel estimation and equalization on torch tensors (counterpart of
gf3x/ops/chanest.py): LS estimate with tap denoising, the beyond-CP ISI
profile, one-tap EQ and CSI-weighted pilot phase tracking.

The host tables (denoise projector P, ISI operator M and its noise gain q)
are built in float64 NumPy exactly as gf3x builds them; a `Modem` keeps
them as buffers and passes them in. The ISI profile departs from gf3x's in
one place: its anchor moves ahead of a response that arrives before the
phase-slope delay (`isi_anchor`)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import ModemConfig, layout
from .kernels.isi_onset import isi_onset

__all__ = ["denoise_projection", "isi_anchor", "isi_profile",
           "estimate_channel", "equalize", "pilot_phase_correct"]


@functools.lru_cache(maxsize=None)
def denoise_projection(cfg: ModemConfig) -> np.ndarray:
    """Host projection matrix P (n_used × n_used) complex64 onto the
    channels with ≤ cfg.est_taps time-domain taps: P = W (WᴴW)⁻¹ Wᴴ with
    W[k,t] = e^{-2πi·k·t/N} over the used band."""
    taps = cfg.est_taps
    assert taps > 0
    k = np.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=np.float64)
    t = np.arange(taps, dtype=np.float64)
    W = np.exp(-2j * np.pi * np.outer(k, t) / cfg.n_fft)
    G = W.conj().T @ W + 1e-9 * np.eye(taps)
    P = W @ np.linalg.solve(G, W.conj().T)
    return P.astype(np.complex64)


def _isi_operator(cfg: ModemConfig):
    """Host tables of the beyond-CP ISI measure: (M, q, t0), or None when
    the geometry leaves no tail window. M maps the raw Ĥ to the response of
    the taps beyond t0 + (cp − backoff); q[k] = Σ_j |M_kj|² is its per-bin
    noise gain. Cached by the band's geometry alone, so configs that differ
    only past the channel estimate (FEC, loading, constellation) share its
    U × U solve (about 45 s on the host at U = 7616)."""
    return _isi_tables(cfg.n_fft, cfg.cp, cfg.bin_lo, cfg.bin_hi)


@functools.lru_cache(maxsize=None)
def _isi_tables(N: int, cp: int, bin_lo: int, bin_hi: int):
    U = bin_hi - bin_lo + 1
    t0 = min(16, U // 8)
    safe = t0 + cp - cp // 4
    if safe >= U - 4:
        return None
    k = np.arange(bin_lo, bin_hi + 1, dtype=np.float64)
    t = np.arange(U, dtype=np.float64)
    W = np.exp(-2j * np.pi * np.outer(k, t) / N)
    G = W.conj().T @ W + 1e-6 * U * np.eye(U)
    Winv = np.linalg.solve(G, W.conj().T)
    tail = np.arange(U) >= safe
    M = (W[:, tail] @ Winv[tail, :]).astype(np.complex64)
    q = np.sum(np.abs(M) ** 2, axis=1).astype(np.float32)
    return M, q, t0


def _bulk_delay(cfg: ModemConfig, H: torch.Tensor) -> torch.Tensor:
    """ŝ (...,): the response's bulk delay in whole taps, read from Ĥ's
    adjacent-bin phase slope."""
    inc = H[..., 1:] * torch.conj(H[..., :-1])
    a = torch.angle(torch.sum(inc, dim=-1))
    return torch.round(-a * np.float32(cfg.n_fft / (2.0 * np.pi)))


@functools.lru_cache(maxsize=None)
def _bins(bin_lo: int, bin_hi: int, device: torch.device) -> torch.Tensor:
    """The used band's bin indices as float32 on `device`."""
    return torch.arange(bin_lo, bin_hi + 1, dtype=torch.float32,
                        device=device)


def _shift_ramp(cfg: ModemConfig, shift: torch.Tensor) -> torch.Tensor:
    """e^{+2πi·k·shift/N} over the used band: multiplying Ĥ by it moves the
    impulse response's tap `shift` (...,) to tap 0."""
    k = _bins(cfg.bin_lo, cfg.bin_hi, shift.device)
    ang = np.float32(2.0 * np.pi / cfg.n_fft) * k * shift[..., None]
    return torch.complex(torch.cos(ang), torch.sin(ang))


# The ISI profile's onset test: a sample of the response's band-limited
# energy counts as arrived where it lies within ONSET_PEAK of the peak's and
# ONSET_NOISE times above the estimator noise's mean there.
ONSET_PEAK = 1e-3
ONSET_NOISE = 30.0


@functools.lru_cache(maxsize=None)
def _onset_plan(N: int, U: int, K: int):
    """(n, D, noise coefficient) of the onset search: the band's energy
    over an n = N/D-point inverse DFT, D the largest power of two with n ≥
    U (so the samples are every D-th tap of the band-limited response), of
    Ĥ under a Hann taper (sidelobes −31 dB, falling fast), whose noise
    per sample is σ_Ĥ² · Σ taper² / n², σ_Ĥ² = noise_var / K."""
    D = 1
    while N % (2 * D) == 0 and N // (2 * D) >= U:
        D *= 2
    n = N // D
    gain = float(np.sum(np.hanning(U + 2) ** 2) / n ** 2)
    return n, D, ONSET_NOISE * gain / K


@functools.lru_cache(maxsize=None)
def _onset_taper(U: int, device: torch.device) -> torch.Tensor:
    """The Hann taper over the U bins, float32 on `device`."""
    return torch.as_tensor(np.hanning(U + 2)[1:-1].astype(np.float32),
                           device=device)


def isi_anchor(cfg: ModemConfig, H_raw: torch.Tensor,
               noise_var: torch.Tensor, s_hat: torch.Tensor,
               t0: int) -> torch.Tensor:
    """The tap of the raw response that the ISI profile moves to tap 0,
    (...,) float32, on the device without a synchronise; `s_hat` is
    `_bulk_delay(cfg, H_raw)`.

    gf3x's anchor is ŝ − t0: the phase-slope delay with t0 taps of
    head-room. Through a speaker and a room ŝ lands after the direct path,
    whose energy then sits at negative taps and wraps into the tail window.
    So the response's onset is found in one band-limited inverse DFT of the
    raw Ĥ (`ops/kernels/isi_onset.py`): the first sample, at most
    cp − cp/4 − g taps before the energy peak, that clears ONSET_PEAK of
    the peak and ONSET_NOISE times the noise. Where the onset lies before
    ŝ − t0, the anchor moves g = min(2·t0, cp − cp/4) taps before it (room
    for the response's leading edge), which leaves the peak inside the
    safe window; elsewhere, as on a flat or one-tap channel, ŝ − t0
    stands."""
    U = cfg.n_used
    n, D, noise_coef = _onset_plan(cfg.n_fft, U, cfg.n_known_symbols)
    g = min(2 * t0, cfg.cp - cfg.cp // 4)
    lead = H_raw.shape[:-1]
    if len(lead) != 1:      # the kernel takes frames in one batch axis
        H_raw, s_hat, noise_var = (H_raw.reshape(-1, U), s_hat.reshape(-1),
                                   noise_var.reshape(-1))
    h = torch.fft.ifft(H_raw * _onset_taper(U, H_raw.device), n=n)
    anchor = isi_onset(h, s_hat - t0, noise_var, D=D,
                       span=(cfg.cp - cfg.cp // 4 - g) // D, g=g,
                       N=cfg.n_fft, peak_share=ONSET_PEAK,
                       noise_coef=noise_coef)
    return anchor if len(lead) == 1 else anchor.reshape(lead)


def isi_profile(cfg: ModemConfig, H_raw: torch.Tensor,
                noise_var: torch.Tensor, s_hat: torch.Tensor,
                M: torch.Tensor | None = None, q: torch.Tensor | None = None):
    """Beyond-CP ISI floor from the RAW LS Ĥ: (isi_var (..., n_used) f32 —
    per-bin tail-response power in noise_var's units, estimator-noise share
    subtracted — and isi_ratio (...,) f32, tail/total channel energy; both
    zeros when the geometry has no tail window). `s_hat` as `isi_anchor`
    takes it."""
    op = _isi_operator(cfg)
    if op is None:
        z = torch.zeros(*H_raw.shape[:-1], cfg.n_used, device=H_raw.device)
        return z, torch.zeros(H_raw.shape[:-1], device=H_raw.device)
    if M is None:
        M, q = (torch.as_tensor(x, device=H_raw.device) for x in op[:2])
    shift = isi_anchor(cfg, H_raw, noise_var, s_hat, op[2])
    Ht = (H_raw * _shift_ramp(cfg, shift)) @ M.T
    sigH2 = (noise_var / np.float32(cfg.n_known_symbols))[..., None]
    isi = torch.clamp(torch.abs(Ht) ** 2 - sigH2 * q, min=0.0)
    num = torch.mean(isi, dim=-1)
    den = torch.mean(torch.abs(H_raw) ** 2, dim=-1)
    return isi, num / torch.clamp(den, min=1e-12)


def estimate_channel(cfg: ModemConfig, known_rx: torch.Tensor,
                     delta: torch.Tensor | None = None,
                     with_isi: bool = False, *,
                     known_syms: torch.Tensor | None = None,
                     P: torch.Tensor | None = None,
                     M: torch.Tensor | None = None,
                     q: torch.Tensor | None = None):
    """LS: Ĥ[k] = mean_r(Y_r[k]/X_r[k]) and the scalar residual noise
    variance. known_rx: (..., K, n_used) complex64 → (Ĥ (..., n_used),
    noise_var (...,)), plus (isi_var, isi_ratio) from the RAW Ĥ when
    `with_isi`. With est_taps > 0, Ĥ is projected onto ≤ est_taps taps
    after moving its bulk delay to tap est_taps//4.

    `delta` (scalar clock offset) first derotates known symbol r by the
    window drift it accumulates, e^{−2πik·δ·r·symbol_len/N}, so that the
    average does not smear top-bin phases at |δ| ≳ 500 ppm."""
    dev = known_rx.device
    X = (torch.as_tensor(layout(cfg).known_syms) if known_syms is None
         else known_syms).to(dev)
    if delta is not None:
        k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=torch.float32,
                         device=dev)[None, :]
        r = torch.arange(cfg.n_known_symbols, dtype=torch.float32,
                         device=dev)[:, None]
        d = torch.as_tensor(delta, dtype=torch.float32, device=dev)
        ang = (np.float32(-2.0 * np.pi / cfg.n_fft) * k
               * (d * np.float32(cfg.symbol_len)) * r)
        known_rx = known_rx * torch.complex(torch.cos(ang), torch.sin(ang))
    H = torch.mean(known_rx / X, dim=-2)
    resid = known_rx - H[..., None, :] * X
    noise_var = torch.mean(torch.abs(resid) ** 2, dim=(-2, -1))
    H_raw = H
    s_hat = _bulk_delay(cfg, H) if with_isi or cfg.est_taps else None
    if cfg.est_taps:
        if P is None:
            P = torch.as_tensor(denoise_projection(cfg), device=dev)
        ramp = _shift_ramp(cfg, s_hat - cfg.est_taps // 4)
        H = ((H * ramp) @ P.T) * torch.conj(ramp)
    if with_isi:
        # after the denoise's product, which keeps the card busy while the
        # host issues the ISI anchor's search
        return H, noise_var, isi_profile(cfg, H_raw, noise_var, s_hat, M, q)
    return H, noise_var


def equalize(H: torch.Tensor, data_rx: torch.Tensor) -> torch.Tensor:
    """One-tap FD EQ X̂ = Y/Ĥ. data_rx: (..., D, n_used), H: (..., n_used)."""
    return data_rx / H[..., None, :]


def pilot_phase_correct(cfg: ModemConfig, eq: torch.Tensor,
                        H: torch.Tensor | None = None,
                        pilot_vals: torch.Tensor | None = None):
    """Residual timing-drift/phase correction from pilot phase slopes: per
    data symbol fit ∠(X̂_p·p*) ≈ a·k + b (slope from adjacent-pilot
    increments, refined on a baseline ladder; intercept from the
    slope-compensated pilot sum), CSI-weighted by |Ĥ_p|² when Ĥ is given.
    Returns (corrected (..., D, n_used), slope (..., D), intercept (..., D))."""
    from ..models.frame import split_pilots

    lay = layout(cfg)
    if cfg.n_pilots < 2:
        zeros = torch.zeros(eq.shape[:-1], dtype=torch.float32,
                            device=eq.device)
        return eq, zeros, zeros
    if pilot_vals is None:
        pilot_vals = torch.as_tensor(lay.pilot_vals)
    pil, _ = split_pilots(cfg, eq)
    z = pil * torch.conj(pilot_vals.to(eq.device))            # (..., D, P)
    if H is not None:
        w, _ = split_pilots(cfg, torch.abs(H) ** 2)           # (..., P)
        z = z * w[..., None, :]
    kp = lay.pilot_pos.astype(np.float64)
    mean_dk = np.float32(np.mean(np.diff(kp)))
    inc = z[..., 1:] * torch.conj(z[..., :-1])
    a = torch.angle(torch.sum(inc, dim=-1)) / mean_dk          # (..., D)
    k = torch.as_tensor(lay.pilot_pos.astype(np.float32), device=eq.device)

    def derotate(x, ph):                                       # x·e^{−i·ph}
        return x * torch.polar(torch.ones_like(ph), -ph)

    P = cfg.n_pilots
    for Q in sorted({max(2, P // 8), P // 2}):
        if not 1 <= Q < P:
            continue
        zd = derotate(z, a[..., None] * k)
        corr = torch.sum(zd[..., Q:] * torch.conj(zd[..., :-Q]), dim=-1)
        a = a + torch.angle(corr) / np.float32(np.mean(kp[Q:] - kp[:-Q]))
    b = torch.angle(torch.sum(derotate(z, a[..., None] * k), dim=-1))
    kk = torch.arange(cfg.n_used, dtype=torch.float32, device=eq.device)
    return derotate(eq, a[..., None] * kk + b[..., None]), a, b
