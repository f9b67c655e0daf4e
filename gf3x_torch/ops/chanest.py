"""Channel estimation and equalization on torch tensors (counterpart of
gf3x/ops/chanest.py): LS estimate with tap denoising, the beyond-CP ISI
profile, one-tap EQ and CSI-weighted pilot phase tracking.

The host tables (denoise projector P, ISI operator M and its noise gain q)
are built in float64 NumPy exactly as gf3x builds them; a `Modem` keeps
them as buffers and passes them in."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import ModemConfig, layout

__all__ = ["denoise_projection", "isi_profile", "estimate_channel",
           "equalize", "pilot_phase_correct"]


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


def _ramp(cfg: ModemConfig, H: torch.Tensor, t: int) -> torch.Tensor:
    """e^{+2πi·k·(ŝ − t)/N} over the used band, where ŝ is the bulk delay
    read from Ĥ's adjacent-bin phase slope: multiplying by it moves the
    impulse response to tap t."""
    k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=torch.float32,
                     device=H.device)
    inc = H[..., 1:] * torch.conj(H[..., :-1])
    a = torch.angle(torch.sum(inc, dim=-1))
    s_hat = torch.round(-a * np.float32(cfg.n_fft / (2.0 * np.pi)))
    ang = np.float32(2.0 * np.pi / cfg.n_fft) * k * (s_hat - t)[..., None]
    return torch.complex(torch.cos(ang), torch.sin(ang))


def isi_profile(cfg: ModemConfig, H_raw: torch.Tensor,
                noise_var: torch.Tensor, M: torch.Tensor | None = None,
                q: torch.Tensor | None = None):
    """Beyond-CP ISI floor from the RAW LS Ĥ: (isi_var (..., n_used) f32 —
    per-bin tail-response power in noise_var's units, estimator-noise share
    subtracted — and isi_ratio (...,) f32, tail/total channel energy; both
    zeros when the geometry has no tail window)."""
    op = _isi_operator(cfg)
    if op is None:
        z = torch.zeros(*H_raw.shape[:-1], cfg.n_used, device=H_raw.device)
        return z, torch.zeros(H_raw.shape[:-1], device=H_raw.device)
    if M is None:
        M, q = (torch.as_tensor(x, device=H_raw.device) for x in op[:2])
    Ht = (H_raw * _ramp(cfg, H_raw, op[2])) @ M.T
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
    isi = isi_profile(cfg, H, noise_var, M, q) if with_isi else None
    if cfg.est_taps:
        if P is None:
            P = torch.as_tensor(denoise_projection(cfg), device=dev)
        ramp = _ramp(cfg, H, cfg.est_taps // 4)
        H = ((H * ramp) @ P.T) * torch.conj(ramp)
    if with_isi:
        return H, noise_var, isi
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
