"""Sampling-clock offset (SFO) estimation (counterpart of gf3x/ops/sfo.py):
the coarse Schmidl–Cox estimator, the fine pilot-slope estimator and the
sfo='auto' retry policy.

The acoustic channel has no carrier, so the offset shows as a clock-rate
offset δ between the transmitter's DAC and the receiver's ADC: the received
waveform is the transmitted one resampled by (1 + δ).

1. `sc_clock_offset`: the SC symbol's two identical halves arrive τ =
   δ·(N/2) samples apart, so each occupied half-grid bin q sees
   Y₂[q] = Y₁[q]·e^{iθq}; the phase slope over q, read unwrap-free from
   adjacent-bin increments and refined on a quarter-band baseline, gives δ.
   At the wide bands (n_fft ≥ 4096) a stage at a 32-bin baseline comes
   between the two, where gf3x's single step aliases
   (SC_SINGLE_STAGE_MAX_LAG).
2. `slope_clock_offset`: per-symbol pilot phase slopes (rad/bin) are
   2π·(window shift)/N, and the shift grows by δ·symbol_len per symbol; a
   least-squares line over the frame's D symbols gives δ."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import ModemConfig, layout
from .ofdm import matmul_f32

__all__ = ["sc_clock_offset", "slope_clock_offset", "SLOPE_PPM_RANGE",
           "auto_retry_needed", "prefer_retry"]

#: |δ| (ppm) beyond which the per-symbol pilot-slope fit starts aliasing on
#: GF3-like geometry: the sfo='auto' threshold for the correction loop.
SLOPE_PPM_RANGE = 350.0

#: The SC estimator's refinement lag (nq // 4 half-grid bins) up to which
#: one refinement follows the adjacent-bin estimate, as in gf3x; above it
#: a stage at lag SC_MID_LAG comes first. The adjacent-bin estimate carries
#: a leakage bias of up to ~0.03 rad a bin at the wide bands (the guarded
#: window is half a symbol, so neighbouring half-grid bins mix), and a
#: single refinement at lag Q aliases once Q times that error passes π:
#: gf3x's estimator then lands one ambiguity step (2π/Q a bin) off, on
#: every window at gf3-8192 (Q = 280). Every geometry gf3x's tests run
#: (Q = 35 at n_fft 1024, 70 at 2048) keeps gf3x's single stage.
SC_SINGLE_STAGE_MAX_LAG = 96
SC_MID_LAG = 32


def auto_retry_needed(crc_ok: bool, clock_ppm) -> bool:
    """The sfo='auto' trigger, shared by every decode path: retry through
    the correction loop when the plain decode failed CRC or reported a
    clock offset beyond the plain receiver's range. `clock_ppm` is a host
    scalar or per-row array."""
    if not crc_ok:
        return True
    return float(np.max(np.abs(np.asarray(clock_ppm)))) > SLOPE_PPM_RANGE


def prefer_retry(plain_crc_ok: bool, retry_crc_ok: bool) -> bool:
    """Keep the corrected decode unless it failed where the plain one
    succeeded."""
    return bool(retry_crc_ok) or not plain_crc_ok


@functools.lru_cache(maxsize=None)
def _sc_half_tables(cfg: ModemConfig):
    """Host DFT tables of the SC symbol's occupied bins on the HALF grid:
    full-grid even bin k is bin q = k/2 of an (N/2)-point transform of one
    half. The windows are guarded (length half − 2·guard, `guard` samples
    skipped at each end) so the half-periodicity survives ±guard samples of
    misalignment. Returns (C (L, nq), S (L, nq), q (nq,), guard), float32
    NumPy, built in float64."""
    lay = layout(cfg)
    half = cfg.n_fft // 2
    guard = half // 4
    L = half - 2 * guard
    used = lay.used_bins
    q = (used[(used % 2) == 0] // 2).astype(np.float64)
    n = np.arange(L, dtype=np.float64)[:, None]
    th = 2.0 * np.pi * n * q[None, :] / half
    return (np.cos(th).astype(np.float32), np.sin(th).astype(np.float32),
            q.astype(np.float32), guard)


@functools.lru_cache(maxsize=None)
def _sc_device_tables(cfg: ModemConfig, device: torch.device):
    """`_sc_half_tables`' C, S and q as tensors on `device`, copied there
    once per (config, device) rather than on every loop step."""
    C, S, q, _ = _sc_half_tables(cfg)
    return tuple(torch.as_tensor(a, device=device) for a in (C, S, q))


def sc_clock_offset(cfg: ModemConfig, sc_win: torch.Tensor,
                    pool: bool = False) -> torch.Tensor:
    """Coarse SFO from the SC symbol window: sc_win (..., n_fft) → δ̂ (...,)
    (δ̂·1e6 = ppm; positive δ ⇒ the waveform is compressed). `pool=True`
    sums the per-bin correlation coherently over every leading axis before
    the phase read and returns one scalar δ̂ (repeated receptions through
    the same clock pair). The four half-window products are full-float32
    matmuls."""
    _, _, q, guard = _sc_half_tables(cfg)
    Ct, St, qt = _sc_device_tables(cfg, sc_win.device)
    half = cfg.n_fft // 2
    L = half - 2 * guard
    h1 = sc_win[..., guard: guard + L]
    h2 = sc_win[..., guard + half: guard + half + L]
    y1 = torch.complex(matmul_f32(h1, Ct), -matmul_f32(h1, St))
    y2 = torch.complex(matmul_f32(h2, Ct), -matmul_f32(h2, St))
    rho = torch.conj(y1) * y2                                    # (..., nq)
    if pool:
        rho = torch.sum(rho.reshape(-1, rho.shape[-1]), dim=0)
    inc = rho[..., 1:] * torch.conj(rho[..., :-1])
    dq = np.float32(np.mean(np.diff(q)))
    a = torch.angle(torch.sum(inc, dim=-1)) / dq                 # rad per q
    nq = q.shape[0]
    Q = max(2, nq // 4)
    lags = [Q] if Q <= SC_SINGLE_STAGE_MAX_LAG else [SC_MID_LAG, Q]
    for lag in lags:
        zd = rho * torch.exp(-1j * a[..., None] * qt)
        corr = torch.sum(zd[..., lag:] * torch.conj(zd[..., :-lag]), dim=-1)
        base = np.float32(np.mean(q[lag:] - q[:-lag]))
        a = a + torch.angle(corr) / base
    tau = a * np.float32(half / (2.0 * np.pi))                   # samples
    return tau / np.float32(half)


def slope_clock_offset(cfg: ModemConfig, slopes: torch.Tensor) -> torch.Tensor:
    """Fine SFO from per-symbol pilot phase slopes (..., D) rad/bin → (...,):
    slope_d = 2π·shift_d/N with shift_d = shift₀ + δ·symbol_len·d, so a
    least-squares line through (d, slope_d) gives δ̂."""
    D = cfg.n_data_symbols
    if D < 2:
        return torch.zeros(slopes.shape[:-1], device=slopes.device)
    d = torch.arange(D, dtype=torch.float32, device=slopes.device)
    dc = d - torch.mean(d)
    a = torch.sum(dc * slopes, dim=-1) / torch.sum(dc * dc)
    return a * np.float32(cfg.n_fft / (2.0 * np.pi * cfg.symbol_len))
