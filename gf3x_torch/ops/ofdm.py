"""OFDM layer: batched real-FFT modulation with cyclic prefix, the used-band
DFT of CP-stripped symbols and its δ-warped form for the clock-offset loop
(counterpart of gf3x/ops/ofdm.py's CPU route: `torch.fft`, which is cuFFT on
the card), and the deroll ramp of a block-grid cut."""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModemConfig
from ..utils.profiling import count, span

__all__ = ["ofdm_modulate", "ofdm_demodulate", "ofdm_dft", "warped_angle",
           "unreduced_angle", "UNREDUCED_MAX_ANGLE", "deroll", "matmul_f32"]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full float32 precision: TF32 is switched off for the call,
    whatever the process-wide setting (a TF32 product fails the −80 dB
    demod DFT gate). The switch is PyTorch's process-global flag, so a
    thread that runs a matmul meanwhile also runs it without TF32, and two
    threads in here at once may leave the flag off."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    mm.allow_tf32 = False
    try:
        return a @ b
    finally:
        mm.allow_tf32 = prev


def ofdm_modulate(cfg: ModemConfig, sym_bins: torch.Tensor) -> torch.Tensor:
    """(..., S, n_used) complex64 bin values → (..., S·(N+CP)) float32
    samples: zero-pad to the rfft grid, inverse real FFT, symbol-RMS
    scaling, CP prepend, flatten."""
    *lead, S, _ = sym_bins.shape
    spec = torch.nn.functional.pad(sym_bins.to(torch.complex64),
                                   (cfg.bin_lo, cfg.n_bins - cfg.bin_hi - 1))
    x = torch.fft.irfft(spec, cfg.n_fft, dim=-1) * np.float32(cfg.ofdm_scale)
    with_cp = torch.cat([x[..., -cfg.cp:], x], dim=-1)
    return with_cp.reshape(*lead, S * cfg.symbol_len)


def ofdm_demodulate(cfg: ModemConfig, samples: torch.Tensor,
                    delta: torch.Tensor | None = None) -> torch.Tensor:
    """(..., S·(N+CP)) float32 samples → (..., S, n_used) complex64 bins:
    CP strip by reshape and slice, then `ofdm_dft` (δ-warped when given)."""
    *lead, T = samples.shape
    S = T // cfg.symbol_len
    sym = samples.reshape(*lead, S, cfg.symbol_len)[..., cfg.cp:]
    return ofdm_dft(cfg, sym, delta)


# the largest angle (rad) up to which the warped DFT's table is gf3x's own,
# (2π/N)·n·k·(1+δ) in float32: one ulp there is 2⁻¹³ rad, −86 to −91 dB
# against float64 at config 5 (N = 1024, bins 24-303: 1902 rad), inside
# the −80 dB gate, and the narrow bands keep gf3x's numbers
UNREDUCED_MAX_ANGLE = 2048.0


def unreduced_angle(cfg: ModemConfig, delta, device) -> torch.Tensor:
    """gf3x's warped-DFT table angle, (2π/N)·n·k·(1+δ) all in float32."""
    n = torch.arange(cfg.n_fft, dtype=torch.float32, device=device)[:, None]
    k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=torch.float32,
                     device=device)[None, :]
    d = torch.as_tensor(delta, dtype=torch.float32, device=device)
    return np.float32(2.0 * np.pi / cfg.n_fft) * n * k * (1.0 + d)


def warped_angle(cfg: ModemConfig, delta, device) -> torch.Tensor:
    """The warped DFT's angles (n_fft, n_used) float32, (2π/N)·n·k·(1+δ)
    for n < N and k over the used bins.

    Where the largest angle passes UNREDUCED_MAX_ANGLE (every band wider
    than config 5's), n·k is reduced mod N in int64 before it becomes an
    angle, as `deroll` and kernel 8's twiddles are, and the angle is
    (2π/N)·((n·k mod N) + n·k·δ): gf3x's float32 product reaches 15 272
    rad at gf3-8192's top bin, where one ulp is 1e-3 rad, and n·k passes
    2²⁴ (−72 dB against float64). The warp n·k·δ is the exact int64
    product rounded once to float32, times δ: float32's relative accuracy
    on at most 2π·k_max·δ rad (2.3 rad at gf3-8192 and 150 ppm), under
    −110 dB at every band to |δ| = 1e-3. Below it, `unreduced_angle`."""
    if 2.0 * np.pi * cfg.bin_hi < UNREDUCED_MAX_ANGLE:
        return unreduced_angle(cfg, delta, device)
    n = torch.arange(cfg.n_fft, device=device)[:, None]
    k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, device=device)[None, :]
    nk = n * k
    th = torch.remainder(nk, cfg.n_fft).to(torch.float32)
    th.add_(nk.to(torch.float32).mul_(
        torch.as_tensor(delta, dtype=torch.float32, device=device)))
    return th.mul_(np.float32(2.0 * np.pi / cfg.n_fft))


def ofdm_dft(cfg: ModemConfig, sym: torch.Tensor,
             delta: torch.Tensor | None = None) -> torch.Tensor:
    """Used-band DFT of CP-stripped symbols: (..., S, n_fft) float32 →
    (..., S, n_used) complex64, scaled by 1/ofdm_scale.

    `delta` (scalar tensor, fractional clock offset) warps the DFT to the
    bin frequencies k·(1+δ) the resampled waveform carries: the cos/sin
    tables of `warped_angle` are built on the tensor's device, and the
    product is a full-float32 matmul (gf3x's HIGHEST twin). The warped
    branch is the `warped_dft` span and counts its transforms
    (`ofdm.warped_dfts`) and the symbol rows they take (`ofdm.warped_rows`)."""
    if delta is None:
        spec = torch.fft.rfft(sym, cfg.n_fft, dim=-1)
        return spec[..., cfg.bin_lo: cfg.bin_hi + 1] / np.float32(
            cfg.ofdm_scale)
    with span("warped_dft"):
        count("ofdm.warped_dfts", 1)
        count("ofdm.warped_rows", sym.numel() // cfg.n_fft)
        th = warped_angle(cfg, delta, sym.device)
        inv = np.float32(1.0 / cfg.ofdm_scale)
        xr = sym.to(torch.float32)
        re = matmul_f32(xr, torch.cos(th)) * inv
        im = -matmul_f32(xr, torch.sin(th)) * inv
        return torch.complex(re, im)


def deroll(cfg: ModemConfig, Y: torch.Tensor,
           roll: torch.Tensor | None) -> torch.Tensor:
    """Undo an early window cut of `roll` samples:
    Y[k]·e^{+2πik·roll/N} (the CP makes the shift circular).
    Y: (..., S, n_used); roll: (...,) int, or None for no cut offset.

    k·roll is reduced mod N in integers before it becomes an angle, as
    kernel 8 indexes its twiddle table: gf3x's float32 product
    (2π/N)·roll·k reaches ≈ 236 rad at GF3 geometry, where one ulp is
    1.5e-5 rad; the reduced angle stays below 2π."""
    if roll is None:
        return Y
    k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, device=Y.device)
    idx = (roll.to(torch.int64)[..., None, None] * k) % cfg.n_fft
    ang = np.float32(2.0 * np.pi / cfg.n_fft) * idx.to(torch.float32)
    return Y * torch.complex(torch.cos(ang), torch.sin(ang))
