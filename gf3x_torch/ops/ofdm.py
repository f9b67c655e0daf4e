"""OFDM layer: batched real-FFT modulation with cyclic prefix, the used-band
DFT of CP-stripped symbols and its δ-warped form for the clock-offset loop
(counterpart of gf3x/ops/ofdm.py's CPU route: `torch.fft`, which is cuFFT on
the card; the wide bands' warped form a chirp-z transform, one hand-written
kernel a row at gf3-4096, gf3-8192 and gf3-16384), and the deroll ramp of a
block-grid cut."""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModemConfig
from ..utils.profiling import count, span
from .kernels.czt import (czt_fused, czt_post, czt_pre, filter_table,
                          takes_fused)

__all__ = ["ofdm_modulate", "ofdm_demodulate", "ofdm_dft", "warped_angle",
           "unreduced_angle", "UNREDUCED_MAX_ANGLE", "takes_czt", "czt_length",
           "chirp_tables", "czt_dft", "czt_chain", "deroll", "matmul_f32"]


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


# the largest angle (rad) up to which the warped DFT is gf3x's dense
# float32 product, (2π/N)·n·k·(1+δ): one ulp there is 2⁻¹³ rad, −86 to −91
# dB against float64 at config 5 (N = 1024, bins 24-303: 1902 rad), inside
# the −80 dB gate, and the narrow bands keep gf3x's numbers; past it the
# angle loses digits (−72 dB at gf3-8192) and the chirp-z transform runs
UNREDUCED_MAX_ANGLE = 2048.0


def warped_angle(cfg: ModemConfig, delta, device) -> torch.Tensor:
    """The dense warped DFT's table angle (n_fft, n_used), gf3x's
    (2π/N)·n·k·(1+δ) all in float32, n·k never reduced."""
    n = torch.arange(cfg.n_fft, dtype=torch.float32, device=device)[:, None]
    k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=torch.float32,
                     device=device)[None, :]
    d = torch.as_tensor(delta, dtype=torch.float32, device=device)
    return np.float32(2.0 * np.pi / cfg.n_fft) * n * k * (1.0 + d)


# the same table, under the name that says n·k is never reduced
unreduced_angle = warped_angle


def takes_czt(cfg: ModemConfig) -> bool:
    """Whether the warped DFT of this band is the chirp-z transform: where
    its largest angle 2π·bin_hi reaches UNREDUCED_MAX_ANGLE (every band
    wider than config 5's); below, gf3x's dense product."""
    return 2.0 * np.pi * cfg.bin_hi >= UNREDUCED_MAX_ANGLE


def czt_length(cfg: ModemConfig) -> int:
    """The chirp-z transform's FFT length: the least L ≥ n_fft + n_used − 1
    (the circular convolution's support) of the form 2^a or 3·2^a, which
    cuFFT runs in few passes (12 288 at gf3-8192)."""
    need = cfg.n_fft + cfg.n_used - 1
    pow2 = 1 << (need - 1).bit_length()
    return min(pow2, 3 << (-(-need // 3) - 1).bit_length())


_CHIRP_ANGLES: dict = {}   # (n_fft, bin_lo, n_used, L, scale, device) → parts


def _chirp_angles(cfg: ModemConfig, L: int, device):
    """The chirp tables' δ-free parts over [filter (L) | pre (N) | post
    (M)], float64 on `device`: the angle at δ = 0 with its integer reduced
    mod 2N exactly (int64), its δ slope, and the magnitude (the filter's
    1/(L·ofdm_scale), 0 in its gap; 1 elsewhere). Each entry's angle is
    ±(π/N)·(1 + δ)·q for an integer q: j² (filter, +) for j = −(N−1) …
    M−1 laid circularly over L, q = 2n·k_lo + n² (pre, −) and m² (post,
    −)."""
    N, M = cfg.n_fft, cfg.n_used
    key = (N, cfg.bin_lo, M, L, cfg.ofdm_scale, str(device))
    got = _CHIRP_ANGLES.get(key)
    if got is not None:
        return got
    n = torch.arange(N, dtype=torch.int64)
    m = torch.arange(M, dtype=torch.int64)
    i = torch.arange(L, dtype=torch.int64)
    j = torch.where(i < M, i, i - L)
    q = torch.cat([j * j, 2 * n * cfg.bin_lo + n * n, m * m])
    sign = torch.cat([torch.ones(L, dtype=torch.float64),
                      torch.full((N + M,), -1.0, dtype=torch.float64)])
    mag = torch.ones(L + N + M, dtype=torch.float64)
    mag[:L] = torch.where(j > -N, 1.0 / (L * cfg.ofdm_scale), 0.0)
    step = np.pi / N
    base = sign * step * torch.remainder(q, 2 * N).to(torch.float64)
    slope = sign * step * q.to(torch.float64)
    got = tuple(t.to(device) for t in (base, slope, mag))
    _CHIRP_ANGLES[key] = got
    return got


def chirp_tables(cfg: ModemConfig, delta, device, L: int):
    """The chirp-z transform's tables at δ on `device`, with no host sync
    for a device δ: (pre (N,), post (M,), H (L,)) complex64,
    pre[n] = e^{−iα(n·k_lo + n²/2)}, post[m] = e^{−iα·m²/2} and H the
    L-point spectrum of h[j] = e^{+iα·j²/2} (j = −(N−1) … M−1, circular)
    times 1/(L·ofdm_scale), α = 2π(1+δ)/N. δ is taken in float32, as the
    dense product takes it; each angle is its reduced integer part plus
    the δ term, in float64, and each table is rounded to complex64 once
    (float32 angles lose 18 dB at gf3-16384, where δ·j² reaches 2.4e5).
    Five launches: the angles, the complex exponential, the filter's FFT,
    two roundings."""
    N = cfg.n_fft
    base, slope, mag = _chirp_angles(cfg, L, device)
    d = torch.as_tensor(delta, dtype=torch.float32, device=device)
    t = torch.polar(mag, torch.addcmul(base, slope, d))
    H = torch.fft.fft(t[:L]).to(torch.complex64)
    ends = t[L:].to(torch.complex64)
    return ends[:N], ends[N:], H


def czt_dft(cfg: ModemConfig, sym: torch.Tensor, delta,
            L: int | None = None) -> torch.Tensor:
    """The δ-warped used-band DFT as a chirp-z transform: (..., S, n_fft)
    float32 → (..., S, n_used) complex64, scaled by 1/ofdm_scale, exact to
    float32's rounding (−131 to −135 dB against float64 at the wide
    bands). Over L (`czt_length` unless given), by shape alone: the fused
    kernel where `takes_fused` (L = 6144, 12 288, 24 576: gf3-4096,
    gf3-8192, gf3-16384), H reordered for it (`filter_table`); else the
    chain around cuFFT (`czt_chain`)."""
    L = L or czt_length(cfg)
    pre, post, H = chirp_tables(cfg, delta, sym.device, L)
    if takes_fused(L, cfg.n_fft, cfg.n_used):
        y = czt_fused(sym, pre, filter_table(H), post)
    else:
        y = czt_chain(sym, pre, H, post)
    return y.reshape(*sym.shape[:-1], cfg.n_used)


def czt_chain(sym: torch.Tensor, pre: torch.Tensor, H: torch.Tensor,
              post: torch.Tensor) -> torch.Tensor:
    """The chirp-z transform as five passes, at any L = H's length:
    `czt_pre` (reads the rows at their strides) → cuFFT over L → the
    product with H → the inverse FFT, unscaled (1/L is in H) → `czt_post`;
    (rows, M) complex64."""
    z = torch.fft.fft(czt_pre(sym, pre, H.shape[0]))
    z = torch.fft.ifft(z.mul_(H), norm="forward")
    return czt_post(z, post)


def ofdm_dft(cfg: ModemConfig, sym: torch.Tensor,
             delta: torch.Tensor | None = None) -> torch.Tensor:
    """Used-band DFT of CP-stripped symbols: (..., S, n_fft) float32 →
    (..., S, n_used) complex64, scaled by 1/ofdm_scale.

    `delta` (scalar tensor, fractional clock offset) warps the DFT to the
    bin frequencies k·(1+δ) the resampled waveform carries: the chirp-z
    transform (`czt_dft`) where `takes_czt`, else gf3x's full-float32
    product over the cos/sin tables of `warped_angle`, built on the
    tensor's device. The warped branch is the `warped_dft` span and counts
    its transforms (`ofdm.warped_dfts`), the symbol rows they take
    (`ofdm.warped_rows`), those of them the chirp-z transform takes
    (`ofdm.czt_rows`) and those of these its fused kernel takes
    (`ofdm.czt_fused_rows`)."""
    if delta is None:
        spec = torch.fft.rfft(sym, cfg.n_fft, dim=-1)
        return spec[..., cfg.bin_lo: cfg.bin_hi + 1] / np.float32(
            cfg.ofdm_scale)
    with span("warped_dft"):
        rows = sym.numel() // cfg.n_fft
        count("ofdm.warped_dfts", 1)
        count("ofdm.warped_rows", rows)
        xr = sym.to(torch.float32)
        if takes_czt(cfg):
            count("ofdm.czt_rows", rows)
            if takes_fused(czt_length(cfg), cfg.n_fft, cfg.n_used):
                count("ofdm.czt_fused_rows", rows)
            return czt_dft(cfg, xr, delta)
        th = warped_angle(cfg, delta, sym.device)
        inv = np.float32(1.0 / cfg.ofdm_scale)
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
