"""OFDM layer: batched real-FFT modulation with cyclic prefix, and the
used-band DFT of CP-stripped symbols (counterpart of gf3x/ops/ofdm.py's
CPU route: `torch.fft`, which is cuFFT on the card). The δ-warped DFT of
the clock-offset loop is not ported yet (ROADMAP queue 1, item 7)."""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModemConfig

__all__ = ["ofdm_modulate", "ofdm_dft"]


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


def ofdm_dft(cfg: ModemConfig, sym: torch.Tensor) -> torch.Tensor:
    """Used-band DFT of CP-stripped symbols: (..., S, n_fft) float32 →
    (..., S, n_used) complex64, scaled by 1/ofdm_scale."""
    spec = torch.fft.rfft(sym, cfg.n_fft, dim=-1)
    return spec[..., cfg.bin_lo: cfg.bin_hi + 1] / np.float32(cfg.ofdm_scale)
