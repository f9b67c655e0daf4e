"""Sampling-clock offset from pilot slopes (counterpart of
gf3x/ops/sfo.py:slope_clock_offset), for `DecodeDiag.clock_ppm`. The SC
coarse estimator and the correction loop are not ported yet (ROADMAP
queue 1, item 7)."""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModemConfig

__all__ = ["slope_clock_offset"]


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
