"""Symbol layer: Gray QPSK/QAM map and max-log LLR demap on torch tensors
(counterpart of gf3x/ops/constellation.py, same labelling and bit order)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pam_label_levels", "qam_norm", "qam_map", "qam_demap_llr",
           "hard_bits"]


def pam_label_levels(m: int) -> np.ndarray:
    """Gray-coded PAM lookup (host constant): label int → amplitude.

    Level positions idx carry amplitudes (M−1)−2·idx and Gray label
    g = idx ^ (idx>>1), so the all-zeros label is the most positive level
    (QPSK → 1−2b)."""
    M = 1 << m
    idx = np.arange(M)
    lut = np.empty(M, dtype=np.float32)
    lut[idx ^ (idx >> 1)] = (M - 1) - 2 * idx
    return lut


def qam_norm(bits_per_symbol: int) -> float:
    M = 1 << (bits_per_symbol // 2)
    return float(1.0 / np.sqrt(2.0 * (M * M - 1) / 3.0))


def _levels(bits_per_symbol: int, device) -> torch.Tensor:
    m = bits_per_symbol // 2
    return torch.as_tensor(pam_label_levels(m) * qam_norm(bits_per_symbol),
                           device=device)


def qam_map(bits: torch.Tensor, bits_per_symbol: int) -> torch.Tensor:
    """(..., bits_per_symbol) bits → complex64 unit-power Gray QAM symbols."""
    m = bits_per_symbol // 2
    lut = _levels(bits_per_symbol, bits.device)
    w = torch.as_tensor(1 << np.arange(m - 1, -1, -1), device=bits.device)
    b = bits.to(torch.int64)
    bi = torch.sum(b[..., :m] * w, dim=-1)
    bq = torch.sum(b[..., m:] * w, dim=-1)
    return torch.complex(lut[bi], lut[bq])


def _axis_llr(x: torch.Tensor, lv: torch.Tensor, m: int) -> torch.Tensor:
    d = (x[..., None] - lv) ** 2                              # (..., M)
    M = 1 << m
    big = torch.tensor(1e30, dtype=torch.float32, device=x.device)
    outs = []
    for j in range(m):
        mask = torch.as_tensor(((np.arange(M) >> (m - 1 - j)) & 1)
                               .astype(bool), device=x.device)
        d0 = torch.amin(torch.where(mask, big, d), dim=-1)
        d1 = torch.amin(torch.where(mask, d, big), dim=-1)
        outs.append(d1 - d0)
    return torch.stack(outs, dim=-1)                          # (..., m)


def qam_demap_llr(y: torch.Tensor, noise_var: torch.Tensor,
                  bits_per_symbol: int) -> torch.Tensor:
    """Max-log LLRs, positive ⇒ bit 0. y: (...,) complex64; noise_var
    broadcastable to y.shape. Returns (..., bits_per_symbol) float32
    (the m I-axis bits, then the m Q-axis bits)."""
    m = bits_per_symbol // 2
    lv = _levels(bits_per_symbol, y.device)
    nv = torch.clamp(torch.as_tensor(noise_var, dtype=torch.float32),
                     min=1e-12)[..., None]
    return torch.cat([_axis_llr(y.real, lv, m) / nv,
                      _axis_llr(y.imag, lv, m) / nv], dim=-1)


def hard_bits(llr: torch.Tensor) -> torch.Tensor:
    """LLR convention: positive ⇒ bit 0, so hard bit = (llr < 0)."""
    return (llr < 0).to(torch.uint8)
