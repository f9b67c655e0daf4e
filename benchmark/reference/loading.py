"""The reference's Gray constellations: the uniform map and max-log demap
axis that every band shares, and the bit-loaded map and demap (SPEC.md
§5b) of a configuration with a `bit_loading` table, rebuilt from the table
alone.

A loaded band follows the modem under test: wire order is sorted by group,
so each OFDM symbol's coded bits fill every QPSK bin, then every 16-QAM
bin, then every 64-QAM bin, each group in ascending bin order and each bin
its I bits before its Q bits; nulled bins carry zero and the active bins
are boosted by √(n_data_bins / n_active), so the symbol's power does not
depend on the table. The demap takes each group on y/g with noise
nv_eff/g², and the EVM is over the active bins alone."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import ModemConfig

__all__ = ["gray_levels", "gray_map", "axis_llr", "Loading", "loading",
           "loaded_map", "loaded_demap"]

BIG = 1e30            # the max-log demap's "no such label"


def gray_levels(bps: int) -> np.ndarray:
    """The unit-power QAM of `bps` bits' per-axis Gray PAM: label ℓ →
    amplitude ((M−1) − 2·idx)·norm with ℓ = idx ^ (idx >> 1)."""
    m = bps // 2
    M = 1 << m
    idx = np.arange(M)
    lut = np.empty(M)
    lut[idx ^ (idx >> 1)] = (M - 1) - 2 * idx
    return lut * (1.0 / np.sqrt(2.0 * (M * M - 1) / 3.0))


def gray_map(bits: np.ndarray, bps: int) -> np.ndarray:
    """Coded bits (..., bps) → QAM symbols (...) complex128: the first
    bps/2 bits label the I axis, the rest the Q axis, MSB first."""
    m = bps // 2
    w = 1 << np.arange(m - 1, -1, -1)
    lut = gray_levels(bps)
    return lut[bits[..., :m] @ w] + 1j * lut[bits[..., m:] @ w]


def axis_llr(x: torch.Tensor, lv: torch.Tensor, m: int) -> torch.Tensor:
    """Max-log LLRs of one axis: x (...) against the Gray levels lv (2^m,)
    → (..., m), positive ⇒ bit 0, unscaled by the noise."""
    labels = np.arange(1 << m)
    d = (x[..., None] - lv) ** 2
    out = []
    for j in range(m):
        one = torch.as_tensor(((labels >> (m - 1 - j)) & 1).astype(bool),
                              device=x.device)
        out.append(torch.amin(torch.where(one, d, BIG), -1)
                   - torch.amin(torch.where(one, BIG, d), -1))
    return torch.stack(out, -1)


class Loading(NamedTuple):
    """A bit-loading table's groups, in wire order."""
    groups: tuple          # ((bits a bin, data-bin positions ascending), ...)
    gain: float            # √(n_data_bins / n_active): the active bins' boost
    n_active: int


def loading(cfg: ModemConfig) -> Loading:
    """The groups of cfg.bit_loading: QPSK, 16-QAM, 64-QAM, those present."""
    bits = np.asarray(cfg.bit_loading, dtype=np.int64)
    groups = tuple((b, np.nonzero(bits == b)[0]) for b in (2, 4, 6)
                   if np.any(bits == b))
    n_active = int(np.count_nonzero(bits))
    return Loading(groups, float(np.sqrt(cfg.n_data_bins / n_active)),
                   n_active)


def loaded_map(cfg: ModemConfig, coded: np.ndarray) -> np.ndarray:
    """Wire-order coded bits (F, D, R), R = Σ table → data-bin symbols
    (F, D, n_data_bins) complex128: zero on nulled bins, each group's QAM
    boosted on its own bins."""
    tab = loading(cfg)
    F, D, _ = coded.shape
    out = np.zeros((F, D, cfg.n_data_bins), np.complex128)
    off = 0
    for bps, pos in tab.groups:
        n = len(pos)
        grp = coded[..., off: off + n * bps].reshape(F, D, n, bps)
        out[..., pos] = gray_map(grp, bps) * tab.gain
        off += n * bps
    return out


def loaded_demap(tab: Loading, data: torch.Tensor, nv_eff: torch.Tensor):
    """Equalised data bins and their noise, each (B, D, n_data_bins) →
    (wire-order LLRs (B, D, R), EVM (B,) over the active bins)."""
    B, D = data.shape[:2]
    dev = data.device
    llrs, err = [], 0.0
    for bps, pos in tab.groups:
        m = bps // 2
        idx = torch.as_tensor(pos, device=dev)
        y = data[..., idx] / tab.gain
        nv = nv_eff[..., idx] / tab.gain ** 2
        lv = torch.as_tensor(gray_levels(bps), dtype=nv.dtype, device=dev)
        l3 = torch.cat([axis_llr(y.real, lv, m), axis_llr(y.imag, lv, m)],
                       -1) / nv[..., None]
        hard = (l3 < 0).to(torch.long)
        w = torch.as_tensor(1 << np.arange(m - 1, -1, -1), device=dev)
        xd = torch.complex(lv[(hard[..., :m] * w).sum(-1)],
                           lv[(hard[..., m:] * w).sum(-1)])
        err = err + torch.sum(torch.abs(y - xd) ** 2, dim=(-2, -1))
        llrs.append(l3.reshape(B, D, len(pos) * bps))
    return torch.cat(llrs, -1), err / (D * tab.n_active)
