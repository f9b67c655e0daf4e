"""GF3 standard frame schema on torch tensors (counterpart of
gf3x/models/frame.py):

    chirp ∥ [Schmidl–Cox symbol] ∥ K known symbols ∥ D pilot-bearing data symbols

Pilot and known-symbol values default to the config's layout tables; a
`Modem` passes its own buffers instead. A bit-loaded config (SPEC.md §5b)
maps and demaps its data bins per constellation group (`loading_tables`)."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import ModemConfig, layout

__all__ = ["LoadingTables", "loading_tables", "loaded_qam_map",
           "loaded_demap_llr", "demap_bin_tables", "scatter_factors",
           "interleave_bits", "interleave_pilots", "split_pilots",
           "data_symbols_from_bits", "frame_bin_matrix"]


@dataclass(frozen=True)
class LoadingTables:
    """Host tables of a per-bin bit-loading config (gf3x's LoadingTables).

    Wire order is group-sorted: each OFDM symbol's coded bits fill the
    loaded data bins in ascending constellation order (all QPSK bins, then
    16-QAM, then 64-QAM), each group in ascending bin index, each bin's
    I-axis bits then its Q-axis bits."""

    groups: tuple          # ((bits, data-bin positions int32 ascending), ...)
    inv_perm: np.ndarray   # (n_data_bins,) int32 into concat(group syms)+[0]
    gain: float            # sqrt(n_data_bins / n_active): TX boost of the
                           # active bins, so nulled bins' power is reused


@functools.lru_cache(maxsize=None)
def loading_tables(cfg: ModemConfig) -> LoadingTables:
    bits = np.asarray(cfg.bit_loading, dtype=np.int32)
    groups = tuple(
        (m, np.nonzero(bits == m)[0].astype(np.int32))
        for m in (2, 4, 6) if np.any(bits == m)
    )
    active = np.concatenate([pos for _, pos in groups])
    inv = np.full(cfg.n_data_bins, len(active), dtype=np.int32)  # → zero slot
    inv[active] = np.arange(len(active), dtype=np.int32)
    return LoadingTables(
        groups=groups, inv_perm=inv,
        gain=float(np.sqrt(cfg.n_data_bins / len(active))),
    )


def loaded_qam_map(cfg: ModemConfig, coded: torch.Tensor) -> torch.Tensor:
    """Group-sorted coded bits (..., D, R) → data-bin symbols
    (..., D, n_data_bins) complex64: zeros on nulled bins, active bins
    boosted by `gain`."""
    from ..ops.constellation import qam_map

    t = loading_tables(cfg)
    *lead, D, _ = coded.shape
    syms, off = [], 0
    for m, pos in t.groups:
        n = len(pos)
        grp = coded[..., off: off + n * m].reshape(*lead, D, n, m)
        syms.append(qam_map(grp, m))
        off += n * m
    cat = torch.cat(syms + [torch.zeros(*lead, D, 1, dtype=syms[0].dtype,
                                        device=coded.device)], dim=-1)
    idx = torch.as_tensor(t.inv_perm, dtype=torch.long, device=coded.device)
    return cat[..., idx] * t.gain


def loaded_demap_llr(cfg: ModemConfig, data: torch.Tensor,
                     nv_eff: torch.Tensor):
    """Equalized data bins (..., D, n_data_bins) + per-bin noise → group-
    sorted LLRs (..., D, R) and EVM (...,) over the active bins: each group
    demaps y/g with noise nv/g², nulled bins give nothing."""
    from ..ops.constellation import hard_bits, qam_demap_llr, qam_map

    t = loading_tables(cfg)
    *lead, D, _ = data.shape
    nv_all = torch.broadcast_to(nv_eff, data.shape)
    llrs, err = [], 0.0
    for m, pos in t.groups:
        idx = torch.as_tensor(pos, dtype=torch.long, device=data.device)
        y = data[..., idx] * np.float32(1.0 / t.gain)
        nv = nv_all[..., idx] * np.float32(1.0 / t.gain ** 2)
        l3 = qam_demap_llr(y, nv, m)                     # (..., D, n_g, m)
        llrs.append(l3.reshape(*lead, D, len(pos) * m))
        err = err + torch.sum(
            torch.abs(y - qam_map(hard_bits(l3), m)) ** 2, dim=(-2, -1))
    evm = err / np.float32(D * cfg.n_active_bins)
    return torch.cat(llrs, dim=-1), evm


def demap_bin_tables(cfg: ModemConfig):
    """Per data bin j: (its used-bin index, its bits — 0 when nulled — and
    the offset of its first bit within a symbol's R wire bits), int32 each;
    the static tables of the demap kernel. A uniform config is one group."""
    nd = cfg.n_data_bins
    if cfg.bit_loading is None:
        bits = np.full(nd, cfg.bits_per_symbol, np.int32)
        off = np.arange(nd, dtype=np.int32) * cfg.bits_per_symbol
    else:
        bits = np.asarray(cfg.bit_loading, np.int32)
        off = np.zeros(nd, np.int32)
        base = 0
        for m, pos in loading_tables(cfg).groups:
            off[pos] = base + m * np.arange(len(pos), dtype=np.int32)
            base += m * len(pos)
    return layout(cfg).data_pos.astype(np.int32), bits, off


def scatter_factors(R: int) -> tuple[int, int]:
    """(A2, B2) with A2·B2 = R and B2 the divisor nearest √R — the
    bin-scatter stage of the v3 interleaver. B2 = 1 (prime R) degrades
    gracefully to the plain symbol transpose."""
    root = R ** 0.5
    B2 = 1
    for d in range(2, R):
        if R % d == 0 and abs(d - root) < abs(B2 - root):
            B2 = d
    return R // B2, B2


def interleave_bits(cfg: ModemConfig, arr, inverse: bool = False):
    """Channel-bit interleaver (WIRE_FORMAT v3, SPEC.md §5a) on
    (..., raw_bits_per_frame) bits or LLRs: the (R × D) symbol spread, then
    the (A2 × B2) bin scatter. Pure reshapes/transposes, so it works on
    numpy arrays and torch tensors alike."""
    *lead, _ = arr.shape
    R, D = cfg.bits_per_ofdm_symbol, cfg.n_data_symbols
    A2, B2 = scatter_factors(R)
    if not inverse:
        x = arr.reshape(*lead, A2, B2, D).swapaxes(-3, -2)
        return x.reshape(*lead, R, D).swapaxes(-2, -1).reshape(*lead, R * D)
    x = arr.reshape(*lead, D, R).swapaxes(-2, -1)
    x = x.reshape(*lead, B2, A2, D).swapaxes(-3, -2)
    return x.reshape(*lead, R * D)


def _pilot_values(cfg: ModemConfig, like: torch.Tensor,
                  pilot_vals: torch.Tensor | None) -> torch.Tensor:
    if pilot_vals is None:
        pilot_vals = torch.as_tensor(layout(cfg).pilot_vals)
    return pilot_vals.to(like.device)


@functools.lru_cache(maxsize=None)
def _layout_index(cfg: ModemConfig, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(pilot positions, data positions) within the used band as int64
    index tensors on `device`, made once per config and device."""
    lay = layout(cfg)
    return (torch.as_tensor(lay.pilot_pos, dtype=torch.long, device=device),
            torch.as_tensor(lay.data_pos, dtype=torch.long, device=device))


def interleave_pilots(cfg: ModemConfig, dsym: torch.Tensor,
                      pilot_vals: torch.Tensor | None = None) -> torch.Tensor:
    """Data symbols (..., n_data_bins) + pilots → (..., n_used). A strided
    layout is the used band viewed as (n_pilots, spacing) groups, pilot at
    slot 0 of each; any other layout (an offset, a spacing that does not
    tile the band, one pilot or none) is scattered by index."""
    *lead, _ = dsym.shape
    pil = _pilot_values(cfg, dsym, pilot_vals).to(dsym.dtype)
    if cfg.strided_pilots:
        grp = dsym.reshape(*lead, cfg.n_pilots, cfg.pilot_spacing - 1)
        pil = pil.expand(*lead, cfg.n_pilots)[..., None]
        return torch.cat([pil, grp], dim=-1).reshape(*lead, cfg.n_used)
    ppos, dpos = _layout_index(cfg, dsym.device)
    out = torch.zeros(*lead, cfg.n_used, dtype=dsym.dtype,
                      device=dsym.device)
    out.index_copy_(-1, dpos, dsym)
    out.index_copy_(-1, ppos, pil.expand(*lead, cfg.n_pilots))
    return out


def split_pilots(cfg: ModemConfig, bins: torch.Tensor):
    """(..., n_used) → (pilot bins (..., n_pilots), data bins
    (..., n_data_bins)), the inverse of `interleave_pilots`: a reshape on
    strided layouts, `index_select` on the others."""
    if cfg.strided_pilots:
        *lead, _ = bins.shape
        grp = bins.reshape(*lead, cfg.n_pilots, cfg.pilot_spacing)
        return grp[..., 0], grp[..., 1:].reshape(*lead, cfg.n_data_bins)
    ppos, dpos = _layout_index(cfg, bins.device)
    return bins.index_select(-1, ppos), bins.index_select(-1, dpos)


def data_symbols_from_bits(cfg: ModemConfig, coded_bits: torch.Tensor,
                           pilot_vals: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Channel bits (..., raw_bits_per_frame) → data-symbol bins
    (..., D, n_used): Gray QAM (per loading group when bit-loaded) on the
    data positions, pilots on theirs."""
    from ..ops.constellation import qam_map

    *lead, _ = coded_bits.shape
    if cfg.bit_loading is not None:
        grp = coded_bits.reshape(*lead, cfg.n_data_symbols,
                                 cfg.bits_per_ofdm_symbol)
        return interleave_pilots(cfg, loaded_qam_map(cfg, grp), pilot_vals)
    grp = coded_bits.reshape(*lead, cfg.n_data_symbols, cfg.n_data_bins,
                             cfg.bits_per_symbol)
    return interleave_pilots(cfg, qam_map(grp, cfg.bits_per_symbol),
                             pilot_vals)


def frame_bin_matrix(cfg: ModemConfig, data_syms: torch.Tensor,
                     known_syms: torch.Tensor | None = None) -> torch.Tensor:
    """Prepend the K known channel-estimation symbols → (..., K+D, n_used)."""
    if known_syms is None:
        known_syms = torch.as_tensor(layout(cfg).known_syms)
    *lead, _, U = data_syms.shape
    known = known_syms.to(data_syms.device).expand(
        *lead, cfg.n_known_symbols, U)
    return torch.cat([known, data_syms], dim=-2)
