"""GF3 standard frame schema on torch tensors (counterpart of
gf3x/models/frame.py):

    chirp ∥ [Schmidl–Cox symbol] ∥ K known symbols ∥ D pilot-bearing data symbols

Pilot and known-symbol values default to the config's layout tables; a
`Modem` passes its own buffers instead. The bit-loaded variants are not
ported yet (ROADMAP queue 1)."""

from __future__ import annotations

import torch

from ..config import ModemConfig, layout

__all__ = ["scatter_factors", "interleave_bits", "interleave_pilots",
           "split_pilots", "data_symbols_from_bits", "frame_bin_matrix"]


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


def _require_strided(cfg: ModemConfig) -> None:
    if not cfg.strided_pilots:
        raise NotImplementedError(
            "irregular pilot layouts are not ported yet (ROADMAP queue 1, "
            "item 7): gf3x_torch takes pilot_offset 0 and a spacing that "
            "tiles the used band")


def interleave_pilots(cfg: ModemConfig, dsym: torch.Tensor,
                      pilot_vals: torch.Tensor | None = None) -> torch.Tensor:
    """Data symbols (..., n_data_bins) + pilots → (..., n_used): the used
    band viewed as (n_pilots, spacing) groups, pilot at slot 0 of each."""
    _require_strided(cfg)
    *lead, _ = dsym.shape
    grp = dsym.reshape(*lead, cfg.n_pilots, cfg.pilot_spacing - 1)
    pil = _pilot_values(cfg, dsym, pilot_vals).to(dsym.dtype)
    pil = pil.expand(*lead, cfg.n_pilots)[..., None]
    return torch.cat([pil, grp], dim=-1).reshape(*lead, cfg.n_used)


def split_pilots(cfg: ModemConfig, bins: torch.Tensor):
    """(..., n_used) → (pilot bins (..., n_pilots), data bins
    (..., n_data_bins)), the inverse of `interleave_pilots`."""
    _require_strided(cfg)
    *lead, _ = bins.shape
    grp = bins.reshape(*lead, cfg.n_pilots, cfg.pilot_spacing)
    return grp[..., 0], grp[..., 1:].reshape(*lead, cfg.n_data_bins)


def data_symbols_from_bits(cfg: ModemConfig, coded_bits: torch.Tensor,
                           pilot_vals: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Channel bits (..., raw_bits_per_frame) → data-symbol bins
    (..., D, n_used): Gray QAM on the data positions, pilots on theirs."""
    from ..ops.constellation import qam_map

    if cfg.bit_loading is not None:
        raise NotImplementedError("bit-loaded configs are not ported yet "
                                  "(ROADMAP queue 1, item 7)")
    *lead, _ = coded_bits.shape
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
