"""The split EQ/demap tail (`csrc/split_eq.cu`), each kernel with its plain
PyTorch version:

- kernel A, `eq_track` (replacing gf3x/ops/pallas/split_eq.py:eq_track_tpu):
  one-tap EQ, pilot slope/CPE tracking, derotation and the per-symbol
  noise floor → eq (B, D, U) complex64, slope, cpe, nv_sym (B, D) f32;
- kernel B, `demap_bins` (replacing :demap_bins_tpu): max-log demap of
  every data bin at its loaded order → llr (B, D·R) f32, scrambled and in
  wire order (group-sorted when bit-loaded), evm (B,) over the active bins
  and mean |llr| (B,). The kernel walks the wire-order slot table
  (`slot_table`) with one warp per data symbol (`demap_geometry`).

Both take their launch from `eq_layout`: kernel A kernel 2's layouts
(`fused_eq_geometry(..., demap=False)`: staged, teamed, spilled), kernel B
staged or streamed (`demap_geometry`); each layout gives the same bits.
Kernels A and 2 read the pilot layout from `layout_table` and the pilot
values from `pilot_floats`.

The plain versions are the XLA twin's math (Modem._eq_tail,
loaded_demap_llr / qam_demap_llr); `fused_eq_demap_plain` is the two run
back to back. Each wrapper runs its plain version for CPU tensors and
launches its kernel for CUDA tensors (or raises), and counts launches in
`.launches`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...config import ModemConfig, layout
from ...utils.device import launch, sm_count
from ..chanest import equalize, pilot_phase_correct
from ..constellation import (hard_bits, pam_label_levels, qam_demap_llr,
                             qam_map, qam_norm)
from .eq_layout import (FusedGeometry, demap_geometry, fused_eq_geometry,
                        spill_scratch)

__all__ = ["eq_track", "eq_track_plain", "demap_bins", "demap_bins_plain",
           "slot_table", "unpack_slots", "track_constants", "layout_table",
           "pilot_floats"]


def eq_track_plain(cfg: ModemConfig, Y: torch.Tensor, H: torch.Tensor,
                   noise_var: torch.Tensor,
                   pilot_vals: torch.Tensor | None = None):
    """Y (B, K+D, U) complex64 spectra (derolled), H (B, U) complex64,
    noise_var (B,) → (eq (B, D, U) derotated equalized bins, slope, cpe,
    nv_sym (B, D)). Below two pilots there is no fit (slope = cpe = 0, no
    derotation); a pilotless config has no noise floor either: nv_sym is
    noise_var on every symbol (gf3x's `_eq_tail`)."""
    from ...models.frame import split_pilots

    if pilot_vals is None:
        pilot_vals = torch.as_tensor(layout(cfg).pilot_vals)
    pilot_vals = pilot_vals.to(Y.device)
    eq = equalize(H, Y[:, cfg.n_known_symbols:])
    eq, slope, cpe = pilot_phase_correct(cfg, eq, H, pilot_vals)
    if cfg.n_pilots == 0:
        return eq, slope, cpe, noise_var[:, None].expand(
            -1, cfg.n_data_symbols).contiguous()
    pil, _ = split_pilots(cfg, eq)
    # per-symbol noise floor from the CSI-weighted pilot residuals: a burst
    # symbol demaps as erasures instead of confident errors
    w, _ = split_pilots(cfg, torch.abs(H) ** 2)
    perr = torch.abs(pil - pilot_vals) ** 2
    sig = torch.sum(w[:, None, :] * perr, dim=-1) / cfg.n_pilots
    return eq, slope, cpe, torch.maximum(noise_var[:, None], sig)


def demap_bins_plain(cfg: ModemConfig, eq: torch.Tensor, H: torch.Tensor,
                     nv_sym: torch.Tensor):
    """eq (B, D, U) from kernel A, H (B, U), nv_sym (B, D) → (llr (B, D·R),
    evm (B,), mean |llr| (B,)): `loaded_demap_llr` when bit-loaded,
    `qam_demap_llr` otherwise, on nv_eff = nv_sym · 1/max(|H|², 1e-12)."""
    from ...models.frame import loaded_demap_llr, split_pilots

    _, data = split_pilots(cfg, eq)                           # (B, D, nd)
    _, inv_csi = split_pilots(cfg, 1.0 / torch.clamp(torch.abs(H) ** 2,
                                                     min=1e-12))
    nv_eff = nv_sym[..., None] * inv_csi[:, None, :]
    if cfg.bit_loading is not None:
        llr, evm = loaded_demap_llr(cfg, data, nv_eff)
    else:
        llr3 = qam_demap_llr(data, nv_eff, cfg.bits_per_symbol)
        Xd = qam_map(hard_bits(llr3), cfg.bits_per_symbol)
        evm = torch.mean(torch.abs(data - Xd) ** 2, dim=(-2, -1))
        llr = llr3
    llr = llr.reshape(eq.shape[0], cfg.raw_bits_per_frame)
    return llr, evm, torch.mean(torch.abs(llr), dim=-1)


@functools.lru_cache(maxsize=None)
def track_constants(cfg: ModemConfig):
    """pilot_phase_correct's static constants as the kernels take them:
    (mean pilot spacing, n_ladder, q0, base0, q1, base1) — the (lag,
    baseline) of each of at most two refinement stages. Below two pilots
    there is no fit: (1.0, 0, 0, 1.0, 0, 1.0)."""
    kp = layout(cfg).pilot_pos.astype(np.float64)
    P = cfg.n_pilots
    if P < 2:
        return 1.0, 0, 0, 1.0, 0, 1.0
    stages = [(Q, float(np.float32(np.mean(kp[Q:] - kp[:-Q]))))
              for Q in sorted({max(2, P // 8), P // 2}) if 1 <= Q < P]
    (q0, b0), (q1, b1) = (stages + [(0, 1.0), (0, 1.0)])[:2]
    return (float(np.float32(np.mean(np.diff(kp)))), len(stages),
            q0, b0, q1, b1)


@functools.lru_cache(maxsize=None)
def pilot_floats(cfg: ModemConfig, device: torch.device) -> torch.Tensor:
    """The config's pilot values as (P, 2) float32 on `device`."""
    return torch.view_as_real(torch.as_tensor(layout(cfg).pilot_vals,
                                              device=device))


@functools.lru_cache(maxsize=None)
def layout_table(cfg: ModemConfig, device: torch.device) -> torch.Tensor:
    """Kernels 2 and A's layout table on `device`: the P pilot positions,
    then the n_data_bins data positions, as int32 used-bin indices
    (n_used)."""
    lay = layout(cfg)
    return torch.as_tensor(np.concatenate([lay.pilot_pos, lay.data_pos])
                           .astype(np.int32), device=device)


def check_track_inputs(name: str, cfg: ModemConfig, Y, H, noise_var):
    """The shape, type and device checks of the kernels that take
    Y (B, K+D, U), H (B, U) complex64 and noise_var (B,) on one CUDA
    device; any pilot layout and band."""
    dev = Y.device
    if dev.type != "cuda" or H.device != dev or noise_var.device != dev:
        raise ValueError(f"{name}: Y, H and noise_var must be on one CUDA "
                         "device")
    B, S, U = Y.shape
    if (S != cfg.n_known_symbols + cfg.n_data_symbols or U != cfg.n_used
            or Y.dtype != torch.complex64 or H.shape != (B, U)
            or H.dtype != torch.complex64 or noise_var.shape != (B,)):
        raise ValueError(f"{name}: needs Y (B, K+D, n_used) and H "
                         "(B, n_used) complex64, noise_var (B,)")


def eq_track(cfg: ModemConfig, Y: torch.Tensor, H: torch.Tensor,
             noise_var: torch.Tensor, pilot_vals: torch.Tensor | None = None,
             *, geometry: FusedGeometry | None = None):
    """`eq_track_plain` for CPU tensors; kernel A otherwise, launched with
    kernel 2's tracking constants and its layout (`fused_eq_geometry(...,
    demap=False)`; `geometry` another of `eq_layout`'s launches: tests and
    chip_smoke.py only)."""
    if Y.device.type == "cpu":
        return eq_track_plain(cfg, Y, H, noise_var, pilot_vals)
    check_track_inputs("eq_track", cfg, Y, H, noise_var)
    dev = Y.device
    B, S, U = Y.shape
    D = cfg.n_data_symbols
    pv = (pilot_floats(cfg, dev) if pilot_vals is None else
          torch.view_as_real(pilot_vals.to(dev, torch.complex64)
                             .contiguous()))
    mean_dk, n_ladder, q0, b0, q1, b1 = track_constants(cfg)
    geo = geometry or fused_eq_geometry(cfg, B, sm_count(dev.index),
                                        demap=False)
    # the inputs stay bound until the launch: a temporary's memory could be
    # handed to the next allocation before the kernel reads it
    y, h = Y.contiguous(), H.contiguous()
    nv = noise_var.to(torch.float32).contiguous()
    eq = torch.empty(B, D, U, dtype=torch.complex64, device=dev)
    slope, cpe, nv_sym = torch.empty(3, B, D, device=dev)
    scratch = spill_scratch(geo, B, cfg.n_pilots, dev)
    launch("gf3x_eq_track", dev.index, y.data_ptr(), h.data_ptr(),
           nv.data_ptr(), pv.data_ptr(), layout_table(cfg, dev).data_ptr(),
           eq.data_ptr(), slope.data_ptr(), cpe.data_ptr(), nv_sym.data_ptr(),
           B, S, cfg.n_known_symbols, U, cfg.n_pilots, n_ladder, q0, b0, q1,
           b1, mean_dk, geo.warps, geo.nbuf, geo.smem,
           0 if scratch is None else scratch.data_ptr(), geo.team,
           geo.blocks, int(geo.stage_h))
    eq_track.launches += 1
    return eq, slope, cpe, nv_sym


eq_track.launches = 0


@functools.lru_cache(maxsize=None)
def _levels_by_order() -> tuple[np.ndarray, int]:
    """The PAM levels of QPSK, 16- and 64-QAM back to back (2 + 4 + 8
    float32, order m at offset 2^m − 2), the values `qam_demap_llr` uses,
    and their host address."""
    lv = np.concatenate([pam_label_levels(m) * qam_norm(2 * m)
                         for m in (1, 2, 3)]).astype(np.float32)
    return lv, lv.ctypes.data


SLOT_BITS_M = 2          # a slot's first word: used-bin index << 2 | m


def slot_table(used, bits, off) -> np.ndarray:
    """Kernel B's wire-order slot table from the per-data-bin tables (used-
    bin index, bits 0/2/4/6, wire offset): slot i is the i-th active bin in
    wire order (ascending offset; group-sorted when bit-loaded), as two
    int32 words — its used-bin index << 2 | its order m, then its offset,
    the running sum of 2m over the slots before it. Bins with 0 bits have
    no slot. int32 (n_active, 2)."""
    used, bits, off = (np.asarray(t, dtype=np.int64) for t in (used, bits,
                                                                off))
    active = np.nonzero(bits > 0)[0]
    order = active[np.argsort(off[active], kind="stable")]
    m = bits[order] // 2
    offs = np.concatenate([[0], np.cumsum(2 * m)[:-1]]).astype(np.int64)
    return np.stack([used[order] << SLOT_BITS_M | m, offs],
                    axis=-1).astype(np.int32)


def unpack_slots(slots) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(used-bin index, m, wire offset) of each slot of `slot_table`."""
    s = np.asarray(slots, dtype=np.int64)
    return (s[:, 0] >> SLOT_BITS_M, s[:, 0] & ((1 << SLOT_BITS_M) - 1),
            s[:, 1])


_LAUNCH: dict = {}       # (config, device) → `_demap_constants`


def _demap_constants(cfg: ModemConfig, tables, dev: torch.device):
    """Kernel B's per-config launch constants, derived once per (config,
    device): (`slot_table` of `tables` on `dev`, 1/g and 1/g² of the
    loading gain as float32, R, the divisors of evm and mean |llr|)."""
    c = _LAUNCH.get((cfg, dev))
    if c is None:
        used, bits, off = (torch.as_tensor(x).cpu().numpy() for x in tables)
        if not used.shape == bits.shape == off.shape == (cfg.n_data_bins,):
            raise ValueError("demap_bins: each table needs n_data_bins "
                             "entries")
        slots = slot_table(used, bits, off)
        k, m, _ = unpack_slots(slots)
        if (not np.isin(bits, (0, 2, 4, 6)).all()
                or 2 * int(m.sum()) != cfg.bits_per_ofdm_symbol
                or not np.all((k >= 0) & (k < cfg.n_used))):
            raise ValueError("demap_bins: the tables' bins must carry 0, 2, "
                             "4 or 6 bits, the config's bits per symbol in "
                             "all, at used bins below n_used")
        gain = 1.0
        if cfg.bit_loading is not None:
            from ...models.frame import loading_tables
            gain = loading_tables(cfg).gain
        c = _LAUNCH[(cfg, dev)] = (
            torch.as_tensor(slots, device=dev),
            float(np.float32(1.0 / gain)), float(np.float32(1.0 / gain ** 2)),
            cfg.bits_per_ofdm_symbol,
            np.float32(cfg.n_data_symbols * cfg.n_active_bins),
            np.float32(cfg.raw_bits_per_frame))
    return c


def demap_bins(cfg: ModemConfig, eq: torch.Tensor, H: torch.Tensor,
               nv_sym: torch.Tensor, tables, *,
               geometry: FusedGeometry | None = None):
    """`demap_bins_plain` for CPU tensors; kernel B otherwise. `tables` is
    (used-bin index, bits, wire offset) per data bin, int32 —
    `models.frame.demap_bin_tables(cfg)`, which a Modem keeps as buffers;
    the kernel takes their wire-order slot table (`slot_table`, derived
    once per config and device by `_demap_constants`), in the launch
    `demap_geometry` picks (`geometry` another, such as
    `eq_layout.streamed_geometry`: tests and chip_smoke.py only). The plain
    version derives the same layout from the config itself, so the two
    agree only if the tables are right."""
    if eq.device.type == "cpu":
        return demap_bins_plain(cfg, eq, H, nv_sym)
    dev = eq.device
    if dev.type != "cuda" or H.device != dev or nv_sym.device != dev:
        raise ValueError("demap_bins: eq, H and nv_sym must be on one CUDA "
                         "device")
    B, D, U = eq.shape
    if (D != cfg.n_data_symbols or U != cfg.n_used
            or eq.dtype != torch.complex64 or H.shape != (B, U)
            or H.dtype != torch.complex64 or nv_sym.shape != (B, D)):
        raise ValueError("demap_bins: needs eq (B, D, n_used) and H "
                         "(B, n_used) complex64, nv_sym (B, D)")
    slots, inv_g, inv_g2, R, evm_div, abs_div = _demap_constants(cfg, tables,
                                                                 dev)
    geo = geometry or demap_geometry(cfg, B, sm_count(dev.index))
    # the inputs stay bound until the launch: a temporary's memory could be
    # handed to the next allocation before the kernel reads it
    e = torch.view_as_real(eq.contiguous())
    h = torch.view_as_real(H.contiguous())
    nv = nv_sym.to(torch.float32).contiguous()
    llr = torch.empty(B, D * R, device=dev)
    evm_p, abs_p = torch.empty(2, B, D, device=dev)
    launch("gf3x_demap_bins", dev.index, e.data_ptr(), h.data_ptr(),
           nv.data_ptr(), slots.data_ptr(), llr.data_ptr(), evm_p.data_ptr(),
           abs_p.data_ptr(), B, D, U, slots.shape[0], R, inv_g, inv_g2,
           _levels_by_order()[1], geo.warps, geo.nbuf, geo.smem)
    demap_bins.launches += 1
    return llr, evm_p.sum(dim=1) / evm_div, abs_p.sum(dim=1) / abs_div


demap_bins.launches = 0
