"""Kernel 2: fused one-tap EQ + pilot tracking + noise floor + max-log
demap (`csrc/fused_eq.cu`, replacing
gf3x/ops/pallas/fused_eq.py:fused_eq_demap_tpu), with its plain PyTorch
version: the XLA twin the JAX CPU path runs (Modem._eq_tail +
pilot_phase_correct + Modem._xla_demap).

`fused_eq_demap` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises); `fused_eq_demap.launches` counts the
launches. Both return

    llr   (B, D·R) f32 — scrambled, interleaved data-bin LLRs in the
          qam_demap_llr bit order (the twin's `llr`),
    slope (B, D), cpe (B, D) f32 — pilot phase fit per data symbol,
    evm   (B,) f32 — mean |X̂ − hard decision|² over the data bins,
    mabs  (B,) f32 — mean |llr|.

The kernel takes the launch `eq_layout.fused_eq_geometry` picks for a
batch: staged at the narrow bands, teamed at the wide ones, spilled past
the pilot bound of shared memory; each gives the same llr, slope and cpe
bits. The kernel reads the pilot layout from a table
(`split_eq.layout_table`), so every layout runs on it: strided, offset, a
spacing that does not tile the band, one pilot or none.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...config import ModemConfig
from ...utils.device import launch, sm_count
from ..constellation import pam_label_levels, qam_norm
from .eq_layout import FusedGeometry, fused_eq_geometry, spill_scratch
from .split_eq import (check_track_inputs, demap_bins_plain, eq_track_plain,
                       layout_table, pilot_floats, track_constants)

__all__ = ["fused_eq_demap", "fused_eq_demap_plain", "launch_constants"]


def fused_eq_demap_plain(cfg: ModemConfig, Y: torch.Tensor, H: torch.Tensor,
                         noise_var: torch.Tensor,
                         pilot_vals: torch.Tensor | None = None):
    """Y (B, K+D, U) complex64 spectra (derolled), H (B, U) complex64,
    noise_var (B,) → (llr, slope, cpe, evm, mabs) as in the module doc: the
    split tail's two plain versions back to back, so the math exists once."""
    eq, slope, cpe, nv_sym = eq_track_plain(cfg, Y, H, noise_var, pilot_vals)
    llr, evm, mabs = demap_bins_plain(cfg, eq, H, nv_sym)
    return llr, slope, cpe, evm, mabs


@functools.lru_cache(maxsize=None)
def launch_constants(cfg: ModemConfig):
    """The kernel's per-config constants, computed once per config:
    (track_constants(cfg), the PAM levels — the values qam_demap_llr uses —
    as a float32 host array and its address, D·n_data_bins and the raw bits
    per frame as float32, the divisors of evm and mabs)."""
    m = cfg.bits_per_symbol // 2
    levels = (pam_label_levels(m) * qam_norm(cfg.bits_per_symbol)).astype(
        np.float32)
    return (track_constants(cfg), levels, levels.ctypes.data,
            float(np.float32(cfg.n_data_symbols * cfg.n_data_bins)),
            float(np.float32(cfg.raw_bits_per_frame)))


def fused_eq_demap(cfg: ModemConfig, Y: torch.Tensor, H: torch.Tensor,
                   noise_var: torch.Tensor,
                   pilot_vals: torch.Tensor | None = None, *,
                   geometry: FusedGeometry | None = None):
    """`fused_eq_demap_plain` for CPU tensors; the CUDA kernel otherwise
    (any pilot layout and band, QPSK to 64-QAM), in the launch
    `fused_eq_geometry` picks (`geometry` another of `eq_layout`'s
    launches: tests and chip_smoke.py only). A bit-loaded config takes the
    split tail (`split_eq`) on either device."""
    if cfg.bit_loading is not None:
        raise ValueError("fused_eq_demap: a bit-loaded config takes the "
                         "split tail (split_eq.eq_track + demap_bins)")
    if Y.device.type == "cpu":
        return fused_eq_demap_plain(cfg, Y, H, noise_var, pilot_vals)
    check_track_inputs("fused_eq_demap", cfg, Y, H, noise_var)
    dev = Y.device
    B, S, U = Y.shape
    D = cfg.n_data_symbols
    pv = (pilot_floats(cfg, dev) if pilot_vals is None else
          torch.view_as_real(pilot_vals.to(dev, torch.complex64)
                             .contiguous()))
    (mean_dk, n_ladder, q0, b0, q1, b1), _, levels, evm_div, abs_div = \
        launch_constants(cfg)
    geo = geometry or fused_eq_geometry(cfg, B, sm_count(dev.index))
    # the inputs stay bound until the launch: a temporary's memory could be
    # handed to the next allocation before the kernel reads it
    y, h = Y.contiguous(), H.contiguous()
    nv = noise_var.to(torch.float32).contiguous()
    llr = torch.empty(B, cfg.raw_bits_per_frame, device=dev)
    slope, cpe = torch.empty(2, B, D, device=dev)
    evm, mabs = torch.empty(2, B, device=dev)
    scratch = spill_scratch(geo, B, cfg.n_pilots, dev)
    # the blocks' sums and the frame's ticket where a frame has several
    part = ticket = None
    if geo.blocks > 1:
        part = torch.empty(B, geo.blocks, 2, device=dev)
        ticket = torch.zeros(B, dtype=torch.int32, device=dev)
    launch("gf3x_fused_eq_demap", dev.index, y.data_ptr(), h.data_ptr(),
           nv.data_ptr(), pv.data_ptr(), layout_table(cfg, dev).data_ptr(),
           llr.data_ptr(), slope.data_ptr(), cpe.data_ptr(), evm.data_ptr(),
           mabs.data_ptr(), B, S, cfg.n_known_symbols, U, cfg.n_pilots,
           cfg.bits_per_symbol // 2, levels, n_ladder, q0, b0, q1, b1, mean_dk,
           geo.warps, geo.nbuf, geo.smem, evm_div, abs_div,
           0 if scratch is None else scratch.data_ptr(), geo.team,
           geo.blocks, int(geo.stage_h),
           0 if part is None else part.data_ptr(),
           0 if ticket is None else ticket.data_ptr())
    fused_eq_demap.launches += 1
    return llr, slope, cpe, evm, mabs


fused_eq_demap.launches = 0
