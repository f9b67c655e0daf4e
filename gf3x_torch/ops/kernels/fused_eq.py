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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...config import ModemConfig, layout
from ...utils.device import launch, ptr, stream_of
from ..constellation import pam_label_levels, qam_norm
from .split_eq import (check_track_inputs, demap_bins_plain, eq_track_plain,
                       track_constants)

__all__ = ["fused_eq_demap", "fused_eq_demap_plain"]


def fused_eq_demap_plain(cfg: ModemConfig, Y: torch.Tensor, H: torch.Tensor,
                         noise_var: torch.Tensor,
                         pilot_vals: torch.Tensor | None = None):
    """Y (B, K+D, U) complex64 spectra (derolled), H (B, U) complex64,
    noise_var (B,) → (llr, slope, cpe, evm, mabs) as in the module doc: the
    split tail's two plain versions back to back, so the math exists once."""
    eq, slope, cpe, nv_sym = eq_track_plain(cfg, Y, H, noise_var, pilot_vals)
    llr, evm, mabs = demap_bins_plain(cfg, eq, H, nv_sym)
    return llr, slope, cpe, evm, mabs


_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 6
         + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def fused_eq_demap(cfg: ModemConfig, Y: torch.Tensor, H: torch.Tensor,
                   noise_var: torch.Tensor,
                   pilot_vals: torch.Tensor | None = None):
    """`fused_eq_demap_plain` for CPU tensors; the CUDA kernel otherwise
    (strided pilots, at least two of them, QPSK to 64-QAM). A bit-loaded
    config takes the split tail (`split_eq`) on either device."""
    if cfg.bit_loading is not None:
        raise ValueError("fused_eq_demap: a bit-loaded config takes the "
                         "split tail (split_eq.eq_track + demap_bins)")
    if Y.device.type == "cpu":
        return fused_eq_demap_plain(cfg, Y, H, noise_var, pilot_vals)
    check_track_inputs("fused_eq_demap", cfg, Y, H, noise_var)
    dev = Y.device
    B, S, U = Y.shape
    K, D = cfg.n_known_symbols, cfg.n_data_symbols
    if pilot_vals is None:
        pilot_vals = torch.as_tensor(layout(cfg).pilot_vals, device=dev)
    y = torch.view_as_real(Y.contiguous())
    h = torch.view_as_real(H.contiguous())
    nv = noise_var.to(torch.float32).contiguous()
    pv = torch.view_as_real(pilot_vals.to(dev, torch.complex64).contiguous())
    llr = torch.empty(B, cfg.raw_bits_per_frame, device=dev)
    slope, cpe, evm_p, abs_p = torch.empty(4, B, D, device=dev)
    m = cfg.bits_per_symbol // 2
    levels = (ctypes.c_float * 8)(
        *(pam_label_levels(m) * qam_norm(cfg.bits_per_symbol)).tolist())
    mean_dk, n_ladder, q0, b0, q1, b1 = track_constants(cfg)
    with torch.cuda.device(dev):
        launch("gf3x_fused_eq_demap", _ARGS, ptr(y), ptr(h), ptr(nv), ptr(pv),
               ptr(llr), ptr(slope), ptr(cpe), ptr(evm_p), ptr(abs_p), B, S,
               K, U, cfg.n_pilots, cfg.pilot_spacing, m, levels, n_ladder,
               q0, b0, q1, b1, mean_dk, stream_of(Y))
    fused_eq_demap.launches += 1
    evm = evm_p.sum(dim=1) / np.float32(D * cfg.n_data_bins)
    mabs = abs_p.sum(dim=1) / np.float32(cfg.raw_bits_per_frame)
    return llr, slope, cpe, evm, mabs


fused_eq_demap.launches = 0
