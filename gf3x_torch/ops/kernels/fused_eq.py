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
from ..chanest import equalize, pilot_phase_correct
from ..constellation import (hard_bits, pam_label_levels, qam_demap_llr,
                             qam_map, qam_norm)

__all__ = ["fused_eq_demap", "fused_eq_demap_plain"]


def fused_eq_demap_plain(cfg: ModemConfig, Y: torch.Tensor, H: torch.Tensor,
                         noise_var: torch.Tensor,
                         pilot_vals: torch.Tensor | None = None):
    """Y (B, K+D, U) complex64 spectra (derolled), H (B, U) complex64,
    noise_var (B,) → (llr, slope, cpe, evm, mabs) as in the module doc."""
    from ...models.frame import split_pilots

    if pilot_vals is None:
        pilot_vals = torch.as_tensor(layout(cfg).pilot_vals)
    pilot_vals = pilot_vals.to(Y.device)
    B = Y.shape[0]
    eq = equalize(H, Y[:, cfg.n_known_symbols:])
    eq, slope, cpe = pilot_phase_correct(cfg, eq, H, pilot_vals)
    pil, data = split_pilots(cfg, eq)                         # (B, D, nd)
    csi = torch.abs(H) ** 2
    # per-symbol noise floor from the CSI-weighted pilot residuals: a burst
    # symbol demaps as erasures instead of confident errors
    w, _ = split_pilots(cfg, csi)
    perr = torch.abs(pil - pilot_vals) ** 2
    sig = torch.sum(w[:, None, :] * perr, dim=-1) / cfg.n_pilots
    nv_sym = torch.maximum(noise_var[:, None], sig)           # (B, D)
    _, inv_csi = split_pilots(cfg, 1.0 / torch.clamp(csi, min=1e-12))
    nv_eff = nv_sym[..., None] * inv_csi[:, None, :]          # (B, D, nd)
    llr3 = qam_demap_llr(data, nv_eff, cfg.bits_per_symbol)
    Xd = qam_map(hard_bits(llr3), cfg.bits_per_symbol)
    evm = torch.mean(torch.abs(data - Xd) ** 2, dim=(-2, -1))
    llr = llr3.reshape(B, cfg.raw_bits_per_frame)
    return llr, slope, cpe, evm, torch.mean(torch.abs(llr), dim=-1)


_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 6
         + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def _ladder(cfg: ModemConfig):
    """pilot_phase_correct's static constants: mean pilot spacing and the
    (lag, baseline) of each refinement stage."""
    kp = layout(cfg).pilot_pos.astype(np.float64)
    P = cfg.n_pilots
    stages = [(Q, float(np.float32(np.mean(kp[Q:] - kp[:-Q]))))
              for Q in sorted({max(2, P // 8), P // 2}) if 1 <= Q < P]
    return float(np.float32(np.mean(np.diff(kp)))), stages


def fused_eq_demap(cfg: ModemConfig, Y: torch.Tensor, H: torch.Tensor,
                   noise_var: torch.Tensor,
                   pilot_vals: torch.Tensor | None = None):
    """`fused_eq_demap_plain` for CPU tensors; the CUDA kernel otherwise
    (strided pilots, at least two of them, up to 64-QAM)."""
    if Y.device.type == "cpu":
        return fused_eq_demap_plain(cfg, Y, H, noise_var, pilot_vals)
    dev = Y.device
    if dev.type != "cuda" or H.device != dev or noise_var.device != dev:
        raise ValueError("fused_eq_demap: Y, H and noise_var must be on one "
                         "CUDA device")
    if not (cfg.strided_pilots and cfg.n_pilots >= 2
            and cfg.bit_loading is None and cfg.n_used <= 1024):
        raise ValueError("fused_eq_demap: the kernel needs strided pilots "
                         "(at least two), uniform loading and n_used ≤ 1024")
    B, S, U = Y.shape
    K, D = cfg.n_known_symbols, cfg.n_data_symbols
    if (S != K + D or U != cfg.n_used or Y.dtype != torch.complex64
            or H.shape != (B, U) or H.dtype != torch.complex64
            or noise_var.shape != (B,)):
        raise ValueError("fused_eq_demap: needs Y (B, K+D, n_used) and H "
                         "(B, n_used) complex64, noise_var (B,)")
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
    mean_dk, stages = _ladder(cfg)
    (q0, b0), (q1, b1) = (stages + [(0, 1.0), (0, 1.0)])[:2]
    with torch.cuda.device(dev):
        launch("gf3x_fused_eq_demap", _ARGS, ptr(y), ptr(h), ptr(nv), ptr(pv),
               ptr(llr), ptr(slope), ptr(cpe), ptr(evm_p), ptr(abs_p), B, S,
               K, U, cfg.n_pilots, cfg.pilot_spacing, m, levels, len(stages),
               q0, b0, q1, b1, mean_dk, stream_of(Y))
    fused_eq_demap.launches += 1
    evm = evm_p.sum(dim=1) / np.float32(D * cfg.n_data_bins)
    mabs = abs_p.sum(dim=1) / np.float32(cfg.raw_bits_per_frame)
    return llr, slope, cpe, evm, mabs


fused_eq_demap.launches = 0
