"""Kernel 8: fused frame cut + used-band DFT + deroll ramp
(`csrc/cut_dft.cu`, replacing gf3x/ops/pallas/cut_dft.py:cut_dft_tpu), with
its plain PyTorch version: kernel 1's plain cut, `ofdm_dft` and the deroll
ramp back to back.

`cut_dft` runs the plain version for a CPU tensor and launches the kernel
for a CUDA tensor (or raises); `cut_dft.launches` counts the launches. Both
return (Y (B, S, n_used) complex64 spectra, already derolled; scw (B, n_fft)
float32 SC window, or None when sc_off < 0)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...config import ModemConfig
from ...utils.device import launch
from ..ofdm import deroll, ofdm_dft
from .gather_cut import cut_symbols_plain

__all__ = ["cut_dft", "cut_dft_plain", "twiddles"]


def cut_dft_plain(cfg: ModemConfig, rx: torch.Tensor, q: torch.Tensor,
                  roll: torch.Tensor, *, valid: int, block: int, S: int,
                  body_off: int, sc_off: int):
    """rx (B, T) f32, q (B,) int32 window block and roll (B,) int32 of each
    row (`ops.sync.cut_plan`) → (Y, scw): `cut_symbols_plain` → `ofdm_dft`
    → `deroll`."""
    syms, scw = cut_symbols_plain(
        rx, q, valid=valid, block=block, S=S, n_fft=cfg.n_fft,
        body_off=body_off, sym_len=cfg.symbol_len, cp=cfg.cp, sc_off=sc_off)
    return deroll(cfg, ofdm_dft(cfg, syms), roll), scw


@functools.lru_cache(maxsize=None)
def twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    """(2, n_fft) float32: cos and sin of 2πj/n_fft, computed in float64 so
    each entry is the exactly rounded value."""
    th = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    tw = np.stack([np.cos(th), np.sin(th)]).astype(np.float32)
    return torch.as_tensor(tw, device=device)


def cut_dft(cfg: ModemConfig, rx: torch.Tensor, q: torch.Tensor,
            roll: torch.Tensor, *, valid: int, block: int, S: int,
            body_off: int, sc_off: int):
    """`cut_dft_plain` for a CPU tensor; the CUDA kernel otherwise (n_fft a
    power of two from 128 to 4096)."""
    kw = dict(valid=valid, block=block, S=S, body_off=body_off,
              sc_off=sc_off)
    if rx.device.type == "cpu":
        return cut_dft_plain(cfg, rx, q, roll, **kw)
    dev = rx.device
    if dev.type != "cuda" or q.device != dev or roll.device != dev:
        raise ValueError(f"cut_dft: rx on {dev}, q on {q.device}, roll on "
                         f"{roll.device}; all must be on one CUDA device")
    if (rx.dtype != torch.float32 or q.dtype != torch.int32
            or roll.dtype != torch.int32 or rx.dim() != 2
            or q.shape != rx.shape[:1] or roll.shape != rx.shape[:1]
            or not (rx.is_contiguous() and q.is_contiguous()
                    and roll.is_contiguous())):
        raise ValueError("cut_dft: needs contiguous rx (B, T) float32 and "
                         "q, roll (B,) int32")
    N = cfg.n_fft
    if N & (N - 1) or not 128 <= N <= 4096 or cfg.bin_hi > N // 2:
        raise ValueError(f"cut_dft: the kernel takes n_fft a power of two "
                         f"in [128, 4096] and bins up to n_fft/2, not "
                         f"n_fft={N}, bin_hi={cfg.bin_hi}")
    B, T = rx.shape
    if not 0 <= valid <= T:
        raise ValueError(f"cut_dft: valid={valid} outside [0, {T}]")
    Y = torch.empty(B, S, cfg.n_used, dtype=torch.complex64, device=dev)
    scw = torch.empty(B, N if sc_off >= 0 else 0, device=dev)
    launch("gf3x_cut_dft", dev.index, rx.data_ptr(), q.data_ptr(),
           roll.data_ptr(), twiddles(N, dev).data_ptr(), Y.data_ptr(),
           scw.data_ptr(), B, T, valid, block, S, N, body_off, cfg.symbol_len,
           cfg.cp, sc_off, cfg.bin_lo, cfg.n_used,
           float(np.float32(1.0 / cfg.ofdm_scale)))
    cut_dft.launches += 1
    return Y, (scw if sc_off >= 0 else None)


cut_dft.launches = 0
