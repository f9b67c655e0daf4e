"""Kernel 8: fused frame cut + used-band DFT + deroll ramp
(`csrc/cut_dft.cu`, replacing gf3x/ops/pallas/cut_dft.py:cut_dft_tpu), with
its plain PyTorch version: kernel 1's plain cut, `ofdm_dft` and the deroll
ramp back to back.

`cut_dft` runs the plain version for a CPU tensor and launches the kernel
for a CUDA tensor (or raises); `cut_dft.launches` counts the launches. Both
return (Y (B, S, n_used) complex64 spectra, already derolled; scw (B, n_fft)
float32 SC window, or None when sc_off < 0).

The kernel's launch comes from `cut_dft_geometry`: a team of threads per
symbol, each holding `points` of the symbol's n_fft/2 packed complex points
in registers, radix-8 passes with a radix-2 or radix-4 tail, and teams per
block (one block per row). The CPU tests reach it and emulate its passes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ...config import ModemConfig
from ...utils.device import SMEM_BLOCK, launch
from ..ofdm import deroll, ofdm_dft
from .gather_cut import cut_symbols_plain

__all__ = ["cut_dft", "cut_dft_plain", "cut_dft_geometry", "CutDftGeometry",
           "takes", "twiddles"]

MAX_THREADS = 512        # the kernel's __launch_bounds__
# segments a team walks in a row, at most: at config 5 (25 segments a row,
# 1024 rows) 5 teams of 5 segments and 2 of 13 ran level on the H100, 9 of
# 3 and 13 of 2 slower (chip_smoke.py --time on each; PERF.md §6)
SEGMENTS_PER_TEAM = 5
N_FFT_RANGE = (128, 4096)    # the powers of two whose FFT fits a team


def takes(cfg: ModemConfig) -> bool:
    """Whether the kernel takes the config's geometry: n_fft a power of two
    in N_FFT_RANGE and bins up to n_fft/2."""
    N = cfg.n_fft
    return (not N & (N - 1) and N_FFT_RANGE[0] <= N <= N_FFT_RANGE[1]
            and cfg.bin_hi <= N // 2)


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


@dataclass(frozen=True)
class CutDftGeometry:
    """Kernel 8's launch for one n_fft and batch: a team of `team` threads
    transforms one segment (a symbol, or the SC window's copy), each thread
    holding `points` of the M = n_fft/2 packed points; `radices` are the
    FFT's passes (radix 8, then 2 or 4 where M is not a power of 8); a block
    takes one row with `teams` teams, team w walking segments w, w + teams,
    ... through `nbuf` window buffers (2: the next window's copy overlaps
    the current FFT); `smem` bytes of dynamic shared memory per block."""

    points: int
    team: int
    radices: tuple
    teams: int
    nbuf: int
    smem: int

    @property
    def threads(self) -> int:
        return self.team * self.teams

    @property
    def tail(self) -> int:
        """The last pass's radix where it is not 8, else 1."""
        return self.radices[-1] if self.radices[-1] != 8 else 1


def buffer_floats(n_fft: int) -> int:
    """Floats of one window buffer: the exchange between passes, M complex
    points with one pad slot after every 8 (slot(i) = i + i/8), which also
    holds the n_fft + 4 samples of the aligned 16-byte chunks covering a
    window."""
    M = n_fft // 2
    return 2 * (M + M // 8)


def fft_plan(n_fft: int) -> tuple[int, int, tuple]:
    """(points per thread, team threads, radices) for n_fft: M = n_fft/2 =
    8^a · {1, 2, 4}; 8 points a thread up to M = 256 (teams of 8 to 32
    threads), 16 at M = 512 and 1024, 32 at 2048, so a team is one warp or
    at most a pair."""
    M = n_fft // 2
    radices = []
    m = M
    while m % 8 == 0:
        radices.append(8)
        m //= 8
    if m > 1:
        radices.append(m)
    points = max(8, M // 64 if M > 512 else M // 32)
    return points, M // points, tuple(radices)


@functools.lru_cache(maxsize=None)
def cut_dft_geometry(n_fft: int, nseg: int) -> CutDftGeometry:
    """The launch for n_fft (a power of two in [128, 4096]) and `nseg`
    segments per row (S symbols, plus the SC window): the fewest teams that
    walk at most SEGMENTS_PER_TEAM segments each, or more segments where the
    block would exceed 227 KB of shared memory or 512 threads (15 named
    barriers for pairs of warps)."""
    if n_fft & (n_fft - 1) or not N_FFT_RANGE[0] <= n_fft <= N_FFT_RANGE[1]:
        raise ValueError(f"cut_dft_geometry: n_fft={n_fft} is not a power "
                         "of two in [128, 4096]")
    points, team, radices = fft_plan(n_fft)
    nseg = max(nseg, 1)
    cap = min(MAX_THREADS // team, 15 if team > 32 else 32)
    for most in range(min(SEGMENTS_PER_TEAM, nseg), nseg + 1):
        teams = -(-nseg // most)
        nbuf = 2 if teams < nseg else 1
        smem = 8 * n_fft + teams * nbuf * 4 * buffer_floats(n_fft)
        if teams <= cap and smem <= SMEM_BLOCK:
            return CutDftGeometry(points, team, radices, teams, nbuf, smem)
    raise ValueError(f"cut_dft_geometry: no block fits n_fft={n_fft}")


def cut_dft(cfg: ModemConfig, rx: torch.Tensor, q: torch.Tensor,
            roll: torch.Tensor, *, valid: int, block: int, S: int,
            body_off: int, sc_off: int):
    """`cut_dft_plain` for a CPU tensor; the CUDA kernel otherwise (n_fft a
    power of two from 128 to 4096), launched by `cut_dft_geometry`."""
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
    if not takes(cfg):
        raise ValueError(f"cut_dft: the kernel takes n_fft a power of two "
                         f"in [128, 4096] and bins up to n_fft/2, not "
                         f"n_fft={N}, bin_hi={cfg.bin_hi}")
    B, T = rx.shape
    if not 0 <= valid <= T:
        raise ValueError(f"cut_dft: valid={valid} outside [0, {T}]")
    geo = cut_dft_geometry(N, S + (sc_off >= 0))
    Y = torch.empty(B, S, cfg.n_used, dtype=torch.complex64, device=dev)
    scw = torch.empty(B, N if sc_off >= 0 else 0, device=dev)
    launch("gf3x_cut_dft", dev.index, rx.data_ptr(), q.data_ptr(),
           roll.data_ptr(), twiddles(N, dev).data_ptr(), Y.data_ptr(),
           scw.data_ptr(), B, T, valid, block, S, N, body_off, cfg.symbol_len,
           cfg.cp, sc_off, cfg.bin_lo, cfg.n_used,
           float(np.float32(1.0 / cfg.ofdm_scale)), geo.points, geo.team,
           len(geo.radices) - (geo.tail > 1), geo.tail, geo.teams, geo.nbuf,
           geo.smem)
    cut_dft.launches += 1
    return Y, (scw if sc_off >= 0 else None)


cut_dft.launches = 0
