"""The channel the traffic generator puts every frame through: a sampling
clock offset by a Kaiser-windowed sinc, chip_smoke.py's `resample_sinc` in
torch on the device (gf3x's linear resampler errs by −11 dB at 13 kHz), and the
noise level of AWGN at an SNR against the frame's mean power, as
`gf3x_torch.bench.step.build_batch` and `channel.torch_sims.awgn` define it."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resample_sinc", "noise_std"]


def resample_sinc(x: torch.Tensor, ppm: float, taps: int = 64,
                  beta: float = 8.0) -> torch.Tensor:
    """A sampling-clock offset of `ppm` on rows x (F, L) float64 (on any
    device): output sample n reads input time n·(1 + ppm·1e-6) through a
    Kaiser-windowed sinc of `taps` taps."""
    ratio = 1.0 + ppm * 1e-6
    F, L = x.shape
    n_out = int(np.floor((L - 1) / ratio)) + 1
    half = taps // 2
    dev = x.device
    j = torch.arange(-half + 1, half + 1, device=dev)
    xp = torch.nn.functional.pad(x.to(torch.float64), (half, half))
    i0b = float(np.i0(beta))
    out = torch.empty(F, n_out, dtype=torch.float64, device=dev)
    for a in range(0, n_out, 1 << 15):
        t = torch.arange(a, min(n_out, a + (1 << 15)), dtype=torch.float64,
                         device=dev) * ratio
        i0 = torch.floor(t).to(torch.int64)
        d = (t - i0)[:, None] - j[None, :]
        w = torch.sinc(d) * torch.special.i0(beta * torch.sqrt(torch.clamp(
            1.0 - (d / half) ** 2, 0.0, 1.0))) / i0b
        idx = (i0[:, None] + j[None, :] + half).reshape(-1)
        out[:, a: a + len(t)] = torch.sum(
            xp[:, idx].reshape(F, len(t), taps) * w, dim=-1)
    return out


def noise_std(frames: torch.Tensor, snr_db: float) -> torch.Tensor:
    """The standard deviation of white noise at `snr_db` below each frame's
    mean power: frames (F, L) → (F,)."""
    p = torch.mean(frames.to(torch.float64) ** 2, dim=-1)
    return torch.sqrt(p / 10.0 ** (snr_db / 10.0))
