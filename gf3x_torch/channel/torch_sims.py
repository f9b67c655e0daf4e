"""Channel impairments on torch tensors, on the input's device (counterpart
of gf3x/channel/jax_sims.py): the BER sweep's channel, so that the whole
sweep — modulate → impair → demodulate → count — stays on the modem's
device with (snr, trial) lead axes."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["awgn", "apply_fir", "delay", "clip"]


def awgn(x: torch.Tensor, snr_db, *,
         generator: Optional[torch.Generator] = None,
         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add white Gaussian noise at snr_db relative to x's mean power (over
    the last axis). snr_db may carry lead axes broadcastable against x's.
    The unit-normal draw comes from `generator` (a torch.Generator on x's
    device; torch's default one when None) unless `noise` gives it."""
    p = torch.mean(x * x, dim=-1, keepdim=True)
    snr = torch.as_tensor(snr_db, dtype=x.dtype, device=x.device)
    nvar = p / (10.0 ** (snr[..., None] / 10.0))
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                            device=x.device)
    return x + noise.to(x.device, x.dtype) * torch.sqrt(nvar)


def apply_fir(x: torch.Tensor, h) -> torch.Tensor:
    """Multipath: convolve (..., T) with the impulse response h (L,) by FFT,
    same-length output (truncated to T; the tail past the recording is lost
    anyway)."""
    h = torch.as_tensor(h, dtype=x.dtype, device=x.device)
    T = x.shape[-1]
    n = T + h.shape[-1] - 1
    nfft = 1 << (n - 1).bit_length()
    X = torch.fft.rfft(x, nfft, dim=-1)
    Hf = torch.fft.rfft(h, nfft)
    y = torch.fft.irfft(X * Hf, nfft, dim=-1)
    return y[..., :T].to(x.dtype)


def delay(x: torch.Tensor, n: int) -> torch.Tensor:
    """Static delay by n samples (length preserved)."""
    return torch.nn.functional.pad(x, (n, 0))[..., : x.shape[-1]]


def clip(x: torch.Tensor, limit: float = 1.0) -> torch.Tensor:
    return torch.clamp(x, -limit, limit)
