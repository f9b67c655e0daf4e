# Copied from gf3x/ops/chirp.py (NumPy only), so that gf3x_torch never imports jax.
"""Chirp preamble generation (reference L4, SURVEY.md §2 "Chirp sync").

The chirp is a config-static constant: generated on the host in float64 and
closed over by the jitted sync path as a float32 device constant.
"""

from __future__ import annotations

import functools

import numpy as np

from ..config import ModemConfig

__all__ = ["make_chirp"]


@functools.lru_cache(maxsize=None)
def make_chirp(cfg: ModemConfig) -> np.ndarray:
    """Linear chirp f0→f1 over chirp_duration with raised-cosine fades.

    c(t) = A·sin(2π(f0·t + (f1−f0)t²/2T)) (SURVEY.md Appendix "Chirp sync").
    Bit-identical to the golden model's `GoldenModem.make_chirp`.
    """
    n = cfg.chirp_len
    t = np.arange(n, dtype=np.float64) / cfg.fs
    T = n / cfg.fs
    phase = 2.0 * np.pi * (cfg.chirp_f0 * t + 0.5 * (cfg.chirp_f1 - cfg.chirp_f0) * t * t / T)
    x = np.sin(phase)
    nf = max(1, int(round(cfg.chirp_fade * cfg.fs)))
    win = np.ones(n)
    ramp = 0.5 * (1 - np.cos(np.pi * np.arange(nf) / nf))
    win[:nf] = ramp
    win[-nf:] = ramp[::-1]
    return (cfg.chirp_amplitude * x * win).astype(np.float64)
