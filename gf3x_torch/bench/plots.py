# Copied from gf3x/bench/plots.py (NumPy and matplotlib only), so that
# gf3x_torch never imports jax.
"""Evaluation plots (reference L7 visual checks, SURVEY.md §5c: BER curves,
constellation scatter, channel frequency response, sync metric)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["save_ber_plot", "save_constellation", "save_channel_response"]


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_ber_plot(res: dict, path: str | Path, title: str = "BER vs SNR") -> None:
    """Plot a `gf3x_torch.bench.ber.ber_sweep` result dict."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4.2))
    eps = 0.5 / max(res.get("bits_per_point", 1), 1)  # half-a-bit floor for log axis
    ax.semilogy(res["snr_db"], np.maximum(res["ber_pre_fec"], eps), "o-",
                label="pre-FEC")
    ax.semilogy(res["snr_db"], np.maximum(res["ber_post_fec"], eps), "s-",
                label="post-FEC")
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("BER")
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_constellation(symbols: np.ndarray, path: str | Path,
                       title: str = "equalized constellation") -> None:
    """Scatter of equalized data symbols (complex array, any shape)."""
    plt = _plt()
    s = np.asarray(symbols).ravel()
    fig, ax = plt.subplots(figsize=(4.6, 4.6))
    ax.scatter(s.real, s.imag, s=2, alpha=0.35, linewidths=0)
    ax.set_xlabel("I")
    ax.set_ylabel("Q")
    ax.set_title(title)
    ax.axhline(0, color="k", lw=0.4)
    ax.axvline(0, color="k", lw=0.4)
    ax.set_aspect("equal")
    lim = max(1.5, np.percentile(np.abs(s), 99) * 1.3) if s.size else 1.5
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_channel_response(H: np.ndarray, cfg, path: str | Path) -> None:
    """|Ĥ| and ∠Ĥ over the used band (diag.H from a decode)."""
    plt = _plt()
    H = np.asarray(H)
    freqs = (np.arange(cfg.bin_lo, cfg.bin_hi + 1) * cfg.fs / cfg.n_fft) / 1000.0
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(6, 5), sharex=True)
    a1.plot(freqs, 20 * np.log10(np.maximum(np.abs(H), 1e-9)))
    a1.set_ylabel("|Ĥ| (dB)")
    a1.grid(alpha=0.3)
    a2.plot(freqs, np.unwrap(np.angle(H)))
    a2.set_ylabel("∠Ĥ (rad)")
    a2.set_xlabel("frequency (kHz)")
    a2.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
