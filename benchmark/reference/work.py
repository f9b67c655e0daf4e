"""The bytes each stage of the receive step must move, from the
configuration's shapes alone (never from what a kernel reads), so that the
same work is counted whatever implements the stage: every input read once,
every output written once, float32 and complex64 at 4 and 8 bytes. Each is a
lower bound on what any implementation moves; a roofline share over 100 %
means a fault in a count or a timing. PERF.md gives the config-5 figures
they reproduce: 209.7, 88.5 and 75.5 MB at B = 1024."""

from __future__ import annotations

from .config import ModemConfig

__all__ = ["cut_bytes", "eq_demap_bytes", "ldpc_bytes"]


def cut_bytes(cfg: ModemConfig, B: int) -> int:
    """Frame cut and CP strip: the K + D symbol windows and the SC window
    read, the (B, K+D+1, n_fft) float32 matrix written."""
    S = cfg.n_known_symbols + cfg.n_data_symbols + int(cfg.use_schmidl_cox)
    return 2 * 4 * B * S * cfg.n_fft


def eq_demap_bytes(cfg: ModemConfig, B: int) -> int:
    """EQ, pilot tracking, noise floor and demap: the data symbols'
    spectra, Ĥ and the noise variance read; the LLRs, the slope and phase
    of each data symbol and two sums a frame (EVM, mean |LLR|) written."""
    D, U = cfg.n_data_symbols, cfg.n_used
    return (8 * B * D * U + 8 * B * U + 4 * B
            + 4 * B * cfg.raw_bits_per_frame + 4 * 2 * B * D + 4 * 2 * B)


def ldpc_bytes(cfg: ModemConfig, B: int) -> int:
    """LDPC decode: each codeword's 24z LLRs read and its 24z totals
    written."""
    return 2 * 4 * B * cfg.n_codewords * cfg.ldpc_n
