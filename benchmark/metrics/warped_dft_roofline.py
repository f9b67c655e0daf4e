"""warped_dft_roofline: the δ-warped DFT's bytes at the peak HBM rate over
the device time of its `gf3x.warped_dft` spans (benchmark/spans.py), both
over the profiled steps. The bytes come from the program's
`ofdm.warped_rows` counter and the configuration's shapes: each symbol row
transformed reads its n_fft float32 samples and writes its n_used
complex64 bins. Bytes, not the dense product's operations: any exact
implementation moves them, an O(N log N) chirp-z form too, where a GEMM's
operation count would read past 100 %. None where the trace saw no device
work, where the program keeps no such span or counter (a checkout older
than them) or where no warped DFT ran."""

from benchmark.spans import counters, device_ms


def warped_dft_bytes(cfg, rows: int) -> int:
    """The bytes `rows` symbol rows of the warped DFT must move: n_fft
    float32 samples in, n_used complex64 bins out, each once."""
    return rows * (4 * cfg.n_fft + 8 * cfg.n_used)


def read(ctx):
    ms = device_ms(ctx)
    rows = (counters(ctx) or {}).get("ofdm.warped_rows")
    if not ms or not rows:
        return None
    nbytes = warped_dft_bytes(ctx["cfg"], rows) / ctx["trace"].steps
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / (ms * 1e-3)
