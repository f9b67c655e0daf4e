"""eq_track_roofline: kernel A's bytes at the peak HBM rate over the device
time of its `gf3x.eq_track` spans (benchmark/spans.py), both over the
profiled steps. The bytes come from the program's `eq_track.rows` counter
(the frames equalized) and the configuration's shapes, each input and
output once: a frame's D data symbols of U complex64 bins and its Ĥ and
noise variance in, its D × U equalized bins and the slope, phase and noise
floor of each data symbol out. None where the trace saw no device work,
where the program keeps no such span or counter (a checkout older than
them) or where the split tail did not run."""

from benchmark.spans import counters, device_ms


def eq_track_bytes(cfg, rows: int) -> int:
    """The bytes kernel A must move for `rows` frames."""
    D, U = cfg.n_data_symbols, cfg.n_used
    return rows * (8 * D * U + 8 * U + 4 + 8 * D * U + 3 * 4 * D)


def read(ctx):
    ms = device_ms(ctx)
    rows = (counters(ctx) or {}).get("eq_track.rows")
    if not ms or not rows:
        return None
    nbytes = eq_track_bytes(ctx["cfg"], rows) / ctx["trace"].steps
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / (ms * 1e-3)
