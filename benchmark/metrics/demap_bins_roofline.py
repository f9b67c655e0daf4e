"""demap_bins_roofline: kernel B's bytes at the peak HBM rate over the
device time of its `gf3x.demap_bins` spans (benchmark/spans.py), both over
the profiled steps. The bytes come from the program's `demap_bins.llrs`
counter (the coded bits demapped, frames × D × R, R = Σ table) and the
configuration's shapes, each input and output once: for each frame the
equalized value of every active data bin of its D data symbols, Ĥ at
those bins and each symbol's noise floor in, its LLRs (float32) and its
EVM and mean |LLR| out; the per-bin tables, shared by every frame, are
left out. None where the trace saw no device work, where the program
keeps no such span or counter (a checkout older than them) or where the
split tail did not run."""

from benchmark.spans import counters, device_ms


def demap_bins_bytes(cfg, llrs: int) -> int:
    """The bytes kernel B must move for `llrs` coded bits."""
    D, A = cfg.n_data_symbols, cfg.n_active_bins
    rows = llrs // cfg.raw_bits_per_frame
    return 4 * llrs + rows * (8 * D * A + 8 * A + 4 * D + 2 * 4)


def read(ctx):
    ms = device_ms(ctx)
    llrs = (counters(ctx) or {}).get("demap_bins.llrs")
    if not ms or not llrs:
        return None
    nbytes = demap_bins_bytes(ctx["cfg"], llrs) / ctx["trace"].steps
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / (ms * 1e-3)
