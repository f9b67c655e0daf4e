"""llr_hist_roofline: the diagnostics' |LLR| histogram's bytes at the peak
HBM rate over the device time of its `gf3x.llr_hist` spans (inside
`gf3x.diag`; benchmark/spans.py), both over the profiled steps. The bytes
come from the program's `llr_hist.samples` counter (rows × the sample
table's ⌈R/8⌉ entries) and the configuration's shapes, each input and
output once: 4 bytes a sampled LLR in, 16 int32 counts a row out; the
sample table, shared by every row, is left out. The samples touch a
quarter of each row's 32-byte sectors, four in each (gf3-8192), so the
card moves about twice these bytes and the share tops out near 50 %. None
where the trace saw no device work or where the program keeps no such span
or counter (a checkout older than them)."""

from benchmark.spans import counters, device_ms

STRIDE = 8   # every 8th coded-stream position is sampled


def llr_hist_bytes(cfg, samples: int) -> int:
    """The bytes the histogram must move for `samples` sampled LLRs."""
    rows = samples // -(-cfg.raw_bits_per_frame // STRIDE)
    return 4 * samples + 4 * 16 * rows


def read(ctx):
    ms = device_ms(ctx)
    samples = (counters(ctx) or {}).get("llr_hist.samples")
    if not ms or not samples:
        return None
    nbytes = llr_hist_bytes(ctx["cfg"], samples) / ctx["trace"].steps
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / (ms * 1e-3)
