"""ldpc.queued_pct: the share of the codewords given to the LDPC decoder
that its check pass queued for the decode pass (useful decode work over
attempts), from the decode kernel's device counter and the host's count
(benchmark/spans.py)."""

from benchmark.spans import counters


def read(ctx):
    c = counters(ctx)
    if not c or not c["ldpc.codewords"]:
        return None
    return 100.0 * c["ldpc.queued"] / c["ldpc.codewords"]
