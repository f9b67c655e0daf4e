"""ldpc.sweeps_per_queued: the min-sum sweeps the decode pass ran per
codeword queued for it, from the decode kernel's two device counters
(benchmark/spans.py); None where none was queued."""

from benchmark.spans import counters


def read(ctx):
    c = counters(ctx)
    if not c or not c["ldpc.queued"]:
        return None
    return c["ldpc.sweeps"] / c["ldpc.queued"]
