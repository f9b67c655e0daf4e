"""diag.device_ms: the device time a step of the diagnostics (the LLR
histogram and what `Modem._finish` assembles): the `gf3x.diag` spans' CUDA
events, from each span's entry to its exit on the stream's clock, so the
stage's own idle time counts too (benchmark/spans.py)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx)
