"""sync.device_ms: the device time a step of the sync stage (`Modem._sync`:
the bounded, decimated chirp correlation): the `gf3x.sync` spans' CUDA
events, from each span's entry to its exit on the stream's clock, so the
stage's own idle time counts too (benchmark/spans.py)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx)
