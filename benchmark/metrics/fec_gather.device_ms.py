"""fec_gather.device_ms: the device time a step of the FEC gather
(`Modem._codeword_llrs`: deinterleave and descramble into codewords): the
`gf3x.fec_gather` spans' CUDA events, from each span's entry to its exit on
the stream's clock, so the stage's own idle time counts too
(benchmark/spans.py)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx)
