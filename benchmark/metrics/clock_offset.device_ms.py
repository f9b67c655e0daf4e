"""clock_offset.device_ms: the device time a step of the clock-offset loop
(`Modem._two_pass_delta`: the Schmidl-Cox coarse offset's median, the
δ₀-warped demod of every row and the median of its pilot slopes): the
`gf3x.clock_offset` spans' CUDA events, from each span's entry to its exit
on the stream's clock, so the stage's own idle time counts too
(benchmark/spans.py). The final warped demod lies outside it."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx)
