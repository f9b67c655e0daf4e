"""warped_dft.device_ms: the device time a step of the δ-warped DFT on the
clock-offset route (`ops.ofdm.ofdm_dft` with δ: the angle tables, the two
full-float32 products and the complex assembly, inside `gf3x.dft`): the
`gf3x.warped_dft` spans' CUDA events, from each span's entry to its exit on
the stream's clock, so the stage's own idle time counts too
(benchmark/spans.py). None on a route or a checkout without the span."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx)
