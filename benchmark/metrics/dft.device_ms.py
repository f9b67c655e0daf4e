"""dft.device_ms: the device time a step of the DFT stage (`Modem._spectra`,
and kernel 8's fused cut + DFT where it runs): the `gf3x.dft` and
`gf3x.cut_dft` spans' CUDA events, from each span's entry to its exit on the
stream's clock, so the stage's own idle time counts too
(benchmark/spans.py)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx)
