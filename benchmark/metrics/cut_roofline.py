"""cut_roofline: the stage's bytes (benchmark/reference/work.py,
cut_bytes, from the configuration's shapes) at the peak HBM rate over the
device time a step of the kernels cut_roofline.json names."""

from benchmark.reference.work import cut_bytes
from benchmark.trace import roofline_pct


def read(ctx):
    return roofline_pct(ctx, cut_bytes(ctx["cfg"], ctx["batch"]))
