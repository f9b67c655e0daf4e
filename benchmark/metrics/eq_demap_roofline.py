"""eq_demap_roofline: the stage's bytes (benchmark/reference/work.py,
eq_demap_bytes, from the configuration's shapes) at the peak HBM rate over the
device time a step of the kernels eq_demap_roofline.json names."""

from benchmark.reference.work import eq_demap_bytes
from benchmark.trace import roofline_pct


def read(ctx):
    return roofline_pct(ctx, eq_demap_bytes(ctx["cfg"], ctx["batch"]))
