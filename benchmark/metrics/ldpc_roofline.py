"""ldpc_roofline: the stage's bytes (benchmark/reference/work.py,
ldpc_bytes, from the configuration's shapes) at the peak HBM rate over the
device time a step of the kernels ldpc_roofline.json names."""

from benchmark.reference.work import ldpc_bytes
from benchmark.trace import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ldpc_bytes(ctx["cfg"], ctx["batch"]))
