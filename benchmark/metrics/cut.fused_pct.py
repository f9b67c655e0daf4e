"""cut.fused_pct: the share of the rows cut in the profiled steps that the
fused cut (kernel 1, `cut_symbols_kernel`) took, against kernel 6
(`gather_cut_group_kernel`) and kernel 7 (`gather_cut_kernel`), from the
program's host counters of each route's rows (benchmark/spans.py); None
where the program keeps no such counters (a checkout older than them) or
cut no row."""

from benchmark.spans import counters

ROUTES = ("cut.fused_rows", "cut.group_rows", "cut.window_rows")


def read(ctx):
    c = counters(ctx)
    if not c or not all(k in c for k in ROUTES):
        return None
    rows = sum(c[k] for k in ROUTES)
    return 100.0 * c["cut.fused_rows"] / rows if rows else None
