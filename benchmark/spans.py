"""Readers of the program's own records of the profiled steps: the device
time of its stage spans and the LDPC decode pass's counters, both kept by
`gf3x_torch.utils.profiling` while the profiler ran. Each gives None where
the trace saw no device work (no card), where the program keeps no such
records (a checkout older than its spans) or where no span of the names
was recorded (a route without that stage)."""

from __future__ import annotations

__all__ = ["device_ms", "counters"]


def _profiling(ctx):
    """The program's tracing module, or None (no card, or no spans)."""
    if not ctx["trace"].device:
        return None
    try:
        from gf3x_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "span_totals"):
        return None
    return profiling


def device_ms(ctx):
    """The device milliseconds a step of the spans ctx["params"]["spans"]
    names, summed: each span's CUDA events on the stream's clock, from its
    entry to its exit, so idle time inside the stage counts too."""
    prof = _profiling(ctx)
    if prof is None:
        return None
    totals = prof.span_totals()
    got = [totals[n]["device_s"] for n in ctx["params"]["spans"]
           if totals.get(n, {}).get("device_s") is not None]
    return 1e3 * sum(got) / ctx["trace"].steps if got else None


def counters(ctx):
    """The program's counters over the profiled steps, or None."""
    prof = _profiling(ctx)
    return None if prof is None else prof.counters()
