"""device.idle_pct: the share of the profiled window's wall time in which no
kernel, copy or set runs on the card (the union of the device's intervals,
not their sum)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
