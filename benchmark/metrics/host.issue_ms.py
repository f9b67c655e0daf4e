"""host.issue_ms: the mean host time of a step from the call into the entry
to its return, before the synchronise, over the steps of the window (the
benchmark's own span around the call; the profiler is off there)."""


def read(ctx):
    s = ctx["issue_s"]
    return 1e3 * sum(s) / len(s) if s else None
