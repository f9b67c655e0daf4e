"""host.launches_per_step: kernel launches, copies and sets a step issues,
counted from the CUDA runtime calls in the profiled window."""


def read(ctx):
    tr = ctx["trace"]
    return tr.runtime / tr.steps if tr.device else None
