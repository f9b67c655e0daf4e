"""Reductions of a torch.profiler trace of the timed step: the device's
busy intervals, each kernel's time, the CUDA runtime calls that launch work,
the device operations of most time and the device's idle time by what the
host was doing meanwhile.

The window is the span of the benchmark's own `bench.step` spans (the call
into the entry and the synchronise after it); every figure is clipped to
it."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch

__all__ = ["STEP_SPAN", "Trace", "collect", "roofline_pct"]

STEP_SPAN = "bench.step"
_RUNTIME = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                      r"Memcpy|Memset)")


@dataclass
class Trace:
    steps: int
    t0: float = 0.0                  # window start, µs (profiler clock)
    t1: float = 0.0                  # window end
    device: list = field(default_factory=list)   # (start, end, name) µs
    host: list = field(default_factory=list)     # (start, end, name) µs
    runtime: int = 0                 # launches, copies and sets issued

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def intervals(self) -> list:
        """The union of device intervals inside the window, sorted."""
        out = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) * 1e-6

    def kernel_s(self, patterns) -> float:
        """Device seconds of the operations whose name holds any of
        `patterns`."""
        return sum(min(e, self.t1) - max(s, self.t0)
                   for s, e, n in self.device
                   if any(p in n for p in patterns)
                   and min(e, self.t1) > max(s, self.t0)) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for s, e, name in self.device:
            by[name] += (min(e, self.t1) - max(s, self.t0)) * 1e-6
        return sorted(([k, v] for k, v in by.items() if v > 0),
                      key=lambda kv: -kv[1])[:n]

    def idle_by_host(self, n: int = 10) -> list:
        """Device idle seconds summed by the innermost host operation
        running at each gap's midpoint ('between steps' outside the step
        spans)."""
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by = defaultdict(float)
        edges = [self.t0] + [x for iv in self.intervals() for x in iv] + [
            self.t1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            label = "between steps"
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if host[i][1] >= mid:
                    label = host[i][2]
                    break
            by[label] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def collect(prof, steps: int) -> Trace:
    """The Trace of a finished torch.profiler.profile over `steps`
    `bench.step` spans."""
    tr = Trace(steps=steps)
    spans = []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.events():
        rng = (ev.time_range.start, ev.time_range.end)
        if ev.device_type == cuda:
            # a record_function span is mirrored on the device's timeline
            # as an annotation, which is no device work
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name == STEP_SPAN):
                tr.device.append((*rng, ev.name))
        elif _RUNTIME.match(ev.name):
            tr.runtime += 1
        else:
            tr.host.append((*rng, ev.name))
            if ev.name == STEP_SPAN:
                spans.append(rng)
    if spans:
        tr.t0, tr.t1 = min(s for s, _ in spans), max(e for _, e in spans)
    return tr


def roofline_pct(ctx: dict, nbytes: float):
    """A stage's share of its bandwidth roofline, in %: the least time
    `nbytes` take at the peak HBM rate over the device time a step of the
    kernels that ctx["params"]["kernels"] name (substrings); None where the
    trace holds none of them (no card, or another route)."""
    tr = ctx["trace"]
    t = tr.kernel_s(ctx["params"]["kernels"]) / tr.steps
    if t <= 0.0:
        return None
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / t
