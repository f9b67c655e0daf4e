"""Tracing and profiling hooks (counterpart of gf3x/utils/profiling.py,
torch.profiler in place of jax.profiler).

Usage:
    with gf3x_torch.utils.profiling.trace("/tmp/gf3x-trace"):
        modem.decode_batch(rx)
    # -> a Chrome trace (trace.json) in /tmp/gf3x-trace

or from the CLI via GF3X_PROFILE=/tmp/gf3x-trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["trace", "maybe_trace", "Timer"]


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the host and, where there is a card, the
    device; written as a Chrome trace to `log_dir`/trace.json on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


@contextlib.contextmanager
def maybe_trace(env: str = "GF3X_PROFILE"):
    """Trace only when the env var names a directory (CLI/bench hook)."""
    log_dir = os.environ.get(env)
    if log_dir:
        with trace(log_dir):
            yield
    else:
        yield


@dataclass
class Timer:
    """Wall-clock section timer for host-side pipeline accounting."""

    sections: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.sections.values()) or 1.0
        lines = [f"{k:24s} {v*1e3:9.1f} ms  {100*v/total:5.1f}%"
                 for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)
