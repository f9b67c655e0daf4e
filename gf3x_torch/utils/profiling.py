"""The port's tracing layer (counterpart of gf3x/utils/profiling.py,
torch.profiler in place of jax.profiler): spans at the receive path's
stages, the LDPC decode pass's and the warped DFT's counters, and the
Chrome trace hook.

Spans. `Modem` wraps each stage of a call in `span(name)`: the public
entries (`demodulate`, `demodulate_sfo`, ...) open the root span, the
stages (`sync`, `cut`, `dft` with `warped_dft` on the clock-offset route,
`chanest`, `eq_demap` with `eq_track` and `demap_bins` on the split
tail, `fec_gather`, `ldpc` with `ldpc.check` and `ldpc.decode`, `diag`
with `llr_hist`, `clock_offset`, ...) its children.
Tracing is on while the torch profiler runs or inside `recording()`;
while it is off a span is one flag check that returns a shared no-op
context (no allocation, no `record_function`, no CUDA call). While it is
on a span

- enters `record_function("gf3x.<name>")` when the profiler runs, so the
  stage lies on the profiler's host timeline beside CUPTI's device events;
- records a pair of CUDA timing events (from a reused pool) on the current
  stream once the card is in use, so its device time is the stream's time
  from entry to exit, idle time inside the stage included;
- records the host clock (`perf_counter_ns`) at entry and exit;
- appends (call id, name, parent) to an in-memory list; the spans of one
  call share the id of its root span.

Nothing in a span synchronises. `span_totals()` synchronises, resolves the
events and returns per span name the count, host seconds, host self seconds
(minus the direct children's host time) and device seconds (None without a
card); `counters()` the LDPC counts; `records()` the spans themselves;
`reset()` clears them all. Reading is idempotent.

Counters. While tracing is on, the LDPC decode pass counts on the device,
with no launch added: the codewords the check pass queued for it
(`ldpc.queued`) and the sweeps they ran (`ldpc.sweeps`); the host counts
the codewords it was given (`ldpc.codewords`). The plain (CPU) route counts
the same from its `passes` with torch ops. The host also counts, from
shapes, the δ-warped DFTs a call ran (`ofdm.warped_dfts`), the symbol
rows they transformed (`ofdm.warped_rows`), those of the rows the
chirp-z transform took (`ofdm.czt_rows`) and those of these its fused
kernel took (`ofdm.czt_fused_rows`), and on the split tail the frames
kernel A equalized (`eq_track.rows`) and the coded bits kernel B demapped
(`demap_bins.llrs`), and the LLRs the diagnostics' histogram counted
(`llr_hist.samples`, inside its `gf3x.llr_hist` span under `gf3x.diag`),
and the rows each of the cut's three routes took (`cut.fused_rows` kernel
1, `cut.group_rows` kernel 6, `cut.window_rows` kernel 7), through
`count`.

An operator's stage times, without the profiler's overhead:

    with profiling.recording():
        for rx in batches:
            modem.demodulate(rx)
    for name, t in profiling.span_totals().items():
        print(name, t["count"], t["host_s"], t["device_s"])

A Chrome trace of the host and the device, the `gf3x.*` spans included:

    with gf3x_torch.utils.profiling.trace("/tmp/gf3x-trace"):
        modem.decode_batch(rx)
    # -> /tmp/gf3x-trace/trace.json

or from the CLI via GF3X_PROFILE=/tmp/gf3x-trace.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["trace", "maybe_trace", "span", "recording", "span_totals",
           "counters", "records", "reset", "Span", "count", "decode_counts",
           "count_plain"]

_NOOP = contextlib.nullcontext()
# the counts kept on the host
HOST_COUNTS = ("ldpc.codewords", "ofdm.warped_dfts", "ofdm.warped_rows",
               "ofdm.czt_rows", "ofdm.czt_fused_rows", "eq_track.rows",
               "demap_bins.llrs", "llr_hist.samples", "cut.fused_rows",
               "cut.group_rows", "cut.window_rows")


class Span(NamedTuple):
    """One recorded span: the id of the call (its root span), its name
    (`gf3x.<stage>`) and the index of its parent in `records()` (-1 for a
    root)."""

    call: int
    name: str
    parent: int


class _Tracer:
    """The process's records: spans as [call, name, parent, host start ns,
    host end ns, (device, start, end) CUDA events or None, device seconds
    or None], the stack of open spans, the free events by device, and the
    counters: those of the host by name, the device's in a buffer each."""

    def __init__(self):
        self.recording = 0
        self.calls = itertools.count()
        self.spans: list = []
        self.stack: list = []
        self.free: dict = {}
        self.counts = dict.fromkeys(HOST_COUNTS, 0)
        self.buffers: dict = {}    # device → int64 (queued, sweeps)

    def events(self):
        """A (device, start, end) triple of timing events of the current
        device."""
        dev = torch.cuda.current_device()
        pool = self.free.setdefault(dev, [])
        if pool:
            return pool.pop()
        return (dev, torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def resolve(self):
        """Wait for each closed span's end event and turn its events into
        seconds, returning them to the pool."""
        for r in self.spans:
            if r[5] is None or not r[4]:
                continue
            dev, start, end = r[5]
            end.synchronize()
            r[6] = start.elapsed_time(end) * 1e-3
            self.free[dev].append(r[5])
            r[5] = None


_T = _Tracer()


def _on() -> bool:
    return _profiler._is_profiler_enabled or _T.recording > 0


class _Span:
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name = "gf3x." + name
        self.rf = None

    def __enter__(self):
        t = _T
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        parent = t.stack[-1] if t.stack else -1
        call = t.spans[parent][0] if parent >= 0 else next(t.calls)
        ev = t.events() if torch.cuda.is_initialized() else None
        if ev is not None:
            ev[1].record()
        t.stack.append(len(t.spans))
        t.spans.append([call, self.name, parent, time.perf_counter_ns(), 0,
                        ev, None])
        return self

    def __exit__(self, *exc):
        t = _T
        r = t.spans[t.stack.pop()]
        if r[5] is not None:
            r[5][2].record()
        r[4] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """The context of stage `name` (recorded as `gf3x.<name>`): a shared
    no-op while tracing is off."""
    if not (_profiler._is_profiler_enabled or _T.recording):
        return _NOOP
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Tracing on without the profiler: spans record their host and device
    times and the counters count, until the context exits."""
    _T.recording += 1
    try:
        yield
    finally:
        _T.recording -= 1


def reset() -> None:
    """Forget every span and zero the counters (outside any span)."""
    _T.resolve()
    _T.spans.clear()
    _T.counts = dict.fromkeys(HOST_COUNTS, 0)
    for b in _T.buffers.values():
        b.zero_()


def records() -> list:
    """Every closed or open span recorded since `reset`, in entry order."""
    return [Span(*r[:3]) for r in _T.spans]


def span_totals() -> dict:
    """{span name: {"count", "host_s", "self_s", "device_s"}} over the
    closed spans: host seconds, host seconds not covered by the span's
    direct children, device seconds (None where no span of the name had
    CUDA events). Synchronises the device."""
    _T.resolve()
    child = [0] * len(_T.spans)
    for r in _T.spans:
        if r[4] and r[2] >= 0:
            child[r[2]] += r[4] - r[3]
    out = {}
    for r, c in zip(_T.spans, child):
        if not r[4]:
            continue
        t = out.setdefault(r[1], {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                  "device_s": None})
        t["count"] += 1
        t["host_s"] += (r[4] - r[3]) * 1e-9
        t["self_s"] += (r[4] - r[3] - c) * 1e-9
        if r[6] is not None:
            t["device_s"] = (t["device_s"] or 0.0) + r[6]
    return out


def counters() -> dict:
    """Each of HOST_COUNTS and the decode pass's "ldpc.queued" and
    "ldpc.sweeps", counted while tracing was on: the codewords given to
    the LDPC decoder, those the check pass queued for the decode pass and
    the sweeps they ran; the δ-warped DFTs run, the symbol rows they
    transformed, those of the rows the chirp-z transform took and those of
    these its fused kernel took; the frames kernel A equalized, the coded
    bits kernel B demapped and the LLRs the histogram counted; the rows
    kernels 1, 6 and 7 cut. Synchronises the device."""
    queued = sweeps = 0
    for b in _T.buffers.values():
        q, s = b.tolist()     # waits for the work queued before it
        queued, sweeps = queued + q, sweeps + s
    return {**_T.counts, "ldpc.queued": queued, "ldpc.sweeps": sweeps}


def count(name: str, n: int) -> None:
    """Add n to the host counter `name` (one of HOST_COUNTS) while tracing
    is on; one flag check while it is off."""
    if _profiler._is_profiler_enabled or _T.recording:
        _T.counts[name] += n


def _counts(device) -> torch.Tensor:
    """The device's two int64 counters (queued, sweeps), made at first
    use."""
    buf = _T.buffers.get(device)
    if buf is None:
        buf = _T.buffers[device] = torch.zeros(2, dtype=torch.int64,
                                               device=device)
    return buf


def decode_counts(lam: torch.Tensor) -> int:
    """The address the decode pass over lam's codewords adds its two counts
    at, or 0 while tracing is off (the kernel counts nothing). The
    device's counters are made at its first call, traced or not, so that a
    traced call launches what an untraced one does."""
    buf = _counts(lam.device)
    if not _on():
        return 0
    _T.counts["ldpc.codewords"] += lam.shape[0]
    return buf.data_ptr()


def count_plain(passes: torch.Tensor) -> None:
    """The plain route's counts while tracing is on: len(passes)
    codewords, (passes > 0).sum() queued, passes.sum() sweeps."""
    if not _on():
        return
    _T.counts["ldpc.codewords"] += passes.shape[0]
    _counts(passes.device).add_(torch.stack(
        [(passes > 0).sum(), passes.sum(dtype=torch.int64)]))


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the host and, where there is a card, the
    device; written as a Chrome trace to `log_dir`/trace.json on exit."""
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
