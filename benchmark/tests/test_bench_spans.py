"""The readers of the program's spans and counters (`benchmark/spans.py` and
the seven metrics that use it): None on an empty record, without a card and
on a program that keeps no spans; the right value on a record filled in
here."""

import pytest

from benchmark import harness
from benchmark.trace import Trace
from gf3x_torch.utils import profiling

ROOT = harness.ROOT
STEPS = 4
TOTALS = {n: {"count": STEPS, "host_s": 1.0, "self_s": 0.5, "device_s": d}
          for n, d in (("gf3x.sync", 0.004), ("gf3x.dft", 0.002),
                       ("gf3x.cut_dft", 0.001), ("gf3x.chanest", 0.008),
                       ("gf3x.fec_gather", 0.012), ("gf3x.diag", 0.006),
                       ("gf3x.demodulate", 0.064))}
COUNTS = {"ldpc.codewords": 4000, "ldpc.queued": 50, "ldpc.sweeps": 300}
# each metric's value on TOTALS and COUNTS over STEPS steps
WANT = {"sync.device_ms": 1.0, "dft.device_ms": 0.75,
        "chanest.device_ms": 2.0, "fec_gather.device_ms": 3.0,
        "diag.device_ms": 1.5, "ldpc.queued_pct": 1.25,
        "ldpc.sweeps_per_queued": 6.0}


def ctx(name, device=True):
    read, params = harness._reader(ROOT, name)
    tr = Trace(steps=STEPS, t0=0.0, t1=100.0,
               device=[(10, 20, "k")] if device else [])
    return read, {"trace": tr, "params": params}


def test_the_seven_metrics_are_listed():
    """Each cell reads the seven but at 30 dB the sweeps per queued
    codeword: there the check pass queues none."""
    cell = harness.load_cell("gf3-8192.b1024-20db")
    assert set(WANT) <= {m["name"] for m in cell.per_layer}
    cell = harness.load_cell("gf3-8192.b1024-30db")
    assert set(WANT) - {m["name"] for m in cell.per_layer} == {
        "ldpc.sweeps_per_queued"}


@pytest.mark.parametrize("name", sorted(WANT))
def test_an_empty_record_reads_none(name):
    profiling.reset()
    read, c = ctx(name)
    assert read(c) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_filled_record_reads_its_value(name, monkeypatch):
    monkeypatch.setattr(profiling, "span_totals", lambda: TOTALS)
    monkeypatch.setattr(profiling, "counters", lambda: COUNTS)
    read, c = ctx(name)
    assert read(c) == pytest.approx(WANT[name])
    read, c = ctx(name, device=False)      # no card: nothing to read
    assert read(c) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_program_without_spans_reads_none(name, monkeypatch):
    """A checkout older than the spans (the parent of this benchmark's
    readers) has no span_totals: the readers say nothing and raise
    nothing."""
    monkeypatch.delattr(profiling, "span_totals")
    read, c = ctx(name)
    assert read(c) is None


def test_none_where_the_route_lacks_the_span_or_queued_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "gf3x.sync": {"count": 1, "host_s": 1.0, "self_s": 1.0,
                      "device_s": None}})
    monkeypatch.setattr(profiling, "counters", lambda: dict(
        COUNTS, **{"ldpc.queued": 0, "ldpc.sweeps": 0}))
    for name in ("sync.device_ms", "dft.device_ms"):
        read, c = ctx(name)
        assert read(c) is None
    read, c = ctx("ldpc.queued_pct")
    assert read(c) == 0.0
    read, c = ctx("ldpc.sweeps_per_queued")
    assert read(c) is None
