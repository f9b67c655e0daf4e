"""The check that decides `correct` fails what it has to: the control (the
reference a precision below the program's, in its place) and the faults a
receive step can have — half of the batch left out, and an answer altered
where it is produced. (A step has no state to leave unchanged, and a
one-chip cell no exchange between chips.)"""

import json
import time

import pytest

from benchmark import entries, harness
from benchmark.control import control

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def small(name, frames=8):
    cell = harness.load_cell(name)
    cell.traffic = dict(cell.traffic, batch=8, ring=2, frames=frames)
    cell.spec = dict(cell.spec, warmup_steps=1, sample_rows=8)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    ok, judged = control(small(name), 4242, "cpu")
    assert ok is False
    graded = [k for k, v in judged.items()
              if v["limit"] and v["value"] > v["limit"]]
    assert graded, judged


def half_batch(entry):
    """Demodulate the first half of the batch; the second half's outputs
    repeat the first half's."""
    def step(modem, rx):
        h = rx.shape[0] // 2
        bits, diag = entry(modem, rx[:h])
        rep = lambda t: t.repeat(2, *([1] * (t.dim() - 1)))  # noqa: E731
        return rep(bits), type(diag)(*(rep(t) for t in diag))
    return step


def flipped_bit(entry):
    """One payload bit of one row inverted where the step produces it."""
    def step(modem, rx):
        bits, diag = entry(modem, rx)
        bits = bits.clone()
        bits[3, 100] ^= 1
        return bits, diag
    return step


@pytest.mark.parametrize("fault", [half_batch, flipped_bit])
@pytest.mark.parametrize("name", CELLS)
def test_a_faulty_step_is_not_correct(name, fault, monkeypatch):
    cell = small(name)
    entry = cell.traffic["entry"]
    monkeypatch.setitem(entries.PROGRAM, entry,
                        fault(entries.PROGRAM[entry]))
    result, lines = harness.run(cell, 77, 0.01, False, "cpu",
                                time.perf_counter())
    assert result["correct"] is False, "\n".join(lines)
