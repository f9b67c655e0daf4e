"""The benchmark's clock-offset cell (`gf3-8192.clock150-30db`) on the CPU
at a small size, with the cell's own limits: the port's `demodulate_sfo`
through `benchmark.harness.run` is `correct` with every payload bit exact,
and the same run with the warped DFT as gf3x computes it — a dense
product over tables of (2π/N)·n·k·(1+δ) in float32, n·k unreduced — is
not. The second shows
the cell's limits see the precision its configuration states (float32):
that angle errs by −72 dB at gf3-8192, and the stages after it read
within a few times of the TF32 control (benchmark/control.py)."""

import time

from benchmark import harness
from gf3x_torch.ops import ofdm as tofdm

CELL = "gf3-8192.clock150-30db"


def small_cell():
    """The cell at B = 8, a ring of 2, 8 distinct frames; one warm-up
    step, every row judged."""
    cell = harness.load_cell(CELL)
    cell.traffic = dict(cell.traffic, batch=8, ring=2, frames=8)
    cell.spec = dict(cell.spec, warmup_steps=1)
    return cell


def run_small(monkeypatch, seed: int) -> dict:
    """One run of the small cell on the CPU: its warm-up, one timed step
    and the float64 reference's judgement. The run's refusal of JAX's
    modules is set aside: this process loaded them for the tests of the
    JAX package (benchmark/tests/test_bench_imports.py holds a run to
    none)."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    result, _ = harness.run(small_cell(), seed, 1e-6, False, "cpu",
                            time.perf_counter())
    return result


def test_clock_offset_configuration_is_what_the_cell_runs():
    """The deployment's configuration (`gf3-8192-clock150`) is gf3-8192's
    modem with the clock pair and route its traffic file runs: the harness
    reads the modem from the configuration and the clock from the
    traffic, so the two files state one deployment."""
    cell = harness.load_cell(CELL)
    wide = harness._json(harness.ROOT / "benchmark" / "configs" /
                         "gf3-8192.json")
    assert (cell.config["preset"], cell.config["replace"]) == \
        (wide["preset"], wide["replace"])
    assert cell.config["reduced"] == []
    assert cell.config["clock"] == {
        "clock_ppm": cell.traffic["clock_ppm"],
        "receive_route": cell.traffic["entry"]}


def test_clock_offset_cell_is_correct_on_the_cpu(monkeypatch):
    """The port's route within every limit, every payload bit exact."""
    result = run_small(monkeypatch, 2_000_000_017)
    assert result["attempted"] >= 8 and result["failed"] == 0
    assert result["checks"]["bits_sent"]["value"] == 0
    assert result["correct"] is True, result["checks"]


def test_clock_offset_cell_catches_the_unreduced_angle(monkeypatch):
    """gf3x's float32 angle in the port's warped DFT (the dense product
    over `ops.ofdm.unreduced_angle`'s table in place of the chirp-z
    transform) fails the cell's limits."""
    monkeypatch.setattr(tofdm, "takes_czt", lambda cfg: False)
    result = run_small(monkeypatch, 2_000_000_017)
    over = sorted(k for k, v in result["checks"].items()
                  if not v["value"] <= v["limit"])
    print("limits the unreduced angle breaks:", over)
    assert result["correct"] is False
    assert {"noise_var", "pilot_slope"} <= set(over)
