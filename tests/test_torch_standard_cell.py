"""The published GF3 frame's cell, the benchmark's gf3-standard.b16384-6db,
on the CPU: its files as the harness loads them, the cell at B = 8 through
`benchmark.harness.run` judged by its own limits (sound, and with one
payload bit flipped where the step produces it), and the host counters of
the cut's three routes at the Modem's own geometries."""

import time

import pytest
import torch

from benchmark import entries, harness
from gf3x_torch import Modem
from gf3x_torch.utils import profiling

CELL = "gf3-standard.b16384-6db"


def test_the_cell_is_the_published_frame():
    """The configuration is GF3_STANDARD with nothing replaced or cut, its
    traffic the 6 dB batch of 16 384 the cell names, and the recording
    length under `assumed` is the frame's plus the margin."""
    cell = harness.load_cell(CELL)
    assert (cell.config["preset"], cell.config["replace"],
            cell.config["reduced"]) == ("gf3-standard", {}, [])
    assert {k: cell.traffic[k] for k in ("entry", "batch", "snr_db",
                                         "margin", "ring")} == {
        "entry": "demodulate", "batch": 16384, "snr_db": 6.0,
        "margin": 4096, "ring": 4}
    assert "sub_batches" not in cell.traffic and cell.chips == 1
    pcfg, rcfg = harness._configs(cell)
    assert (pcfg.n_fft, pcfg.cp, pcfg.n_used, pcfg.n_codewords) == (
        1024, 256, 280, 4)
    assert cell.config["assumed"]["recording_samples"] == (
        rcfg.frame_len + cell.traffic["margin"])
    assert "cut.fused_pct" in {m["name"] for m in cell.per_layer}


def flip_a_bit(entry):
    """One payload bit of one row inverted where the step produces it."""
    def step(modem, rx):
        bits, diag = entry(modem, rx)
        bits = bits.clone()
        bits[5, 200] ^= 1
        return bits, diag
    return step


@pytest.mark.parametrize("fault", [None, flip_a_bit], ids=["sound",
                                                           "flipped-bit"])
def test_the_cell_at_b8(fault, monkeypatch):
    """The committed cell at B = 8, a ring of 2, through the port's CPU
    route and judged by its own limits: `correct` with every payload bit
    exact, the check pass queueing codewords for the decode pass (6 dB is
    near the waterfall) and every row cut by kernel 1's route; with one
    payload bit flipped in the program's output, not `correct`. The run's
    refusal of JAX's modules is set aside, as in
    tests/test_torch_loaded_cell.py: this process loaded them for the
    tests of the JAX package."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    cell = harness.load_cell(CELL)
    cell.traffic = dict(cell.traffic, batch=8, ring=2)
    cell.spec = dict(cell.spec, warmup_steps=1, sample_rows=8)
    if fault is not None:
        monkeypatch.setitem(entries.PROGRAM, "demodulate",
                            fault(entries.PROGRAM["demodulate"]))
    profiling.reset()
    with profiling.recording():
        result, lines = harness.run(cell, 2 ** 33 + 17, 0.01, False, "cpu",
                                    time.perf_counter())
    c = profiling.counters()
    profiling.reset()
    calls = result["attempted"] // 8 + 2           # the warm-up's two
    if fault is None:
        assert result["failed"] == 0
        assert result["checks"]["bits_sent"]["value"] == 0
        assert result["correct"] is True, "\n".join(lines)
        assert 0 < c["ldpc.queued"] <= c["ldpc.codewords"] == 4 * 8 * calls
        assert (c["cut.fused_rows"], c["cut.group_rows"],
                c["cut.window_rows"]) == (8 * calls, 0, 0)
    else:
        assert result["checks"]["bits_sent"]["value"] > 0
        assert result["correct"] is False, "\n".join(lines)


def wide_config():
    return harness._configs(harness.load_cell("gf3-8192.b1024-20db"))[0]


@pytest.mark.parametrize("band,B,counter", [
    ("standard", 8, "cut.fused_rows"), ("standard", 16, "cut.fused_rows"),
    ("standard", 3, "cut.window_rows"), ("8192", 8, "cut.group_rows"),
    ("8192", 5, "cut.window_rows")])
def test_each_cut_route_counts_its_rows(band, B, counter):
    """`Modem._cut_frame` at the Modem's own geometry counts its B rows
    under the route `ops.sync.cut_symbols` takes: kernel 1's at the
    published frame (CP 256: every offset on the 128 grid), kernel 6's at
    gf3-8192 (its SC offset is off the grid) in whole 8-row groups, kernel
    7's where B % 8 ≠ 0; the other two count nothing, and nothing counts
    with tracing off."""
    cfg = (harness._configs(harness.load_cell(CELL))[0] if band == "standard"
           else wide_config())
    modem = Modem(cfg, device="cpu")
    rx = torch.randn(B, cfg.frame_len + 4096,
                     generator=torch.Generator().manual_seed(B))
    start = torch.arange(B, dtype=torch.int64) * 37
    profiling.reset()
    modem._cut_frame(rx, start)
    assert profiling.counters()[counter] == 0
    with profiling.recording():
        modem._cut_frame(rx, start)
    c = profiling.counters()
    profiling.reset()
    routes = {"cut.fused_rows", "cut.group_rows", "cut.window_rows"}
    assert c[counter] == B
    assert all(c[k] == 0 for k in routes - {counter})
