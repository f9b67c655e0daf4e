"""The harness on the CPU: BENCHMARK.json against the contract, every file a
cell, configuration or metric needs found by name, a new cell picked up from
files alone, the result line's keys, the trace reductions and the byte
counts; and `run.py` refusing to run without a card."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.reference import config as ref_config
from benchmark.reference import work
from benchmark.trace import Trace, roofline_pct

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(cell, batch=8, frames=4):
    """The cell at a size the CPU runs in seconds: B rows, two ring
    batches, few rows judged."""
    cell.traffic = dict(cell.traffic, batch=batch, ring=2, frames=frames)
    cell.spec = dict(cell.spec, warmup_steps=1, profile_steps=2,
                     sample_rows=4)
    return cell


def test_benchmark_json_keeps_the_contract():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in BENCH["workloads"]} == names
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_is_found_by_name(name):
    cell = harness.load_cell(name)
    assert cell.traffic["entry"] in harness.PROGRAM
    assert cell.traffic["entry"] in harness.REFERENCE
    limits = cell.spec["limits"]
    assert set(limits) >= {"bits_sent", "bits_ref", "sync_start", "H"}
    pcfg, rcfg = harness._configs(cell)
    fields = [f for f in vars(rcfg)]
    assert {f: getattr(pcfg, f) for f in fields} == vars(rcfg)
    assert cell.config["reduced"] == []
    for m in cell.per_layer:
        read, params = harness._reader(ROOT, m["name"])
        assert callable(read) and params["unit"] == m["unit"]


def test_a_new_cell_is_files_alone(tmp_path):
    """A configuration and a workload added as files and BENCHMARK.json
    entries run with no code edit, steps of several calls included."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = tmp_path / "benchmark"
    (base / "configs" / "gf3-narrow.json").write_text(json.dumps(
        {"preset": "gf3-standard", "replace": {}, "reduced": []}))
    (base / "traffic" / "b8x2-25db.json").write_text(
        json.dumps({"entry": "demodulate", "sub_batches": 2, "batch": 8,
                    "snr_db": 25.0, "clock_ppm": 0.0, "margin": 1024,
                    "frames": 2, "payload_bytes": 100, "ring": 2}))
    spec = json.loads((base / "workloads" / f"{CELLS[0]}.json").read_text())
    (base / "workloads" / "gf3-narrow.b8x2-25db.json").write_text(
        json.dumps(dict(spec, sample_rows=3)))
    bench["configs"].append({"name": "gf3-narrow", "source": "a test",
                             "file": "benchmark/configs/gf3-narrow.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "gf3-narrow.b8x2-25db",
                               "config": "gf3-narrow",
                               "traffic": "b8x2-25db", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("gf3-narrow.b8x2-25db", root=tmp_path)
    assert cell.traffic["batch"] == 8 and cell.root == tmp_path
    result, _ = harness.run(cell, 5, 0.01, False, "cpu", time.perf_counter())
    assert result["correct"] is True and result["attempted"] >= 16
    assert result["attempted"] % 16 == 0


def test_result_line_has_the_contract_keys():
    cell = tiny(harness.load_cell(CELLS[0]))
    result, lines = harness.run(cell, 2 ** 31 + 5, 0.01, True, "cpu",
                                time.perf_counter())
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    # a run without a card reports no device metric and no breakdown
    assert set(result["metrics"]) == {"host.issue_ms"}
    assert all(set(v) == {"value", "limit"}
               for v in result["checks"].values())
    assert lines[-len(result["checks"]):] == [
        f"{k} {v['value']!r} limit {v['limit']!r}"
        for k, v in result["checks"].items()]


def test_run_exits_without_a_card(tmp_path):
    """No CUDA device: a non-zero exit and no result. Also in a directory
    that holds only BENCHMARK.json and the benchmark's folder."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for where in (ROOT, tmp_path):
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            CELLS[0], "--seed", "1", "--seconds", "1",
                            "--trace", "0"], cwd=where, capture_output=True,
                           text=True, timeout=300)
        assert p.returncode != 0 and p.stdout == ""
        assert "benchmark:" in p.stderr


def test_byte_counts_reproduce_the_config5_bounds():
    cfg = ref_config.GF3_STANDARD
    assert round(work.cut_bytes(cfg, 1024) / 1e6, 1) == 209.7
    assert round(work.eq_demap_bytes(cfg, 1024) / 1e6, 1) == 88.5
    assert round(work.ldpc_bytes(cfg, 1024) / 1e6, 1) == 75.5


def test_trace_reductions():
    tr = Trace(steps=2, t0=0.0, t1=100.0,
               device=[(10, 30, "k_a"), (20, 40, "k_b"), (60, 70, "k_a"),
                       (95, 120, "k_c")],
               host=[(0, 100, "bench.step"), (45, 55, "aten::nonzero")],
               runtime=6)
    assert tr.intervals() == [[10, 40], [60, 70], [95, 100]]
    assert abs(tr.busy_s() - 45e-6) < 1e-12
    assert abs(tr.window_s - 100e-6) < 1e-12
    assert abs(tr.kernel_s(["k_a"]) - 30e-6) < 1e-12
    assert tr.top_ops(2) == [["k_a", pytest.approx(30e-6)],
                             ["k_b", pytest.approx(20e-6)]]
    gaps = dict(tr.idle_by_host())
    assert gaps == {"aten::nonzero": pytest.approx(20e-6),
                    "bench.step": pytest.approx(35e-6)}
    ctx = {"trace": tr, "params": {"kernels": ["k_a"]},
           "peaks": {"hbm_bytes_per_s": 1e9}}
    assert roofline_pct(ctx, 10.0) == pytest.approx(100 * 1e-8 / 15e-6)
    ctx["params"] = {"kernels": ["absent"]}
    assert roofline_pct(ctx, 10.0) is None
