"""Nothing a benchmark run loads is the JAX package or JAX (top-level names
compared whole: gf3x_torch is not gf3x), and the reference loads nothing of
the program either."""

import ast
import subprocess
import sys
import types

import pytest

from benchmark import harness

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "gf3x"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_the_jax_side():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert len(files) > 10
    for f in files:
        names = set(_imports(f))
        assert not names & FORBIDDEN, f
        if "reference" in f.parts:
            assert "gf3x_torch" not in names, f


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "c = harness.load_cell('gf3-8192.b1024-20db')\n"
        "c.traffic = dict(c.traffic, batch=8, ring=1, frames=2)\n"
        "c.spec = dict(c.spec, warmup_steps=1, sample_rows=2)\n"
        "harness.run(c, 1, 0.01, True, 'cpu', time.perf_counter())\n"
        "for m in c.per_layer: harness._reader(c.root, m['name'])\n"
        "import benchmark.control\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd="/")
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "gf3x_torch" in top and not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.modem, benchmark.reference.work\n"
            "import benchmark.reference.channel, benchmark.traffic\n"
            "import benchmark.checks\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd="/")
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & (FORBIDDEN | {"gf3x_torch"})


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("gf3x_torch", "gf3x_torchy", "jaxtyping_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gf3x.ops", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["gf3x"]


@pytest.mark.card
def test_a_run_on_the_card():
    """One short run of the first cell on the card: correct, with its
    end-to-end metrics."""
    import json

    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gf3-8192.b1024-20db", "--seed", "5", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"frames_per_s", "step_p95_ms",
                                      "setup_s"}
