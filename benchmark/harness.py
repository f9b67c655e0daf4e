"""The benchmark's harness: one cell, one seed, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of `workloads` in BENCHMARK.json; the harness finds its
files by name: `benchmark/configs/<config>.json` (the modem configuration),
`benchmark/traffic/<traffic>.json` (the generator's parameters, the entry
the window drives and the calls a step makes) and `benchmark/workloads/<cell>.json` (warm-up and
profiled steps, the rows the reference judges, the limits of the
comparison). Each per-layer metric is `benchmark/metrics/<name>.py` (its
reader) with `<name>.json` (the reader's parameters). Adding a cell, a
configuration or a metric is adding files and entries in BENCHMARK.json.

A run: the kernel library is loaded from its compile cache (built on the
first run in a checkout), the cell's `Modem` is built, the inputs are made
from the seed (`benchmark/traffic.py`), every ring batch is warmed up, then
a closed loop runs the entry back to back over the ring for `--seconds`:
a step is `sub_batches` calls (1 where the traffic file names none) on the
next batches of the ring, as arrival batches of a streaming receiver, then
one synchronise. With `--trace 1` a profiled run of the same
loop follows. Once the window has closed and the peak memory is read, the
program's state is freed and the float64 reference judges a sample of the
rows of the last output of each ring batch (`benchmark/checks.py`)."""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import checks
from .entries import PROGRAM, REFERENCE
from .reference import config as ref_config
from .reference.modem import F64, Receiver
from .trace import STEP_SPAN, collect
from .traffic import make_inputs

__all__ = ["ROOT", "FORBIDDEN", "Cell", "load_cell", "forbidden_modules",
           "reference_config", "sample_rows", "run", "main"]

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gf3x")


class RunError(RuntimeError):
    """A run that must print no result."""


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    spec: dict
    chips: int
    end_to_end: list
    per_layer: list
    root: Path


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    base = root / "benchmark"

    def applies(m):
        return name in m.get("workloads", [name])
    return Cell(name=name, config=_json(base / "configs" /
                                        f"{w['config']}.json"),
                traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
                spec=_json(base / "workloads" / f"{name}.json"),
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)],
                root=root)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not hold, compared
    whole (gf3x_torch is not gf3x)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _replace(cell: Cell) -> dict:
    """The config file's `replace` block with each list (a loading table)
    as the tuple a ModemConfig holds."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in cell.config["replace"].items()}


def reference_config(cell: Cell):
    """The reference's ModemConfig from the cell's config file."""
    return ref_config.preset(cell.config["preset"]).replace(**_replace(cell))


def _configs(cell: Cell):
    """(the program's ModemConfig, the reference's) from the config file."""
    from gf3x_torch.config import preset

    return (preset(cell.config["preset"]).replace(**_replace(cell)),
            reference_config(cell))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reader(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read, _json(path.with_suffix(".json"))


def sample_rows(seed: int, B: int, n: int, ring: int, dev) -> list:
    """The rows of each ring batch the reference judges, drawn from the
    seed: min(n, B) distinct rows a batch, sorted."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    return [torch.as_tensor(np.sort(rng.choice(B, min(n, B), replace=False)),
                            device=dev) for _ in range(ring)]


def _power_limit(dev: torch.device):
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float):
    """One run of `cell` on `device` → (result dict, the check lines)."""
    from gf3x_torch import Modem

    marks = [("imports", time.perf_counter())]
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg, rcfg = _configs(cell)
    tr_cfg, spec = cell.traffic, cell.spec
    margin, B = int(tr_cfg["margin"]), int(tr_cfg["batch"])
    K = int(tr_cfg.get("sub_batches", 1))
    if dev.type == "cuda":
        from gf3x_torch.utils.device import kernel_lib
        kernel_lib()
    marks.append(("library", time.perf_counter()))
    modem = Modem(pcfg, max_delay=margin + pcfg.cp, device=dev)
    marks.append(("modem", time.perf_counter()))
    inputs = make_inputs(rcfg, tr_cfg, seed, dev)
    _sync(dev)
    marks.append(("inputs", time.perf_counter()))
    ring, R = inputs.ring, len(inputs.ring)
    entry = PROGRAM[tr_cfg["entry"]]
    outs = [None] * R

    def step(i):
        """Step i: its K calls on the ring's next batches, unsynchronised."""
        for j in range(i * K, (i + 1) * K):
            outs[j % R] = entry(modem, ring[j % R])

    for i in range(max(int(spec["warmup_steps"]), -(-R // K))):
        step(i)
        _sync(dev)

    # ---- the window: a closed loop, back to back, each step synchronised
    t_first = time.perf_counter()
    setup_s = t_first - t_start
    marks.append(("warm-up", t_first))
    steps, t_end = 0, t_first
    step_s, issue_s, ends = [], [], []
    while t_end - t_first < seconds:
        t0 = time.perf_counter()
        step(steps)
        t1 = time.perf_counter()
        _sync(dev)
        t_end = time.perf_counter()
        step_s.append(t_end - t0)
        issue_s.append(t1 - t0)
        ends.append(t_end - t_first)
        steps += 1
    window_s = t_end - t_first
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    prev = [t_start] + [t for _, t in marks[:-1]]
    lines = [" ".join(f"{k} {t - p:.3f}" for (k, t), p in zip(marks, prev)),
             f"setup_s {setup_s!r} steps {steps} window_s {window_s!r} "
             f"steps_each_second "
             f"{np.bincount(np.floor(ends).astype(int)).tolist()} "
             f"step_median_ms "
             f"{1e3 * float(np.median(step_s))!r} step_p95_ms "
             f"{1e3 * float(np.percentile(step_s, 95))!r}"]

    values = {"frames_per_s": B * K * steps / window_s,
              "step_p95_ms": 1e3 * float(np.percentile(step_s, 95)),
              "setup_s": setup_s}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        n_prof = int(spec["profile_steps"])
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            for k in range(n_prof):
                with record_function(STEP_SPAN):
                    step(steps + k)
                    _sync(dev)
        tr = collect(prof, n_prof)
        del prof
        ctx = {"trace": tr, "issue_s": issue_s, "cfg": rcfg, "batch": B * K,
               "peaks": _json(cell.root / "benchmark" / "peaks.json")}
        values = {}
        for m in cell.per_layer:
            read, params = _reader(cell.root, m["name"])
            v = read(dict(ctx, params=params))
            if v is not None:
                values[m["name"]] = v
        if tr.device:
            device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
            breakdown = {"device_ops": tr.top_ops(),
                         "idle_gaps": tr.idle_by_host()}
    units = {m["name"]: m["unit"]
             for m in (cell.per_layer if trace else cell.end_to_end)}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items()
               if k in units}
    if dev.type == "cuda":
        device_info["power"] = _power_limit(dev)

    found = forbidden_modules()
    if found:
        raise RunError("modules the benchmark may not load are loaded: "
                       + ", ".join(found))

    # ---- the check, once the program's state is freed
    t_check = time.perf_counter()
    rows = sample_rows(seed, B, int(spec["sample_rows"]), R, dev)
    prog, bits_sent, failed = [], 0, 0
    for (bits, diag), r in zip(outs, rows):
        wrong = bits != inputs.sent[inputs.frame_of_row]
        bits_sent += int(wrong.sum())
        failed += int(wrong.any(dim=1).sum())
        prog.append({f: (bits if f == "bits" else getattr(diag, f))[r]
                     .clone() for f in checks.FIELDS})
    del outs, modem, bits, diag, wrong
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = Receiver(rcfg, margin + rcfg.cp, dev, F64)
    want = [REFERENCE[tr_cfg["entry"]](ref, rx, r)
            for rx, r in zip(ring, rows)]
    numbers = checks.compare(checks.join(prog), checks.join(want))
    numbers["bits_sent"] = bits_sent
    correct, judged = checks.judge(numbers, spec.get("limits", {}))
    lines.append(f"check_s {time.perf_counter() - t_check!r} rows "
                 f"{len(rows) * len(rows[0])}")
    result = {"correct": correct, "attempted": B * K * steps, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = judged
    lines += [f"{k} {v['value']!r} limit {v['limit']!r}"
              for k, v in judged.items()]
    return result, lines


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload)
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card "
                           "only")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"the cell needs {cell.chips} CUDA devices; "
                           f"{torch.cuda.device_count()} visible")
        result, lines = run(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", t_start)
    except (RunError, ImportError, OSError, KeyError) as e:
        print(f"benchmark: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0
