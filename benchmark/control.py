"""The control of the check that decides `correct`: the reference itself put
in the program's place, computed a precision below the program's float32
with TF32 off: TF32 (the matrix products in TF32, the recording and every
stage's output rounded to TF32's mantissa, `reference.modem.CONTROL`), judged by the same comparison and limits as a
run. It has to come out not correct. The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

runs it at the cell's own size on the card and prints one JSON line a seed
with every number beside its limit; `benchmark/tests/test_bench_control.py`
runs it at a small size on the CPU."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import checks  # noqa: E402
from benchmark.entries import REFERENCE  # noqa: E402
from benchmark.harness import (Cell, load_cell, reference_config,  # noqa: E402
                               sample_rows)
from benchmark.reference.modem import CONTROL, F64, Receiver  # noqa: E402
from benchmark.traffic import make_inputs  # noqa: E402

__all__ = ["control"]


def control(cell: Cell, seed: int, device) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) of the control on the cell's
    inputs for `seed`, on the rows a run would judge."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = True
    tr, cfg = cell.traffic, reference_config(cell)
    inputs = make_inputs(cfg, tr, seed, dev)
    rows = sample_rows(seed, int(tr["batch"]), int(cell.spec["sample_rows"]),
                       len(inputs.ring), dev)
    route = REFERENCE[tr["entry"]]
    max_delay = int(tr["margin"]) + cfg.cp
    low = Receiver(cfg, max_delay, dev, CONTROL)
    ref = Receiver(cfg, max_delay, dev, F64)
    got, want, bits_sent = [], [], 0
    for rx, r in zip(inputs.ring, rows):
        g = route(low, rx, r)
        bits_sent += int((g["bits"] != inputs.sent[inputs.frame_of_row[r]])
                         .sum())
        got.append(g)
        want.append(route(ref, rx, r))
    numbers = checks.compare(checks.join(got), checks.join(want))
    numbers["bits_sent"] = bits_sent
    return checks.judge(numbers, cell.spec.get("limits", {}))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in args.seeds:
        ok, judged = control(cell, seed, "cuda")
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": ok, "checks": judged}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
