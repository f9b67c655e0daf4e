"""What the three evaluation reports (`stress`, `perf_report`,
`adapt_report`) share: their command line — `--device cuda|cpu` (the card
by default, exiting non-zero without one), `--trials N` and a required
`--out PATH` — and the write of a report to that path alone."""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

__all__ = ["parse_args", "write_report"]


def parse_args(doc: str, trials: int, argv=None, extra=None):
    """The reports' command line; `extra(ap)` adds a report's own options.
    Exits non-zero for `--device cuda` where torch has no CUDA device."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--trials", type=int, default=trials)
    ap.add_argument("--out", required=True,
                    help="the markdown report's path (its figures go beside "
                         "it)")
    if extra is not None:
        extra(ap)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gf3x_torch.bench: torch has no CUDA device here; "
                         "pass --device cpu to run on the CPU")
    return args


def write_report(out: str | Path, lines: list[str]) -> Path:
    """The report's markdown at `out` (its directory made if missing)."""
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    print(f"wrote {path}")
    return path
