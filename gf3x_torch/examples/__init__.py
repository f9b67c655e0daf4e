"""The walkthroughs of gf3x's examples/ on the port, one module each:

    python -m gf3x_torch.examples.end_to_end [outdir] [--device cuda|cpu]
    python -m gf3x_torch.examples.arq_file_transfer [outdir] [--device ...]
    python -m gf3x_torch.examples.adaptive_link [outdir] [--device ...]
    python -m gf3x_torch.examples.live_stream [outdir] [--device ...]

Each runs on the card by default and fails without one; `--device cpu`
runs it on the CPU (the kernels' plain versions). Each `main(outdir,
device)` raises if its walkthrough does not end as its original's does."""

from __future__ import annotations

import argparse

import torch

__all__ = ["EXAMPLES", "require_device", "run"]

EXAMPLES = ("end_to_end", "arq_file_transfer", "adaptive_link",
            "live_stream")


def require_device(device: str) -> torch.device:
    """`device` as a torch.device; exits non-zero for 'cuda' where torch
    has no CUDA device, rather than running on the CPU."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gf3x_torch.examples: torch has no CUDA device "
                         "here; pass --device cpu to run on the CPU")
    return torch.device(device)


def run(main, doc: str, argv=None) -> None:
    """A walkthrough's command line: [outdir] [--device cuda|cpu]."""
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("outdir", nargs="?", default="demo_out")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    main(args.outdir, device=args.device)
