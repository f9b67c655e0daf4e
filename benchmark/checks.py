"""The comparison that decides `correct`: what the timed path produced,
stage by stage as far as `Modem.demodulate`'s outputs expose it, against
the float64 reference on the same recordings, and every payload bit
against what was sent.

Each number is a worst case over the rows compared. The names and what they
read:

    sync_start     rows whose chirp onset differs (exact)
    sync_metric    max relative gap of the correlation peak metric
    H              max over rows of max |ΔĤ| / rms |Ĥ_ref| (cut, DFT, estimate)
    noise_var      max relative gap of the LS noise variance
    pilot_slope    max |Δ slope| (rad a bin; EQ's pilot tracking)
    common_phase   max |Δ phase| (rad, wrapped)
    evm            max relative gap of the EVM (EQ/demap)
    mean_abs_llr   max relative gap of the mean |LLR| (demap)
    clock_ppm      max |Δ| of the clock offset from the slopes (ppm)
    fec_iters      max |Δ| of the most LDPC sweeps a frame's codewords ran
    fec_unsat      rows whose count of unsatisfied codewords differs (exact)
    bits_ref       payload bits that differ from the reference's (exact)
    bits_sent      payload bits that differ from those sent, over every row
                   of the outputs kept (exact; the configuration's
                   guarantee)

A cell's limits are in its workload file; a number with no limit fails."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["FIELDS", "join", "compare", "judge"]

FIELDS = ("bits", "sync_start", "sync_metric", "H", "noise_var",
          "pilot_slope", "common_phase", "evm", "mean_abs_llr", "clock_ppm",
          "fec_iters", "fec_unsat")


def join(parts: list) -> dict:
    """Per-batch dicts of FIELDS → one dict, rows concatenated."""
    return {f: torch.cat([p[f] for p in parts]) for f in FIELDS}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.max(torch.abs(a - b) / torch.clamp(torch.abs(b),
                                                          min=1e-30)))


def _abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a.double() - b.double())))


def compare(prog: dict, ref: dict) -> dict:
    """prog, ref: the FIELDS of the same rows (tensors with rows leading)
    → {name: number} for every name but bits_sent."""
    dev = ref["H"].device
    p = {k: v.to(dev) for k, v in prog.items()}
    dH = torch.abs(p["H"].to(torch.complex128) - ref["H"].to(
        torch.complex128))
    rms = torch.sqrt(torch.mean(torch.abs(ref["H"].to(torch.complex128))
                                ** 2, dim=-1))
    dphi = p["common_phase"].double() - ref["common_phase"].double()
    dphi = torch.remainder(dphi + math.pi, 2 * math.pi) - math.pi
    return {
        "sync_start": int(torch.sum(p["sync_start"].long()
                                    != ref["sync_start"].long())),
        "sync_metric": _rel(p["sync_metric"], ref["sync_metric"]),
        "H": float(torch.max(torch.amax(dH, dim=-1) / rms)),
        "noise_var": _rel(p["noise_var"], ref["noise_var"]),
        "pilot_slope": _abs(p["pilot_slope"], ref["pilot_slope"]),
        "common_phase": float(torch.max(torch.abs(dphi))),
        "evm": _rel(p["evm"], ref["evm"]),
        "mean_abs_llr": _rel(p["mean_abs_llr"], ref["mean_abs_llr"]),
        "clock_ppm": _abs(p["clock_ppm"], ref["clock_ppm"]),
        "fec_iters": int(torch.max(torch.abs(p["fec_iters"].long()
                                             - ref["fec_iters"].long()))),
        "fec_unsat": int(torch.sum(p["fec_unsat"].long()
                                   != ref["fec_unsat"].long())),
        "bits_ref": int(torch.sum(p["bits"] != ref["bits"])),
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = (limit is not None and np.isfinite(value)
                and value <= limit)
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
