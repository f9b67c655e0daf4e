"""Kernel 3: layered normalised min-sum LDPC decoding with a per-codeword
freeze (`csrc/ldpc_bp.cu`, replacing
gf3x/ops/pallas/ldpc_bp.py:minsum_totals_tpu), with its plain PyTorch
version: LdpcCode._minsum_xla (gf3x/fec/ldpc.py:301), op for op, so that
the two agree bit for bit.

`minsum_totals` runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor (or raises); `minsum_totals.launches` counts the
launches. Both map lam (L, 24·z) f32 LLRs (positive ⇒ bit 0), one codeword
per row, to (totals (L, 24·z) f32, unsat (L,) bool — a parity check of the
final hard decisions is still violated —, passes (L,) int32 — message
sweeps the codeword ran before it froze or hit `iters`)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...fec.codes import N_BLOCK_COLS, block_rows, build_H_blocks
from ...utils.device import launch

__all__ = ["minsum_totals", "minsum_totals_plain", "row_edges", "device_edges"]

_ALPHA = 0.8
_BIG = 1e30


@functools.lru_cache(maxsize=None)
def row_edges(z: int, rate: str) -> tuple:
    """The lifted code's edges grouped by block row, in `build_H_blocks`
    order: ((edge, block column, shift), ...) per row."""
    rows = [[] for _ in range(block_rows(rate))]
    for e, (i, j, s) in enumerate(build_H_blocks(z, rate)):
        rows[i].append((e, j, s))
    return tuple(tuple(r) for r in rows)


def _unsat(tot: torch.Tensor, rows) -> torch.Tensor:
    """(L, 24, z) totals → (L,) bool: any parity check of the hard
    decisions violated (check c of a row reads variable (c + s) mod z)."""
    hard = tot < 0
    bad = torch.zeros(tot.shape[0], dtype=torch.bool, device=tot.device)
    for row in rows:
        par = torch.zeros_like(hard[:, 0])
        for _, j, s in row:
            par = par ^ torch.roll(hard[:, j], -s, dims=-1)
        bad = bad | torch.any(par, dim=-1)
    return bad


def minsum_totals_plain(lam: torch.Tensor, z: int, rate: str, iters: int):
    """The layered min-sum of `_minsum_xla`: each block row reads the
    current totals and writes its message delta back at once; codewords
    whose hard decisions satisfy every check before a sweep freeze."""
    rows = row_edges(z, rate)
    L = lam.shape[0]
    tot = lam.reshape(L, N_BLOCK_COLS, z).clone()
    c2v = torch.zeros(sum(len(r) for r in rows), L, z, device=lam.device)
    passes = torch.zeros(L, dtype=torch.int32, device=lam.device)
    for _ in range(iters):
        active = _unsat(tot, rows)
        if not bool(active.any()):
            break
        upd = active.to(torch.float32)[:, None]
        for row in rows:
            v2c = torch.stack([torch.roll(tot[:, j], -s, dims=-1) - c2v[e]
                               for e, j, s in row])              # (d, L, z)
            mag = torch.abs(v2c)
            sgn = torch.where(v2c < 0, -1.0, 1.0)
            prod = torch.prod(sgn, dim=0, keepdim=True)
            m1 = torch.amin(mag, dim=0, keepdim=True)
            am = torch.argmin(mag, dim=0, keepdim=True)
            mask = torch.arange(len(row), device=lam.device)[:, None, None] == am
            m2 = torch.amin(torch.where(mask, _BIG, mag), dim=0, keepdim=True)
            mins = torch.where(mask, m2, m1)
            out = _ALPHA * (prod * sgn) * mins
            for d, (e, j, s) in enumerate(row):
                delta = (out[d] - c2v[e]) * upd
                tot[:, j] = tot[:, j] + torch.roll(delta, s, dims=-1)
                c2v[e] = c2v[e] + delta
        passes += active.to(torch.int32)
    return tot.reshape(L, -1), _unsat(tot, rows), passes


def device_edges(z: int, rate: str, device) -> tuple:
    """(row_ptr, col, shift) int32 on `device`: the edge list for the
    kernel, row-major as `build_H_blocks` orders it."""
    rows = row_edges(z, rate)
    ptr = np.cumsum([0] + [len(r) for r in rows]).astype(np.int32)
    col = np.array([j for r in rows for _, j, _ in r], np.int32)
    shf = np.array([s for r in rows for _, _, s in r], np.int32)
    return tuple(torch.as_tensor(a, device=device) for a in (ptr, col, shf))


def minsum_totals(lam: torch.Tensor, z: int, rate: str, iters: int,
                  edges: tuple | None = None):
    """`minsum_totals_plain` for a CPU tensor; the CUDA kernel otherwise.
    `edges` is `(row_ptr, col, shift)` already on the card (a caller that
    decodes often keeps it; built here otherwise)."""
    if lam.device.type == "cpu":
        return minsum_totals_plain(lam, z, rate, iters)
    if lam.device.type != "cuda":
        raise ValueError(f"minsum_totals: lam on {lam.device}")
    L, n = lam.shape
    if lam.dtype != torch.float32 or n != N_BLOCK_COLS * z \
            or not lam.is_contiguous() or not 1 <= z <= 1024:
        raise ValueError("minsum_totals: needs contiguous lam (L, 24·z) "
                         "float32 with 1 ≤ z ≤ 1024")
    if edges is None:
        edges = device_edges(z, rate, lam.device)
    row_ptr, col, shf = edges
    totals = torch.empty_like(lam)
    unsat = torch.empty(L, dtype=torch.int32, device=lam.device)
    passes = torch.empty(L, dtype=torch.int32, device=lam.device)
    launch("gf3x_minsum_totals", lam.device.index, lam.data_ptr(),
           totals.data_ptr(), unsat.data_ptr(), passes.data_ptr(),
           row_ptr.data_ptr(), col.data_ptr(), shf.data_ptr(), L,
           block_rows(rate), col.numel(), z, iters)
    minsum_totals.launches += 1
    return totals, unsat.bool(), passes


minsum_totals.launches = 0
