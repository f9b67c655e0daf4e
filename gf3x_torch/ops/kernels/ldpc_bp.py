"""Kernel 3: layered normalised min-sum LDPC decoding with a per-codeword
freeze (`csrc/ldpc_bp.cu`, replacing
gf3x/ops/pallas/ldpc_bp.py:minsum_totals_tpu), with its plain PyTorch
version: LdpcCode._minsum_xla (gf3x/fec/ldpc.py:301), op for op, so that
the two agree bit for bit.

`minsum_totals` runs the plain version for a CPU tensor and for a CUDA
tensor launches the kernel's two passes (or raises): the check pass over
every codeword (`minsum_check`), then the decode pass over the codewords
that fail it (`minsum_decode`), each with its plain version and its count
of launches in `.launches`; `minsum_totals.launches` counts the calls.
Both map lam (L, 24·z) f32 LLRs (positive ⇒ bit 0), one codeword per row,
to (totals (L, 24·z) f32, unsat (L,) bool — a parity check of the final
hard decisions is still violated —, passes (L,) int32 — message sweeps the
codeword ran before it froze or hit `iters`). With the freeze rule each
codeword decodes independently of the batch, so decoding the failing ones
alone gives the whole batch's result.

Every lift z ≥ 1 launches. `check_warps` and `decode_geometry` give the
two passes' layouts: up to z = 512 a thread per check with everything in
shared memory; above it a block of at most 512 threads, each taking
several checks of a block row; where the messages no longer fit shared
memory (z > 576 at rate 1/2) they move to a global scratch that the
wrapper allocates, a slice per resident block, and where the totals do
not fit either (z > 2348) those too. The check pass takes fewer codewords
a block past z = 1076 and reads its hard decisions from global memory
past 8609. Every layout gives the plain version's bits."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ...fec.codes import N_BLOCK_COLS, block_rows, build_H_blocks
from ...utils import profiling
from ...utils.device import SMEM_BLOCK, launch

__all__ = ["minsum_totals", "minsum_totals_plain", "minsum_check",
           "minsum_check_plain", "minsum_decode", "minsum_decode_plain",
           "row_edges", "kernel_edges", "check_warps", "decode_geometry",
           "DecodeGeometry"]

_ALPHA = 0.8
_BIG = 1e30
CHECK_WARPS = 8          # codewords a block of the check pass, where they fit
MAX_THREADS = 512        # the decode pass's block
MAX_LIFT = 0x7FFFFFFF // 128   # the kernels' int32 indices (csrc kMaxLift)
# the decode pass's layouts (csrc/ldpc_bp.cu's DecodeLayout)
ONE_CHECK, ROWS_SHARED, C2V_GLOBAL, ALL_GLOBAL = range(4)


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


def minsum_check_plain(lam: torch.Tensor, z: int, rate: str):
    """The check pass's plain version: lam (L, 24·z) → (unsat (L,) bool —
    a parity check of lam's hard decisions is violated —, totals = a copy
    of lam)."""
    tot = lam.reshape(lam.shape[0], N_BLOCK_COLS, z)
    return _unsat(tot, row_edges(z, rate)), lam.clone()


def minsum_decode_plain(lam: torch.Tensor, totals: torch.Tensor,
                        unsat: torch.Tensor, passes: torch.Tensor, z: int,
                        rate: str, iters: int):
    """The decode pass's plain version: `minsum_totals_plain` of the
    codewords the check pass left unsatisfied (none when iters is 0),
    written in place into the check pass's totals, unsat and passes."""
    idx = torch.nonzero(unsat).flatten() if iters > 0 else unsat[:0]
    if idx.numel():
        totals[idx], unsat[idx], passes[idx] = minsum_totals_plain(
            lam[idx], z, rate, iters)
    return totals, unsat, passes


@functools.lru_cache(maxsize=None)
def kernel_edges(z: int, rate: str) -> tuple:
    """The edge list the kernels copy into their parameter bank at each
    launch: ((row_ptr, col, shift) int32 host arrays, row-major as
    `build_H_blocks` orders them, and their addresses)."""
    rows = row_edges(z, rate)
    ptr = np.cumsum([0] + [len(r) for r in rows]).astype(np.int32)
    col = np.array([j for r in rows for _, j, _ in r], np.int32)
    shf = np.array([s for r in rows for _, _, s in r], np.int32)
    return (ptr, col, shf), tuple(a.ctypes.data for a in (ptr, col, shf))


def check_stride(z: int) -> int:
    """Shared memory per codeword of the check pass: its hard decisions as
    bytes (24·z) and bit words (3·z bytes), rounded up to 16 bytes."""
    return (27 * z + 15) & ~15


def check_warps(z: int) -> int:
    """Codewords (warps) a block of the check pass takes: 8 where their
    hard decisions fit a block's shared memory (z ≤ 1076), else as many as
    fit (z ≤ 8609); 0 past that: one warp a block reading the hard
    decisions from the totals it wrote to global memory."""
    return min(CHECK_WARPS, SMEM_BLOCK // check_stride(z))


@dataclass(frozen=True)
class DecodeGeometry:
    """The decode pass's launch at one lift: `layout` (ONE_CHECK: a thread
    per check, everything in shared memory; ROWS_SHARED: several checks a
    thread; C2V_GLOBAL: the messages in a global scratch; ALL_GLOBAL: the
    totals too, in place in the output), `threads` a block, checks of a
    block row per thread at most (`rows`), dynamic shared memory bytes
    (`smem`) and scratch floats per resident block (`slice`)."""

    layout: int
    threads: int
    rows: int
    smem: int
    slice: int

    def checks(self, thread: int, z: int) -> range:
        """The checks of a block row that `thread` updates."""
        return range(thread, z, self.threads)


@functools.lru_cache(maxsize=None)
def decode_geometry(z: int, rate: str) -> DecodeGeometry:
    """The decode pass's layout for lift z at `rate` (E edges): shared
    memory holds the totals (24·z floats), the messages (E·z) and the hard
    decisions' bit words (24·z / 32) where they fit a block's 227 KB, the
    totals and bit words where only those fit, else nothing."""
    E = sum(len(r) for r in row_edges(z, rate))
    words = N_BLOCK_COLS * z // 32
    shared = 4 * ((E + N_BLOCK_COLS) * z + words)
    if z <= MAX_THREADS:
        return DecodeGeometry(ONE_CHECK, z, 1, shared, 0)
    per = -(-z // -(-z // MAX_THREADS))          # checks over ⌈z/512⌉ rows
    threads = -(-per // 32) * 32
    rows = -(-z // threads)
    if shared <= SMEM_BLOCK:
        return DecodeGeometry(ROWS_SHARED, threads, rows, shared, 0)
    tot = 4 * (N_BLOCK_COLS * z + words)
    if tot <= SMEM_BLOCK:
        return DecodeGeometry(C2V_GLOBAL, threads, rows, tot, E * z)
    return DecodeGeometry(ALL_GLOBAL, threads, rows, 0, E * z + words + 1)


@functools.lru_cache(maxsize=None)
def _resident_blocks(index: int, layout: int, threads: int,
                     smem: int) -> int:
    """Blocks of the decode kernel of this layout resident on CUDA device
    `index` at once (the kernel's occupancy times the SMs)."""
    out = np.zeros(1, np.int32)
    launch("gf3x_minsum_decode_blocks", index, out.ctypes.data, layout,
           threads, smem)
    return int(out[0])


def _check_lam(name: str, lam: torch.Tensor, z: int) -> None:
    if lam.device.type != "cuda":
        raise ValueError(f"{name}: lam on {lam.device}")
    if lam.dtype != torch.float32 or lam.dim() != 2 \
            or lam.shape[1] != N_BLOCK_COLS * z \
            or not lam.is_contiguous() or not 1 <= z <= MAX_LIFT:
        raise ValueError(f"{name}: needs contiguous lam (L, 24·z) float32 "
                         f"with 1 ≤ z ≤ {MAX_LIFT} (the kernels' int32 "
                         "indices)")


def _check_pass(lam: torch.Tensor, z: int, rate: str, iters: int):
    """Launch the check pass: (totals, unsat, passes, work) — work is the
    device list of the codewords queued for the decode pass (none when
    iters is 0)."""
    L = lam.shape[0]
    (_, col, _), (ptr_a, col_a, shf_a) = kernel_edges(z, rate)
    with profiling.span("ldpc.check"):
        totals = torch.empty_like(lam)
        unsat = torch.empty(L, dtype=torch.bool, device=lam.device)
        pw = torch.empty(2 * L + 2, dtype=torch.int32, device=lam.device)
        passes, work = pw[:L], pw[L:]
        launch("gf3x_minsum_check", lam.device.index, lam.data_ptr(),
               totals.data_ptr(), unsat.data_ptr(), passes.data_ptr(),
               work.data_ptr(), ptr_a, col_a, shf_a, L, block_rows(rate),
               col.size, z, iters, check_warps(z))
    minsum_check.launches += 1
    return totals, unsat, passes, work


def minsum_check(lam: torch.Tensor, z: int, rate: str):
    """`minsum_check_plain` for a CPU tensor; the check pass's kernel alone
    otherwise (nothing queued)."""
    if lam.device.type == "cpu":
        return minsum_check_plain(lam, z, rate)
    _check_lam("minsum_check", lam, z)
    totals, unsat, _, _ = _check_pass(lam, z, rate, 0)
    return unsat, totals


minsum_check.launches = 0


def minsum_decode(lam: torch.Tensor, totals: torch.Tensor,
                  unsat: torch.Tensor, passes: torch.Tensor,
                  work: torch.Tensor | None, z: int, rate: str, iters: int):
    """`minsum_decode_plain` for CPU tensors (`work` is not read: the
    queued codewords are the unsatisfied ones); otherwise the decode
    pass's kernel over the check pass's device work list `work`, which
    completes totals, unsat and passes in place. While tracing is on the
    kernel adds the codewords queued and their sweeps to the device's
    counters (`utils.profiling.decode_counts`)."""
    if lam.device.type == "cpu":
        return minsum_decode_plain(lam, totals, unsat, passes, z, rate, iters)
    _check_lam("minsum_decode", lam, z)
    L = lam.shape[0]
    if (work is None or work.shape != (L + 2,) or totals.shape != lam.shape
            or unsat.shape != (L,) or passes.shape != (L,)):
        raise ValueError("minsum_decode: needs the check pass's totals, "
                         "unsat, passes and work list")
    (_, col, _), (ptr_a, col_a, shf_a) = kernel_edges(z, rate)
    geo = decode_geometry(z, rate)
    index = lam.device.index
    grid = min(L, _resident_blocks(index, geo.layout, geo.threads, geo.smem))
    counts = profiling.decode_counts(lam)
    with profiling.span("ldpc.decode"):
        # the messages' scratch, a slice per resident block, on the caller's
        # stream: freed after the launch, it is reused only by later work
        # there
        scratch = (torch.empty(grid * geo.slice, device=lam.device)
                   if geo.slice and grid else None)
        launch("gf3x_minsum_decode", index, lam.data_ptr(),
               totals.data_ptr(), unsat.data_ptr(), passes.data_ptr(),
               work.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
               counts, ptr_a, col_a, shf_a, L, block_rows(rate), col.size, z,
               iters, geo.layout, geo.threads, geo.smem, grid)
    minsum_decode.launches += 1
    return totals, unsat, passes


minsum_decode.launches = 0


def minsum_totals(lam: torch.Tensor, z: int, rate: str, iters: int):
    """`minsum_totals_plain` for a CPU tensor (counted, while tracing is
    on, by `utils.profiling.count_plain`); otherwise the check pass, then
    the decode pass over the codewords it queued (no host synchronisation
    between them)."""
    if lam.device.type == "cpu":
        out = minsum_totals_plain(lam, z, rate, iters)
        profiling.count_plain(out[2])
        return out
    _check_lam("minsum_totals", lam, z)
    totals, unsat, passes, work = _check_pass(lam, z, rate, iters)
    minsum_decode(lam, totals, unsat, passes, work, z, rate, iters)
    minsum_totals.launches += 1
    return totals, unsat, passes


minsum_totals.launches = 0
