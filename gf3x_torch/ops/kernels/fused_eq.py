"""Kernel 2: fused one-tap EQ + pilot tracking + noise floor + max-log
demap (`csrc/fused_eq.cu`, replacing
gf3x/ops/pallas/fused_eq.py:fused_eq_demap_tpu), with its plain PyTorch
version: the XLA twin the JAX CPU path runs (Modem._eq_tail +
pilot_phase_correct + Modem._xla_demap).

`fused_eq_demap` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises); `fused_eq_demap.launches` counts the
launches. Both return

    llr   (B, D·R) f32 — scrambled, interleaved data-bin LLRs in the
          qam_demap_llr bit order (the twin's `llr`),
    slope (B, D), cpe (B, D) f32 — pilot phase fit per data symbol,
    evm   (B,) f32 — mean |X̂ − hard decision|² over the data bins,
    mabs  (B,) f32 — mean |llr|.

The kernel takes one frame per block and one data symbol per warp at a
time, as kernel A does; `fused_eq_geometry` chooses the warps per block,
the layout and the shared memory of either for a batch, and the CPU tests
reach it. The staged layout holds Ĥ and each warp's symbols in shared
memory; a band whose staged layout fits no warp count (gf3-16384, U =
7616) takes the streamed one, which reads them from global memory and
gives the same bits. Past MAX_STREAMED_PILOTS pilots, where even one
warp's pilot scratch does not fit a block, the spilled layout keeps it in
a global buffer the wrapper allocates (and reads the pilot positions from
the layout table there), again with the same bits. Both kernels read the
pilot layout from a table (`layout_table`), so every layout runs on them:
strided, offset, a spacing that does not tile the band, one pilot or none.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ...config import ModemConfig, layout
from ...utils.device import launch
from ..constellation import pam_label_levels, qam_norm
from .split_eq import (check_track_inputs, demap_bins_plain, eq_track_plain,
                       track_constants)

__all__ = ["fused_eq_demap", "fused_eq_demap_plain", "fused_eq_geometry",
           "FusedGeometry", "launch_constants", "layout_table", "pick_warps",
           "spill_scratch"]

SMEM_BLOCK = 232_448     # dynamic shared memory one block may use (227 KB)
SMEM_SM = 233_472        # shared memory of one SM (228 KB)
SMEM_RESERVED = 1_024    # per resident block
WARPS_SM = 32            # resident warps per SM at ≤ 64 registers a thread
                         # (the kernel's __launch_bounds__(1024))
BLOCKS_SM = 32
H100_SMS = 132


def fused_eq_demap_plain(cfg: ModemConfig, Y: torch.Tensor, H: torch.Tensor,
                         noise_var: torch.Tensor,
                         pilot_vals: torch.Tensor | None = None):
    """Y (B, K+D, U) complex64 spectra (derolled), H (B, U) complex64,
    noise_var (B,) → (llr, slope, cpe, evm, mabs) as in the module doc: the
    split tail's two plain versions back to back, so the math exists once."""
    eq, slope, cpe, nv_sym = eq_track_plain(cfg, Y, H, noise_var, pilot_vals)
    llr, evm, mabs = demap_bins_plain(cfg, eq, H, nv_sym)
    return llr, slope, cpe, evm, mabs


@dataclass(frozen=True)
class FusedGeometry:
    """The launch of kernel 2, or of kernels A and B (`split_eq.eq_track`,
    `split_eq.demap_bins`), which have its layout: one block per frame
    with `warps` warps; warp w takes data symbols w, w + warps, ...
    (`passes` of them at most), each through
    `nbuf` shared-memory symbol buffers (2: the next symbol's copy overlaps
    the current one's work; 0: the streamed layout, which stages no
    symbol and reads every bin from global memory); `smem` bytes of dynamic
    shared memory per block. `spill` (kernels 2 and A, streamed): the warps'
    pilot scratch lives in a global buffer of `scratch_floats(B, P)`."""

    warps: int
    passes: int
    nbuf: int
    smem: int
    spill: bool = False

    @property
    def streamed(self) -> bool:
        return self.nbuf == 0

    def symbols(self, warp: int, D: int) -> range:
        """The data symbols warp `warp` of a block takes."""
        return range(warp, D, self.warps)

    def scratch_floats(self, B: int, P: int) -> int:
        """The spilled layout's global pilot scratch: 4P floats for each
        warp of each of B frames (0 for the other layouts)."""
        return B * self.warps * 4 * P if self.spill else 0


def _smem_bytes(U: int, P: int, warps: int, nbuf: int,
                demap: bool = True) -> int:
    """The kernels' layout: Ĥ (2U floats), the warps' symbol buffers (2U
    each), |Ĥ|² (U), the warps' pilot scratch (4P each) and the pilot
    positions (P ints); kernel 2 (`demap`) adds the clamped inverse of |Ĥ|²
    (U), the warps' two sums and the data positions (U − P ints)."""
    if demap:
        return 4 * (5 * U + warps * (2 * U * nbuf + 4 * P + 2))
    return 4 * (3 * U + P + warps * (2 * U * nbuf + 4 * P))


# the streamed layout's one limit: a warp's pilot scratch (4P floats), the
# pilot positions (P ints) and kernel 2's two sums in one block; past it
# the spilled layout
MAX_STREAMED_PILOTS = (SMEM_BLOCK // 4 - 2) // 5


def _streamed_smem_bytes(P: int, warps: int, demap: bool = True) -> int:
    """The streamed layout: the warps' pilot scratch (4P each) and the pilot
    positions (P ints); kernel 2 (`demap`) adds the warps' two sums."""
    return 4 * (P + warps * (4 * P + (2 if demap else 0)))


def _spilled_smem_bytes(warps: int, demap: bool = True) -> int:
    """The spilled layout: kernel 2's warps' two sums alone."""
    return 4 * 2 * warps if demap else 0


def streamed_geometry(staged: FusedGeometry | None, D: int, B: int, sms: int,
                      smem_of) -> FusedGeometry | None:
    """The streamed launch: the staged layout's warps where that layout fits
    (so the frame's sums keep their order and the outputs their bits), else
    `pick_warps` on the streamed shared memory `smem_of(warps)`; None if no
    count fits."""
    if staged is None:
        staged = pick_warps(D, B, sms, lambda warps, nbuf: smem_of(warps))
        if staged is None:
            return None
    return FusedGeometry(staged.warps, staged.passes, 0, smem_of(staged.warps))


def pick_warps(D: int, B: int, sms: int, smem_of) -> FusedGeometry | None:
    """The warp count for a block per frame whose warps walk D symbols, for
    a batch of B frames on `sms` SMs, `smem_of(warps, nbuf)` giving a
    block's shared memory: of the counts whose shared memory fits a block,
    the one with the fewest symbols in a row per warp slot (waves of
    resident blocks × symbols per warp), then the most resident warps, then
    the fewest warps; None if no count fits."""
    best, best_key = None, None
    for warps in range(1, min(D, 32) + 1):
        passes = -(-D // warps)
        if -(-D // passes) != warps:    # the same passes with fewer warps
            continue
        nbuf = 2 if passes > 1 else 1
        smem = smem_of(warps, nbuf)
        if smem > SMEM_BLOCK:
            continue
        resident = min(WARPS_SM // warps, BLOCKS_SM,
                       SMEM_SM // (smem + SMEM_RESERVED))
        waves = -(-max(B, 1) // (resident * sms))
        key = (waves * passes, -resident * warps, warps)
        if best_key is None or key < best_key:
            best, best_key = FusedGeometry(warps, passes, nbuf, smem), key
    return best


@functools.lru_cache(maxsize=None)
def fused_eq_geometry(cfg: ModemConfig, B: int, sms: int = H100_SMS,
                      demap: bool = True, streamed: bool = False,
                      spilled: bool = False) -> FusedGeometry:
    """Warps per block for a batch of B frames on `sms` SMs, for kernel 2
    (`demap`) or kernel A (`pick_warps`): the staged layout where a warp
    count fits it, else (or with `streamed`, which only the tests and
    chip_smoke.py pass) the streamed one (`streamed_geometry`), else — past
    MAX_STREAMED_PILOTS pilots, or with `spilled` — the spilled one, the
    streamed layout with the pilot scratch in global memory. A forced
    layout keeps the warps of the one the batch would take, so each frame's
    sums keep their order."""
    U, P, D = cfg.n_used, cfg.n_pilots, cfg.n_data_symbols
    best = pick_warps(D, B, sms,
                      lambda warps, nbuf: _smem_bytes(U, P, warps, nbuf,
                                                      demap))
    if best is None or streamed or spilled:
        best = streamed_geometry(best, D, B, sms,
                                 lambda warps: _streamed_smem_bytes(P, warps,
                                                                    demap))
    if best is None or spilled:
        best = dataclasses.replace(streamed_geometry(
            best, D, B, sms, lambda warps: _spilled_smem_bytes(warps, demap)),
            spill=True)
    return best


@functools.lru_cache(maxsize=None)
def launch_constants(cfg: ModemConfig):
    """The kernel's per-config constants, computed once per config:
    (track_constants(cfg), the PAM levels — the values qam_demap_llr uses —
    as a float32 host array and its address, D·n_data_bins and the raw bits
    per frame as float32, the divisors of evm and mabs)."""
    m = cfg.bits_per_symbol // 2
    levels = (pam_label_levels(m) * qam_norm(cfg.bits_per_symbol)).astype(
        np.float32)
    return (track_constants(cfg), levels, levels.ctypes.data,
            float(np.float32(cfg.n_data_symbols * cfg.n_data_bins)),
            float(np.float32(cfg.raw_bits_per_frame)))


@functools.lru_cache(maxsize=None)
def _pilot_floats(cfg: ModemConfig, device: torch.device) -> torch.Tensor:
    """The config's pilot values as (P, 2) float32 on `device`."""
    return torch.view_as_real(torch.as_tensor(layout(cfg).pilot_vals,
                                              device=device))


@functools.lru_cache(maxsize=None)
def layout_table(cfg: ModemConfig, device: torch.device) -> torch.Tensor:
    """The kernels' layout table on `device`: the P pilot positions, then
    the n_data_bins data positions, as int32 used-bin indices (n_used)."""
    lay = layout(cfg)
    return torch.as_tensor(np.concatenate([lay.pilot_pos, lay.data_pos])
                           .astype(np.int32), device=device)


def spill_scratch(geo: FusedGeometry, B: int, P: int,
                  dev: torch.device) -> torch.Tensor | None:
    """The spilled layout's global pilot scratch on the caller's stream
    (None for the other layouts); freed after the launch, its memory is
    reused only by later work on that stream."""
    n = geo.scratch_floats(B, P)
    return torch.empty(n, device=dev) if n else None


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_eq_demap(cfg: ModemConfig, Y: torch.Tensor, H: torch.Tensor,
                   noise_var: torch.Tensor,
                   pilot_vals: torch.Tensor | None = None, *,
                   streamed: bool = False, spilled: bool = False):
    """`fused_eq_demap_plain` for CPU tensors; the CUDA kernel otherwise
    (any pilot layout and band, QPSK to 64-QAM), in the layout
    `fused_eq_geometry` picks (`streamed` and `spilled` force those). A
    bit-loaded config takes the split tail (`split_eq`) on either
    device."""
    if cfg.bit_loading is not None:
        raise ValueError("fused_eq_demap: a bit-loaded config takes the "
                         "split tail (split_eq.eq_track + demap_bins)")
    if Y.device.type == "cpu":
        return fused_eq_demap_plain(cfg, Y, H, noise_var, pilot_vals)
    check_track_inputs("fused_eq_demap", cfg, Y, H, noise_var)
    dev = Y.device
    B, S, U = Y.shape
    D = cfg.n_data_symbols
    pv = (_pilot_floats(cfg, dev) if pilot_vals is None else
          torch.view_as_real(pilot_vals.to(dev, torch.complex64)
                             .contiguous()))
    (mean_dk, n_ladder, q0, b0, q1, b1), _, levels, evm_div, abs_div = \
        launch_constants(cfg)
    geo = fused_eq_geometry(cfg, B, _sm_count(dev.index), streamed=streamed,
                            spilled=spilled)
    # the inputs stay bound until the launch: a temporary's memory could be
    # handed to the next allocation before the kernel reads it
    y, h = Y.contiguous(), H.contiguous()
    nv = noise_var.to(torch.float32).contiguous()
    llr = torch.empty(B, cfg.raw_bits_per_frame, device=dev)
    slope, cpe = torch.empty(2, B, D, device=dev)
    evm, mabs = torch.empty(2, B, device=dev)
    scratch = spill_scratch(geo, B, cfg.n_pilots, dev)
    launch("gf3x_fused_eq_demap", dev.index, y.data_ptr(), h.data_ptr(),
           nv.data_ptr(), pv.data_ptr(), layout_table(cfg, dev).data_ptr(),
           llr.data_ptr(), slope.data_ptr(), cpe.data_ptr(), evm.data_ptr(),
           mabs.data_ptr(), B, S, cfg.n_known_symbols, U, cfg.n_pilots,
           cfg.bits_per_symbol // 2, levels, n_ladder, q0, b0, q1, b1, mean_dk,
           geo.warps, geo.nbuf, geo.smem, evm_div, abs_div,
           0 if scratch is None else scratch.data_ptr())
    fused_eq_demap.launches += 1
    return llr, slope, cpe, evm, mabs


fused_eq_demap.launches = 0
