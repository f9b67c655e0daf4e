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

The kernel has four layouts (`FusedGeometry.layout`), which give the same
llr, slope and cpe bits; `fused_eq_geometry` picks one for a batch and the
CPU tests reach it. Staged (the narrow bands): a block per frame and a
warp per data symbol, Ĥ and each warp's symbols in shared memory.
Streamed: the same warps reading every bin from global memory. Teamed
(the wide bands): a team of warps per data symbol, one pilot scratch a
team, and a frame's symbols spread over several blocks, so a small batch
fills the card. Spilled: past MAX_STREAMED_PILOTS pilots, where one team's
pilot scratch does not fit a block, the teamed layout keeps it in a global
buffer the wrapper allocates (and reads the pilot positions from the
layout table there). Both kernels read the pilot layout from a table
(`layout_table`), so every layout runs on them: strided, offset, a spacing
that does not tile the band, one pilot or none.
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
           "spill_scratch", "teamed_geometry"]

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
    `split_eq.demap_bins`), which have its layout: a grid of (B, `blocks`)
    blocks of `warps` warps, a team of `team` warps per data symbol. Block
    j of a frame takes a contiguous run of ⌈D / blocks⌉ of its data
    symbols, and its team g (of warps // team) symbols g, g + teams, ...
    of the run (`passes` of them at most, `symbols`). Each warp of the
    staged and streamed layouts (team = blocks = 1) runs through `nbuf`
    shared-memory symbol buffers (2: the next symbol's copy overlaps the
    current one's work; 0: the streamed layout, which stages no symbol and
    reads every bin from global memory); the teamed layout (team or blocks
    above 1) stages no symbol either, and `stage_h` puts Ĥ in shared
    memory. `smem` bytes of dynamic shared memory per block. `spill`
    (kernels 2 and A, teamed): the teams' pilot scratch lives in a global
    buffer of `scratch_floats(B, P)`."""

    warps: int
    passes: int
    nbuf: int
    smem: int
    spill: bool = False
    team: int = 1
    blocks: int = 1
    stage_h: bool = False

    @property
    def streamed(self) -> bool:
        """No symbol buffers: the streamed, teamed and spilled layouts."""
        return self.nbuf == 0

    @property
    def layout(self) -> str:
        if self.spill:
            return "spilled"
        if self.team > 1 or self.blocks > 1:
            return "teamed"
        return "streamed" if self.nbuf == 0 else "staged"

    @property
    def teams(self) -> int:
        return self.warps // self.team

    def symbols(self, team: int, D: int, block: int = 0) -> range:
        """The data symbols team `team` (a warp where team = 1) of block
        `block` of a frame takes."""
        per = -(-D // self.blocks)
        lo = block * per
        return range(lo + team, min(D, lo + per), self.teams)

    def scratch_floats(self, B: int, P: int) -> int:
        """The spilled layout's global pilot scratch: 4P floats for each
        team of each block of each of B frames (0 for the other
        layouts)."""
        return B * self.blocks * self.teams * 4 * P if self.spill else 0


def _smem_bytes(U: int, P: int, warps: int, nbuf: int,
                demap: bool = True) -> int:
    """The kernels' layout: Ĥ (2U floats), the warps' symbol buffers (2U
    each), |Ĥ|² (U), the warps' pilot scratch (4P each) and the pilot
    positions (P ints); kernel 2 (`demap`) adds the clamped inverse of |Ĥ|²
    (U), the warps' two sums and the data positions (U − P ints)."""
    if demap:
        return 4 * (5 * U + warps * (2 * U * nbuf + 4 * P + 2))
    return 4 * (3 * U + P + warps * (2 * U * nbuf + 4 * P))


# the limit of the layouts that keep the pilot scratch in shared memory:
# one team's pilot scratch (4P floats), the pilot positions (P ints), its
# three shared values (4 floats) and kernel 2's two sums of one warp in one
# block; past it the spilled layout
MAX_STREAMED_PILOTS = (SMEM_BLOCK // 4 - 6) // 5


def _streamed_smem_bytes(P: int, warps: int, demap: bool = True) -> int:
    """The streamed layout: the warps' pilot scratch (4P each) and the pilot
    positions (P ints); kernel 2 (`demap`) adds the warps' two sums."""
    return 4 * (P + warps * (4 * P + (2 if demap else 0)))


def _teamed_smem_bytes(U: int, P: int, warps: int, teams: int, demap: bool,
                       stage_h: bool, spill: bool) -> int:
    """The teamed layout (fused_eq.cu, split_eq.cu): with `stage_h`, Ĥ
    (2U floats) and |Ĥ|² (U), and for kernel 2 (`demap`) the clamped
    inverse (U) and the layout table (U ints); unless `spill`, the teams'
    pilot scratch (4P each); the teams' three shared values (4 each);
    kernel 2's warps' two sums; the pilot positions (P ints) unless
    staged with the table or spilled."""
    n = (5 * U if demap else 3 * U) if stage_h else 0
    n += 0 if spill else 4 * P * teams
    n += 4 * teams + (2 * warps if demap else 0)
    n += 0 if spill or (stage_h and demap) else P
    return 4 * n


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


def _resident(warps: int, smem: int) -> int:
    """Blocks of `warps` warps and `smem` bytes one SM holds at once."""
    return min(WARPS_SM // warps, BLOCKS_SM, SMEM_SM // (smem + SMEM_RESERVED))


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
        resident = _resident(warps, smem)
        waves = -(-max(B, 1) // (resident * sms))
        key = (waves * passes, -resident * warps, warps)
        if best_key is None or key < best_key:
            best, best_key = FusedGeometry(warps, passes, nbuf, smem), key
    return best


TEAMS = (1, 2, 4, 8)     # the team sizes the teamed layout takes
MAX_TEAMS = 15           # named barriers a block has for teams of T > 1
# the staged layout wins where one SM holds at least this many of its warps
STAGED_MIN_WARPS = 16
# a team is at least the fewest warps that leave a lane this many bins of
# a symbol (the teamed layout's rule, fused_eq_geometry)
LANE_BINS = 18


def _team_runs(D: int, teams: int):
    """(blocks, passes) for each count of blocks a frame whose runs of
    ⌈D / blocks⌉ symbols give every block and every one of `teams` teams
    a symbol."""
    for blocks in range(1, D + 1):
        per = -(-D // blocks)
        if -(-D // per) != blocks or teams > per:
            continue
        passes = -(-per // teams)
        if -(-per // passes) == teams:
            yield blocks, passes


def teamed_launches(U: int, P: int, D: int, demap: bool, team: int,
                    stage_h: bool, spill: bool):
    """Every teamed launch of `team` warps a symbol whose block fits: each
    count of teams a block (at most MAX_TEAMS where a team has more than
    one warp: a named barrier each) and of blocks a frame (`_team_runs`);
    one warp a team and one block a frame is the streamed layout's launch
    and not among them."""
    for teams in range(1, WARPS_SM // team + 1):
        if team > 1 and teams > MAX_TEAMS:
            break
        warps = team * teams
        smem = _teamed_smem_bytes(U, P, warps, teams, demap, stage_h, spill)
        if smem > SMEM_BLOCK:
            break
        for blocks, passes in _team_runs(D, teams):
            if team > 1 or blocks > 1:
                yield FusedGeometry(warps, passes, 0, smem, spill, team,
                                    blocks, stage_h)


def _fullest(launches) -> FusedGeometry | None:
    """The launch an SM holds most warps of (at most WARPS_SM), then the
    fewest passes, then the fewest warps."""
    return min(launches, default=None, key=lambda g: (
        -min(_resident(g.warps, g.smem) * g.warps, WARPS_SM), g.passes,
        g.warps))


def teamed_geometry(U: int, P: int, D: int, B: int, sms: int,
                    demap: bool = True, team: int | None = None,
                    blocks: int | None = None, stage_h: bool | None = None,
                    spill: bool = False) -> FusedGeometry | None:
    """The teamed launch for a batch of B frames of D data symbols on `sms`
    SMs (`team`, `blocks` and `stage_h` force those), by the rule timed on
    the card (PERF.md §6, `chip_smoke.py --layouts`):

    - a team is the fewest warps (of TEAMS) that leave a lane at most
      LANE_BINS bins of a symbol, or that give the batch's symbols every
      warp slot of the card (B·D·T ≥ sms·WARPS_SM), whichever is more;
    - the teams a block, for each count of blocks a frame, are those of
      most resident warps, then fewest passes (`_fullest`); with one block
      a frame Ĥ is staged in shared memory where it fits, with more it is
      read through L2;
    - a frame takes the count of blocks with the fewest symbols in a row
      per team slot (waves of resident blocks × passes), then the one that
      keeps the most SMs busy, then the fewest.

    None if no launch fits."""
    if team is None:
        by_bins = next((t for t in TEAMS if -(-U // (32 * t)) <= LANE_BINS),
                       TEAMS[-1])
        by_fill = next((t for t in TEAMS
                        if max(B, 1) * D * t >= sms * WARPS_SM), TEAMS[-1])
        team = max(by_bins, by_fill)

    def pick(b: int):
        for sh in (False,) if spill else (
                (stage_h,) if stage_h is not None else
                (True, False) if b == 1 else (False,)):
            geo = _fullest(g for g in teamed_launches(U, P, D, demap, team,
                                                      sh, spill)
                           if g.blocks == b)
            if geo is not None:
                return geo
        return None

    if blocks is not None:
        return pick(blocks)

    def key(geo: FusedGeometry):
        grid = max(B, 1) * geo.blocks
        waves = -(-grid // (sms * _resident(geo.warps, geo.smem)))
        return waves * geo.passes, -min(grid, sms), geo.blocks

    return min((g for g in map(pick, sorted({b for b, _ in _team_runs(D, 1)}))
                if g is not None), key=key, default=None)


@functools.lru_cache(maxsize=None)
def fused_eq_geometry(cfg: ModemConfig, B: int, sms: int = H100_SMS,
                      demap: bool = True, streamed: bool = False,
                      spilled: bool = False,
                      teamed: bool = False) -> FusedGeometry:
    """The launch of kernel 2 (`demap`) or kernel A for a batch of B frames
    on `sms` SMs, picked by residency and waves, not by fit. The rule was
    decided by timing every candidate in turns on the card (`chip_smoke.py
    --layouts`, PERF.md §6):

    - the staged layout (`pick_warps`) wins where an SM holds at least
      STAGED_MIN_WARPS of its warps — every narrow band (20 or 32 warps);
      at the wide bands (4-10 warps, or none fits) it lost to the teamed
      layout by 1.5-2.3× at B = 1024 and by 4× at B = 1;
    - the teamed layout (`teamed_geometry`) wins everywhere else, with the
      team, blocks and Ĥ placement its own rule gives;
    - the spilled layout wins past MAX_STREAMED_PILOTS pilots, where no
      other fits;
    - the streamed layout wins nowhere: the teamed one beat it at every
      wide band.

    The forced layouts are for the tests and chip_smoke.py: `streamed`
    (`streamed_geometry`), `teamed`, and `spilled`, which keeps the warps,
    team and blocks of the layout the batch would take, so each frame's
    sums keep their order."""
    U, P, D = cfg.n_used, cfg.n_pilots, cfg.n_data_symbols
    staged = pick_warps(D, B, sms,
                        lambda warps, nbuf: _smem_bytes(U, P, warps, nbuf,
                                                        demap))
    if streamed:
        return streamed_geometry(staged, D, B, sms,
                                 lambda warps: _streamed_smem_bytes(
                                     P, warps, demap))
    over = P > MAX_STREAMED_PILOTS
    if (staged is not None and not teamed and not over
            and _resident(staged.warps, staged.smem) * staged.warps
            >= STAGED_MIN_WARPS):
        best = staged
    else:
        best = teamed_geometry(U, P, D, B, sms, demap, spill=over)
    if spilled and not best.spill:
        best = dataclasses.replace(best, nbuf=0, spill=True, stage_h=False,
                                   smem=_teamed_smem_bytes(
                                       U, P, best.warps, best.teams, demap,
                                       False, True))
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
                   streamed: bool = False, spilled: bool = False,
                   teamed: bool = False,
                   geometry: FusedGeometry | None = None):
    """`fused_eq_demap_plain` for CPU tensors; the CUDA kernel otherwise
    (any pilot layout and band, QPSK to 64-QAM), in the layout
    `fused_eq_geometry` picks (`streamed`, `spilled` and `teamed` force
    those, `geometry` a launch of its own: tests and chip_smoke.py only).
    A bit-loaded config takes the split tail (`split_eq`) on either
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
    geo = geometry or fused_eq_geometry(cfg, B, _sm_count(dev.index),
                                        streamed=streamed, spilled=spilled,
                                        teamed=teamed)
    # the inputs stay bound until the launch: a temporary's memory could be
    # handed to the next allocation before the kernel reads it
    y, h = Y.contiguous(), H.contiguous()
    nv = noise_var.to(torch.float32).contiguous()
    llr = torch.empty(B, cfg.raw_bits_per_frame, device=dev)
    slope, cpe = torch.empty(2, B, D, device=dev)
    evm, mabs = torch.empty(2, B, device=dev)
    scratch = spill_scratch(geo, B, cfg.n_pilots, dev)
    # the blocks' sums and the frame's ticket where a frame has several
    part = ticket = None
    if geo.blocks > 1:
        part = torch.empty(B, geo.blocks, 2, device=dev)
        ticket = torch.zeros(B, dtype=torch.int32, device=dev)
    launch("gf3x_fused_eq_demap", dev.index, y.data_ptr(), h.data_ptr(),
           nv.data_ptr(), pv.data_ptr(), layout_table(cfg, dev).data_ptr(),
           llr.data_ptr(), slope.data_ptr(), cpe.data_ptr(), evm.data_ptr(),
           mabs.data_ptr(), B, S, cfg.n_known_symbols, U, cfg.n_pilots,
           cfg.bits_per_symbol // 2, levels, n_ladder, q0, b0, q1, b1, mean_dk,
           geo.warps, geo.nbuf, geo.smem, evm_div, abs_div,
           0 if scratch is None else scratch.data_ptr(), geo.team,
           geo.blocks, int(geo.stage_h),
           0 if part is None else part.data_ptr(),
           0 if ticket is None else ticket.data_ptr())
    fused_eq_demap.launches += 1
    return llr, slope, cpe, evm, mabs


fused_eq_demap.launches = 0
