"""The launch rule of the EQ/demap kernels: kernel 2 (`fused_eq`), kernels A
and B (`split_eq`). Each wrapper asks this module for its launch
(`fused_eq_geometry`, `demap_geometry`) and passes it to its kernel; the
shared-memory formulas here are the kernels' own layouts of shared memory
(`csrc/fused_eq.cu`, `csrc/split_eq.cu`), and the card's limits come from
`utils.device`.

Kernels 2 and A take one of three layouts (`FusedGeometry.layout`), which
give the same llr, slope and cpe bits (and A's eq, nv_sym): staged (the
narrow bands), a block per frame and a warp per data symbol, Ĥ and each
warp's symbols in shared memory; teamed (the wide bands), a team of warps
per data symbol, one pilot scratch a team, and a frame's symbols spread
over several blocks, so a small batch fills the card; spilled, past
MAX_SHARED_PILOTS pilots, where one team's pilot scratch does not fit a
block, the teamed layout with the scratch in a global buffer the wrapper
allocates (`spill_scratch`). Kernel B is staged where a warp count fits,
else streamed: the same warps reading every bin from global memory.

`teamed_geometry`, `spilled_geometry` and `streamed_geometry` give the
launches the rule does not pick for a batch, which the tests and
chip_smoke.py pass to the wrappers as `geometry=`.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

from ...config import ModemConfig
from ...utils.device import (BLOCKS_SM, H100_SMS, SMEM_BLOCK, SMEM_RESERVED,
                             SMEM_SM, WARPS_SM)

__all__ = ["FusedGeometry", "fused_eq_geometry", "demap_geometry",
           "pick_warps", "teamed_geometry", "teamed_launches",
           "spilled_geometry", "streamed_geometry", "spill_scratch",
           "staged_smem_bytes", "demap_smem_bytes", "MAX_SHARED_PILOTS",
           "TEAMS", "MAX_TEAMS", "STAGED_MIN_WARPS", "LANE_BINS"]

TEAMS = (1, 2, 4, 8)     # the team sizes the teamed layout takes
MAX_TEAMS = 15           # named barriers a block has for teams of T > 1
# the staged layout wins where one SM holds at least this many of its warps
STAGED_MIN_WARPS = 16
# a team is at least the fewest warps that leave a lane this many bins of
# a symbol (the teamed layout's rule, fused_eq_geometry)
LANE_BINS = 18


@dataclass(frozen=True)
class FusedGeometry:
    """The launch of kernel 2, A or B: a grid of (B, `blocks`) blocks of
    `warps` warps, a team of `team` warps per data symbol. Block j of a
    frame takes a contiguous run of ⌈D / blocks⌉ of its data symbols, and
    its team g (of warps // team) symbols g, g + teams, ... of the run
    (`passes` of them at most, `symbols`). Each warp of the staged layout
    (team = blocks = 1) runs through `nbuf` shared-memory symbol buffers
    (2: the next symbol's copy overlaps the current one's work; 0: kernel
    B's streamed layout, which stages no symbol and reads every bin from
    global memory); the teamed layout (team or blocks above 1) stages no
    symbol either, and `stage_h` puts Ĥ in shared memory. `smem` bytes of
    dynamic shared memory per block. `spill` (kernels 2 and A, teamed): the
    teams' pilot scratch lives in a global buffer of `scratch_floats(B,
    P)`. Kernels 2 and A have no launch of one warp a team, one block a
    frame and no symbol buffer unless spilled."""

    warps: int
    passes: int
    nbuf: int
    smem: int
    spill: bool = False
    team: int = 1
    blocks: int = 1
    stage_h: bool = False

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


def staged_smem_bytes(U: int, P: int, warps: int, nbuf: int,
                      demap: bool = True) -> int:
    """Kernels 2 and A's staged layout: Ĥ (2U floats), the warps' symbol
    buffers (2U each), |Ĥ|² (U), the warps' pilot scratch (4P each) and the
    pilot positions (P ints); kernel 2 (`demap`) adds the clamped inverse of
    |Ĥ|² (U), the warps' two sums and the data positions (U − P ints)."""
    if demap:
        return 4 * (5 * U + warps * (2 * U * nbuf + 4 * P + 2))
    return 4 * (3 * U + P + warps * (2 * U * nbuf + 4 * P))


# the limit of the layouts that keep the pilot scratch in shared memory:
# one team's pilot scratch (4P floats), the pilot positions (P ints), its
# three shared values (4 floats) and kernel 2's two sums of one warp in one
# block; past it the spilled layout
MAX_SHARED_PILOTS = (SMEM_BLOCK // 4 - 6) // 5


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


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def demap_smem_bytes(U: int, R: int, NS: int, warps: int, nbuf: int) -> int:
    """Kernel B's shared memory, staged: per warp, nbuf eq rows (2U floats
    each) and its LLR row (R floats), each rounded up to 16 bytes; then the
    slot table (NS int2), 1/max(|Ĥ|², 1e-12) per slot (NS) and the PAM
    levels (16 floats). Streamed (nbuf = 0): the levels alone."""
    if nbuf == 0:
        return 4 * 16
    return 4 * (warps * (nbuf * _round4(2 * U) + _round4(R)) + 3 * NS + 16)


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
    one warp a team with one block a frame is not among them."""
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
                      demap: bool = True) -> FusedGeometry:
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
    - the spilled layout wins past MAX_SHARED_PILOTS pilots, where no
      other fits."""
    U, P, D = cfg.n_used, cfg.n_pilots, cfg.n_data_symbols
    staged = pick_warps(D, B, sms,
                        lambda warps, nbuf: staged_smem_bytes(U, P, warps,
                                                              nbuf, demap))
    over = P > MAX_SHARED_PILOTS
    if (staged is not None and not over
            and _resident(staged.warps, staged.smem) * staged.warps
            >= STAGED_MIN_WARPS):
        return staged
    return teamed_geometry(U, P, D, B, sms, demap, spill=over)


def spilled_geometry(geo: FusedGeometry, cfg: ModemConfig,
                     demap: bool = True) -> FusedGeometry:
    """Kernel 2's (`demap`) or A's launch `geo` in the spilled layout: its
    warps, team, blocks and passes, so each frame's sums keep their order,
    with no symbol buffers, no staged Ĥ and the pilot scratch in global
    memory."""
    return dataclasses.replace(geo, nbuf=0, spill=True, stage_h=False,
                               smem=_teamed_smem_bytes(
                                   cfg.n_used, cfg.n_pilots, geo.warps,
                                   geo.teams, demap, False, True))


def _demap_staged(cfg: ModemConfig, B: int, sms: int):
    """Kernel B's staged launch, or None where no warp count fits."""
    U, R, NS = cfg.n_used, cfg.bits_per_ofdm_symbol, cfg.n_active_bins
    return pick_warps(cfg.n_data_symbols, B, sms,
                      lambda warps, nbuf: demap_smem_bytes(U, R, NS, warps,
                                                           nbuf))


def streamed_geometry(cfg: ModemConfig, B: int,
                      sms: int = H100_SMS) -> FusedGeometry:
    """Kernel B's streamed launch: the staged layout's warps where that
    layout fits (so the outputs keep their bits), else `pick_warps` on the
    streamed shared memory."""
    U, R, NS = cfg.n_used, cfg.bits_per_ofdm_symbol, cfg.n_active_bins

    def smem(warps: int, nbuf: int = 0) -> int:
        return demap_smem_bytes(U, R, NS, warps, 0)

    staged = (_demap_staged(cfg, B, sms)
              or pick_warps(cfg.n_data_symbols, B, sms, smem))
    return FusedGeometry(staged.warps, staged.passes, 0, smem(staged.warps))


@functools.lru_cache(maxsize=None)
def demap_geometry(cfg: ModemConfig, B: int,
                   sms: int = H100_SMS) -> FusedGeometry:
    """Kernel B's launch for a batch of B frames on `sms` SMs: one block per
    frame, warp w taking data symbols w, w + warps, ... (`pick_warps` on
    `demap_smem_bytes`), staged where a warp count fits, else streamed
    (`streamed_geometry`)."""
    return _demap_staged(cfg, B, sms) or streamed_geometry(cfg, B, sms)


def spill_scratch(geo: FusedGeometry, B: int, P: int,
                  dev: torch.device) -> torch.Tensor | None:
    """The spilled layout's global pilot scratch on the caller's stream
    (None for the other layouts); freed after the launch, its memory is
    reused only by later work on that stream."""
    n = geo.scratch_floats(B, P)
    return torch.empty(n, device=dev) if n else None
