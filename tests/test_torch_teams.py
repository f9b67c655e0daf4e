"""Kernels 2 and A's launch layouts on the CPU (`eq_layout.fused_eq_geometry`
and `FusedGeometry`): the narrow bands keep the staged launch, value for
value; the wide bands take the teamed layout — a team of warps per data
symbol, a frame's symbols spread over several blocks — and past the pilot
bound of shared memory the spilled one. The kernels run only on the card
(`chip_smoke.py` holds every layout against the others and against the
plain versions there); what is held here is the launch Python computes:
every (frame, data symbol) covered once across (block, team), shared
memory within a block, resident warps within an SM."""

from collections import Counter

import pytest

import chip_smoke
from gf3x_torch import GF3_STANDARD, GF3_TURBO
from gf3x_torch.ops.kernels import eq_layout, fused_eq, split_eq
from gf3x_torch.ops.kernels.eq_layout import FusedGeometry
from gf3x_torch.utils import device


def _loaded(cfg):
    return cfg.replace(bit_loading=chip_smoke.loading_table(cfg.n_data_bins))


NARROW = {"config 5": GF3_STANDARD, "gf3-turbo": GF3_TURBO,
          "bit-loaded": _loaded(GF3_STANDARD),
          "gf3-longcp": GF3_STANDARD.replace(**chip_smoke.LONGCP),
          "offset 4": GF3_STANDARD.replace(pilot_offset=4),
          "pilotless": GF3_STANDARD.replace(pilot_spacing=0),
          "one pilot": GF3_STANDARD.replace(pilot_spacing=280),
          "offset 4, loaded": _loaded(GF3_STANDARD.replace(pilot_offset=4))}

# the staged launches the narrow bands took before the teamed layout came,
# (warps, passes, nbuf, smem) for kernel 2 and kernel A by batch
_C5 = {True: {1: (20, 1, 1, 61760), 1024: (4, 5, 2, 25792)},
       False: {1: (20, 1, 1, 59500), 1024: (4, 5, 2, 23660)}}
STAGED = {
    "config 5": _C5, "gf3-turbo": _C5, "offset 4": _C5,
    "bit-loaded": {False: _C5[False]},
    "offset 4, loaded": {False: _C5[False]},
    "gf3-longcp": {True: {1: (20, 1, 1, 123360), 1024: (10, 2, 2, 112080)},
                   False: {1: (20, 1, 1, 119000), 1024: (10, 2, 2, 107800)}},
    "pilotless": {True: {1: (20, 1, 1, 50560), 1024: (4, 5, 2, 23552)},
                  False: {1: (20, 1, 1, 48160), 1024: (4, 5, 2, 21280),
                          4096: (2, 10, 2, 12320)}},
    "one pilot": {True: {1: (20, 1, 1, 50880), 1024: (4, 5, 2, 23616)},
                  False: {1: (20, 1, 1, 48484), 1024: (4, 5, 2, 21348),
                          4096: (2, 10, 2, 12356)}},
}
BATCHES = (1, 4, 7, 64, 1024, 4096)


def _expected(name: str, demap: bool, B: int):
    """The literal staged launch of `STAGED` at batch B: the entry of the
    largest listed batch ≤ B (the launch changes only there)."""
    table = STAGED[name][demap]
    return table[max(b for b in table if b <= B)]


@pytest.mark.parametrize("name", list(NARROW))
def test_narrow_bands_keep_the_staged_launch(name):
    """Config 5, gf3-turbo, bit-loaded, gf3-longcp and the pilot layouts of
    chip_smoke.PILOT_LAYOUTS keep the staged launch they took before the
    teamed layout (one block per frame, a warp per data symbol, no team):
    every field, at every batch the port runs, for kernel 2 where the
    config is uniform and for kernel A."""
    cfg = NARROW[name]
    for demap in STAGED[name]:
        for B in BATCHES:
            warps, passes, nbuf, smem = _expected(name, demap, B)
            geo = eq_layout.fused_eq_geometry(cfg, B, demap=demap)
            assert geo == FusedGeometry(warps, passes, nbuf, smem, spill=False,
                                        team=1, blocks=1, stage_h=False)
            assert geo.layout == "staged"


WIDE = {name: GF3_STANDARD.replace(**kw)
        for name, kw in chip_smoke.WIDE_BANDS.items()}
WIDE["gf3-8192 loaded"] = _loaded(WIDE["gf3-8192"])
WIDE["spill"] = GF3_STANDARD.replace(**chip_smoke.SPILL_BAND)


def _smem(cfg, geo: FusedGeometry, demap: bool) -> int:
    """The teamed kernels' shared memory in bytes (fused_eq.cu's and
    split_eq.cu's team kernels): with Ĥ staged, Ĥ (2U floats) and |Ĥ|² (U),
    kernel 2 adds the clamped inverse (U) and the layout table (U ints);
    the teams' pilot scratch (4P floats each) unless spilled; the teams'
    three shared values (4 floats each); kernel 2's two sums per warp;
    the P pilot positions unless kernel 2 stages the table or the scratch
    is spilled."""
    U, P = cfg.n_used, cfg.n_pilots
    floats = (5 * U if demap else 3 * U) if geo.stage_h else 0
    floats += 0 if geo.spill else 4 * P * geo.teams
    floats += 4 * geo.teams + (2 * geo.warps if demap else 0)
    if not (geo.spill or (geo.stage_h and demap)):
        floats += P
    return 4 * floats


def _resident_warps(geo: FusedGeometry) -> int:
    blocks = min(device.WARPS_SM // geo.warps, device.BLOCKS_SM,
                 device.SMEM_SM // (geo.smem + device.SMEM_RESERVED))
    assert blocks >= 1
    return blocks * geo.warps


def _covered(geo: FusedGeometry, B: int, D: int) -> Counter:
    """(frame, data symbol) → how many (block, team) slots take it; checks
    every block a symbol and no team more than `passes`."""
    seen = Counter()
    for blk in range(geo.blocks):
        run = [d for g in range(geo.teams) for d in geo.symbols(g, D, blk)]
        assert run, (geo, blk)
        for g in range(geo.teams):
            assert len(geo.symbols(g, D, blk)) <= geo.passes
        for b in range(B):
            seen.update((b, d) for d in run)
    return seen


def _teamed(cfg, B: int, demap: bool) -> FusedGeometry:
    """The teamed launch of kernel 2 (`demap`) or A for B frames of `cfg`
    (spilled past the pilot bound), whatever the rule picks."""
    return eq_layout.teamed_geometry(
        cfg.n_used, cfg.n_pilots, cfg.n_data_symbols, B, device.H100_SMS,
        demap, spill=cfg.n_pilots > eq_layout.MAX_SHARED_PILOTS)


@pytest.mark.parametrize("B", (1, 4, 64, 1024))
@pytest.mark.parametrize("name", list(WIDE))
def test_teamed_launch_covers_every_symbol_once(name, B):
    """At every wide band and the spilled band, for kernel 2 (uniform) and
    kernel A, at B = 1, 4, 64 and 1024: the launch the geometry picks and
    `teamed_geometry`'s cover every (frame, data symbol) exactly once
    across (block, team), give every block a symbol, keep a block within
    SMEM_BLOCK with the kernels' layout of shared memory, and hold at most
    WARPS_SM warps on an SM; a team is at most 8 warps, and with more than
    one warp a block has at most 15 teams (its named barriers). The spilled
    layout's global scratch is 4P floats a team."""
    cfg = WIDE[name]
    D, P = cfg.n_data_symbols, cfg.n_pilots
    for demap in (False,) if cfg.bit_loading else (True, False):
        for geo in (eq_layout.fused_eq_geometry(cfg, B, demap=demap),
                    _teamed(cfg, B, demap)):
            assert geo.layout == ("spilled" if name == "spill" else "teamed")
            assert geo.nbuf == 0
            assert geo.warps == geo.team * geo.teams <= 32
            assert geo.team in eq_layout.TEAMS
            assert geo.team == 1 or geo.teams <= 15
            seen = _covered(geo, B, D)
            assert len(seen) == B * D and set(seen.values()) == {1}
            assert geo.smem == _smem(cfg, geo, demap) <= device.SMEM_BLOCK
            assert _resident_warps(geo) <= device.WARPS_SM
            assert geo.scratch_floats(B, P) == (
                B * geo.blocks * geo.teams * 4 * P if geo.spill else 0)


@pytest.mark.parametrize("name", ["config 5", "gf3-longcp", "gf3-4096",
                                  "gf3-16384", "spill"])
def test_forced_layouts_keep_the_launch(name):
    """The forced layouts (tests and chip_smoke.py only):
    `spilled_geometry` keeps the warps, team, blocks and passes of the
    launch the batch would take — so each frame's sums keep their order,
    and at the narrow bands the spilled kernel runs one warp a team and one
    block a frame — with no symbol buffers, no staged Ĥ and only the shared
    values and sums in shared memory; `teamed_geometry` gives the teamed
    layout at the narrow bands too, covering every symbol once."""
    cfg = (NARROW | WIDE)[name]
    D = cfg.n_data_symbols
    for demap in (True, False):
        for B in (1, 1024):
            picked = eq_layout.fused_eq_geometry(cfg, B, demap=demap)
            sp = eq_layout.spilled_geometry(picked, cfg, demap)
            assert sp.spill and sp.nbuf == 0 and not sp.stage_h
            assert (sp.warps, sp.team, sp.blocks, sp.passes) == (
                picked.warps, picked.team, picked.blocks, picked.passes)
            assert sp.smem == _smem(cfg, sp, demap)
            tm = _teamed(cfg, B, demap)
            assert tm.layout == ("spilled" if name == "spill" else "teamed")
            seen = _covered(tm, B, D)
            assert len(seen) == B * D and set(seen.values()) == {1}


@pytest.mark.parametrize("name", list(NARROW) + list(WIDE))
def test_layout_is_picked_by_residency(name):
    """The staged layout is picked exactly where it fits and an SM holds at
    least STAGED_MIN_WARPS of its warps (every narrow band); elsewhere the
    teamed layout (the spilled one past MAX_SHARED_PILOTS pilots), at
    every batch; never a streamed one, which kernels 2 and A do not
    have."""
    cfg = (NARROW | WIDE)[name]
    U, P, D = cfg.n_used, cfg.n_pilots, cfg.n_data_symbols
    for demap in (False,) if cfg.bit_loading else (True, False):
        for B in BATCHES:
            staged = eq_layout.pick_warps(
                D, B, device.H100_SMS,
                lambda w, nbuf: eq_layout.staged_smem_bytes(U, P, w, nbuf,
                                                            demap))
            geo = eq_layout.fused_eq_geometry(cfg, B, demap=demap)
            assert geo.layout in ("staged", "teamed", "spilled")
            wins = (staged is not None and P <= eq_layout.MAX_SHARED_PILOTS
                    and _resident_warps(staged)
                    >= eq_layout.STAGED_MIN_WARPS)
            assert (geo == staged) == wins
            if not wins:
                assert geo.layout == ("spilled"
                                      if P > eq_layout.MAX_SHARED_PILOTS
                                      else "teamed")


# the launch each kernel takes, pinned value for value before the launch rule
# moved out of kernel 2's module: (layout, warps, passes, nbuf, smem, team,
# blocks, stage_h) of kernel 2 (`fused_eq_geometry`, demap), kernel A (the
# same without demap) and kernel B (`demap_geometry`) at B = 1, 64, 1024
PICKS = {
    "config 5": {
        1: (("staged", 20, 1, 1, 61760, 1, 1, False),
            ("staged", 20, 1, 1, 59500, 1, 1, False),
            ("staged", 20, 1, 1, 87164, 1, 1, False)),
        64: (("staged", 20, 1, 1, 61760, 1, 1, False),
             ("staged", 20, 1, 1, 59500, 1, 1, False),
             ("staged", 20, 1, 1, 87164, 1, 1, False)),
        1024: (("staged", 4, 5, 2, 25792, 1, 1, False),
               ("staged", 4, 5, 2, 23660, 1, 1, False),
               ("staged", 10, 2, 2, 67484, 1, 1, False)),
    },
    "gf3-turbo": {
        1: (("staged", 20, 1, 1, 61760, 1, 1, False),
            ("staged", 20, 1, 1, 59500, 1, 1, False),
            ("staged", 20, 1, 1, 165564, 1, 1, False)),
        64: (("staged", 20, 1, 1, 61760, 1, 1, False),
             ("staged", 20, 1, 1, 59500, 1, 1, False),
             ("staged", 20, 1, 1, 165564, 1, 1, False)),
        1024: (("staged", 4, 5, 2, 25792, 1, 1, False),
               ("staged", 4, 5, 2, 23660, 1, 1, False),
               ("staged", 5, 4, 2, 54844, 1, 1, False)),
    },
    "bit-loaded": {
        1: (("staged", 20, 1, 1, 61760, 1, 1, False),
            ("staged", 20, 1, 1, 59500, 1, 1, False),
            ("staged", 20, 1, 1, 106348, 1, 1, False)),
        64: (("staged", 20, 1, 1, 61760, 1, 1, False),
             ("staged", 20, 1, 1, 59500, 1, 1, False),
             ("staged", 20, 1, 1, 106348, 1, 1, False)),
        1024: (("staged", 4, 5, 2, 25792, 1, 1, False),
               ("staged", 4, 5, 2, 23660, 1, 1, False),
               ("staged", 7, 3, 2, 54636, 1, 1, False)),
    },
    "gf3-longcp": {
        1: (("staged", 20, 1, 1, 123360, 1, 1, False),
            ("staged", 20, 1, 1, 119000, 1, 1, False),
            ("staged", 20, 1, 1, 173944, 1, 1, False)),
        64: (("staged", 20, 1, 1, 123360, 1, 1, False),
             ("staged", 20, 1, 1, 119000, 1, 1, False),
             ("staged", 20, 1, 1, 173944, 1, 1, False)),
        1024: (("staged", 10, 2, 2, 112080, 1, 1, False),
               ("staged", 10, 2, 2, 107800, 1, 1, False),
               ("staged", 20, 1, 1, 173944, 1, 1, False)),
    },
    "offset 4": {
        1: (("staged", 20, 1, 1, 61760, 1, 1, False),
            ("staged", 20, 1, 1, 59500, 1, 1, False),
            ("staged", 20, 1, 1, 87164, 1, 1, False)),
        64: (("staged", 20, 1, 1, 61760, 1, 1, False),
             ("staged", 20, 1, 1, 59500, 1, 1, False),
             ("staged", 20, 1, 1, 87164, 1, 1, False)),
        1024: (("staged", 4, 5, 2, 25792, 1, 1, False),
               ("staged", 4, 5, 2, 23660, 1, 1, False),
               ("staged", 10, 2, 2, 67484, 1, 1, False)),
    },
    "pilotless": {
        1: (("staged", 20, 1, 1, 50560, 1, 1, False),
            ("staged", 20, 1, 1, 48160, 1, 1, False),
            ("staged", 20, 1, 1, 93024, 1, 1, False)),
        64: (("staged", 20, 1, 1, 50560, 1, 1, False),
             ("staged", 20, 1, 1, 48160, 1, 1, False),
             ("staged", 20, 1, 1, 93024, 1, 1, False)),
        1024: (("staged", 4, 5, 2, 23552, 1, 1, False),
               ("staged", 4, 5, 2, 21280, 1, 1, False),
               ("staged", 10, 2, 2, 70624, 1, 1, False)),
    },
    "one pilot": {
        1: (("staged", 20, 1, 1, 50880, 1, 1, False),
            ("staged", 20, 1, 1, 48484, 1, 1, False),
            ("staged", 20, 1, 1, 93012, 1, 1, False)),
        64: (("staged", 20, 1, 1, 50880, 1, 1, False),
             ("staged", 20, 1, 1, 48484, 1, 1, False),
             ("staged", 20, 1, 1, 93012, 1, 1, False)),
        1024: (("staged", 4, 5, 2, 23616, 1, 1, False),
               ("staged", 4, 5, 2, 21348, 1, 1, False),
               ("staged", 10, 2, 2, 70612, 1, 1, False)),
    },
    "offset 4, loaded": {
        1: (("staged", 20, 1, 1, 61760, 1, 1, False),
            ("staged", 20, 1, 1, 59500, 1, 1, False),
            ("staged", 20, 1, 1, 106348, 1, 1, False)),
        64: (("staged", 20, 1, 1, 61760, 1, 1, False),
             ("staged", 20, 1, 1, 59500, 1, 1, False),
             ("staged", 20, 1, 1, 106348, 1, 1, False)),
        1024: (("staged", 4, 5, 2, 25792, 1, 1, False),
               ("staged", 4, 5, 2, 23660, 1, 1, False),
               ("staged", 7, 3, 2, 54636, 1, 1, False)),
    },
    "gf3-4096": {
        1: (("teamed", 8, 1, 0, 2880, 8, 20, False),
            ("teamed", 8, 1, 0, 2816, 8, 20, False),
            ("staged", 7, 3, 2, 192144, 1, 1, False)),
        64: (("teamed", 16, 2, 0, 9712, 4, 3, False),
             ("teamed", 16, 2, 0, 9584, 4, 3, False),
             ("staged", 7, 3, 2, 192144, 1, 1, False)),
        1024: (("teamed", 8, 5, 0, 31488, 2, 1, True),
               ("teamed", 8, 5, 0, 23024, 2, 1, True),
               ("staged", 4, 5, 2, 114864, 1, 1, False)),
    },
    "gf3-8192": {
        1: (("teamed", 8, 1, 0, 5680, 8, 20, False),
            ("teamed", 8, 1, 0, 5616, 8, 20, False),
            ("staged", 2, 10, 2, 189344, 1, 1, False)),
        64: (("teamed", 16, 2, 0, 19232, 4, 3, False),
             ("teamed", 16, 2, 0, 19104, 4, 3, False),
             ("staged", 2, 10, 2, 189344, 1, 1, False)),
        1024: (("teamed", 16, 5, 0, 62912, 4, 1, True),
               ("teamed", 16, 5, 0, 45984, 4, 1, True),
               ("staged", 1, 20, 2, 106464, 1, 1, False)),
    },
    "gf3-16384": {
        1: (("teamed", 8, 1, 0, 38160, 8, 20, False),
            ("teamed", 8, 1, 0, 38096, 8, 20, False),
            ("streamed", 20, 1, 0, 64, 1, 1, False)),
        64: (("teamed", 16, 3, 0, 68704, 8, 4, False),
             ("teamed", 16, 3, 0, 68576, 8, 4, False),
             ("streamed", 20, 1, 0, 64, 1, 1, False)),
        1024: (("teamed", 32, 1, 0, 129792, 8, 5, False),
               ("teamed", 32, 1, 0, 129536, 8, 5, False),
               ("streamed", 4, 5, 0, 64, 1, 1, False)),
    },
    "gf3-8192 loaded": {
        1: (("teamed", 8, 1, 0, 5680, 8, 20, False),
            ("teamed", 8, 1, 0, 5616, 8, 20, False),
            ("staged", 3, 7, 2, 200032, 1, 1, False)),
        64: (("teamed", 16, 2, 0, 19232, 4, 3, False),
             ("teamed", 16, 2, 0, 19104, 4, 3, False),
             ("staged", 3, 7, 2, 200032, 1, 1, False)),
        1024: (("teamed", 16, 5, 0, 62912, 4, 1, True),
               ("teamed", 16, 5, 0, 45984, 4, 1, True),
               ("staged", 3, 7, 2, 200032, 1, 1, False)),
    },
    "spill": {
        1: (("spilled", 8, 1, 0, 80, 8, 20, False),
            ("spilled", 8, 1, 0, 16, 8, 20, False),
            ("streamed", 20, 1, 0, 64, 1, 1, False)),
        64: (("spilled", 16, 3, 0, 160, 8, 4, False),
             ("spilled", 16, 3, 0, 32, 8, 4, False),
             ("streamed", 20, 1, 0, 64, 1, 1, False)),
        1024: (("spilled", 32, 1, 0, 320, 8, 5, False),
               ("spilled", 32, 1, 0, 64, 8, 5, False),
               ("streamed", 4, 5, 0, 64, 1, 1, False)),
    },
}
PICK_KERNELS = ("fused_eq_demap", "eq_track", "demap_bins")


@pytest.mark.parametrize("kernel", PICK_KERNELS)
@pytest.mark.parametrize("B", (1, 64, 1024))
@pytest.mark.parametrize("name", list(PICKS))
def test_launch_picks_are_pinned(name, B, kernel):
    """Every band of NARROW and WIDE (the spilled band with them), at B =
    1, 64 and 1024: kernels 2 and A take the launch `fused_eq_geometry`
    picked when it also had the streamed layout, and kernel B the one
    `demap_geometry` picked (the cells' shape is gf3-8192 at B = 1024:
    teams of 4, a block a frame, Ĥ staged). Reached through the wrappers'
    modules, which held the rule before `eq_layout` did."""
    cfg = (NARROW | WIDE)[name]
    if kernel == "demap_bins":
        geo = split_eq.demap_geometry(cfg, B)
    else:
        geo = fused_eq.fused_eq_geometry(cfg, B,
                                         demap=kernel == "fused_eq_demap")
    assert (geo.layout, geo.warps, geo.passes, geo.nbuf, geo.smem, geo.team,
            geo.blocks, geo.stage_h) == \
        PICKS[name][B][PICK_KERNELS.index(kernel)]
