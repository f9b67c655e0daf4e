"""Kernels 7 and 6 (gf3x_torch's block-aligned window cuts): their plain
versions against gf3x's Pallas `gather_cut_tpu` and `gather_cut_group_tpu`
in interpret mode and against gf3x's `gather_cut`, on the CPU; the routes
by which `ops.sync.cut_symbols` picks kernel 1, 6 or 7, as gf3x's
`cut_symbols` does, each equal to gf3x's cut; and the wrappers' dispatch
rule.

Tolerance: none — every comparison is exact (a cut moves samples).

The CUDA kernels run only on the card: `chip_smoke.py` holds them against
these plain versions there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gf3x.ops import sync as jsync
from gf3x.ops.pallas.gather_cut import gather_cut_group_tpu, gather_cut_tpu

from gf3x_torch.ops import sync as tsync
from gf3x_torch.ops.kernels import gather_cut as tcut
from gf3x_torch.utils import profiling

BLOCK = 128
GEOM = dict(S=5, n_fft=512, sym_len=640, cp=128, body_off=640, sc_off=96,
            block=BLOCK)


def ragged(B, seed, T=9000 + 77):
    """B noise recordings of a length that is not a whole number of
    blocks."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T)).astype(np.float32), rng


@pytest.mark.parametrize("B", [1, 3])
def test_gather_cut_plain_matches_pallas_interpret(B):
    """The TPU kernel (one DMA per row on the (B, nf + 8, block) view of the
    zero-padded whole-block prefix) against the port's plain cut at the
    same window blocks, the last allowed one included: exactly equal."""
    rx, rng = ragged(B, 20 + B)
    T = rx.shape[1]
    nf, K = T // BLOCK, 32
    q = rng.integers(0, nf + 8 - K + 1, B).astype(np.int32)
    q[0] = nf + 8 - K                       # reads into the zero tail
    xb = np.pad(rx[:, : nf * BLOCK], ((0, 0), (0, 8 * BLOCK)))
    ref = gather_cut_tpu(jnp.asarray(xb.reshape(B, nf + 8, BLOCK)),
                         jnp.asarray(q), K, interpret=True)
    got = tcut.gather_cut(torch.as_tensor(rx), torch.as_tensor(q), K, BLOCK,
                          nf * BLOCK)
    assert got.shape == (B, K * BLOCK)
    assert np.array_equal(got.numpy(), np.asarray(ref).reshape(B, -1))


def test_gather_cut_matches_gf3x_gather_cut():
    """gf3x's `gather_cut` (its CPU route) at random starts and both clamp
    edges against the port's cut at the same plan (`cut_plan`): the port's
    window is the first `window_blocks` blocks of gf3x's, which rounds the
    window up to whole 8-block tiles; the rolls are equal."""
    rx, rng = ragged(5, 24)
    T = rx.shape[1]
    need = 640 + 5 * 640
    starts = rng.integers(0, T - need, 5).astype(np.int32)
    starts[:2] = [0, T]
    win_r, r_r = jsync.gather_cut(jnp.asarray(rx), jnp.asarray(starts), need,
                                  BLOCK)
    geo = {k: GEOM[k] for k in ("S", "n_fft", "sym_len", "sc_off",
                                "body_off", "block")}
    q, valid, roll = tsync.cut_plan(T, torch.as_tensor(starts), **geo)
    nb = tcut.window_blocks(BLOCK, GEOM["S"], GEOM["n_fft"],
                            GEOM["body_off"], GEOM["sym_len"],
                            GEOM["sc_off"])
    win = tcut.gather_cut(torch.as_tensor(rx), q, nb, BLOCK, valid)
    assert np.array_equal(win.numpy(), np.asarray(win_r)[:, : nb * BLOCK])
    assert np.array_equal(roll.numpy(), np.asarray(r_r))


@pytest.mark.parametrize("B", [8, 16])
def test_gather_cut_group_plain_matches_pallas_interpret(B):
    """Kernel 6's TPU form (one whole 8-row group staged at a time, zero
    tail past the whole-block prefix) against the port's plain version at
    gf3x's 8-block-rounded window, on a ragged T, with the last allowed
    window block reading into the zero tail: exactly equal."""
    rx, rng = ragged(B, 50 + B)
    T = rx.shape[1]
    nf, nb = T // BLOCK, 40
    q = rng.integers(0, nf + 8 - nb + 1, B).astype(np.int32)
    q[0] = nf + 8 - nb
    ref = gather_cut_group_tpu(jnp.asarray(rx), jnp.asarray(q), BLOCK, nb,
                               interpret=True)
    got = tcut.gather_cut_group(torch.as_tensor(rx), torch.as_tensor(q), nb,
                                BLOCK)
    assert got.shape == (B, nb * BLOCK)
    assert not got[0, (nf - q[0]) * BLOCK:].any()
    assert np.array_equal(got.numpy(), np.asarray(ref))


ALIGNED = dict(GEOM, sc_off=384)
ROUTES = {
    "B1-kernel7": (1, GEOM, "gather_cut"),
    "B3-kernel7": (3, GEOM, "gather_cut"),
    "B8-aligned-kernel1": (8, ALIGNED, "cut_symbols"),
    "B8-sc_off-kernel6": (8, GEOM, "gather_cut_group"),
    "B8-cp-kernel6": (8, dict(ALIGNED, cp=192, n_fft=448),
                      "gather_cut_group"),
    "B8-block32-kernel1": (8, dict(GEOM, block=32), "cut_symbols"),
}
# the host counter of each route's rows (`utils.profiling`)
COUNTERS = {"gather_cut": "cut.window_rows",
            "gather_cut_group": "cut.group_rows",
            "cut_symbols": "cut.fused_rows"}


@pytest.mark.parametrize("case", list(ROUTES))
def test_cut_symbols_route_by_batch(case, monkeypatch):
    """`ops.sync.cut_symbols` runs kernel 7 + a slice for a batch that is
    not whole 8-row groups, kernel 6 + a slice for whole groups on a
    geometry gf3x's fused cut refuses (an offset off the 128 grid with a
    128-sample block; `GEOM`'s sc_off = 96), and kernel 1 otherwise —
    the tiny-block case included (gf3x/ops/sync.py:329-348, 388-402) —
    and every route gives gf3x's cut exactly and counts its B rows under
    its own host counter."""
    B, geom, route = ROUTES[case]
    rx, rng = ragged(B, 30 + B)
    starts = rng.integers(0, 4000, B).astype(np.int32)
    called = []
    for name in ("gather_cut", "gather_cut_group", "cut_symbols"):
        real = getattr(tcut, name)
        monkeypatch.setattr(
            tcut, name,
            lambda *a, _n=name, _f=real, **k: called.append(_n) or _f(*a, **k))
    profiling.reset()
    with profiling.recording():
        syms, scw, roll = tsync.cut_symbols(torch.as_tensor(rx),
                                            torch.as_tensor(starts), **geom)
    counted = profiling.counters()
    profiling.reset()
    assert called == [route]
    assert {k: counted[k] for k in COUNTERS.values()} == {
        k: B if k == COUNTERS[route] else 0 for k in COUNTERS.values()}
    r_syms, r_scw, r_roll = jsync.cut_symbols(jnp.asarray(rx),
                                              jnp.asarray(starts), **geom)
    assert np.array_equal(syms.numpy(), np.asarray(r_syms))
    assert np.array_equal(scw.numpy(), np.asarray(r_scw))
    assert np.array_equal(roll.numpy(), np.asarray(r_roll))


def test_gather_cut_wrapper_dispatch():
    """A CPU tensor runs the plain version and launches nothing; a tensor on
    another device is refused, never silently computed."""
    rx, _ = ragged(2, 40, T=4000)
    q = torch.tensor([0, 30], dtype=torch.int32)
    before = tcut.gather_cut.launches
    win = tcut.gather_cut(torch.as_tensor(rx), q, 4, BLOCK, 3968)
    assert torch.equal(win, tcut.gather_cut_plain(torch.as_tensor(rx), q, 4,
                                                  BLOCK, 3968))
    assert torch.equal(win[0], torch.as_tensor(rx[0, :512]))
    assert torch.equal(win[1, :128], torch.as_tensor(rx[1, 3840:3968]))
    assert not win[1, 128:].any()
    assert tcut.gather_cut.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tcut.gather_cut(torch.as_tensor(rx, device="meta"), q.to("meta"), 4,
                        BLOCK, 3968)
    assert tcut.gather_cut.launches == before


def test_gather_cut_group_wrapper_dispatch():
    """Kernel 6's wrapper: a CPU tensor runs the plain version (zeros past
    the whole-block prefix) and launches nothing; a batch that is not
    whole 8-row groups and a tensor on another device are refused."""
    rx, _ = ragged(8, 41, T=4000)
    q = torch.tensor([0, 30, 1, 2, 3, 4, 5, 6], dtype=torch.int32)
    before = tcut.gather_cut_group.launches
    win = tcut.gather_cut_group(torch.as_tensor(rx), q, 8, BLOCK)
    assert win.shape == (8, 8 * BLOCK)
    assert torch.equal(win[0], torch.as_tensor(rx[0, :1024]))
    assert torch.equal(win[1, :128], torch.as_tensor(rx[1, 3840:3968]))
    assert not win[1, 128:].any()
    assert tcut.gather_cut_group.launches == before
    with pytest.raises(ValueError, match="B % 8"):
        tcut.gather_cut_group(torch.as_tensor(rx[:3]), q[:3], 8, BLOCK)
    with pytest.raises(ValueError, match="CUDA"):
        tcut.gather_cut_group(torch.as_tensor(rx, device="meta"),
                              q.to("meta"), 8, BLOCK)
    assert tcut.gather_cut_group.launches == before
