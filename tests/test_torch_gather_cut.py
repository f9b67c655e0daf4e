"""Kernel 7's plain version (gf3x_torch's block-aligned window cut) against
gf3x's Pallas `gather_cut_tpu` in interpret mode and against gf3x's
`gather_cut`, on the CPU; the route that sends a batch which is not whole
8-row groups (one recording) through it, as gf3x's `cut_symbols` does; and
its wrapper's dispatch rule.

The CUDA kernel runs only on the card: `chip_smoke.py` holds it against
this plain version there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gf3x.ops import sync as jsync
from gf3x.ops.pallas.gather_cut import gather_cut_tpu

from gf3x_torch.ops import sync as tsync
from gf3x_torch.ops.kernels import gather_cut as tcut

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


@pytest.mark.parametrize("B,route", [(1, "gather_cut"), (3, "gather_cut"),
                                     (8, "cut_symbols")])
def test_cut_symbols_route_by_batch(B, route, monkeypatch):
    """`ops.sync.cut_symbols` runs kernel 1 for whole 8-row groups and
    kernel 7 + a slice otherwise (gf3x/ops/sync.py:339-344), and the two
    give gf3x's cut exactly."""
    rx, rng = ragged(B, 30 + B)
    starts = rng.integers(0, 4000, B).astype(np.int32)
    called = []
    for name in ("gather_cut", "cut_symbols"):
        real = getattr(tcut, name)
        monkeypatch.setattr(
            tcut, name,
            lambda *a, _n=name, _f=real, **k: called.append(_n) or _f(*a, **k))
    syms, scw, roll = tsync.cut_symbols(torch.as_tensor(rx),
                                        torch.as_tensor(starts), **GEOM)
    assert called == [route]
    r_syms, r_scw, r_roll = jsync.cut_symbols(jnp.asarray(rx),
                                              jnp.asarray(starts), **GEOM)
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
