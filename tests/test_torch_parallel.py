"""The port's multi-device decode (`gf3x_torch.parallel`) on an eight-entry
CPU mesh: tests/test_parallel.py's cases on gf3x's TINY config (93 used
bins at spacing 8, an irregular pilot layout), and the port's
`sharded_decode` against gf3x's on the same recordings (gf3x's tests run
on eight virtual CPU devices, tests/conftest.py)."""

import numpy as np
import jax
import pytest
import torch

from gf3x import Modem as JModem
from gf3x.parallel import make_mesh as j_make_mesh
from gf3x.parallel import shard_batch as j_shard_batch
from gf3x.parallel import sharded_decode as j_sharded_decode

from gf3x_torch import Modem, ModemConfig
from gf3x_torch.parallel import (make_mesh, shard_batch, sharded_decode,
                                 sharded_pipeline_step)
from gf3x_torch.parallel.mesh import _shard_generator

from test_parallel import TINY as J_TINY

TINY = ModemConfig(
    n_fft=256, cp=64, bin_lo=8, bin_hi=100,
    pilot_spacing=8, n_known_symbols=2, n_data_symbols=12,
    chirp_duration=0.02, fec="ldpc", ldpc_z=24, ldpc_iters=5,
).validate()
INTEGER_DIAG = ("sync_start", "fec_iters", "fec_unsat")
# a float diagnostic of a sharded decode within this share of its mean
# magnitude of the unsharded one's: 1e-4 (observed ≤ 3e-7), but 1e-2 for
# the ISI floor and its tail/total ratio in dB, which come from a small
# difference of near-equal channel energies (observed 6.5e-3 and 1.2e-5)
FLOAT_DIAG_REL = dict(isi_var=1e-2, isi_db=1e-2)


@pytest.fixture(scope="module")
def modem():
    return Modem(TINY, device="cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * 8)


def recordings(modem, B, seed):
    """tests/test_parallel.py's recordings: B frames at onsets 100 + i,
    0.7 gain, 1e-4 noise."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, size=(B, TINY.payload_bits_per_frame),
                        dtype=np.uint8)
    wav = modem.modulate_frames(torch.as_tensor(info)).numpy()
    T = wav.shape[-1] + 400
    rx = np.zeros((B, T), np.float32)
    for i in range(B):
        rx[i, 100 + i: 100 + i + wav.shape[-1]] = 0.7 * wav[i]
    rx += rng.standard_normal(rx.shape).astype(np.float32) * 1e-4
    return rx, info


def test_mesh_of_8_and_the_default_mesh(mesh):
    """An explicit mesh keeps its devices (here eight CPU entries, the
    first n when asked); the default mesh is every CUDA device, so without
    a card there is none."""
    assert len(mesh) == 8 and set(mesh) == {torch.device("cpu")}
    assert len(make_mesh(3, devices=mesh)) == 3
    if torch.cuda.is_available():
        assert len(make_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(ValueError, match="no devices"):
            make_mesh()


def test_shard_batch_splits_dim_0(mesh):
    """One piece per device, in order; a batch that does not divide by the
    shard count is refused, as in gf3x."""
    x = torch.arange(16 * 3).reshape(16, 3)
    pieces = shard_batch(x, mesh)
    assert len(pieces) == 8 and torch.equal(torch.cat(pieces), x)
    assert all(p.shape == (2, 3) for p in pieces)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(x[:12], mesh)


def test_sharded_pipeline_step_exact(modem, mesh):
    """tests/test_parallel.py's step at 25 dB: BER 0, no violation, the
    bits back; and the same seed gives the same step."""
    step = sharded_pipeline_step(modem, mesh)
    rng = np.random.default_rng(0)
    B = 16
    info = rng.integers(0, 2, size=(B, TINY.payload_bits_per_frame),
                        dtype=np.uint8)
    ber, ok, bits = step(info, 1, 25.0)
    assert float(ber) == 0.0
    assert bool(ok)
    assert np.array_equal(bits.numpy(), info)
    ber0, ok0, _ = step(info, 1, -20.0)
    assert float(ber0) > 0.1 and not bool(ok0)


def test_shard_noise_differs_by_shard_and_repeats_by_seed():
    """Each shard draws from its own generator, seeded from (seed, shard):
    gf3x's fold_in of the shard index."""
    cpu = torch.device("cpu")

    def draw(seed, shard):
        return torch.randn(64, generator=_shard_generator(seed, shard, cpu))

    assert torch.equal(draw(1, 0), draw(1, 0))
    assert not torch.equal(draw(1, 0), draw(1, 1))
    assert not torch.equal(draw(1, 0), draw(2, 0))


def test_sharded_sync_decode_matches_unsharded(modem, mesh):
    """tests/test_parallel.py's decode: the sharded bits equal the
    unsharded decode's and the planted bits, sync_start and the other
    integer diagnostics equal, the LLR histogram's counts per frame equal
    with at most 1e-4 of them in another bucket, the float ones within
    `FLOAT_DIAG_REL` of their scale (eight shards of one frame reduce in other orders than one
    batch of eight), each field on the first device; a full batch and the
    shards of `shard_batch` give the same."""
    rx, info = recordings(modem, 8, 1)
    dec = sharded_decode(modem, mesh)
    bits_s, diag_s = dec(shard_batch(rx, mesh))
    bits_u, diag_u = modem.demodulate(torch.as_tensor(rx))
    assert torch.equal(bits_s, bits_u)
    assert np.array_equal(bits_s.numpy(), info)
    for name in diag_u._fields:
        a, b = getattr(diag_s, name), getattr(diag_u, name)
        assert a.shape == b.shape and a.device == mesh[0], name
        if name in INTEGER_DIAG:
            assert torch.equal(a, b), name
        elif name == "llr_hist":
            # power-of-two buckets of the LLRs: one on a bucket edge may
            # move when its last bits do; the frame's count may not
            assert torch.equal(a.sum(-1), b.sum(-1))
            assert (a - b).abs().sum() / 2 <= 1e-4 * b.sum()
        else:
            rel = FLOAT_DIAG_REL.get(name, 1e-4)
            assert (a - b).abs().max() <= rel * b.abs().mean() + 1e-30, name
    bits_f, _ = dec(torch.as_tensor(rx))
    assert torch.equal(bits_f, bits_s)


def test_sharded_decode_matches_gf3x_sharded_decode(modem, mesh):
    """The port's sharded decode and gf3x's `shard_map` decode on its
    eight-device mesh, on the same recordings: bits and sync_start equal."""
    rx, _ = recordings(modem, 16, 4)
    jm, jmesh = JModem(J_TINY), j_make_mesh()
    bits_j, diag_j = j_sharded_decode(jm, jmesh)(j_shard_batch(rx, jmesh))
    bits, diag = sharded_decode(modem, mesh)(rx)
    assert np.array_equal(bits.numpy(), np.asarray(bits_j))
    assert np.array_equal(diag.sync_start.numpy(),
                          np.asarray(jax.device_get(diag_j.sync_start)))
