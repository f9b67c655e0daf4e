"""Kernel 3 at lifts above 512 (gf3x puts no bound on `ldpc_z`): the plain
version the card's kernel is held to, against gf3x's XLA twin at z = 600,
768 and 1024; a gf3-4096 Modem at z = 768 against gf3x's; and the two
passes' launch layouts (`ldpc_bp.decode_geometry`, `check_warps`) across
every lift up to 2048, every rate.

The CUDA kernel runs only on the card: `chip_smoke.py`'s "lifts" phase
holds it bit for bit to these plain versions at z = 520, 600, 768, 1024,
2048, 2400 and 9000 and decodes two wide configs end to end."""

import re
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gf3x import GF3_STANDARD as J_STANDARD
from gf3x import Modem as JModem
from gf3x.fec.ldpc import LdpcCode as JCode

import chip_smoke
from gf3x_torch import GF3_STANDARD, Modem
from gf3x_torch.fec.codes import N_BLOCK_COLS, RATES
from gf3x_torch.ops.kernels import ldpc_bp
from gf3x_torch.utils import device

from test_torch_long_cp import build_batch


@pytest.mark.parametrize("z,rate", [(600, "1/2"), (768, "1/2"),
                                    (1024, "3/4")])
def test_minsum_plain_matches_gf3x_xla_above_512(z, rate):
    """Kernel 3's plain version against `LdpcCode._minsum_xla` on 4
    codewords at σ = 0.8 (rate 1/2) or 0.5 (rate 3/4), with
    `test_minsum_plain_bit_identical_to_xla_twin`'s assertions: the totals'
    signs and the unsat flags equal, the totals within 1e-5 of their
    largest magnitude (XLA:CPU contracts the update into an FMA), the
    slowest codeword's passes equal to gf3x's batch-wide count."""
    jc = JCode(z, rate)
    rng = np.random.default_rng(z)
    sigma = 0.8 if rate == "1/2" else 0.5
    u = rng.integers(0, 2, size=(4, jc.k), dtype=np.uint8)
    y = (1.0 - 2.0 * jc.encode(u)) + rng.normal(0, sigma, (4, jc.n))
    llr = (2 * y / sigma ** 2).astype(np.float32)
    iters = 12
    tot_r, it_r, uns_r = jc._minsum_xla(
        jnp.asarray(llr).reshape(-1, N_BLOCK_COLS, z), iters, True)
    tot_t, uns_t, pas_t = ldpc_bp.minsum_totals_plain(
        torch.as_tensor(llr), z, rate, iters)
    tot_r = np.asarray(tot_r).reshape(4, -1)
    assert np.array_equal(tot_t.numpy() < 0, tot_r < 0)
    assert np.max(np.abs(tot_t.numpy() - tot_r)) \
        <= 1e-5 * np.max(np.abs(tot_r))
    assert np.array_equal(uns_t.numpy(), np.asarray(uns_r))
    assert int(pas_t.max()) == int(it_r) and int(pas_t.min()) >= 1
    assert np.mean((tot_t.numpy()[:, :jc.k] < 0) != u) < 0.01


def test_wide_band_at_z768_matches_gf3x():
    """gf3-4096 at ldpc_z = 768 (D = 20: 39 200 coded bits a frame, 2
    codewords of n = 18 432) through `Modem.demodulate` of both packages
    on B = 2 recordings: payload bits equal, every row CRC-ok, no codeword
    left unsatisfied."""
    kw = dict(chip_smoke.WIDE_BANDS["gf3-4096"], ldpc_z=768)
    jm = JModem(J_STANDARD.replace(**kw), max_delay=4096 + kw["cp"])
    assert jm.cfg.n_codewords == 2 and jm.cfg.ldpc_n == 18432
    rx, payload = build_batch(jm, 2, np.random.default_rng(3))
    j_bits, _ = jm._decode_jit(jnp.asarray(rx))
    tm = Modem(GF3_STANDARD.replace(**kw), max_delay=4096 + kw["cp"],
               device="cpu")
    bits, d = tm.demodulate(torch.as_tensor(rx))
    assert np.array_equal(bits.numpy(), np.asarray(j_bits))
    assert not d.fec_unsat.numpy().any()
    for b in bits.numpy():
        res = tm._result(b, None)
        assert res.crc_ok and res.payload == payload


def _source_const(name: str) -> str:
    src = (device.CSRC / "ldpc_bp.cu").read_text()
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)


def test_decode_geometry_covers_every_check_once():
    """For every lift 1 ≤ z ≤ 2048 and rate: the decode pass's threads
    take every check of a block row exactly once (thread t checks t,
    t + threads, ...; `rows` of them at most), z threads a block up to 512
    and a multiple of 32 of at most 512 above; the messages stay in shared
    memory exactly while the totals, the messages and the bit words fit a
    block's 227 KB (up to z = 576 at rate 1/2, 647 at 2/3, 633 at 3/4, 619
    at 5/6), the totals while they and the bit words fit (z ≤ 2347), and
    the scratch slice holds what left; the check pass takes 8 codewords a
    block up to z = 1076 and as many as fit after."""
    assert int(_source_const("kMaxThreads")) == ldpc_bp.MAX_THREADS == 512
    assert int(_source_const("kCheckWarps")) == ldpc_bp.CHECK_WARPS == 8
    assert eval(_source_const("kMaxLift").replace("/", "//")) \
        == ldpc_bp.MAX_LIFT
    last_shared = {}
    for rate in RATES:
        E = sum(len(r) for r in ldpc_bp.row_edges(96, rate))
        for z in range(1, 2049):
            geo = ldpc_bp.decode_geometry(z, rate)
            # thread t takes checks t, t + threads, ...: `rows` at most
            assert (geo.rows - 1) * geo.threads < z <= geo.rows * geo.threads
            if z in (1, 31, 513, 577, 600, 1000, 2047):
                seen = Counter(c for t in range(geo.threads)
                               for c in geo.checks(t, z))
                assert sorted(seen) == list(range(z))
                assert set(seen.values()) == {1}
                assert max(len(geo.checks(t, z))
                           for t in range(geo.threads)) == geo.rows
            words = N_BLOCK_COLS * z // 32
            shared = 4 * ((E + N_BLOCK_COLS) * z + words)
            tot = 4 * (N_BLOCK_COLS * z + words)
            if z <= 512:
                assert geo.layout == ldpc_bp.ONE_CHECK and geo.threads == z
            else:
                assert geo.threads % 32 == 0 and geo.threads <= 512
                assert geo.layout == (
                    ldpc_bp.ROWS_SHARED if shared <= ldpc_bp.SMEM_BLOCK
                    else ldpc_bp.C2V_GLOBAL if tot <= ldpc_bp.SMEM_BLOCK
                    else ldpc_bp.ALL_GLOBAL)
            assert geo.smem <= ldpc_bp.SMEM_BLOCK
            assert geo.smem == {ldpc_bp.C2V_GLOBAL: tot,
                                ldpc_bp.ALL_GLOBAL: 0}.get(geo.layout,
                                                           shared)
            assert geo.slice == {ldpc_bp.C2V_GLOBAL: E * z,
                                 ldpc_bp.ALL_GLOBAL: E * z + words + 1
                                 }.get(geo.layout, 0)
            if geo.layout <= ldpc_bp.ROWS_SHARED:
                last_shared[rate] = z
    assert last_shared == {"1/2": 576, "2/3": 647, "3/4": 633, "5/6": 619}
    assert ldpc_bp.decode_geometry(2347, "1/2").layout == ldpc_bp.C2V_GLOBAL
    assert ldpc_bp.decode_geometry(2348, "1/2").layout == ldpc_bp.ALL_GLOBAL
    for z in range(1, 2049):
        w = ldpc_bp.check_warps(z)
        assert w == (8 if z <= 1076 else
                     ldpc_bp.SMEM_BLOCK // ldpc_bp.check_stride(z))
        assert 1 <= w and w * ldpc_bp.check_stride(z) <= ldpc_bp.SMEM_BLOCK
    assert ldpc_bp.check_warps(8609) == 1 and ldpc_bp.check_warps(8610) == 0
