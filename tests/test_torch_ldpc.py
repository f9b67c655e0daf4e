"""Kernel 3's plain version against gf3x's NumPy and C++ LDPC backends, and
the two facts its check pass + decode pass design rests on, on the CPU.

The north star holds the port's LDPC decode bit-identical to gf3x's four
backends. `tests/test_torch_kernels.py` compares it with the XLA twin and
the Pallas kernel; here it meets the NumPy golden decoder
(`LdpcCode.decode_diag`, float64) and the C++ `NativeLdpc` (float32) at
every rate, in the pattern of `tests/test_ldpc_rates.py`'s backend test at
z = 96. The kernels themselves run only on the card: `chip_smoke.py`
holds both passes against these plain versions there."""

import re

import numpy as np
import pytest
import torch

from gf3x.fec.ldpc import LdpcCode as JCode

from gf3x_torch.fec.codes import N_BLOCK_COLS, RATES, block_rows
from gf3x_torch.fec.ldpc import LdpcCode as TCode
from gf3x_torch.ops.kernels import ldpc_bp
from gf3x_torch.utils import device

Z, ITERS, N_OK, N_JUNK = 96, 20, 8, 4
# Eb/N0 (dB) at which a batch of N_OK codewords converges within ITERS
# sweeps at each rate (tests/test_ldpc_rates.py's operating points, and
# 2.5 dB at rate 1/2)
EBN0 = {"1/2": 2.5, "2/3": 3.2, "3/4": 4.0, "5/6": 5.2}


def batch(rate: str, seed: int = 17):
    """(info bits of the N_OK codewords, their BPSK LLRs at the rate's
    operating point, the same LLRs with N_JUNK random rows appended), as
    float32 NumPy arrays."""
    code = JCode(Z, rate)
    R = code.k / code.n
    sigma = float(np.sqrt(1.0 / (2 * R * 10 ** (EBN0[rate] / 10))))
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(N_OK, code.k), dtype=np.uint8)
    y = (1.0 - 2.0 * code.encode(u)) + rng.normal(0, sigma, (N_OK, code.n))
    llr = (2 * y / sigma ** 2).astype(np.float32)
    junk = (4.0 * rng.standard_normal((N_JUNK, code.n))).astype(np.float32)
    return u, llr, np.concatenate([llr, junk])


@pytest.fixture(scope="module")
def native():
    """gf3x's C++ backend, skipped as tests/test_native_ldpc.py skips it
    where it cannot be built."""
    mod = pytest.importorskip("gf3x.native")
    if not mod.available():
        pytest.skip("native toolchain unavailable")
    return mod


@pytest.mark.parametrize("rate", RATES)
def test_plain_decode_matches_numpy_backend(rate):
    """The port's `LdpcCode.decode` (kernel 3's plain version) against
    gf3x's NumPy `decode_diag`: on a batch that converges, info bits equal
    (and the transmitted ones), no codeword unsatisfied, and the slowest
    codeword's passes equal NumPy's batch-wide count; with junk codewords
    mixed in, the unsat flags equal. NumPy decodes in float64 and the port
    in float32, so their totals differ in the low bits; at these operating
    points no codeword's pass count moved by that rounding."""
    u, llr, mixed = batch(rate)
    jc, tc = JCode(Z, rate), TCode(Z, rate)
    nb, it_np, nu = jc.decode_diag(llr.astype(np.float64), ITERS)
    tb, tp, tu = (t.numpy() for t in tc.decode(torch.as_tensor(llr), ITERS))
    assert not nu.any() and not tu.any()
    assert np.array_equal(tb, nb) and np.array_equal(tb, u)
    assert int(tp.max()) == it_np >= 1

    _, _, nu = jc.decode_diag(mixed.astype(np.float64), ITERS)
    _, tp, tu = (t.numpy() for t in tc.decode(torch.as_tensor(mixed), ITERS))
    assert np.array_equal(tu, nu)
    assert tu[N_OK:].all() and not tu[:N_OK].any()
    assert (tp[N_OK:] == ITERS).all()


@pytest.mark.parametrize("rate", RATES)
def test_plain_decode_matches_native_backend(rate, native):
    """The same batches against gf3x's C++ `NativeLdpc.decode` (float32,
    built with -O3 -march=native, so its totals may round through an FMA;
    bits and counts are compared): info bits equal on the converging
    batch, and its count of valid codewords equals the port's count of
    codewords left satisfied, with junk codewords mixed in too."""
    _, llr, mixed = batch(rate)
    nat, tc = native.NativeLdpc(Z, rate=rate), TCode(Z, rate)
    cb, ok = nat.decode(llr, iters=ITERS)
    tb, _, tu = (t.numpy() for t in tc.decode(torch.as_tensor(llr), ITERS))
    assert np.array_equal(cb, tb)
    assert ok == int((~tu).sum()) == N_OK
    _, ok = nat.decode(mixed, iters=ITERS)
    _, _, tu = tc.decode(torch.as_tensor(mixed), ITERS)
    assert ok == int((~tu).sum()) == N_OK


@pytest.mark.parametrize("rate", ["1/2", "5/6"])
def test_decoding_the_failing_subset_equals_the_whole_batch(rate):
    """What the kernel's split rests on: with the freeze rule a codeword
    decodes independently of the batch, so the check pass (totals = lam,
    unsat = the first check) followed by `minsum_totals_plain` of only the
    codewords that fail it, scattered back, gives the whole batch's
    totals, unsat and passes bit for bit — here on valid, noisy and junk
    codewords interleaved, through the plain versions and through the
    wrappers, which on the CPU launch nothing."""
    u, llr, mixed = batch(rate)
    code = JCode(Z, rate)
    clean = (8.0 * (1.0 - 2.0 * code.encode(u))).astype(np.float32)
    lam = torch.as_tensor(np.stack([clean, mixed[:N_OK], np.concatenate(
        [mixed[N_OK:], clean[:N_JUNK]])], axis=1).reshape(-1, code.n))
    whole = ldpc_bp.minsum_totals_plain(lam, Z, rate, ITERS)

    unsat, totals = ldpc_bp.minsum_check_plain(lam, Z, rate)
    assert 0 < int(unsat.sum()) < lam.shape[0]
    assert torch.equal(totals, lam) and totals.data_ptr() != lam.data_ptr()
    passes = torch.zeros(lam.shape[0], dtype=torch.int32)
    split = ldpc_bp.minsum_decode_plain(lam, totals, unsat, passes, Z, rate,
                                        ITERS)
    before = (ldpc_bp.minsum_check.launches, ldpc_bp.minsum_decode.launches)
    unsat_w, totals_w = ldpc_bp.minsum_check(lam, Z, rate)
    wrapped = ldpc_bp.minsum_decode(
        lam, totals_w, unsat_w, torch.zeros_like(passes), None, Z, rate,
        ITERS)
    for got in (split, wrapped):
        assert torch.equal(got[0].view(torch.int32), whole[0].view(torch.int32))
        assert torch.equal(got[1], whole[1]) and torch.equal(got[2], whole[2])
    assert before == (ldpc_bp.minsum_check.launches,
                      ldpc_bp.minsum_decode.launches)
    assert int(whole[2].max()) > 0 and bool(whole[1].any())


@pytest.mark.parametrize("rate", RATES)
def test_check_plain_is_the_syndrome(rate):
    """The check pass's plain version flags exactly the codewords whose
    hard decisions have a non-zero syndrome under gf3x's dense parity
    matrix (`LdpcCode.check`), the test the decode pass's freeze applies;
    with iters = 0 the whole function is that check."""
    u, _, mixed = batch(rate)
    code = JCode(Z, rate)
    lam = np.concatenate([mixed, (1.0 - 2.0 * code.encode(u)).astype(
        np.float32)])
    unsat, totals = ldpc_bp.minsum_check_plain(torch.as_tensor(lam), Z, rate)
    ref = code.check((lam < 0).astype(np.uint8)) > 0
    assert np.array_equal(unsat.numpy(), ref) and ref.any() and not ref.all()
    assert np.array_equal(totals.numpy(), lam)
    tot0, uns0, pas0 = ldpc_bp.minsum_totals_plain(torch.as_tensor(lam), Z,
                                                   rate, 0)
    assert torch.equal(uns0, unsat) and torch.equal(tot0, totals)
    assert not pas0.any()


def test_kernel_tables_are_sized_for_every_rate():
    """The kernels' parameter-bank arrays and the decode pass's register
    array (`csrc/ldpc_bp.cu`) fit every code of the family: kMaxDeg is the
    largest block-row degree over RATES, and kMaxRows and kMaxEdges hold
    every rate's rows and edges; `kernel_edges` is `row_edges` flattened."""
    src = (device.CSRC / "ldpc_bp.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    degs = {r: [len(row) for row in ldpc_bp.row_edges(Z, r)] for r in RATES}
    assert const("kMaxDeg") == max(max(d) for d in degs.values()) == 18
    assert const("kMaxRows") == max(block_rows(r) for r in RATES)
    assert const("kMaxEdges") >= max(sum(d) for d in degs.values())
    assert const("kBlockCols") == N_BLOCK_COLS
    for r in RATES:
        (ptr, col, shf), addrs = ldpc_bp.kernel_edges(Z, r)
        assert ptr.dtype == col.dtype == shf.dtype == np.int32
        assert list(np.diff(ptr)) == degs[r] and ptr[-1] == col.size
        flat = [(j, s) for row in ldpc_bp.row_edges(Z, r) for _, j, s in row]
        assert list(zip(col.tolist(), shf.tolist())) == flat
        assert addrs == (ptr.ctypes.data, col.ctypes.data, shf.ctypes.data)


@pytest.mark.parametrize("z,rate", [(32, "5/6"), (64, "3/4"), (96, "1/2")])
def test_packed_syndrome_arithmetic(z, rate):
    """The bit-word syndrome `csrc/ldpc_bp.cu` uses where z % 32 = 0, done
    in NumPy with the source's own multiplier: four 0/1 bytes pack to four
    bits with no carry (all 16 cases), and the XOR over a row's edges of
    the funnel-shifted column words (from (c0 + s) mod z, the last word
    wrapping to the first) flags the same codewords as the plain check."""
    src = (device.CSRC / "ldpc_bp.cu").read_text()
    mult = int(re.search(r"x \* (0x[0-9a-fA-F]+)u", src).group(1), 16)
    for b in range(16):
        x = sum(((b >> k) & 1) << (8 * k) for k in range(4))
        assert ((x * mult) % 2 ** 32 >> 21) & 0xF == b

    code = JCode(z, rate)
    rng = np.random.default_rng(z)
    u = rng.integers(0, 2, size=(6, code.k), dtype=np.uint8)
    clean = (1.0 - 2.0 * code.encode(u)).astype(np.float32)
    mixed = np.concatenate([clean, rng.standard_normal(
        (6, code.n)).astype(np.float32)])
    hard = (mixed < 0).astype(np.uint64)
    words = (hard.reshape(len(mixed), -1, 32)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint64)
    cw_words = z // 32
    bad = np.zeros(len(mixed), bool)
    for row in ldpc_bp.row_edges(z, rate):
        for c0 in range(0, z, 32):
            par = np.zeros(len(mixed), np.uint64)
            for _, j, s in row:
                p = (c0 + s) % z
                q, r = divmod(p, 32)
                lo = words[:, j * cw_words + q]
                hi = words[:, j * cw_words + (q + 1) % cw_words]
                par ^= ((lo | hi << np.uint64(32)) >> np.uint64(r)) \
                    & np.uint64(0xFFFFFFFF)
            bad |= par != 0
    ref, _ = ldpc_bp.minsum_check_plain(torch.as_tensor(mixed), z, rate)
    assert np.array_equal(bad, ref.numpy()) and bad.any() and not bad.all()
