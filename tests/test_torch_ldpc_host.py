"""The port's host LDPC surface (`LdpcCode.check`, `LdpcCode.decode_diag`,
the float64 NumPy min-sum the golden model decodes with) against gf3x's
on the same LLRs: bit for bit (info bits, passes run, unsat flags;
tolerance none — both are the same float64 NumPy operations), at all four
rates, with early exit on and off; and against kernel 3's plain version
(float32, per-codeword freeze) on the codewords both decoders satisfied."""

import numpy as np
import pytest
import torch

from gf3x.fec.ldpc import LdpcCode as JCode

from gf3x_torch.fec.codes import RATES
from gf3x_torch.fec.ldpc import LdpcCode as TCode

Z, N_CW, SIGMA = 24, 6, 0.8
# Eb/N0 (dB) at which all N_CW codewords converge within 25 sweeps at
# each rate (a dB above tests/test_torch_ldpc.py's operating points)
EBN0 = {"1/2": 3.5, "2/3": 4.2, "3/4": 5.0, "5/6": 6.2}


def bpsk_llrs(rate: str, seed: int = 3, sigma: float = SIGMA):
    """(codewords (N_CW, n) uint8, their BPSK LLRs 2y/σ², σ = 0.8 unless
    given)."""
    code = JCode(Z, rate)
    rng = np.random.default_rng(seed)
    c = code.encode(rng.integers(0, 2, size=(N_CW, code.k), dtype=np.uint8))
    y = (1.0 - 2.0 * c) + rng.normal(0.0, sigma, c.shape)
    return c, 2.0 * y / sigma ** 2


@pytest.mark.parametrize("rate", RATES)
def test_check_matches_gf3x(rate):
    """Syndrome weights of valid codewords (0), of codewords with flipped
    bits and of random words equal gf3x's."""
    c, _ = bpsk_llrs(rate)
    rng = np.random.default_rng(4)
    flipped = c.copy()
    flipped[np.arange(N_CW), rng.integers(0, c.shape[1], N_CW)] ^= 1
    junk = rng.integers(0, 2, size=c.shape, dtype=np.uint8)
    words = np.concatenate([c, flipped, junk])
    got, ref = TCode(Z, rate).check(words), JCode(Z, rate).check(words)
    assert np.array_equal(got, ref)
    assert not got[:N_CW].any() and got[N_CW:2 * N_CW].all()


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("rate", RATES)
def test_decode_diag_bit_for_bit(rate, early_exit):
    """(bits, passes, unsat) of `decode_diag` equal gf3x's, on a lead
    shape (2, 3) that both restore."""
    _, llr = bpsk_llrs(rate)
    llr = llr.reshape(2, 3, -1)
    bits, passes, unsat = TCode(Z, rate).decode_diag(llr, 12, early_exit)
    rb, rp, ru = JCode(Z, rate).decode_diag(llr, 12, early_exit)
    assert bits.dtype == rb.dtype and bits.shape == rb.shape == (2, 3, rb.shape[-1])
    assert np.array_equal(bits, rb)
    assert passes == rp and (passes == 12 or early_exit)
    assert unsat.shape == (2, 3) and np.array_equal(unsat, ru)


@pytest.mark.parametrize("rate", RATES)
def test_decode_diag_against_kernel3_plain(rate):
    """On batches where every codeword converged in both decoders — σ =
    0.8 at rate 1/2, and each rate at its EBN0 point — `decode_diag`'s
    bits equal the tensor decode's (kernel 3's plain version on the CPU)
    and the transmitted info bits."""
    code = TCode(Z, rate)
    R = code.k / code.n
    cases = [SIGMA] if rate == "1/2" else []
    cases.append(float(np.sqrt(1.0 / (2 * R * 10 ** (EBN0[rate] / 10)))))
    for sigma in cases:
        c, llr = bpsk_llrs(rate, sigma=sigma)
        bits, passes, unsat = code.decode_diag(llr, 25)
        tb, tp, tu = code.decode(torch.as_tensor(llr, dtype=torch.float32),
                                 25)
        assert not unsat.any() and not tu.any()
        assert passes >= 1 and int(tp.max()) == passes
        assert np.array_equal(bits, tb.numpy())
        assert np.array_equal(bits, c[:, : code.k])
