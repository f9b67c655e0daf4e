"""The float64 reference against the port's CPU route (`device="cpu"`, the
kernels' plain versions): the transmitter, the decoder, and whole runs of
the harness at a small batch judged by each cell's own limits."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference.config import GF3_STANDARD
from benchmark.reference.modem import F64, Receiver, encode_frames, info_bits


def test_transmitter_matches_the_port():
    from gf3x_torch import GF3_STANDARD as PORT_CFG, Modem

    payload = bytes(range(200)) * 2
    ours = encode_frames(GF3_STANDARD,
                         info_bits(GF3_STANDARD, payload, "bench.bin")[None])
    port = Modem(PORT_CFG, device="cpu").encode(payload, "bench.bin")
    assert ours.shape == (1, port.size)
    assert np.max(np.abs(ours[0] - port)) < 1e-6


def test_minsum_matches_the_port():
    from gf3x_torch.ops.kernels.ldpc_bp import minsum_totals_plain

    cfg = GF3_STANDARD
    rx = Receiver(cfg, 4096 + cfg.cp, "cpu", F64)
    g = torch.Generator().manual_seed(3)
    bits = torch.zeros(24, cfg.ldpc_n)        # the all-zero codeword
    lam = (1.0 - 2.0 * bits + 0.8 * torch.randn(bits.shape, generator=g)) \
        * (2.0 / 0.64)
    tot, unsat, passes = rx.minsum(lam.double())
    ptot, punsat, ppasses = minsum_totals_plain(lam, cfg.ldpc_z,
                                                cfg.ldpc_rate, cfg.ldpc_iters)
    assert torch.equal(tot < 0, ptot < 0)
    assert torch.equal(unsat, punsat) and torch.equal(passes, ppasses)
    assert int(passes.max()) > 0


# the narrow band's clock-offset route, which no cell drives yet: the limits
# its cell held on the card (the 20 dB cell's where none is named here)
CLOCK_LIMITS = {"H": 1e-3, "noise_var": 9e-4, "pilot_slope": 3e-6,
                "common_phase": 4e-4, "evm": 6e-4, "mean_abs_llr": 9e-4,
                "clock_ppm": 1e-2}


def narrow(cell, clock_ppm):
    """`cell` moved to the published GF3 frame (n_fft 1024, QPSK), through
    the clock-offset route where clock_ppm is not 0."""
    cell.config = {"preset": "gf3-standard", "replace": {}, "reduced": []}
    if clock_ppm:
        cell.traffic = dict(cell.traffic, entry="demodulate_sfo",
                            clock_ppm=clock_ppm)
        cell.spec = dict(cell.spec, limits=dict(cell.spec["limits"],
                                                **CLOCK_LIMITS))
    return cell


@pytest.mark.parametrize("name,ring,band", [
    ("gf3-8192.b1024-20db", 1, None), ("gf3-8192.b1024-20db", 2, 0.0),
    ("gf3-8192.b1024-20db", 2, 150.0)])
def test_a_small_run_is_correct(name, ring, band):
    """The port's CPU route at B = 8 passes the cell's own check; also on
    the narrow band, plain and at +150 ppm."""
    cell = harness.load_cell(name)
    if band is not None:
        cell = narrow(cell, band)
    cell.traffic = dict(cell.traffic, batch=8, ring=ring, frames=8)
    cell.spec = dict(cell.spec, warmup_steps=1, sample_rows=4)
    result, lines = harness.run(cell, 987654321987, 0.01, False, "cpu",
                                time.perf_counter())
    assert result["correct"] is True, "\n".join(lines)
    assert result["failed"] == 0
