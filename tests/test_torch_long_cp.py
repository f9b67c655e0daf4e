"""gf3-longcp — GF3_STANDARD with CP = N/4 at N = 2048, the GF3 parameter
standard's other common geometry (SURVEY.md:139) — through both packages
on the CPU, cut to D = 4 data symbols and B = 8 rows: the batched receive
path whose SC window offset (704) gf3x's fused cut refuses, so that the
cut runs kernel 6 (`gather_cut_group`).

Tolerances (tests/test_torch_modem.py's): payload bits exact and CRC ok;
sync_start within the decimation step (2); H, noise_var, isi_var ≤ 1e-3
rel; slope/cpe ≤ 1e-4 rad; evm, mean|LLR| and sc_metric ≤ 1e-3 rel;
fec_unsat exact; the LLR histograms' totals exact and their bins within 4
counts."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gf3x import GF3_STANDARD as J_STANDARD
from gf3x import Modem as JModem

from gf3x_torch import GF3_STANDARD, Modem
from gf3x_torch.ops.kernels import cut_dft, gather_cut

LONGCP = dict(n_fft=2048, cp=512, bin_lo=48, bin_hi=607)
CFG = GF3_STANDARD.replace(n_data_symbols=4, **LONGCP)
MARGIN = 4096
MAX_DELAY = MARGIN + CFG.cp


def build_batch(modem, B, rng):
    """bench.build_batch's recipe (one frame at a random onset in
    [0, MARGIN), 20 dB AWGN) with a payload that fits D = 4."""
    cfg = modem.cfg
    payload = rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
    wav = modem.encode(payload, "lcp.bin")
    rx = np.zeros((B, cfg.frame_len + MARGIN), dtype=np.float32)
    delays = rng.integers(0, MARGIN, size=B)
    for i in range(B):
        rx[i, delays[i]: delays[i] + wav.size] = wav
    p = float(np.mean(wav ** 2))
    rx += (rng.standard_normal(rx.shape) * np.sqrt(p / 100.0)).astype(
        np.float32)
    return rx, payload


@pytest.fixture(scope="module")
def batch():
    """The B = 8 batch, decoded once by gf3x (bounded sync)."""
    jm = JModem(J_STANDARD.replace(n_data_symbols=4, **LONGCP),
                max_delay=MAX_DELAY)
    rx, payload = build_batch(jm, 8, np.random.default_rng(0))
    bits, diag = jm._decode_jit(jnp.asarray(rx))
    return rx, payload, np.asarray(bits), jax.device_get(diag)


def counting(monkeypatch, module, names):
    """Wrap `module.<name>` so that each call is recorded in order."""
    called = []
    for name in names:
        real = getattr(module, name)
        monkeypatch.setattr(
            module, name,
            lambda *a, _n=name, _f=real, **k: called.append(_n) or _f(*a, **k))
    return called


def test_longcp_demodulate_matches_gf3x(batch, monkeypatch):
    """gf3-longcp `demodulate` on B = 8: the cut is kernel 6's (once, and
    neither kernel 1 nor 7), and bits and diagnostics equal gf3x's within
    the stated tolerances."""
    rx, payload, j_bits, jd = batch
    tm = Modem(CFG, max_delay=MAX_DELAY, device="cpu")
    assert tm._fused_cut_refuses(rx.shape[-1])
    called = counting(monkeypatch, gather_cut,
                      ("gather_cut", "gather_cut_group", "cut_symbols"))
    bits, d = tm.demodulate(torch.as_tensor(rx))
    assert called == ["gather_cut_group"]
    assert np.array_equal(bits.numpy(), j_bits)
    for b in bits.numpy():
        res = tm._result(b, None)
        assert res.crc_ok and res.payload == payload
    assert np.max(np.abs(d.sync_start.numpy()
                         - np.asarray(jd.sync_start))) <= 2

    def rel(a, b):
        return np.max(np.abs(a - b)) / np.max(np.abs(b))

    Hj = np.asarray(jd.H)[..., 0] + 1j * np.asarray(jd.H)[..., 1]
    assert rel(d.H.numpy(), Hj) <= 1e-3
    assert rel(d.noise_var.numpy(), np.asarray(jd.noise_var)) <= 1e-3
    assert rel(d.isi_var.numpy(), np.asarray(jd.isi_var)) <= 1e-3
    assert np.max(np.abs(d.pilot_slope.numpy()
                         - np.asarray(jd.pilot_slope))) <= 1e-4
    assert np.max(np.abs(d.common_phase.numpy()
                         - np.asarray(jd.common_phase))) <= 1e-4
    for name in ("evm", "mean_abs_llr", "sc_metric"):
        assert np.allclose(getattr(d, name).numpy(),
                           np.asarray(getattr(jd, name)), rtol=1e-3), name
    assert np.array_equal(d.fec_unsat.numpy(), np.asarray(jd.fec_unsat))
    assert not d.fec_unsat.numpy().any()
    assert np.array_equal(d.llr_hist.numpy().sum(-1),
                          np.asarray(jd.llr_hist).sum(-1))
    assert np.abs(d.llr_hist.numpy() - np.asarray(jd.llr_hist)).sum() <= 4


def test_longcp_use_cut_dft_takes_the_two_stage_cut(batch, monkeypatch):
    """With `use_cut_dft=True` on this geometry, the plain decode yields to
    the two-stage cut, as gf3x's `cut_dft_spectra` does (it returns None
    here): kernel 6 cuts, kernel 8 never runs, and the bits equal gf3x's."""
    rx, _, j_bits, _ = batch
    tm = Modem(CFG, max_delay=MAX_DELAY, device="cpu", use_cut_dft=True)
    called = counting(monkeypatch, gather_cut, ("gather_cut_group",))
    dft = counting(monkeypatch, cut_dft, ("cut_dft",))
    bits, _ = tm.demodulate(torch.as_tensor(rx))
    assert called == ["gather_cut_group"] and dft == []
    assert np.array_equal(bits.numpy(), j_bits)
