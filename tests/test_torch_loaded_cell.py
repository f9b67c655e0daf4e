"""The bit-loaded link through a room — the benchmark's cell
gf3-8192-loaded.b1024-15db-room — on the CPU: the ISI profile's anchor
through the cell's room and on a one-tap channel, the committed loading
table against its probe recipe, and the cell at B = 8 through the harness
with its TF32 control and two faults planted in the loaded path."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.control import control
from benchmark.reference.channel import room_fir
from benchmark.traffic import make_inputs

from gf3x_torch import Modem, preset
from gf3x_torch.channel.sims import (awgn, delay_gain, multipath,
                                     room_impulse_response)
from gf3x_torch.ops import chanest as tchan
from gf3x_torch.ops.adapt import _h_and_nv, bit_loading_from_probe

CELL = "gf3-8192-loaded.b1024-15db-room"


def small(cell, B: int = 8):
    """The cell cut to B rows, a ring of one, one warm-up step and B rows
    judged."""
    cell.traffic = dict(cell.traffic, batch=B, ring=1)
    cell.spec = dict(cell.spec, warmup_steps=1, sample_rows=B)
    return cell


@pytest.fixture(scope="module")
def probe():
    """The configuration's probe recipe (`assumed.probe`): gf3-8192 without
    the table, decoded by the port on the CPU from the cell's traffic at
    B rows, a ring of one, its seed → (cell, the probe's config, diag)."""
    cell = harness.load_cell(CELL)
    recipe = cell.config["assumed"]["probe"]
    bench = harness._json(harness.ROOT / "BENCHMARK.json")
    assert {"name": CELL, "traffic": recipe["traffic"]}.items() <= next(
        w for w in bench["workloads"] if w["name"] == CELL).items()
    base = harness.load_cell(CELL)
    base.config = dict(base.config, replace={
        k: v for k, v in base.config["replace"].items() if k != "bit_loading"})
    pcfg, rcfg = harness._configs(base)
    assert pcfg.bit_loading is None
    traffic = harness._json(harness.ROOT / "benchmark" / "traffic"
                            / f"{recipe['traffic']}.json")
    rx = make_inputs(rcfg, dict(traffic, batch=recipe["batch"],
                                ring=recipe["ring"]),
                     recipe["seed"], "cpu").ring[0]
    modem = Modem(pcfg, max_delay=int(traffic["margin"]) + pcfg.cp,
                  device="cpu")
    _, diag = modem.demodulate(rx)
    return cell, pcfg, diag


def test_the_probe_reads_no_tail_through_the_room(probe):
    """The room fits the CP, so the probe reads its tail/total ratio at the
    noise floor, under −20 dB, where ŝ − 16 read +7 dB on every row: over
    the rows combined as `bit_loading_from_probe` combines them (the
    median `isi_var` over the median |Ĥ|²), and on the median row. Single
    rows of a clean 15 dB probe read up to about −10 dB, the clamped
    estimator noise at the band's edges, so no bound holds each row."""
    _, pcfg, diag = probe
    assert diag.isi_db.shape == (8,)
    H, _, isi = _h_and_nv(diag, pcfg)
    assert 10 * np.log10(np.mean(isi) / np.mean(np.abs(H) ** 2)) <= -20.0
    assert float(diag.isi_db.median()) <= -20.0


def test_the_committed_table_is_the_probes(probe):
    """The table in the configuration file is what the port's
    `bit_loading_from_probe` gives for the recipe, counted as `assumed`
    says: every order, under 10 % of the bins nulled, R ≥ 9500."""
    cell, pcfg, diag = probe
    assumed = cell.config["assumed"]
    table = bit_loading_from_probe(diag, pcfg,
                                   margin_db=assumed["probe"]["margin_db"])
    assert list(table) == cell.config["replace"]["bit_loading"]
    counts = {str(b): table.count(b) for b in (0, 2, 4, 6)}
    assert counts == assumed["bins_at_bits"]
    assert sum(table) == assumed["bits_per_ofdm_symbol"] >= 9500
    assert all(counts.values()) and counts["0"] < 0.1 * len(table)


def test_the_room_fits_the_safe_window():
    """The cell's speaker and room in float64: under −40 dB of the FIR's
    energy lies outside the best (cp − cp/4)-tap window, so the −20 dB
    bound above is the probe's noise floor, not a tail of the room."""
    cell = harness.load_cell(CELL)
    cfg = harness.reference_config(cell)
    e = room_fir(cell.traffic["channel"], cfg.fs) ** 2
    W = cfg.cp - cfg.cp // 4
    c = np.concatenate([[0.0], np.cumsum(e)])
    best = np.max(c[W:] - c[:-W]) if len(e) > W else c[-1]
    assert 10 * np.log10(1.0 - best / c[-1]) < -40.0


def test_the_anchor_stays_on_a_one_tap_channel():
    """A one-tap channel at gf3-8192 with estimator noise: the anchor is
    gf3x's ŝ − t0 on every row, and the ISI profile, `isi_var` and the
    tail/total ratio, equals gf3x's (≤ 1e-3 rel, the Modem tests'
    tolerance)."""
    import jax.numpy as jnp
    from gf3x.ops import chanest as jchan

    cfg = harness._configs(harness.load_cell("gf3-8192.b1024-20db"))[0]
    rng = np.random.default_rng(5)
    k = np.arange(cfg.bin_lo, cfg.bin_hi + 1)
    d = rng.integers(200, 700, 4)
    H = 0.7 * np.exp(-2j * np.pi * np.outer(d, k) / cfg.n_fft)
    nv = np.full(4, 0.01)
    H = H + np.sqrt(nv[:, None] / cfg.n_known_symbols / 2) * (
        rng.standard_normal(H.shape) + 1j * rng.standard_normal(H.shape))
    H32, nv32 = (torch.as_tensor(H.astype(np.complex64)),
                 torch.as_tensor(nv.astype(np.float32)))
    t0 = tchan._isi_operator(cfg)[2]
    s_hat = tchan._bulk_delay(cfg, H32)
    got = tchan.isi_anchor(cfg, H32, nv32, s_hat, t0).numpy()
    assert np.array_equal(got, d - t0)
    iv_t, ir_t = tchan.isi_profile(cfg, H32, nv32, s_hat)
    iv_j, ir_j = (np.asarray(x) for x in jchan.isi_profile(
        cfg, jnp.asarray(H32.numpy()), jnp.asarray(nv32.numpy())))
    assert np.max(np.abs(iv_t.numpy() - iv_j)) <= 1e-3 * np.max(iv_j)
    assert np.max(np.abs(ir_t.numpy() - ir_j)) <= 1e-3 * np.max(ir_j)


def test_a_room_longer_than_the_cp_reads_its_tail():
    """tests/test_adapt.py's room-aware probe on the port: GF3 through a
    40 ms room (7× its CP) at 30 dB reads a tail at least 10 dB above the
    same probe on a clean channel."""
    cfg = preset("gf3")
    m = Modem(cfg, device="cpu")
    rng = np.random.default_rng(12)
    wav = m.encode(b"room probe payload", "p.bin").astype(np.float64)
    clean = awgn(delay_gain(wav, 500, 0.7, total_len=len(wav) + 2000), 30.0,
                 rng)
    res_c = m.decode(clean.astype(np.float32))
    h = room_impulse_response(rng, rt60=0.040, drr_db=0.0)
    room = awgn(delay_gain(multipath(wav, h), 500, 0.7,
                           total_len=len(wav) + 4000), 30.0, rng)
    res_r = m.decode(room.astype(np.float32))
    assert res_c.crc_ok and res_r.crc_ok
    assert float(res_r.diag.isi_db) > float(res_c.diag.isi_db) + 10.0


def test_the_cell_is_correct_at_b8(monkeypatch):
    """The committed cell at B = 8 through the harness on the CPU, judged
    by its own limits: `correct`, no frame failed, every payload bit
    exact. The run's refusal of JAX's modules is set aside, as in
    tests/test_torch_clock_offset_cell.py: this process loaded them for
    the tests of the JAX package."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    cell = small(harness.load_cell(CELL))
    result, lines = harness.run(cell, 2 ** 35 + 1, 0.01, False, "cpu",
                                time.perf_counter())
    assert result["failed"] == 0 and result["attempted"] >= 8
    assert result["checks"]["bits_sent"]["value"] == 0
    assert result["correct"] is True, "\n".join(lines)


def test_the_tf32_control_is_not_correct():
    """The reference a precision below the program's (TF32) on the cell
    at B = 8 fails the cell's limits."""
    ok, judged = control(small(harness.load_cell(CELL)), 77, "cpu")
    assert ok is False
    assert [k for k, v in judged.items() if v["value"] > v["limit"]], judged


def negate_a_group(monkeypatch, cfg):
    """The 16-QAM group's LLRs negated where the split tail produces them
    (the table sorts the data bins by order, so the group is one run of
    LLRs in each symbol)."""
    table = np.asarray(cfg.bit_loading)
    lo = 2 * int(np.sum(table == 2))
    hi = lo + 4 * int(np.sum(table == 4))
    tail = Modem._split_eq_demap

    def faulty(self, Y, H, noise_var):
        llr, *rest = tail(self, Y, H, noise_var)
        llr = llr.reshape(llr.shape[0], cfg.n_data_symbols, -1).clone()
        llr[..., lo:hi] *= -1
        return (llr.reshape(llr.shape[0], -1), *rest)
    monkeypatch.setattr(Modem, "_split_eq_demap", faulty)


def shift_the_table(monkeypatch, cfg):
    """The program's table one bin off the transmitter's."""
    configs = harness._configs

    def shifted(cell):
        pcfg, rcfg = configs(cell)
        return (pcfg.replace(bit_loading=tuple(np.roll(pcfg.bit_loading,
                                                       1).tolist())), rcfg)
    monkeypatch.setattr(harness, "_configs", shifted)


@pytest.mark.parametrize("fault", [negate_a_group, shift_the_table])
def test_a_faulty_loaded_step_is_not_correct(fault, monkeypatch):
    """A fault planted in the program's loaded path, on the committed cell
    at B = 8: the payload bits differ from those sent, and the run is not
    `correct`."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    cell = small(harness.load_cell(CELL))
    fault(monkeypatch, harness.reference_config(cell))
    result, lines = harness.run(cell, 91, 0.01, False, "cpu",
                                time.perf_counter())
    assert result["checks"]["bits_sent"]["value"] > 0
    assert result["correct"] is False, "\n".join(lines)


@pytest.mark.card
def test_isi_onset_kernel_is_its_plain_version():
    """The onset kernel against its plain version on the same h, taken
    from the card's inverse FFT: rows through the cell's room, one-tap
    rows and noise alone, at gf3-8192 and the narrow band; the anchors
    equal, and some rows move."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from gf3x_torch.ops.kernels.isi_onset import isi_onset, isi_onset_plain

    fir = room_fir(harness.load_cell(CELL).traffic["channel"], 44100)
    rng = np.random.default_rng(9)
    wide = harness._configs(harness.load_cell("gf3-8192.b1024-20db"))[0]
    moved = 0
    for cfg in (wide, preset("gf3")):
        N, k = cfg.n_fft, np.arange(cfg.bin_lo, cfg.bin_hi + 1)
        t0 = tchan._isi_operator(cfg)[2]
        n, D, coef = tchan._onset_plan(N, cfg.n_used, cfg.n_known_symbols)
        rows = []
        for r in range(48):
            d = int(rng.integers(0, N))
            taps = (fir[: cfg.cp] if r % 3 == 0 else [1.0] if r % 3 == 1
                    else [0.0])
            x = np.zeros(N)
            x[(d + np.arange(len(taps))) % N] = taps
            rows.append(np.fft.fft(x)[k])
        nv = np.full(len(rows), 0.02, np.float32)
        H = torch.as_tensor((np.array(rows) + np.sqrt(0.01) * (
            rng.standard_normal((len(rows), cfg.n_used)) + 1j
            * rng.standard_normal((len(rows), cfg.n_used)))).astype(
                np.complex64), device="cuda")
        a0 = tchan._bulk_delay(cfg, H) - t0
        h = torch.fft.ifft(H * tchan._onset_taper(cfg.n_used, H.device), n=n)
        kw = dict(D=D, span=(cfg.cp - cfg.cp // 4 - 2 * t0) // D, g=2 * t0,
                  N=N, peak_share=tchan.ONSET_PEAK, noise_coef=coef)
        got = isi_onset(h, a0, torch.as_tensor(nv, device="cuda"), **kw)
        want = isi_onset_plain(h.cpu(), a0.cpu(), torch.as_tensor(nv), **kw)
        assert torch.equal(got.cpu(), want)
        moved += int((want != a0.cpu()).sum())
    assert moved > 0

