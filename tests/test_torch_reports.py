"""gf3x's three evaluation reports on the port (`gf3x_torch.bench.stress`,
`perf_report`, `adapt_report`) against the gf3x tools they port
(tools/stress.py, tools/perf_report.py, tools/adapt_report.py, loaded by
path) on the CPU, at their smallest sizes: the same stress cells succeed
on the same seeds, one preset's sweep counts the same errors on gf3x's own
draws, the adaptive link builds the same bit-loading table from one probe,
and each report writes its markdown where `--out` says and nothing under
docs/ or tools/."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from gf3x import GoldenModem as JGolden
from gf3x import Modem as JModem
from gf3x import channel as jchannel
from gf3x.bench.ber import ber_sweep as jax_ber_sweep
from gf3x.config import preset as jpreset
from gf3x.ops.adapt import bit_loading_from_probe as j_bit_loading

from gf3x_torch import GoldenModem, Modem, preset
from gf3x_torch import channel as tchannel
from gf3x_torch.bench import adapt_report, perf_report, stress

from test_torch_ber import counts, jax_draws

ROOT = Path(__file__).resolve().parent.parent


def tool(name: str):
    """tools/<name>.py as a module (the tools are scripts, not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree_state(*dirs):
    """(path, size, mtime) of every file under `dirs`."""
    return sorted((str(p), p.stat().st_size, p.stat().st_mtime_ns)
                  for d in dirs for p in (ROOT / d).rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts)


# (label, impairment as (channel module) → fn(x, rng), operating SNR): one
# stress cell of four of the tool's axes, each well inside the envelope,
# and one far below the AWGN waterfall
CELLS = (
    ("+500 ppm", lambda ch: lambda x, r: ch.resample_sfo(x, 500), 18.0),
    ("rt60 0.04 s", lambda ch: lambda x, r: ch.multipath(
        x, ch.room_impulse_response(r, rt60=0.04, drr_db=5.0)), 15.0),
    ("clip at 25 %", lambda ch: lambda x, r: ch.clip(
        x, 0.25 * float(np.max(np.abs(x)))), 16.0),
    ("-8 dB", lambda ch: lambda x, r: x, -8.0),
)


def test_stress_cells_succeed_as_the_tools():
    """`success_rate` of the port's report and of tools/stress.py, on the
    same seeded trials (one generator per cell for both; the port's
    channel sims are gf3x's, copied): equal success counts on cells away
    from the threshold."""
    ref_tool = tool("stress")
    jm, tm = JModem(jpreset("gf3")), Modem(preset("gf3"), device="cpu")
    rates = []
    for i, (label, imp, snr) in enumerate(CELLS):
        ref = ref_tool.success_rate(jm, imp(jchannel),
                                    np.random.default_rng(i), 2, snr)
        got = stress.success_rate(tm, imp(tchannel),
                                  np.random.default_rng(i), 2, snr)
        assert got == ref, label
        rates.append(got)
    assert rates == [1.0, 1.0, 1.0, 0.0]


def test_perf_report_sweep_counts_gf3xs_errors_on_its_draws(monkeypatch):
    """One preset (gf3) over the report's grid, in AWGN and through the
    report's room, with 2 trials a point: the port's `preset_rows` on
    gf3x's own payload and noise draws counts the errors gf3x's sweep does,
    within tests/test_torch_ber.py's bounds: failed frames equal, pre-FEC
    bit errors within 2 + 1e-3 of the count, and post-FEC bit errors equal
    (none) wherever no frame failed — a failed codeword's wrong bits are
    not comparable (ROADMAP §3, "Failed frames' bits"), and down this
    grid's waterfall they differ by more than that test's 2 + 1 %. Its
    grids, room and number format are the tool's."""
    ref_tool = tool("perf_report")
    assert perf_report.GRIDS == ref_tool.GRIDS
    for x, floor in ((3e-4, 1e-5), (4e-6, 1e-5), (0.0, 1e-5)):
        assert perf_report.fmt(x, floor) == ref_tool.fmt(x, floor)
    jfir = jchannel.room_impulse_response(np.random.default_rng(3),
                                          rt60=0.04, drr_db=6.0)
    fir = perf_report.room_fir()
    assert np.array_equal(fir, jfir.astype(np.float32))

    name, N = "gf3", 2
    cfg = preset(name)
    snrs = perf_report.GRIDS[name]
    real = perf_report.ber.ber_sweep

    def on_gf3x_draws(modem, snrs_db, n_trials, fir=None, delay_samples=0):
        info, noise = jax_draws(cfg, len(snrs_db), n_trials,
                                cfg.frame_len + delay_samples)
        return real(modem, snrs_db, n_trials, fir=fir,
                    delay_samples=delay_samples, info=info, noise=noise)

    monkeypatch.setattr(perf_report.ber, "ber_sweep", on_gf3x_draws)
    rows, res, room = perf_report.preset_rows(name, N, "cpu", fir)
    jm = JModem(jpreset(name))
    ref = jax_ber_sweep(jm, snrs, n_trials=N)
    ref_room = jax_ber_sweep(jm, snrs, n_trials=N, fir=fir,
                             delay_samples=perf_report.ROOM_DELAY)
    for got, want in ((res, ref), (room, ref_room)):
        (pre, post, fer), (rpre, rpost, rfer) = counts(got, cfg), counts(
            want, cfg)
        assert np.array_equal(fer, rfer)
        assert np.all(np.abs(pre - rpre) <= 2 + 1e-3 * rpre)
        assert np.array_equal(post[fer == 0], rpost[rfer == 0])
        assert not post[fer == 0].any()
    assert fer.any() and not fer.all()
    assert rows[2] == "| SNR (dB) | pre-FEC BER | post-FEC BER | FER | " \
        "room FER |" and len(rows) == 4 + len(snrs) + 1


def test_adapt_report_builds_the_tools_table():
    """The adaptive link's table from one probe at 14 dB: the port's
    `probe_table` (the port's golden model and `bit_loading_from_probe`)
    equals tools/adapt_report.py's steps on gf3x's; the shaped channel, its
    SNR grid and presets are the tool's."""
    ref_tool = tool("adapt_report")
    assert adapt_report.SNRS == ref_tool.SNRS
    assert adapt_report.UNIFORM == ref_tool.UNIFORM
    rng = np.random.default_rng(3)
    jfir = jchannel.speaker_mic_fir(highcut=7000.0, ripple_db=4.0, rng=rng)
    jfir = np.roll(jfir, -(len(jfir) // 2 - 48))
    fir = adapt_report.shaped_fir()
    assert np.array_equal(fir, jfir)

    snr = 14
    jg = JGolden(jpreset("gf3"))
    probe = jg.encode(b"probe", "p")
    prng = np.random.default_rng(100 + snr)
    rx = jchannel.awgn(jchannel.delay_gain(
        jchannel.multipath(probe, jfir), 977, 1.0,
        total_len=probe.size + 4000), snr, prng)
    jres = jg.decode(rx)
    assert jres.crc_ok
    ref = j_bit_loading(jres.diag, jpreset("gf3"), margin_db=1.0)
    g = GoldenModem(preset("gf3"))
    got = adapt_report.probe_table(g, g.encode(b"probe", "p"), fir, snr)
    assert tuple(got) == tuple(ref)
    assert adapt_report.net_kbps(preset("gf3")) == ref_tool.net_kbps(
        jpreset("gf3"))


@pytest.mark.parametrize("name", ["stress", "perf_report", "adapt_report"])
def test_report_writes_only_to_out(name, tmp_path, monkeypatch):
    """Each report's command line on the CPU at 1 trial (perf_report and
    adapt_report cut to one preset and one SNR, stress to its first table's
    first cell, through their own module constants) writes its markdown —
    the tool's section and column headings — to `--out` (a directory that
    does not exist yet) and nothing under docs/ or tools/; `--out` is
    required and `--device cuda` exits non-zero without a card."""
    before = tree_state("docs", "tools")
    mod = {"stress": stress, "perf_report": perf_report,
           "adapt_report": adapt_report}[name]
    out = tmp_path / "new" / f"{name}.md"
    if name == "perf_report":
        monkeypatch.setattr(perf_report, "GRIDS", {"gf3": [6]})
        argv = ["--no-plots"]
        want = ["## gf3 — 4-QAM", "| SNR (dB) | pre-FEC BER | post-FEC BER "
                "| FER | room FER |"]
    elif name == "adapt_report":
        monkeypatch.setattr(adapt_report, "SNRS", [14])
        monkeypatch.setattr(adapt_report, "UNIFORM", ("gf3",))
        argv = []
        want = ["## Uniform presets (fixed rate, one clearing SNR each)",
                "| config | net kbit/s | 14 dB |", "| SNR | net kbit/s | FER |"]
    else:
        real = stress.success_rate
        calls = []

        def first_cell(*a, **k):
            calls.append(1)
            return real(*a, **k) if len(calls) == 1 else 0.0

        monkeypatch.setattr(stress, "success_rate", first_cell)
        argv = []
        want = ["## Sampling-clock offset (18 dB SNR)",
                "| clock offset | success |", "| +0 ppm | 100% |",
                "## Speaker/mic response (15 dB SNR, 4th-order LP at 15 kHz, "
                "3 dB ripple)"]
    mod.main(["--device", "cpu", "--trials", "1", "--out", str(out)] + argv)
    lines = out.read_text().splitlines()
    for line in want:
        assert any(ln.startswith(line) for ln in lines), line
    assert tree_state("docs", "tools") == before
    assert {p.name for p in tmp_path.rglob("*")} == {"new", out.name}
    with pytest.raises(SystemExit):
        mod.main(["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            mod.main(["--out", str(out)])
