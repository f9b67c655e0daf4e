"""The port's tracing layer (`gf3x_torch/utils/profiling.py`): the spans a
`demodulate` call records, their cost while tracing is off, the totals, and
the LDPC decode pass's counters — on the CPU through the plain route, and
on the card (the `card` test, which skips without one) through kernel 3's
device counters. No JAX here: the card test runs where JAX is absent."""

import json
import re
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gf3x_torch import Modem, preset
from gf3x_torch.channel.torch_sims import awgn
from gf3x_torch.fec.ldpc import LdpcCode
from gf3x_torch.ops.kernels import ldpc_bp
from gf3x_torch.utils import profiling

CFG = preset("gf3-standard")
MARGIN = 1024
STAGES = {"gf3x.sync", "gf3x.cut", "gf3x.dft", "gf3x.chanest",
          "gf3x.eq_demap", "gf3x.fec_gather", "gf3x.ldpc", "gf3x.diag"}
# the spans a plain `demodulate` on the CPU nests inside a stage
NESTED = {"gf3x.llr_hist": "gf3x.diag"}
# the CUDA runtime calls that issue device work (benchmark/trace.py's rule)
RUNTIME = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                     r"Memcpy|Memset)")


def recordings(modem, B: int, snr_db: float, seed: int = 3):
    """B recordings of distinct payloads at onsets in [0, MARGIN), with
    AWGN at snr_db, on the modem's device."""
    rng = np.random.default_rng(seed)
    wav = modem.encode_batch([b"span %d" % i for i in range(B)])
    rx = np.zeros((B, wav.shape[1] + MARGIN), np.float32)
    for i, d in enumerate(rng.integers(0, MARGIN, B)):
        rx[i, d: d + wav.shape[1]] = wav[i]
    x = torch.as_tensor(rx, device=modem.device)
    g = torch.Generator(device=modem.device).manual_seed(seed)
    return awgn(x, snr_db, generator=g)


@pytest.fixture(scope="module")
def cpu_case():
    modem = Modem(CFG, max_delay=MARGIN + CFG.cp, device="cpu")
    return modem, recordings(modem, 2, 25.0)


@pytest.fixture
def clean():
    profiling.reset()
    yield
    profiling.reset()


def noisy_lam(z: int = 96, L: int = 24, sigma: float = 0.8, seed: int = 5):
    """L rate-1/2 codewords' BPSK LLRs, the odd rows at noise σ (they fail
    the first check and need sweeps), the even ones at σ/20 (they pass
    it)."""
    code = LdpcCode(z, "1/2")
    g = torch.Generator().manual_seed(seed)
    u = torch.randint(0, 2, (L, code.k), generator=g, dtype=torch.uint8)
    y = 1.0 - 2.0 * code.encode(u).to(torch.float32)
    scale = torch.where(torch.arange(L) % 2 == 1, sigma, sigma / 20)
    y = y + scale[:, None] * torch.randn(y.shape, generator=g)
    return (2.0 * y / sigma ** 2).contiguous()


def test_a_call_is_one_root_with_its_stages(cpu_case, clean):
    """Two `demodulate` calls under torch.profiler: one root span each,
    every stage span a child of its call's root, sharing the root's id,
    and every other span a child of the stage it belongs to (NESTED)."""
    modem, rx = cpu_case
    with profile(activities=[ProfilerActivity.CPU]):
        modem.demodulate(rx)
        modem.demodulate(rx)
    recs = profiling.records()
    roots = [i for i, r in enumerate(recs) if r.parent == -1]
    assert [recs[i].name for i in roots] == ["gf3x.demodulate"] * 2
    assert recs[roots[0]].call != recs[roots[1]].call
    for root in roots:
        kids = [r for r in recs if r.parent == root]
        assert {r.name for r in kids} == STAGES
        assert all(r.call == recs[root].call for r in kids)
    assert all(r.parent in roots or recs[r.parent].name == NESTED[r.name]
               for r in recs if r.parent != -1)
    assert all(r.call == recs[r.parent].call for r in recs if r.parent != -1)


def test_every_aten_op_lies_in_a_stage(cpu_case, clean):
    """No op of a `demodulate` call runs in the root's own time: each
    aten op the profiler saw inside the root lies inside a stage span."""
    modem, rx = cpu_case
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        modem.demodulate(rx)
    evs = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events()]
    (r0, r1), = [(s, e) for s, e, n in evs if n == "gf3x.demodulate"]
    stages = [(s, e) for s, e, n in evs if n in STAGES]
    assert len(stages) >= len(STAGES)
    ops = [(s, e, n) for s, e, n in evs
           if n.startswith("aten::") and r0 <= s and e <= r1]
    assert len(ops) > 50
    outside = [n for s, e, n in ops
               if not any(a <= s and e <= b for a, b in stages)]
    assert outside == []


def test_spans_off_record_nothing(cpu_case, clean, monkeypatch):
    """Profiler off and no `recording()`: a span is the shared no-op
    context, `record_function` is never entered, nothing is recorded and
    nothing counted, on the plain and the clock-offset route."""
    modem, rx = cpu_case
    entered = []
    real = profiling._profiler

    def counting(name):
        entered.append(name)
        return real.record_function(name)
    monkeypatch.setattr(profiling, "_profiler", types.SimpleNamespace(
        _is_profiler_enabled=False, record_function=counting))
    assert profiling.span("dft") is profiling.span("ldpc")
    assert profiling.span("dft") is profiling._NOOP
    modem.demodulate(rx)
    modem.demodulate_sfo(rx)
    assert entered == [] and profiling.records() == []
    assert profiling.span_totals() == {}
    assert profiling.counters() == {"ldpc.codewords": 0, "ldpc.queued": 0,
                                    "ldpc.sweeps": 0, "ofdm.warped_dfts": 0,
                                    "ofdm.warped_rows": 0,
                                    "ofdm.czt_rows": 0,
                                    "ofdm.czt_fused_rows": 0,
                                    "eq_track.rows": 0,
                                    "demap_bins.llrs": 0,
                                    "llr_hist.samples": 0,
                                    "cut.fused_rows": 0,
                                    "cut.group_rows": 0,
                                    "cut.window_rows": 0}


def test_span_totals_are_idempotent(cpu_case, clean):
    """`recording()` without the profiler: the totals count each call's
    stages, a root's self time is its host time less its stages', and a
    second read gives the same answer."""
    modem, rx = cpu_case
    with profiling.recording():
        modem.demodulate(rx)
        modem.demodulate(rx)
    first = profiling.span_totals()
    assert first == profiling.span_totals()
    assert set(first) == STAGES | set(NESTED) | {"gf3x.demodulate"}
    root = first["gf3x.demodulate"]
    assert root["count"] == 2 and first["gf3x.ldpc"]["count"] == 2
    kids = sum(first[n]["host_s"] for n in STAGES)
    assert root["self_s"] == pytest.approx(root["host_s"] - kids, abs=1e-6)
    assert 0 < root["self_s"] < root["host_s"]
    if not torch.cuda.is_initialized():   # no card in use: no events
        assert all(t["device_s"] is None for t in first.values())
    assert profiling.counters() == profiling.counters()
    profiling.reset()
    assert profiling.span_totals() == {} and profiling.records() == []


def test_plain_ldpc_counts_are_the_passes(clean):
    """The CPU route counts, while tracing is on, the codewords, those
    with passes > 0 (the ones the check pass would queue) and the sum of
    passes of `minsum_totals_plain`; untraced calls count nothing."""
    lam = noisy_lam()
    _, _, passes = ldpc_bp.minsum_totals_plain(lam, 96, "1/2", 20)
    assert 0 < int((passes > 0).sum()) < lam.shape[0]
    ldpc_bp.minsum_totals(lam, 96, "1/2", 20)
    with profiling.recording():
        ldpc_bp.minsum_totals(lam, 96, "1/2", 20)
        ldpc_bp.minsum_totals(lam[:8], 96, "1/2", 20)
    want_q = int((passes > 0).sum()) + int((passes[:8] > 0).sum())
    want_s = int(passes.sum()) + int(passes[:8].sum())
    assert profiling.counters() == {"ldpc.codewords": lam.shape[0] + 8,
                                    "ldpc.queued": want_q,
                                    "ldpc.sweeps": want_s,
                                    "ofdm.warped_dfts": 0,
                                    "ofdm.warped_rows": 0,
                                    "ofdm.czt_rows": 0,
                                    "ofdm.czt_fused_rows": 0,
                                    "eq_track.rows": 0,
                                    "demap_bins.llrs": 0,
                                    "llr_hist.samples": 0,
                                    "cut.fused_rows": 0,
                                    "cut.group_rows": 0,
                                    "cut.window_rows": 0}


@pytest.fixture(scope="module")
def sfo_case(cpu_case):
    modem, _ = cpu_case
    return modem, recordings(modem, 8, 25.0, seed=4)


def test_clock_offset_route_records_two_warped_dfts(sfo_case, clean):
    """One `demodulate_sfo` call at B = 8 runs the warped DFT twice — the
    δ₀ pass inside `gf3x.clock_offset`, then the final demod — each a
    `gf3x.warped_dft` span under a `gf3x.dft`, and counts both transforms
    and their 2·B·(K+D) symbol rows."""
    modem, rx = sfo_case
    with profiling.recording():
        modem.demodulate_sfo(rx)
    recs = profiling.records()
    warped = [r for r in recs if r.name == "gf3x.warped_dft"]
    assert len(warped) == 2
    assert all(recs[r.parent].name == "gf3x.dft" for r in warped)

    def ancestors(r):
        while r.parent >= 0:
            r = recs[r.parent]
            yield r.name
    assert "gf3x.clock_offset" in ancestors(warped[0])
    assert "gf3x.clock_offset" not in ancestors(warped[1])
    S = CFG.n_known_symbols + CFG.n_data_symbols
    c = profiling.counters()
    assert (c["ofdm.warped_dfts"], c["ofdm.warped_rows"]) == (2, 2 * 8 * S)


def test_plain_route_runs_no_warped_dft(cpu_case, clean):
    """`demodulate` records no `gf3x.warped_dft` span and counts no warped
    transform."""
    modem, rx = cpu_case
    with profiling.recording():
        modem.demodulate(rx)
    assert "gf3x.warped_dft" not in {r.name for r in profiling.records()}
    c = profiling.counters()
    assert c["ofdm.warped_dfts"] == c["ofdm.warped_rows"] == 0


def loaded_table(n: int) -> tuple:
    """A table of n bins at 0, 2, 4 and 6 bits in turn."""
    return tuple((2 * (i % 4)) for i in range(n))


def test_split_tail_spans_nest_in_eq_demap(clean):
    """A bit-loaded `demodulate` takes the split tail: `gf3x.eq_track` then
    `gf3x.demap_bins`, each a child of `gf3x.eq_demap`, and the counters
    equal the shapes: B frames through kernel A, B·D·R coded bits through
    kernel B."""
    cfg = CFG.replace(bit_loading=loaded_table(CFG.n_data_bins))
    modem = Modem(cfg, max_delay=MARGIN + cfg.cp, device="cpu")
    rx = recordings(modem, 3, 25.0)
    with profiling.recording():
        modem.demodulate(rx)
    recs = profiling.records()
    split = [r for r in recs if r.name in ("gf3x.eq_track",
                                           "gf3x.demap_bins")]
    assert [r.name for r in split] == ["gf3x.eq_track", "gf3x.demap_bins"]
    assert all(recs[r.parent].name == "gf3x.eq_demap" for r in split)
    c = profiling.counters()
    assert c["eq_track.rows"] == 3
    assert c["demap_bins.llrs"] == (3 * cfg.n_data_symbols
                                    * sum(cfg.bit_loading))


def test_fused_tail_records_no_split_spans(cpu_case, clean):
    """A uniform `demodulate` takes kernel 2: neither split span appears
    and neither split counter counts."""
    modem, rx = cpu_case
    with profiling.recording():
        modem.demodulate(rx)
    names = {r.name for r in profiling.records()}
    assert "gf3x.eq_demap" in names
    assert not names & {"gf3x.eq_track", "gf3x.demap_bins"}
    c = profiling.counters()
    assert c["eq_track.rows"] == c["demap_bins.llrs"] == 0


def test_llr_hist_nests_in_diag_and_counts_its_samples(cpu_case, clean):
    """One `demodulate` records one `gf3x.llr_hist` span, a child of the
    first `gf3x.diag`, and counts rows × ⌈R/8⌉ sampled LLRs; an untraced
    call counts none."""
    modem, rx = cpu_case
    modem.demodulate(rx)
    assert profiling.counters()["llr_hist.samples"] == 0
    with profiling.recording():
        modem.demodulate(rx)
    recs = profiling.records()
    hist = [r for r in recs if r.name == "gf3x.llr_hist"]
    assert len(hist) == 1
    diag = [i for i, r in enumerate(recs) if r.name == "gf3x.diag"]
    assert len(diag) == 2 and hist[0].parent == diag[0]
    assert profiling.counters()["llr_hist.samples"] == (
        rx.shape[0] * -(-CFG.raw_bits_per_frame // 8))


WARPED_READERS = ("warped_dft.device_ms", "clock_offset.device_ms",
                  "warped_dft_roofline")
SPLIT_READERS = ("eq_track_roofline", "demap_bins_roofline")
HIST_READERS = ("llr_hist_roofline",)
CUT_READERS = ("cut.fused_pct",)


def reader_ctx(device: bool, steps: int = 16) -> dict:
    """A reader's context at gf3-8192: a trace with or without device
    work, the benchmark's peaks."""
    from benchmark import harness
    from benchmark.trace import Trace

    cell = harness.load_cell("gf3-8192.clock150-30db")
    tr = Trace(steps=steps, device=[(0.0, 1.0, "k")] if device else [])
    return {"trace": tr, "issue_s": [], "cfg": harness.reference_config(cell),
            "batch": 1024, "peaks": json.loads(
                (harness.ROOT / "benchmark" / "peaks.json").read_text())}


@pytest.mark.parametrize("name", WARPED_READERS + SPLIT_READERS
                         + HIST_READERS + CUT_READERS)
def test_warped_readers_say_nothing_without_a_card(name, clean):
    """Without device work in the trace each of these readers returns
    None."""
    from benchmark import harness

    read, params = harness._reader(harness.ROOT, name)
    assert read(dict(reader_ctx(False), params=params)) is None


def test_warped_dft_roofline_reads_the_records(monkeypatch):
    """The roofline from the program's records: 2·B·(K+D) rows a step of
    n_fft float32 in and n_used complex64 out at the HBM peak over the
    span's device time; None where the program has no such counter (a
    checkout older than it) or ran no warped DFT."""
    from benchmark import harness, spans

    ctx = reader_ctx(True)
    cfg, steps = ctx["cfg"], ctx["trace"].steps
    rows = steps * 2 * 1024 * (cfg.n_known_symbols + cfg.n_data_symbols)
    device_s = steps * 0.064
    counts = {"ofdm.warped_rows": rows}
    monkeypatch.setattr(spans, "_profiling", lambda ctx: types.SimpleNamespace(
        span_totals=lambda: {"gf3x.warped_dft": {"device_s": device_s}},
        counters=lambda: counts))
    read, params = harness._reader(harness.ROOT, "warped_dft_roofline")
    got = read(dict(ctx, params=params))
    want = (100.0 * rows / steps * (4 * cfg.n_fft + 8 * cfg.n_used)
            / ctx["peaks"]["hbm_bytes_per_s"] / 0.064)
    assert got == pytest.approx(want) and 0.5 < got < 2.0
    read_ms, params_ms = harness._reader(harness.ROOT, "warped_dft.device_ms")
    assert read_ms(dict(ctx, params=params_ms)) == pytest.approx(64.0)
    del counts["ofdm.warped_rows"]
    assert read(dict(ctx, params=params)) is None
    counts["ofdm.warped_rows"] = 0
    assert read(dict(ctx, params=params)) is None


@pytest.mark.parametrize("name", SPLIT_READERS)
def test_split_rooflines_read_the_records(name, monkeypatch):
    """Each split kernel's roofline from the program's records at the
    loaded cell's configuration: its bytes for B = 1024 frames a step (in
    and out once, from the shapes) at the HBM peak over its span's device
    time; None where the program has no such span or counter (a checkout
    older than them) or ran no split tail."""
    from benchmark import harness, spans

    cell = harness.load_cell("gf3-8192-loaded.b1024-15db-room")
    ctx = dict(reader_ctx(True), cfg=harness.reference_config(cell))
    cfg, steps, B = ctx["cfg"], ctx["trace"].steps, 1024
    D, U, A = cfg.n_data_symbols, cfg.n_used, cfg.n_active_bins
    R = sum(cfg.bit_loading)
    span, counter, per_frame = {
        "eq_track_roofline": ("gf3x.eq_track", "eq_track.rows",
                              16 * D * U + 8 * U + 4 + 12 * D),
        "demap_bins_roofline": ("gf3x.demap_bins", "demap_bins.llrs",
                                4 * D * R + 8 * D * A + 8 * A + 4 * D + 8),
    }[name]
    count = steps * B * (1 if counter == "eq_track.rows" else D * R)
    counts = {counter: count}
    monkeypatch.setattr(spans, "_profiling", lambda ctx: types.SimpleNamespace(
        span_totals=lambda: {span: {"device_s": steps * 1e-3}},
        counters=lambda: counts))
    read, params = harness._reader(harness.ROOT, name)
    got = read(dict(ctx, params=params))
    want = 100.0 * B * per_frame / ctx["peaks"]["hbm_bytes_per_s"] / 1e-3
    assert got == pytest.approx(want) and 5.0 < got < 100.0
    del counts[counter]
    assert read(dict(ctx, params=params)) is None
    counts[counter] = 0
    assert read(dict(ctx, params=params)) is None


HIST_CELLS = ("gf3-8192.b1024-20db", "gf3-8192.b1024-30db",
              "gf3-8192.clock150-30db", "gf3-8192-loaded.b1024-15db-room")


@pytest.mark.parametrize("cell", HIST_CELLS)
def test_llr_hist_roofline_reads_the_records(cell, monkeypatch):
    """The histogram's roofline from the program's records in each cell
    that lists it: 4 bytes a sampled LLR and 64 a row (B = 1024 rows of
    ⌈R/8⌉ samples a step, R from the cell's configuration) at the HBM
    peak over the span's device time; None where the program has no such
    span or counter (a checkout older than them)."""
    from benchmark import harness, spans

    ctx = dict(reader_ctx(True),
               cfg=harness.reference_config(harness.load_cell(cell)))
    cfg, steps, B = ctx["cfg"], ctx["trace"].steps, 1024
    n = -(-cfg.raw_bits_per_frame // 8)
    counts = {"llr_hist.samples": steps * B * n}
    totals = {"gf3x.llr_hist": {"device_s": steps * 1e-4}}
    monkeypatch.setattr(spans, "_profiling", lambda ctx: types.SimpleNamespace(
        span_totals=lambda: totals, counters=lambda: counts))
    read, params = harness._reader(harness.ROOT, "llr_hist_roofline")
    assert params["layer"] == "diagnostics"
    got = read(dict(ctx, params=params))
    want = 100.0 * B * (4 * n + 64) / ctx["peaks"]["hbm_bytes_per_s"] / 1e-4
    assert got == pytest.approx(want) and 20.0 < got < 50.0
    del counts["llr_hist.samples"]
    assert read(dict(ctx, params=params)) is None
    counts["llr_hist.samples"] = steps * B * n
    del totals["gf3x.llr_hist"]
    assert read(dict(ctx, params=params)) is None


@pytest.mark.parametrize("rows,want", [
    ((16 * 16384, 0, 0), 100.0), ((0, 16 * 1024, 0), 0.0),
    ((24, 0, 8), 75.0), ((0, 0, 0), None), (None, None)])
def test_cut_fused_pct_reads_the_route_counters(rows, want, monkeypatch):
    """The fused cut's share of the rows cut, from the program's counters
    of the three routes (kernels 1, 6, 7) over the profiled steps; None
    where no row was cut or the program has no such counters (a checkout
    older than them)."""
    from benchmark import harness, spans

    routes = ("cut.fused_rows", "cut.group_rows", "cut.window_rows")
    counts = {"ldpc.codewords": 4}
    if rows is not None:
        counts.update(zip(routes, rows))
    monkeypatch.setattr(spans, "_profiling", lambda ctx: types.SimpleNamespace(
        span_totals=lambda: {}, counters=lambda: counts))
    read, params = harness._reader(harness.ROOT, "cut.fused_pct")
    assert params == {"layer": "cut", "source": "program_counter",
                      "unit": "%"}
    got = read(dict(reader_ctx(True), params=params))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.card
def test_device_counters_on_the_card(clean, monkeypatch):
    """Kernel 3's decode pass counts on the card: the counters equal the
    sums over the kernel's own passes, its totals, unsat and passes are
    bit for bit the same with the counter address set and null, and a
    traced `demodulate` step issues the launches an untraced one does."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from gf3x_torch.utils.device import kernel_lib

    kernel_lib()
    lam = noisy_lam(L=512).cuda()
    off = ldpc_bp.minsum_totals(lam, 96, "1/2", 20)
    with profiling.recording():
        on = ldpc_bp.minsum_totals(lam, 96, "1/2", 20)
    for a, b in zip(off, on):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    passes = on[2]
    assert 0 < int((passes > 0).sum()) < lam.shape[0]
    assert profiling.counters() == {
        "ldpc.codewords": lam.shape[0], "ldpc.queued": int((passes > 0).sum()),
        "ldpc.sweeps": int(passes.sum()), "ofdm.warped_dfts": 0,
        "ofdm.warped_rows": 0, "ofdm.czt_rows": 0,
        "ofdm.czt_fused_rows": 0, "eq_track.rows": 0, "demap_bins.llrs": 0,
        "llr_hist.samples": 0, "cut.fused_rows": 0, "cut.group_rows": 0,
        "cut.window_rows": 0}

    modem = Modem(CFG, max_delay=MARGIN + CFG.cp)
    rx = recordings(modem, 64, 4.0)
    modem.demodulate(rx)
    torch.cuda.synchronize()
    real = profiling._profiler

    def launches(traced: bool) -> int:
        if not traced:   # the profiler runs, the spans see it off
            monkeypatch.setattr(profiling, "_profiler", types.SimpleNamespace(
                _is_profiler_enabled=False))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            modem.demodulate(rx)
            torch.cuda.synchronize()
        monkeypatch.setattr(profiling, "_profiler", real)
        return sum(1 for e in prof.events() if RUNTIME.match(e.name))

    profiling.reset()
    untraced, traced = launches(False), launches(True)
    assert untraced == traced > 0
    assert profiling.span_totals()["gf3x.demodulate"]["count"] == 1
    assert profiling.counters()["ldpc.codewords"] == 64 * CFG.n_codewords
    assert profiling.counters()["cut.fused_rows"] == 64
