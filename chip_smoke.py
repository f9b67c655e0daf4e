#!/usr/bin/env python3
"""Smoke run of the gf3x_torch port on one CUDA card (an H100 for sm_90a).

Builds the ten CUDA kernels from `gf3x_torch/csrc/`, holds each against
its plain PyTorch version on the card at the shapes its path gives it, and
drives the receive paths once each through the port's entry points:

- config 5: `Modem(GF3_STANDARD, max_delay=4096 + cp).demodulate` on
  bench.py's 1024-frame batch — kernels 1 (cut), 2 (fused EQ/demap) and 3
  (LDPC), with the FEC gather (`fec_gather`) between 2 and 3, held bit for
  bit against its plain version at gf3-8192 (B = 1024, 1 and 1023, and
  timed against its bound), config 5, a row stride, the bit-loaded config
  and `interleave=False`; kernel 2 is held at QPSK, 16-QAM (gf3-fast) and
  64-QAM (gf3-turbo); the batch comes from the port's copy of bench.py's recipe
  (`gf3x_torch/bench/step.py`), so nothing of the JAX side is imported;
- the fused cut+DFT route: the same batch through
  `Modem(..., use_cut_dft=True).demodulate` — kernel 8 (cut + DFT +
  deroll) in place of kernel 1, then 2 and 3; both routes' steps are
  timed in turns;
- the clock-offset loop: `demodulate_sfo` on the same batch (kernels 1, 2
  and 3; the δ-warped DFT held at −80 dB against float64);
- bit-loaded: the config-5 workload on `GF3_STANDARD.replace(
  bit_loading=...)` with the reference's on-chip parity table — kernels 1,
  A (eq_track), B (demap_bins) and 3; on gf3-turbo the split pair is also
  held against kernel 2 and both are timed;
- gf3-longcp: `GF3_STANDARD.replace(n_fft=2048, cp=512, bin_lo=48,
  bin_hi=607)` (CP = N/4, SURVEY.md:139) on bench.py's batch recipe —
  gf3x's fused cut refuses its SC window offset, so the cut is kernel 6
  (the window cut of whole 8-row groups), then 2 (held at U = 560) and 3;
- the six frozen captures of tests/fixtures/ through `decode_stream`, and
  one of them through `decode` with sync='sc', sfo='on' and dd='on': one
  recording, so the cut is kernel 7 (the window cut gf3x takes for a batch
  that is not whole 8-row groups), held at that shape and at an odd batch
  of config 5's rows;
- HARQ: `chase_combine` of two failed GF3 receptions, and of two
  receptions at +800 ppm through `joint_clock_offset` (kernels 7, 2, 3);
  ARQ: a two-round `ArqSender`/`ArqReceiver` session at 0 dB in which
  every single decode fails; long recordings: `encode_file` transfers of
  28 frames (> 1 000 000 samples, the device frame scan) and 180 frames
  (> 8 000 000 samples, overlap-save) through `decode_stream`. Their
  recordings come from `gf3x_torch.channel`;
- the evaluation and command-line surface: the BER sweep
  (`gf3x_torch.bench.ber.ber_sweep`) of 8 SNRs × 128 trials = 1024 GF3
  frames through a room FIR and a delay in one pass (kernels 1, 2, 3),
  checked on its curve and against the same sweep on the CPU; the
  `gf3x-torch` command line through `gf3x_torch.cli.main` on the card
  (transmit → receive round trip, retransmit, info, adapt and a
  `--loading` round trip on kernels A and B, sweep, bench);
  `Modem.equalized_symbols` (kernels 7 and A); and the golden model
  (`gf3x_torch.GoldenModem`, host float64) beside the Modem on 7 dB frames;
- every pilot layout ("pilots"): config 5's batch on GF3 with its pilot
  grid offset by 4 bins (kernels 1, 2, 3), pilotless and with one pilot
  (kernel 2 without a fit), and offset and bit-loaded (kernels A, B) —
  kernels 2, A and B read the layout from tables — each kernel held
  against its plain version, 1024/1024 rows CRC-ok;
- the wide bands ("wide", WIDE_BANDS: the GF3 band at n_fft 4096, 8192
  and 16384, CP = N/4): config 5's batch recipe at gf3-4096 (QPSK, B =
  1024), gf3-8192 (64-QAM and bit-loaded, B = 1024) and gf3-16384 (64-QAM
  and bit-loaded, pilot spacing 4, B = 64) — kernels 6, 2 or A and B, and
  3; kernels 2, A and B held against their plain versions and the layout
  each picks against the forced ones (kernels 2 and A: teamed against
  `teamed_geometry`'s and `spilled_geometry`'s; B: staged against
  `streamed_geometry`'s; sha256), kernel 2 bit for bit against A + B;
  `use_cut_dft` on each band and on an aligned CP
  (kernel 8 at n_fft 4096 only) and `Modem.decode` of one gf3-4096
  recording (kernels 7, 2, 3); the ISI profile's onset kernel launched
  once in each band's `demodulate`;
  and, on each uniform band, its other routes: `demodulate_sfo` and
  `demodulate_sc` with the clock-offset loop on the batch recipe at +150
  ppm, `demodulate_dd` on the band's batch, `decode(dd='on')` and
  `decode(sync='sc', sfo='on')` of one recording, the warped DFT (the
  chirp-z transform) held to its plain versions on the host and to a
  float64 DFT at δ̂, 0 and −9e-4, and each band's `Modem(cfg)`
  construction timed;
- the ISI profile's onset kernel (`isi_onset`, `run_isi_onset`) at
  gf3-8192, B = 1024 and 1, through the loaded benchmark cell's room and
  on one-tap rows: one launch a `demodulate`, its inputs from that call
  held bit for bit against the plain version, its µs beside its bound;
- the diagnostics' |LLR| histogram kernel (`llr_hist`, `run_llr_hist`)
  on the path's own LLRs at gf3-8192 20 and 30 dB, through the loaded
  cell's room and at config 5, B = 1024 and 1, on edge values and wide
  synthetic rows: one launch a `demodulate`, counts integer-equal to the
  plain version, no aten scatter or index kernel under `gf3x.diag`, its
  µs beside its byte bound and sector floor;
- kernels 2 and A past the pilot bound of shared memory (the spilled
  layout, pilot scratch in global memory): forced at config 5 against the
  staged layout's sha256, and at a synthetic n_fft = 65536 band of 15 616
  pilots (inputs built in the frequency domain, B = 4) against their plain
  versions;
- kernels 2 and A in every candidate launch ("layouts":
  `layout_candidates`: staged, and the teamed launches of each team size
  with Ĥ through L2 or in shared memory) at config 5, the wide
  bands and the spilled band (LAYOUT_BANDS, spectra built in the frequency
  domain), each launch's outputs hashed against the picked one's and its
  µs printed — the timings the geometry's rule rests on;
- kernel 3 above z = 512 ("lifts"): bit for bit against its plain version
  at z = 520, 600, 768, 1024, 2048, 2400 and 9000 (every layout of both
  passes), and gf3-4096 at z = 768 (B = 1024) and gf3-16384 at z = 1024
  (B = 64) through `Modem.demodulate`, every row CRC-ok;
- the three evaluation reports ("reports": `gf3x_torch.bench.stress`,
  `perf_report`, `adapt_report`) through their command lines at 2 trials,
  each writing only its --out file, with the tools' tables and gf3
  closing at its top SNR;
- multi-GPU ("mesh", `gf3x_torch.parallel`): `sharded_decode` on the
  one-card mesh and on a two-shard mesh of this card against
  `Modem.demodulate`, and `sharded_pipeline_step` at 25 dB;
- the four walkthroughs of `gf3x_torch.examples` ("examples") on the card,
  each with its own assertions.

Any failed check raises, so the exit code is non-zero; there is no CPU
route.

Run from the repository root:  python3 chip_smoke.py

Kernel 2 is also held bit for bit against the split pair (kernels A + B)
at config 5 and gf3-turbo, and kernel 7's call against `torch.gather`'s in
turns at the one-recording cut. Kernel 3 (check pass, then decode pass
over the codewords that fail it) is held bit for bit on four inputs — the
20 dB codewords (nothing queued), the same codewords at σ = 0.8, a mixed
batch and the loaded path's — and at two other lifts (z = 24 and 32), and
its check pass against its own plain version; its time is read three
ways (CUDA events, the profiler, a CUDA graph). Kernel A is held at
B = 1024, 1 and 7.

Kernel 8 is also held at n_fft = 128, 1024, 2048 and 4096 on synthetic
rows (every 16-byte alignment, windows across and past `valid`, with and
without the SC window).

Two other modes time kernels 2, 3, A, B and 8 alone (`time_tree`):
`python3 chip_smoke.py --time TREE` those of the port in the checkout
TREE, and `python3 chip_smoke.py --against TREE` TREE's and this
checkout's in turns on one card, each in its own process (for a before
and after on one machine: unpack the parent commit into TREE); the outputs
of kernels 2 (config 5 and gf3-turbo), 3 (0 sweeps, σ = 0.8, mixed), A
and B (bit-loaded) must hash the same in every run, and each kernel's
profiler µs of this tree over TREE's is printed, with each tree's ptxas
report.

`--time` and `--against` also time and hash kernels 2 and A at the
bands of TREE_BANDS (gf3-4096, gf3-8192 uniform and loaded, gf3-16384 at
B = 64, the spilled band at B = 4).

A fourth, `python3 chip_smoke.py --mesh`, runs the mesh phase alone
across every card of the machine (the one-card mesh against all cards);
a fifth, `python3 chip_smoke.py --layouts`, the layouts phase alone; a
sixth, `python3 chip_smoke.py --fec-gather`, the FEC gather phase alone;
a seventh, `python3 chip_smoke.py --warped-dft`, the clock-offset route's
warped DFT, the chirp-z transform, against float64 on the card at the three
wide bands; its fused kernel at each of them at B = 1024 and 1 against its
plain version, the chain and float64, timed beside its byte bound and the
chain; the chain's two kernels against their plain versions and timed at
gf3-8192, B = 1024 (`warped_dft_only`); an eighth,
`python3 chip_smoke.py --isi-onset`, the onset phase alone
(`isi_onset_only`); a ninth, `python3 chip_smoke.py --llr-hist`, the
diagnostics' |LLR| histogram kernel alone (`llr_hist_only`).

Phases print one line each. The last lines are a JSON object with every
kernel's measurements (host-clock and CUDA-event times, the kernel's own
device time from torch.profiler, the plain version's time, the bound — the
larger of its bytes at 3.35 TB/s and its float32 operations at 67 TFLOP/s
— and the nearest single PyTorch call's time where there is one), the
card's name and power limit as nvidia-smi reports them, and
`{"ok": true, "device": {...}}`.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

B = 1024            # frames per batch (config 5)
MARGIN = 4096       # random onset headroom per recording, as in bench.py
TIMED_RUNS = 20     # median over this many synchronised runs
HBM_BPS = 3.35e12   # H100 SXM device memory rate, bytes/s
F32_FLOPS = 67e12   # H100 SXM float32 rate outside the tensor cores
# gf3-longcp: CP = N/4 at N = 2048 (SURVEY.md:139), the same band and bins
# of 21.5 Hz as GF3; defined here and in the tests only (gf3x has no preset)
LONGCP = dict(n_fft=2048, cp=512, bin_lo=48, bin_hi=607)
# the wide bands: the GF3 band (1.03-13.1 kHz) with the symbol lengthened
# for long reverb, CP = N/4, the next steps of gf3-longcp's ladder; defined
# here and in the tests only. Each is run at full width: (replace keywords,
# frames per batch); gf3-8192 and gf3-16384 also bit-loaded
# (`loading_table` over their data bins)
WIDE_BANDS = {
    "gf3-4096": dict(n_fft=4096, cp=1024, bin_lo=96, bin_hi=1215),
    "gf3-8192": dict(n_fft=8192, cp=2048, bin_lo=192, bin_hi=2431,
                     bits_per_symbol=6),
    "gf3-16384": dict(n_fft=16384, cp=4096, bin_lo=384, bin_hi=7999,
                      pilot_spacing=4, bits_per_symbol=6),
}
# the bit-loaded path's table: tools/tpu_parity.py's on-chip parity table
LOADING_SEED, LOADING_P = 5, [0.1, 0.4, 0.35, 0.15]
MINSUM_KERNELS = ["minsum_check_kernel", "minsum_decode_kernel"]
FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"

# bench.py's config-5 batch recipe: build_batch(modem, B, margin, rng) →
# (rx (B, frame_len + margin) float32, payload, delays), from this
# checkout's copy of it (gf3x_torch/bench/step.py; tests/test_torch_launch.py
# holds it equal to bench.py's). It is loaded from its file, not imported
# from the package, so that `--time TREE` builds its batches with this one
# recipe whatever TREE holds.
_STEP_SPEC = importlib.util.spec_from_file_location(
    "_chip_smoke_step",
    Path(__file__).resolve().parent / "gf3x_torch" / "bench" / "step.py")
_STEP = importlib.util.module_from_spec(_STEP_SPEC)
_STEP_SPEC.loader.exec_module(_STEP)
build_batch = _STEP.build_batch
# What the redesigns of kernels 2, 7, 3, A, 8 and B were predicted to reach
# on an H100 80GB HBM3 at 700 W, and what the designs before them measured
# there (PERF.md §6): printed beside this run's numbers
EXPECTED = {
    "fused_eq_demap": "predicted 0.04-0.08 ms device; one block per symbol "
                      "took 0.195",
    "fused_eq_demap U=560": "predicted 0.08-0.16 ms device; one block per "
                            "symbol took 0.463",
    "gather_cut": "predicted a host-clock call at or under torch.gather's; "
                  "the ctypes binding took 0.031 ms against 0.023",
    "minsum_totals": "predicted 30-45 us of kernel time at 0 sweeps and "
                     "0.35-0.6 ms at sigma 0.8, then with the syndrome in "
                     "bit words a check pass of 27-31 us and a decode pass "
                     "of 430-490 us at sigma 0.8; one block per codeword "
                     "took 121.2-121.4 us and 0.99 ms",
    "eq_track": "predicted 45-75 us of kernel time; one block per symbol "
                "took 106.5-112.1 us",
    "cut_dft": "predicted 60-100 us of kernel time (goal <= 98, half the "
               "bound); a block per symbol with nine radix-2 stages took "
               "212.7 us",
    "demap_bins": "predicted 40-60 us of kernel time (goal <= 62, half the "
                  "bound); a block per symbol took 93.4 us",
    "fec_gather": "predicted 650-800 us of kernel time at gf3-8192; aten's "
                  "index kernel and multiply took 2.9 ms, the indexed "
                  "kernel alone 2.06 at its best chunk",
}
# kernel 8 on synthetic rows at other FFT sizes: (n_fft, cp, bin_lo,
# bin_hi), each a valid GF3_STANDARD geometry (config 5's n_fft = 1024 is
# held on its path and here)
CUT_DFT_SHAPES = ((128, 32, 4, 60), (1024, 256, 24, 303),
                  (2048, 512, 48, 607), (4096, 512, 96, 1214))
# the BER sweep at full GF3 width: `gf3x-torch sweep`'s default grid
# (gf3x's) × 128 trials = 1024 frames, config 5's batch, through a room
# (seeded, rt60 20 ms, DRR 3 dB: 99.3 % of its energy inside the 256-sample
# CP) and a delay of 1000 samples; its card-against-CPU check at 4 trials
SWEEP_SNRS = (0.0, 2.0, 4.0, 6.0, 8.0, 12.0, 16.0, 20.0)
SWEEP_TRIALS, SWEEP_DELAY, SWEEP_CHECK_TRIALS = 128, 1000, 4
# the pilots phase: config 5's batch recipe on the pilot layouts that are
# not a strided grid of two or more pilots, each as GF3_STANDARD.replace
# keywords with the payload bits it carries; "loaded" takes the bit-loaded
# phase's table drawn for its 245 data bins (`loading_table`)
PILOT_LAYOUTS = (("offset 4", dict(pilot_offset=4), 4608),
                 ("pilotless", dict(pilot_spacing=0), 4608),
                 ("one pilot", dict(pilot_spacing=280), 4608),
                 ("offset 4, loaded", dict(pilot_offset=4, loaded=True), 6912))
# tests/test_observability.py's small LDPC config, whose 7 dB frame the
# golden phase decodes beside a GF3 one
OBS_CFG = dict(n_fft=256, cp=64, bin_lo=8, bin_hi=103, pilot_spacing=8,
               n_known_symbols=2, n_data_symbols=12, chirp_duration=0.02,
               fec="ldpc", ldpc_z=24, ldpc_iters=10)


def loading_table(n_bins: int) -> tuple:
    """The bit-loaded phase's table (tools/tpu_parity.py's on-chip parity
    table) for `n_bins` data bins: orders 0/2/4/6 drawn with LOADING_P from
    LOADING_SEED."""
    return tuple(int(x) for x in np.random.default_rng(LOADING_SEED).choice(
        [0, 2, 4, 6], size=n_bins, p=LOADING_P))


def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median wall time of fn() in ms, each run fenced by synchronize()."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def event_ms(fn, runs: int = 50) -> float:
    """Device time of one fn() in ms: CUDA events around `runs`
    back-to-back calls after a warm-up, divided by `runs`."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def graph_us(fn, runs: int = 50) -> float:
    """Device time of one fn() in µs from `runs` calls captured in one CUDA
    graph: the replay timed with CUDA events, so the host's issue rate
    does not enter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / runs


def kernel_us(fn, names, runs: int = 20) -> dict:
    """The device time of the kernels fn() launches whose names contain
    one of `names`, per call, in µs: the kernels' own durations from
    torch.profiler over `runs` calls after a warm-up, each kernel's mean
    duration per record times its launches per call. The profiler can
    drop records (seen as fewer records than launches); dividing by the
    records kept, not by `runs`, leaves the mean unbiased. Where the
    profiler records no device time, the CUDA-graph replay time of fn()
    instead. Returns {"us", "by": "profiler" | "graph", "per_call": the
    records kept per call, "by_name": µs per call of each name}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    tot, cnt = {}, {}
    for ev in prof.key_averages():
        for n in names:
            if n in ev.key:
                tot[n] = tot.get(n, 0.0) + float(
                    getattr(ev, "self_device_time_total", None)
                    or getattr(ev, "self_cuda_time_total", 0.0))
                cnt[n] = cnt.get(n, 0) + int(ev.count)
                break
    by_name = {n: tot[n] / cnt[n] * max(1, round(cnt[n] / runs))
               for n in tot if cnt[n] > 0 and tot[n] > 0.0}
    if by_name:
        return dict(us=sum(by_name.values()), by="profiler",
                    per_call=sum(cnt.values()) / runs, by_name=by_name)
    return dict(us=graph_us(fn), by="graph", per_call=None, by_name=None)


def issue_us(fn, runs: int = 2000) -> float:
    """Host time to issue one fn() in µs, over `runs` back-to-back calls
    with no synchronisation between them (for calls much longer than
    their kernels, the host's cost of the call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / runs


def bound(nbytes: float, flops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move over HBM_BPS and its float32 operations over
    F32_FLOPS."""
    t_b, t_o = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                bound_bytes=nbytes, bound_flops=flops)


def cut_index(q: torch.Tensor, block: int, offsets) -> torch.Tensor:
    """The int64 gather index of a window cut: row i reads
    q[i]·block + offsets, for `torch.gather` as the library yardstick."""
    return q.to(torch.int64)[:, None] * block + offsets[None, :]


def gather_call(rx: torch.Tensor, idx: torch.Tensor):
    """One `torch.gather` at a precomputed index (built, and clamped into
    the row, outside the timing): the library yardstick of a cut, which
    leaves the cut's zero tail out."""
    idx = idx.clamp(0, rx.shape[-1] - 1)
    return lambda: torch.gather(rx, 1, idx)


def timed(fn_k, fn_p, nbytes: float, flops: float = 0.0, lib=None, *,
          kernel) -> dict:
    """A kernel's row of times: host-clock ms of the kernel and its plain
    version; the kernel's device time twice — `device_ms`, CUDA events over
    50 back-to-back calls (for a body of a few µs that is the host's issue
    rate), and `kernel_us`, the body alone (the profiler's durations of the
    kernels whose names contain `kernel`, a name or a list of names, summed
    per call); the library yardstick's host-clock ms and, for a
    `torch.gather` yardstick, its kernel's µs (None where no single call
    computes the function); and the bound."""
    k_us = kernel_us(fn_k, [kernel] if isinstance(kernel, str) else kernel)
    row = dict(ms=median_ms(fn_k), plain_ms=median_ms(fn_p),
               device_ms=event_ms(fn_k), kernel_us=k_us["us"],
               kernel_us_by=k_us["by"],
               kernel_records_per_call=k_us["per_call"],
               kernel_us_by_name=k_us["by_name"],
               library_ms=None if lib is None else median_ms(lib),
               **bound(nbytes, flops))
    if lib is not None:
        row["library_kernel_us"] = kernel_us(lib, ["gather"])["us"]
    return row


def tail_timed(cfg, fn_k, fn_p, Y) -> dict:
    """`timed` for a uniform EQ/demap tail (kernel 2): the bound counts the
    data symbols' spectra, Ĥ and the noise floor in, the LLRs, slope and
    cpe per data symbol and evm and mean |llr| per frame out, and 14
    operations per data cell (EQ, derotation and the demap's products); no
    single call computes it."""
    Bk, D, U = Y.shape[0], cfg.n_data_symbols, cfg.n_used
    nbytes = (8 * Bk * D * U + 8 * Bk * U + 4 * Bk
              + 4 * Bk * cfg.raw_bits_per_frame + 4 * 2 * Bk * D + 4 * 2 * Bk)
    return timed(fn_k, fn_p, nbytes, 14.0 * Bk * D * U,
                 kernel="fused_eq_demap")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| relative to the mean magnitude of b."""
    return float((a - b).abs().max() / b.abs().mean())


def build_report(log: str) -> str:
    """ptxas's registers / stack / spills per kernel, from the build log."""
    out, name, stack = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            full = ln.split("'")[1]
            name = max((short for short in (
                "cut_symbols", "gather_cut", "gather_cut_group", "cut_dft",
                "fused_eq_demap", "fused_eq_demap_team", "eq_track",
                "eq_track_team", "demap_bins", "minsum")
                if short in full), key=len, default=full)
            # the template arguments of the instantiation, mangled
            args = full.split("_kernel", 1)[-1].split("Ev", 1)[0]
            if args.startswith("I"):
                name += args
        elif "stack frame" in ln:
            stack = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append(f"{name}: {ln.split('Used ')[-1]}; {stack}")
    return " | ".join(out)


def path_inputs(modem, rx):
    """The path's sync, cut plan (q, roll, kernel 1's keywords) and
    post-estimate tensors for one batch."""
    from gf3x_torch.ops import sync
    from gf3x_torch.ops.kernels import gather_cut

    cfg = modem.cfg
    start, _ = sync.find_frame_start(cfg, rx, modem.chirp,
                                     search_len=modem.max_delay, decimate=2)
    base, S, sc_off = modem._cut_geom(rx, start)
    geo = dict(S=S, n_fft=cfg.n_fft, sym_len=cfg.symbol_len,
               sc_off=sc_off, body_off=cfg.sc_len, block=modem._cut_block)
    q, valid, roll = sync.cut_plan(rx.shape[-1], base, **geo)
    kw = dict(geo, cp=cfg.cp, valid=valid)
    syms, _ = gather_cut.cut_symbols(rx, q, **kw)
    Y, H, nv, _, _ = modem._estimate(syms, roll)
    return q, roll, kw, syms, Y, H, nv


def hold_fused(cfg, Y, H, nv, pv, label):
    """Kernel 2 against its plain version: hard decisions equal, |ΔLLR| ≤
    2e-4·mean|LLR|, slope/cpe ≤ 1e-4 rad, evm and mean|llr| ≤ 1e-4 rel.
    Returns (kernel outputs, max |ΔLLR|, mean |LLR|)."""
    from gf3x_torch.ops.kernels import fused_eq

    out_k = fused_eq.fused_eq_demap(cfg, Y, H, nv, pv)
    out_p = fused_eq.fused_eq_demap_plain(cfg, Y, H, nv, pv)
    err, scale = hold_tail(out_k, out_p, f"fused_eq_demap {label}")
    return out_k, err, scale


def hold_eq_track(cfg, Y, H, nv, pv, label):
    """Kernel A against its plain version: slope and cpe within 1e-4 rad,
    eq and nv_sym within 1e-4 of their mean magnitude. Returns the
    kernel's outputs."""
    from gf3x_torch.ops.kernels import split_eq

    a_k = split_eq.eq_track(cfg, Y, H, nv, pv)
    a_p = split_eq.eq_track_plain(cfg, Y, H, nv, pv)
    d_slope = float((a_k[1] - a_p[1]).abs().max())
    d_cpe = float((a_k[2] - a_p[2]).abs().max())
    d_eq, d_nv = rel_err(a_k[0], a_p[0]), rel_err(a_k[3], a_p[3])
    check(d_slope <= 1e-4 and d_cpe <= 1e-4, f"eq_track {label}: slope/cpe "
          f"differ by {d_slope}/{d_cpe} rad")
    check(d_eq <= 1e-4 and d_nv <= 1e-4, f"eq_track {label}: eq/nv_sym "
          f"differ by {d_eq}/{d_nv} of their mean magnitude")
    print(f"eq_track {label}: slope/cpe within {max(d_slope, d_cpe):.3g} "
          f"rad, eq {d_eq:.3g} and nv_sym {d_nv:.3g} of mean magnitude",
          flush=True)
    return a_k


def hold_split(modem, Y, H, nv, out_k, label):
    """Kernel 2's outputs `out_k` against the split pair (kernels A + B,
    `Modem._split_eq_demap`) on the same inputs: llr, slope and cpe
    bit-identical (the two share their device code), evm and mean |llr|
    within 1e-4 relative (summed in another order). Returns that largest
    relative difference."""
    split = modem._split_eq_demap(Y, H, nv)
    for i, name in ((0, "llr"), (1, "slope"), (2, "cpe")):
        check(torch.equal(out_k[i], split[i]), f"{label}: kernel 2's {name} "
              "is not bit-identical to the split pair's")
    rel = max(float(((a - b).abs() / b.abs()).max())
              for a, b in zip(out_k[3:], split[3:]))
    check(rel <= 1e-4, f"{label}: evm or mean|llr| differ from the split "
          f"pair's by {rel} rel")
    return rel


def hold_demap(cfg, eq, H, nv_sym, tables, label):
    """Kernel B against its plain version on kernel A's output: hard
    decisions equal, |ΔLLR| ≤ 2e-4·mean|LLR|, evm and mean|llr| ≤ 1e-4
    rel. Returns (the kernel's outputs, max |ΔLLR|, mean |LLR|)."""
    from gf3x_torch.ops.kernels import split_eq

    b_k = split_eq.demap_bins(cfg, eq, H, nv_sym, tables)
    b_p = split_eq.demap_bins_plain(cfg, eq, H, nv_sym)
    scale = float(b_p[0].abs().mean())
    err = float((b_k[0] - b_p[0]).abs().max())
    check(same_decisions(b_k[0], b_p[0], f"demap_bins {label}"),
          f"demap_bins {label}: hard decisions differ from its plain version")
    check(err <= 2e-4 * scale, f"demap_bins {label}: LLR error {err} > 2e-4 "
          f"x mean|LLR| {scale}")
    for i, name in ((1, "evm"), (2, "mean|llr|")):
        d = float(((b_k[i] - b_p[i]).abs() / b_p[i].abs()).max())
        check(d <= 1e-4, f"demap_bins {label}: {name} differs by {d} rel")
    return b_k, err, scale


def hold_tail(out_k, out_p, what):
    """(llr, slope, cpe, evm, mabs) of two tails against each other, to
    the bounds of `hold_fused`; returns (max |ΔLLR|, mean |LLR|)."""
    llr_k, llr_p = out_k[0], out_p[0]
    scale = float(llr_p.abs().mean())
    err = float((llr_k - llr_p).abs().max())
    check(same_decisions(llr_k, llr_p, what), f"{what}: hard decisions differ")
    check(err <= 2e-4 * scale, f"{what}: LLR error {err} > 2e-4 x mean|LLR| "
          f"{scale}")
    for i, name in ((1, "slope"), (2, "cpe")):
        d = float((out_k[i] - out_p[i]).abs().max())
        check(d <= 1e-4, f"{what}: {name} differs by {d} rad")
    for i, name in ((3, "evm"), (4, "mean|llr|")):
        d = float(((out_k[i] - out_p[i]).abs() / out_p[i].abs()).max())
        check(d <= 1e-4, f"{what}: {name} differs by {d} rel")
    return err, scale


# per held output, the plain LLRs of exactly 0 on which the kernel's LLR is
# negative: ties `same_decisions` lets pass, printed in the kernels line
DECISION_TIES: dict = {}


def same_decisions(llr_k: torch.Tensor, llr_p: torch.Tensor,
                   what: str) -> bool:
    """Whether a kernel's LLRs make the plain version's hard decisions
    (llr < 0) wherever the plain LLR is not exactly 0. A 0 is a tie, which
    decides nothing; the soft bound still holds there. Ties the kernel
    breaks the other way are counted in DECISION_TIES."""
    tie = llr_p == 0
    broken = int(((llr_k < 0) & tie).sum())
    if broken:
        DECISION_TIES[what] = broken
        print(f"{what}: {broken} plain LLR(s) of exactly 0 where the kernel's "
              "is negative (ties, within the soft bound)", flush=True)
    return torch.equal((llr_k < 0) | tie, (llr_p < 0) | tie)


def hold_minsum(code, lam, iters, label) -> dict:
    """Kernel 3 (`LdpcCode.decode_totals`: check pass, then decode pass)
    against its plain version on one input: totals, unsat and passes
    bit-identical; and the check pass alone against `minsum_check_plain`:
    unsat mask equal, totals equal to lam. Both passes must launch. Returns
    the codewords the check pass queued and the plain decode's passes and
    unsat counts."""
    from gf3x_torch.ops.kernels import ldpc_bp

    out_k, counts = launch_counts(
        {"check": ldpc_bp.minsum_check, "decode": ldpc_bp.minsum_decode},
        lambda: code.decode_totals(lam, iters))
    out_p = ldpc_bp.minsum_totals_plain(lam, code.z, code.rate, iters)
    for a, b, name in zip(out_k, out_p, ("totals", "unsat", "passes")):
        check(torch.equal(a, b), f"minsum_totals {name} differ from its "
              f"plain version on {label}")
    check(counts["check"] == 1 and counts["decode"] == 1,
          f"minsum_totals on {label}: pass launches {counts}")
    bad_k, tot_k = ldpc_bp.minsum_check(lam, code.z, code.rate)
    bad_p, _ = ldpc_bp.minsum_check_plain(lam, code.z, code.rate)
    check(torch.equal(bad_k, bad_p) and torch.equal(tot_k, lam),
          f"minsum_check differs from its plain version on {label}")
    held = dict(queued=int(bad_p.sum()) if iters > 0 else 0,
                passes_sum=int(out_p[2].sum()), passes_max=int(out_p[2].max()),
                unsat=int(out_p[1].sum()), pass_launches=counts)
    print(f"minsum_totals on {label}: totals, unsat and passes bit-identical "
          f"over {lam.shape[0]} codewords, check pass's mask equal; {held}",
          flush=True)
    return held


def launch_counters() -> dict:
    """Every kernel wrapper by name, each with its `launches` count."""
    from gf3x_torch.ops.kernels import (cut_dft, czt, fec_gather, fused_eq,
                                        gather_cut, isi_onset, ldpc_bp,
                                        llr_hist, split_eq)

    return {"cut_symbols": gather_cut.cut_symbols,
            "gather_cut": gather_cut.gather_cut,
            "gather_cut_group": gather_cut.gather_cut_group,
            "fused_eq_demap": fused_eq.fused_eq_demap,
            "eq_track": split_eq.eq_track,
            "demap_bins": split_eq.demap_bins,
            "minsum_totals": ldpc_bp.minsum_totals,
            "minsum_check": ldpc_bp.minsum_check,
            "minsum_decode": ldpc_bp.minsum_decode,
            "cut_dft": cut_dft.cut_dft,
            "fec_gather": fec_gather.fec_gather,
            "czt_pre": czt.czt_pre, "czt_post": czt.czt_post,
            "czt_fused": czt.czt_fused,
            "isi_onset": isi_onset.isi_onset,
            "llr_hist": llr_hist.llr_hist}


def launch_counts(counters, fn):
    """Run fn() with every launch counter at 0; (its result, the counts)."""
    for k in counters.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in counters.items()}


def in_turns(fns: dict, blocks: int = 8, runs: int = 10):
    """Step time of each fn timed in turns within this call (a, b, then
    b, a, ...): blocks of `runs` synchronised calls; returns ({name:
    median of its block medians}, {name: block medians})."""
    names = list(fns)
    meds = {n: [] for n in names}
    for b in range(blocks):
        for n in (names if b % 2 == 0 else names[::-1]):
            meds[n].append(median_ms(fns[n], runs))
    return {n: float(np.median(v)) for n, v in meds.items()}, meds


def run_path(modem, rx, payload, delays, counters, label, entry=None,
             entry_kw=None, sync_tol=None):
    """Drive one entry point (default `modem.demodulate`, with `entry_kw`)
    once with every launch counter at 0 and check it: every row CRC-ok with
    the planted payload, every codeword satisfied, finite diagnostics, sync
    within `sync_tol` (default cp/4), and the first 4 rows decoded the same
    on the CPU (plain versions). Returns (launch counts, bits, diag, sync
    error)."""
    from gf3x_torch import Modem

    cfg = modem.cfg
    entry = entry or "demodulate"
    entry_kw = entry_kw or {}
    sync_tol = cfg.cp // 4 if sync_tol is None else sync_tol
    (bits, diag), launches = launch_counts(
        counters, lambda: getattr(modem, entry)(rx, **entry_kw))
    bits_np = bits.cpu().numpy()
    check(bits_np.shape == (rx.shape[0], cfg.payload_bits_per_frame),
          f"{label}: bits shape")
    for i in range(rx.shape[0]):
        res = modem._result(bits_np[i], None)
        check(res.crc_ok and res.payload == payload,
              f"{label}: row {i} did not decode to the planted payload")
    # SC timing has no chirp metric: its sync_metric is NaN, as gf3x's
    for name in ("sync_metric", "sc_metric", "H", "noise_var", "pilot_slope",
                 "common_phase", "evm", "mean_abs_llr", "clock_ppm",
                 "isi_var", "isi_db"):
        if name == "sync_metric" and entry == "demodulate_sc":
            continue
        check(bool(torch.isfinite(getattr(diag, name)).all()),
              f"{label}: diag.{name} is not finite")
    check(int(diag.fec_unsat.sum()) == 0, f"{label}: codewords left "
          "unsatisfied")
    sync_err = int((diag.sync_start.cpu() - torch.as_tensor(delays)).abs()
                   .max())
    check(sync_err <= sync_tol, f"{label}: sync off by {sync_err} samples")
    cpu = Modem(cfg, max_delay=MARGIN + cfg.cp, device="cpu",
                use_cut_dft=modem.use_cut_dft)
    bits_cpu, _ = getattr(cpu, entry)(rx[:4].cpu(), **entry_kw)
    check(torch.equal(bits_cpu, bits[:4].cpu()),
          f"{label}: card and CPU decodes of the first rows differ")
    return launches, bits, diag, sync_err


# the FEC gather phase's cases: (label, GF3_STANDARD.replace keywords,
# frames); "loaded" takes the bit-loaded phase's table for the config's data
# bins, "row stride" feeds the kernel rows of a wider tensor
FEC_GATHER_CASES = (
    ("gf3-8192", WIDE_BANDS["gf3-8192"], B),
    ("gf3-8192 B = 1", WIDE_BANDS["gf3-8192"], 1),
    ("gf3-8192 B = 1023", WIDE_BANDS["gf3-8192"], B - 1),
    ("config 5", {}, B),
    ("config 5, row stride", {}, B),
    ("bit-loaded", dict(loaded=True), B),
    ("interleave=False", dict(interleave=False), B),
)


def run_fec_gather(dev) -> dict:
    """The FEC gather (`fec_gather`) against its plain version with
    torch.equal on random LLRs (B, raw_bits) through each case's Modem
    tables (FEC_GATHER_CASES), on both kernels: the tiled one, on the axes
    the Modem names (every interleaved case; `_codeword_llrs` takes it),
    and the indexed one (the table alone). At gf3-8192, B = 1024 (the
    benchmark's shape) the Modem's route is timed beside the bound (each
    used LLR read and written once, the int32 table and the sign bytes read
    once), the indexed kernel and the plain version's kernels. Returns the
    kernel's row."""
    from gf3x_torch import GF3_STANDARD, Modem
    from gf3x_torch.ops.kernels import fec_gather as fg

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(17)
    held, row = {}, None
    for label, kw, Bk in FEC_GATHER_CASES:
        kw = dict(kw)
        if kw.pop("loaded", False):
            kw["bit_loading"] = loading_table(
                GF3_STANDARD.replace(**kw).n_data_bins)
        cfg = GF3_STANDARD.replace(**kw)
        modem = Modem(cfg, device=dev)
        idx, scr = modem.codeword_index, modem.scramble
        R, used = cfg.raw_bits_per_frame, idx.numel()
        pad = 4 if "stride" in label else 0
        llr = torch.randn(Bk, R + pad, generator=gen, device=dev)[:, :R]
        axes = modem._fec_axes
        check((axes is not None) == cfg.interleave,
              f"fec_gather {label}: the Modem names axes {axes}")
        want = fg.fec_gather_plain(llr, idx, scr)
        before = fg.fec_gather.launches
        for route in (axes, None):
            got = fg.fec_gather(llr, idx, scr, route)
            torch.cuda.synchronize()
            check(got.shape == (Bk, used) and torch.equal(got, want),
                  f"fec_gather {label}, axes {route}: the kernel differs "
                  "from its plain version")
        check(torch.equal(modem._codeword_llrs(llr),
                          want.reshape(-1, cfg.ldpc_n))
              and fg.fec_gather.launches == before + 3,
              f"fec_gather {label}: _codeword_llrs differs or launched "
              f"{fg.fec_gather.launches - before} kernels in 3 calls")
        chunk = fg.fec_gather_chunk(Bk, used, sms)
        tiles = (None if axes is None else
                 (fg.TILE_A, fg.fec_gather_tiles(Bk, axes, sms)))
        held[label] = dict(B=Bk, raw_bits=R, used=used, axes=axes,
                           tiles=tiles, chunk=chunk)
        print(f"fec_gather {label} ({Bk} x {R} -> {Bk} x {used}; axes "
              f"{axes}, tiles {tiles}; indexed chunk {chunk}): both kernels "
              "equal to the plain version", flush=True)
        if label == "gf3-8192":
            row = dict(
                name="fec_gather", route="cuda",
                source="gf3x_torch/csrc/fec_gather.cu",
                replaces="none (gf3x: XLA gather and multiply, "
                         "gf3x/models/modem.py:332-369)", max_abs_err=0.0,
                **timed(lambda: fg.fec_gather(llr, idx, scr, axes),
                        lambda: fg.fec_gather_plain(llr, idx, scr),
                        8 * Bk * used + 5 * used, kernel="fec_gather"))
            row["indexed_kernel_us"] = kernel_us(
                lambda: fg.fec_gather(llr, idx, scr), ["fec_gather"])["us"]
            row["plain_kernel"] = kernel_us(
                lambda: fg.fec_gather_plain(llr, idx, scr),
                ["index_elementwise_kernel", "elementwise_kernel"])
            print(f"fec_gather at gf3-8192, B = {Bk}: kernel "
                  f"{row['kernel_us']:.1f} us ({row['kernel_us_by_name']}) "
                  f"against the bound {1e3 * row['bound_ms']:.1f} us "
                  f"({row['bound_bytes'] / 1e9:.3f} GB; "
                  f"{row['kernel_us'] / (1e3 * row['bound_ms']):.2f}x); "
                  f"device {row['device_ms']:.4f} ms; the indexed kernel "
                  f"{row['indexed_kernel_us']:.1f} us; plain version's "
                  f"kernels {row['plain_kernel']['us']:.1f} us "
                  f"{row['plain_kernel']['by_name']}; host {row['ms']:.3f} "
                  f"ms vs plain {row['plain_ms']:.3f} ms "
                  f"({EXPECTED['fec_gather']})", flush=True)
        del modem, llr, got, want
    row["held"] = held
    return row


def fec_gather_only() -> None:
    """`--fec-gather`: the FEC gather phase alone after the build's ptxas
    report; prints its row as one JSON line and the card's name and power
    limit."""
    from gf3x_torch.utils.device import kernel_lib, library_path

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    kernel_lib()
    print("build: " + build_report(
        (library_path().parent / "build.log").read_text()), flush=True)
    record("fec_gather", run_fec_gather(torch.device("cuda", 0)),
           print_too=True)
    print(smi, flush=True)


def run_captures(dev, counters):
    """The six frozen captures of tests/fixtures/ through the port's
    `decode_stream` on the card, each to its manifest sha256. Returns (the
    launch counts summed over the captures, seconds per capture)."""
    from gf3x_torch import Modem
    from gf3x_torch.io import read_wav
    from gf3x_torch.models.stream import decode_stream
    from gf3x_torch.utils.captures import capture_config

    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    total = {name: 0 for name in counters}
    secs = {}
    for cap in manifest["captures"]:
        rx, _ = read_wav(FIXTURES / cap["wav"])
        modem = Modem(capture_config(cap), device=dev)
        t0 = time.perf_counter()
        res, launches = launch_counts(counters,
                                      lambda: decode_stream(modem, rx))
        secs[cap["wav"]] = time.perf_counter() - t0
        check(res.complete and res.starts.size == cap["n_frames"]
              and res.filename == cap["filename"]
              and hashlib.sha256(res.payload).hexdigest()
              == cap["payload_sha256"],
              f"capture {cap['wav']}: not decoded to its manifest sha256")
        for name in total:
            total[name] += launches[name]
        print(f"capture {cap['wav']}: {cap['n_frames']} frame(s), sha256 "
              f"ok, clock_ppm "
              f"{[round(float(f.diag.clock_ppm), 1) for f in res.frames]}, "
              f"launches {launches}; {secs[cap['wav']]:.2f} s", flush=True)
    for name in ("fused_eq_demap", "eq_track", "demap_bins", "minsum_totals"):
        check(total[name] > 0, f"captures: {name} did not launch")
    return total, secs


def hold_gather_cut(rx, q, nb, block, valid):
    """Kernel 7 against its plain version on one input: the windows equal.
    Returns `timed`'s dict with max_abs_err."""
    from gf3x_torch.ops.kernels import gather_cut

    win_k = gather_cut.gather_cut(rx, q, nb, block, valid)
    win_p = gather_cut.gather_cut_plain(rx, q, nb, block, valid)
    check(torch.equal(win_k, win_p), f"gather_cut kernel differs from its "
          f"plain version at {tuple(rx.shape)}")
    L = nb * block
    return dict(max_abs_err=float((win_k - win_p).abs().max()), **timed(
        lambda: gather_cut.gather_cut(rx, q, nb, block, valid),
        lambda: gather_cut.gather_cut_plain(rx, q, nb, block, valid),
        2 * rx.shape[0] * L * 4 + q.numel() * 4,
        lib=gather_call(rx, cut_index(q, block, torch.arange(
            L, device=rx.device))), kernel="gather_cut_kernel"))


def hold_cut_dft_shapes(dev, rows: int = 8, S: int = 24) -> dict:
    """Kernel 8 against its plain version on synthetic rows at each of
    CUT_DFT_SHAPES, with the SC window (sc_off >= 0) and without: T odd, so
    the rows' windows start on every 16-byte alignment; q in 0..4 blocks
    and valid = T − sym_len − block, so some windows cross `valid` and some
    lie past it. Spectra within 1e-5 of their mean magnitude, −80 dB
    against a float64 DFT of kernel 1's cut, and the SC window equal to
    kernel 1's. Returns {n_fft: {sc_off: (max |ΔY| / mean |Y|, dB)}}."""
    from gf3x_torch import GF3_STANDARD
    from gf3x_torch.ops.kernels import cut_dft, gather_cut

    out = {}
    for n_fft, cp, lo, hi in CUT_DFT_SHAPES:
        cfg = GF3_STANDARD.replace(n_fft=n_fft, cp=cp, bin_lo=lo, bin_hi=hi,
                                   fec="none")
        block, body_off = 128, cfg.sc_len + 3
        T = body_off + S * cfg.symbol_len + 4 * block + 1
        T += 1 - T % 2
        rng = np.random.default_rng(n_fft)
        rx = torch.as_tensor(rng.standard_normal((rows, T)).astype(
            np.float32), device=dev)
        q = torch.as_tensor(np.arange(rows) % 5, dtype=torch.int32,
                            device=dev)
        roll = torch.as_tensor(rng.integers(0, block, rows), dtype=torch.int32,
                               device=dev)
        valid = T - cfg.symbol_len - block
        k = np.arange(lo, hi + 1)
        ramp = np.exp(2j * np.pi * k * roll.cpu().numpy()[:, None, None]
                      / n_fft)
        out[n_fft] = {}
        for sc_off in (cp + cp // 4 + 64, -1):
            kw = dict(valid=valid, block=block, S=S, body_off=body_off,
                      sc_off=sc_off)
            Yk, sk = cut_dft.cut_dft(cfg, rx, q, roll, **kw)
            Yp, _ = cut_dft.cut_dft_plain(cfg, rx, q, roll, **kw)
            rel = float((Yk - Yp).abs().max() / Yp.abs().mean())
            syms, s1 = gather_cut.cut_symbols(
                rx, q, n_fft=n_fft, sym_len=cfg.symbol_len, cp=cp, **kw)
            ref = (np.fft.rfft(syms.cpu().numpy().astype(np.float64))
                   [..., lo: hi + 1] / cfg.ofdm_scale * ramp)
            got = Yk.cpu().numpy().astype(np.complex128)
            db = 10 * np.log10(np.sum(np.abs(got - ref) ** 2)
                               / np.sum(np.abs(ref) ** 2))
            what = f"cut_dft n_fft {n_fft}, sc_off {sc_off}"
            check(rel <= 1e-5, f"{what}: spectra differ from the plain "
                  f"version by {rel} of their mean magnitude")
            check(db <= -80.0, f"{what}: {db:.1f} dB > -80 dB")
            check(sk is None if sc_off < 0 else torch.equal(sk, s1),
                  f"{what}: SC window differs from kernel 1's")
            out[n_fft][sc_off] = (rel, float(db))
        print(f"cut_dft on {rows} synthetic rows at n_fft {n_fft} "
              f"({cut_dft.cut_dft_geometry(n_fft, S + 1)}): (max |dY| "
              f"/ mean |Y|, dB vs float64) by sc_off {out[n_fft]}; SC window "
              "equal to kernel 1's", flush=True)
    return out


def run_routes(dev, counters):
    """`decode` of gf3_single_room.wav with sync='sc', sfo='on' and
    dd='on' on the card: each CRC-ok with the capture's payload, kernels
    7, 2 and 3 launched on each route and kernel 1 not (one recording cuts
    with kernel 7, as gf3x's `cut_symbols` does). Kernel 7 is held first at
    the cut this recording gives it. Returns (the launch counts summed over
    the three, and kernel 7's row at this cut — `hold_gather_cut`'s dict
    with kernel 1's ms on the same cut)."""
    from gf3x_torch import GF3_STANDARD, Modem
    from gf3x_torch.io import read_wav
    from gf3x_torch.ops import sync
    from gf3x_torch.ops.kernels import gather_cut

    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    cap = next(c for c in manifest["captures"]
               if c["wav"] == "gf3_single_room.wav")
    rx, _ = read_wav(FIXTURES / cap["wav"])
    modem = Modem(GF3_STANDARD, device=dev)
    cfg, block = modem.cfg, modem._cut_block
    x = torch.as_tensor(np.asarray(rx, dtype=np.float32), device=dev)
    base, S, sc_off = modem._cut_geom(x, modem._sync(x)[0])
    geo = dict(S=S, n_fft=cfg.n_fft, sym_len=cfg.symbol_len, sc_off=sc_off,
               body_off=cfg.sc_len)
    q, valid, _ = sync.cut_plan(x.shape[-1], base, block=block, **geo)
    nb = gather_cut.window_blocks(block, S, cfg.n_fft, cfg.sc_len,
                                  cfg.symbol_len, sc_off)
    x2, q = x.reshape(1, -1), q.contiguous()
    held = hold_gather_cut(x2, q, nb, block, valid)
    # the call against torch.gather's, in turns: at this size both are the
    # host's issue of one launch and a few µs of kernel
    turns, _ = in_turns({
        "gather_cut": lambda: gather_cut.gather_cut(x2, q, nb, block, valid),
        "torch_gather": gather_call(x2, cut_index(q, block, torch.arange(
            nb * block, device=x.device)))}, blocks=16, runs=100)
    # where the call's host time goes: the whole call, torch.gather's, the
    # output's allocation and the entry alone (conversion and CUDA launch)
    from gf3x_torch.utils import device

    L = nb * block
    win = torch.empty(1, L, device=x.device)
    entry = device._ENTRIES["gf3x_gather_cut"]
    stream = torch.cuda.current_stream().cuda_stream
    pieces = {
        "call": lambda: gather_cut.gather_cut(x2, q, nb, block, valid),
        "torch_gather": gather_call(x2, cut_index(q, block, torch.arange(
            L, device=x.device))),
        "allocation": lambda: x2.new_empty(1, L),
        "entry": lambda: entry(x2.data_ptr(), q.data_ptr(), win.data_ptr(),
                               1, x2.shape[1], valid, L, block, stream,
                               x.device.index)}
    call_us = {name: issue_us(fn) for name, fn in pieces.items()}
    # what the B % 8 route costs against kernel 1 on the same cut
    k1_ms = median_ms(lambda: gather_cut.cut_symbols(
        x2, q, valid=valid, block=block, cp=cfg.cp, **geo))
    print(f"gather_cut at decode's cut of {cap['wav']} (1 x {x.shape[-1]} "
          f"-> 1 x {nb * block}): equal; {held['ms']:.3f} ms vs plain "
          f"{held['plain_ms']:.3f} ms; in turns (16 blocks of 100 calls) "
          f"{turns['gather_cut']:.4f} ms vs torch.gather "
          f"{turns['torch_gather']:.4f} ms; kernel {held['kernel_us']:.2f} us"
          f" vs torch.gather's {held['library_kernel_us']:.2f} us; device_ms "
          f"(issue-bound) {held['device_ms']:.4f}; host issue us per call "
          f"{ {k: round(v, 2) for k, v in call_us.items()} }; kernel 1 on the "
          f"same cut {k1_ms:.3f} ms ({EXPECTED['gather_cut']})", flush=True)
    total = {name: 0 for name in counters}
    for kw in (dict(sync="sc"), dict(sfo="on"), dict(dd="on")):
        res, launches = launch_counts(counters,
                                      lambda: modem.decode(rx, **kw))
        check(res.crc_ok and hashlib.sha256(res.payload).hexdigest()
              == cap["payload_sha256"], f"decode {kw}: not CRC-ok")
        for name in ("gather_cut", "fused_eq_demap", "minsum_totals"):
            check(launches[name] > 0, f"decode {kw}: {name} did not launch")
        check(launches["cut_symbols"] == 0, f"decode {kw}: kernel 1 "
              "launched on one recording")
        for name in total:
            total[name] += launches[name]
        print(f"decode {kw} of {cap['wav']}: CRC-ok, sync_start "
              f"{int(res.diag.sync_start)}, clock_ppm "
              f"{float(res.diag.clock_ppm):.2f}, launches {launches}",
              flush=True)
    return total, dict(held, kernel1_same_cut_ms=k1_ms, turns_ms=turns,
                       issue_us=call_us)


def run_longcp(dev, counters, rows):
    """gf3-longcp on bench.py's batch recipe (1024 × 79 121): kernel 6 held
    against its plain version at the path's cut (exactly equal) and timed
    beside kernel 1 on the same cut; the strided symbol view the cut hands
    cuFFT timed against a contiguous copy; kernel 2 held at U = 560; then
    `demodulate` once with every counter at 0 — 1024/1024 CRC-ok, kernels
    6, 2 and 3 launched, 1 and 7 not — and its step timed. Adds kernel 6's
    row and kernel 2's U = 560 times to `rows`; returns (launch counts,
    step ms, the DFT's view and copy ms)."""
    from gf3x_torch import GF3_STANDARD, Modem
    from gf3x_torch.ops.kernels import fused_eq, gather_cut
    from gf3x_torch.ops.ofdm import ofdm_dft

    cfg = GF3_STANDARD.replace(**LONGCP)
    modem = Modem(cfg, max_delay=MARGIN + cfg.cp, device=dev)
    rx_np, payload, delays = build_batch(modem, B, MARGIN,
                                         np.random.default_rng(0))
    rx = torch.as_tensor(rx_np, device=dev)
    del rx_np
    check(modem._fused_cut_refuses(rx.shape[-1]), "gf3-longcp: gf3x's fused "
          "cut must refuse this geometry")
    q, _, kw, _, Y, H, nv = path_inputs(modem, rx)
    blk = kw["block"]
    geo = {k: kw[k] for k in ("S", "n_fft", "body_off", "sym_len", "sc_off")}
    nb = gather_cut.group_blocks(blk, **geo)
    L = nb * blk
    win_k = gather_cut.gather_cut_group(rx, q, nb, blk)
    win_p = gather_cut.gather_cut_group_plain(rx, q, nb, blk)
    check(torch.equal(win_k, win_p), f"gather_cut_group kernel differs from "
          f"its plain version at {tuple(rx.shape)} -> {tuple(win_k.shape)}")
    rows["gather_cut_group"] = dict(
        name="gather_cut_group", route="cuda",
        source="gf3x_torch/csrc/gather_cut_group.cu",
        replaces="gf3x/ops/pallas/gather_cut.py:95",
        max_abs_err=float((win_k - win_p).abs().max()),
        **timed(lambda: gather_cut.gather_cut_group(rx, q, nb, blk),
                lambda: gather_cut.gather_cut_group_plain(rx, q, nb, blk),
                2 * 4 * B * L + 4 * B,
                lib=gather_call(rx, cut_index(q, blk, torch.arange(
                    L, device=dev))), kernel="gather_cut_group_kernel"),
        kernel1_same_cut_ms=median_ms(
            lambda: gather_cut.cut_symbols(rx, q, **kw)),
        kernel1_same_cut_device_ms=event_ms(
            lambda: gather_cut.cut_symbols(rx, q, **kw)))
    r6 = rows["gather_cut_group"]
    syms, _ = gather_cut.window_symbols(win_k, cp=cfg.cp, **geo)
    dft = dict(view_ms=median_ms(lambda: ofdm_dft(cfg, syms)),
               contiguous_ms=median_ms(lambda: ofdm_dft(cfg,
                                                        syms.contiguous())))
    print(f"gather_cut_group at gf3-longcp's cut ({B} x {rx.shape[-1]} -> "
          f"{B} x {L}): equal; {r6['ms']:.3f} ms (device "
          f"{r6['device_ms']:.3f}, bound {r6['bound_ms']:.3f}) vs plain "
          f"{r6['plain_ms']:.3f} ms, torch.gather {r6['library_ms']:.3f} ms; "
          f"kernel 1 on the same cut {r6['kernel1_same_cut_ms']:.3f} ms "
          f"(device {r6['kernel1_same_cut_device_ms']:.3f}); DFT of the "
          f"strided symbol view {dft['view_ms']:.3f} ms, of a contiguous "
          f"copy {dft['contiguous_ms']:.3f} ms", flush=True)
    del win_k, win_p, syms
    pv = modem.pilot_vals
    _, err, scale = hold_fused(cfg, Y, H, nv, pv, "U = 560")
    u560 = tail_timed(cfg, lambda: fused_eq.fused_eq_demap(cfg, Y, H, nv, pv),
                      lambda: fused_eq.fused_eq_demap_plain(cfg, Y, H, nv,
                                                            pv), Y)
    rows["fused_eq_demap"]["longcp"] = dict(u560, max_abs_err=err)
    print(f"fused_eq_demap at U = {cfg.n_used} ({cfg.n_used // 8} pilots): "
          f"hard decisions equal, max |dLLR| {err:.3g} (mean |LLR| "
          f"{scale:.3g}); {u560['ms']:.3f} ms vs plain {u560['plain_ms']:.3f}"
          f" ms; device {u560['device_ms']:.4f} ms, kernel "
          f"{u560['kernel_us']:.1f} us, bound {u560['bound_ms']:.4f} ms "
          f"({EXPECTED['fused_eq_demap U=560']})", flush=True)
    del Y, H, nv
    launches, _, diag, sync_err = run_path(modem, rx, payload, delays,
                                           counters, "gf3-longcp")
    for name in ("gather_cut_group", "fused_eq_demap", "minsum_totals"):
        check(launches[name] > 0, f"gf3-longcp: {name} did not launch: "
              f"{launches}")
    for name in ("cut_symbols", "gather_cut", "cut_dft"):
        check(launches[name] == 0, f"gf3-longcp: {name} launched: "
              f"{launches}")
    step_ms = median_ms(lambda: modem.demodulate(rx))
    print(f"demodulate, gf3-longcp (n_fft {cfg.n_fft}, cp {cfg.cp}, "
          f"{cfg.n_used} used bins, {cfg.n_codewords} codewords, T "
          f"{rx.shape[-1]}): {B}/{B} rows CRC-ok with the planted payload, "
          f"sync within {sync_err} samples, launches {launches}; "
          f"{step_ms:.3f} ms/step, "
          f"{B * cfg.n_data_symbols / (step_ms / 1e3):.1f} data symbols/s",
          flush=True)
    return launches, step_ms, dft


def sum_counts(total: dict, launches: dict) -> None:
    for name in total:
        total[name] += launches[name]


def run_harq(dev, counters):
    """tests/test_combining.py's HARQ scenarios on the card, recordings from
    `gf3x_torch.channel`: (a) two GF3 receptions at −0.5 dB, each failing
    `decode(start=s, sfo='off')`, that `chase_combine` decodes; (b) two
    receptions at +800 ppm and 0.5 dB, where sfo='off' combining fails, the
    joint clock offset lands within 250 ppm of the truth and sfo='on'
    combining decodes. Kernels 7, 2 and 3 launch, kernel 1 not. Returns
    (launch counts, seconds per scenario, joint δ̂ in ppm)."""
    from gf3x_torch import Modem, preset
    from gf3x_torch.channel import awgn, delay_gain, resample_sfo
    from gf3x_torch.models.stream import chase_combine

    m = Modem(preset("gf3"), device=dev)
    total, secs = {name: 0 for name in counters}, {}

    rng = np.random.default_rng(5)
    payload = bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    wav = m.encode(payload, "f.bin")
    rcp = []
    for delay, seed in ((300, 1), (700, 2)):
        r = np.random.default_rng(seed)
        rcp.append((awgn(delay_gain(wav, delay, 1.0,
                                    total_len=wav.size + 2000), -0.5, r),
                    delay))
    t0 = time.perf_counter()
    (singles, res), launches = launch_counts(counters, lambda: (
        [m.decode(x, start=s, sfo="off") for x, s in rcp],
        chase_combine(m, rcp)))
    secs["two_failed"] = time.perf_counter() - t0
    check(not any(r.crc_ok for r in singles), "HARQ (a): a single reception "
          "decoded at -0.5 dB")
    check(res.crc_ok and res.payload == payload, "HARQ (a): the combined "
          "receptions did not decode")
    sum_counts(total, launches)
    print(f"HARQ (a): two receptions at -0.5 dB each fail, chase_combine "
          f"CRC-ok with the payload; launches {launches}; "
          f"{secs['two_failed']:.3f} s", flush=True)

    rng = np.random.default_rng(8)
    payload = bytes(rng.integers(0, 256, 400, dtype=np.uint8))
    wav = m.encode(payload, "k.bin")
    rcp = []
    for seed in (31, 32):
        r = np.random.default_rng(seed)
        rcp.append((resample_sfo(awgn(delay_gain(
            wav.astype(np.float64), 300, 1.0, total_len=wav.size + 3000),
            0.5, r), 800.0).astype(np.float32), 300))
    t0 = time.perf_counter()
    (off, d, on), launches = launch_counts(counters, lambda: (
        chase_combine(m, rcp, sfo="off"), m.joint_clock_offset(rcp),
        chase_combine(m, rcp, sfo="on")))
    secs["clock_offset"] = time.perf_counter() - t0
    check(not off.crc_ok, "HARQ (b): sfo='off' combining decoded at +800 "
          "ppm")
    check(abs(d * 1e6 - 800.0) < 250.0, f"HARQ (b): joint clock offset "
          f"{d * 1e6:.1f} ppm, +800 planted")
    check(on.crc_ok and on.payload == payload, "HARQ (b): sfo='on' "
          "combining did not decode")
    sum_counts(total, launches)
    print(f"HARQ (b): +800 ppm at 0.5 dB, sfo='off' combining fails, joint "
          f"clock offset {d * 1e6:.3f} ppm, sfo='on' combining CRC-ok; "
          f"launches {launches}; {secs['clock_offset']:.3f} s", flush=True)
    for name in ("gather_cut", "fused_eq_demap", "minsum_totals"):
        check(total[name] > 0, f"HARQ: {name} did not launch")
    check(total["cut_symbols"] == 0, "HARQ: kernel 1 launched on single "
          "receptions")
    return total, secs, d * 1e6


def run_arq(dev, counters):
    """The HARQ half of examples/arq_file_transfer.py on the card: a
    two-frame transfer through a room (rt60 15 ms) at 0 dB, two rounds in
    which every single decode fails, completed by chase combining the
    stored copies per seq. Returns (launch counts, seconds)."""
    from gf3x_torch import Modem, preset
    from gf3x_torch.channel import (awgn, delay_gain, multipath,
                                    room_impulse_response)
    from gf3x_torch.models.arq import ArqReceiver, ArqSender
    from gf3x_torch.models.stream import frame_capacity

    m = Modem(preset("gf3"), device=dev)
    rng = np.random.default_rng(7)
    rir = room_impulse_response(rng, rt60=0.015, drr_db=8.0)

    def air(wav):
        x = multipath(wav, rir)
        x = delay_gain(x, int(rng.integers(500, 3000)), 0.7,
                       total_len=x.size + 6000)
        return awgn(x, 0.0, rng)

    payload = bytes(rng.integers(0, 256, 2 * frame_capacity(m, "h.bin"),
                                 dtype=np.uint8))
    tx, rcv = ArqSender(m, payload, "h.bin"), ArqReceiver(m, sfo="off")
    t0 = time.perf_counter()
    (got0, nack, got1), launches = launch_counts(counters, lambda: (
        rcv.feed(air(tx.initial())), rcv.nack(),
        rcv.feed(air(tx.retransmit("all")), nacked="all")))
    secs = time.perf_counter() - t0
    check(not any(f.crc_ok for f in got0.frames) and nack == "all",
          f"ARQ: round 0 at 0 dB decoded a frame (nack {nack})")
    check(got1.complete and got1.payload == payload, "ARQ: two all-failed "
          "rounds did not complete by combining")
    print(f"ARQ: two all-failed rounds at 0 dB -> complete, payload equal "
          f"({len(payload)} B); launches {launches}; {secs:.3f} s",
          flush=True)
    return launches, secs


def run_long_recordings(dev, counters):
    """`encode_file` transfers of 28 and 180 GF3 frames (1 264 235 and
    8 139 195 samples: the device frame scan, and above 8 000 000 its
    overlap-save form) in 20 dB AWGN through `decode_stream` on the card:
    complete with the payload. The windows decode through
    `demodulate_prewindowed`, so no cut kernel runs. Returns (launch
    counts summed, seconds per recording)."""
    from gf3x_torch import Modem, preset
    from gf3x_torch.channel import awgn, delay_gain
    from gf3x_torch.models.stream import (MAX_HOST_SCAN, MAX_WHOLE_FFT,
                                          decode_stream, encode_file,
                                          frame_capacity)

    m = Modem(preset("gf3"), device=dev)
    total, secs = {name: 0 for name in counters}, {}
    for n_frames, floor, seed in ((28, MAX_HOST_SCAN, 40),
                                  (180, MAX_WHOLE_FFT, 41)):
        rng = np.random.default_rng(seed)
        cap = frame_capacity(m, "long.bin")
        data = bytes(rng.integers(0, 256, n_frames * cap - 7,
                                  dtype=np.uint8))
        wav = encode_file(m, data, "long.bin")
        rec = awgn(delay_gain(wav, 1000, 0.5, total_len=wav.size + 5000),
                   20.0, rng).astype(np.float32)
        check(rec.size > floor, f"long recording: {rec.size} samples")
        t0 = time.perf_counter()
        res, launches = launch_counts(counters,
                                      lambda: decode_stream(m, rec))
        secs[f"{n_frames}_frames"] = time.perf_counter() - t0
        check(res.complete and res.payload == data
              and res.starts.size == n_frames, f"long recording of "
              f"{n_frames} frames: not decoded (missing {res.missing})")
        for name in ("fused_eq_demap", "minsum_totals"):
            check(launches[name] > 0, f"long recording: {name} did not "
                  "launch")
        for name in ("cut_symbols", "gather_cut", "gather_cut_group"):
            check(launches[name] == 0, f"long recording: {name} launched")
        sum_counts(total, launches)
        print(f"decode_stream of {n_frames} frames ({rec.size} samples): "
              f"complete, payload equal ({len(data)} B); launches "
              f"{launches}; {secs[f'{n_frames}_frames']:.3f} s", flush=True)
    return total, secs


def sweep_counts(res, cfg):
    """A sweep's (pre-FEC bit errors, post-FEC bit errors, failed frames)
    per SNR point, as integers."""
    N = res["n_trials"]
    return (np.rint(res["ber_pre_fec"] * N * cfg.raw_bits_per_frame),
            np.rint(res["ber_post_fec"] * N * cfg.payload_bits_per_frame),
            np.rint(res["fer"] * N))


def run_sweep(dev, counters):
    """The BER sweep (the reference's config 3) through
    `gf3x_torch.bench.ber.ber_sweep` on `Modem(GF3_STANDARD)` on the card:
    SWEEP_SNRS × SWEEP_TRIALS frames in one pass through the room FIR and
    the delay. Checks: post-FEC BER 0 at 16 and 20 dB, pre-FEC above
    post-FEC at 6 dB, both curves monotone within 1e-3, the EQ/demap and
    LDPC kernels and a cut kernel launched; and the same sweep at
    SWEEP_CHECK_TRIALS on the card and on the CPU (plain versions) from one
    injected draw: failed frames equal, bit errors within 2 + 1e-3 of the
    count before the FEC and 2 + 1 % after it (tests/test_torch_ber.py's
    bounds against gf3x). Returns (launch counts, numbers)."""
    from gf3x_torch import GF3_STANDARD, Modem
    from gf3x_torch.bench.ber import ber_sweep
    from gf3x_torch.channel import room_impulse_response

    cfg = GF3_STANDARD
    m = Modem(cfg, device=dev)
    h = room_impulse_response(np.random.default_rng(0), rt60=0.02,
                              drr_db=3.0)
    tail = float(np.sum(h[cfg.cp:] ** 2) / np.sum(h ** 2))
    T = cfg.frame_len + SWEEP_DELAY
    S, N = len(SWEEP_SNRS), SWEEP_TRIALS

    def sweep():
        gen = torch.Generator(device=dev).manual_seed(0)
        return ber_sweep(m, SWEEP_SNRS, N, generator=gen, fir=h,
                         delay_samples=SWEEP_DELAY)

    res, launches = launch_counts(counters, sweep)
    pre, post, fer = res["ber_pre_fec"], res["ber_post_fec"], res["fer"]
    i16, i20, mid = (SWEEP_SNRS.index(x) for x in (16.0, 20.0, 6.0))
    check(post[i16] == 0.0 and post[i20] == 0.0, f"sweep: post-FEC BER "
          f"{post[i16]} at 16 dB, {post[i20]} at 20 dB")
    check(pre[mid] > post[mid], f"sweep: pre-FEC BER {pre[mid]} not above "
          f"post-FEC {post[mid]} at 6 dB")
    for name, c in (("post-FEC", post), ("pre-FEC", pre)):
        check(all(c[i] >= c[i + 1] - 1e-3 for i in range(S - 1)),
              f"sweep: the {name} curve is not monotone: {c}")
    for name in ("fused_eq_demap", "minsum_totals"):
        check(launches[name] > 0, f"sweep: {name} did not launch")
    check(launches["cut_symbols"] + launches["gather_cut_group"] > 0,
          "sweep: no cut kernel launched")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sweep_s = float(np.median(times))

    rng = np.random.default_rng(1)
    Nc = SWEEP_CHECK_TRIALS
    draws = dict(info=rng.integers(0, 2, (S, Nc, cfg.payload_bits_per_frame),
                                   dtype=np.uint8),
                 noise=rng.standard_normal((S, Nc, T), dtype=np.float32))
    card = sweep_counts(ber_sweep(m, SWEEP_SNRS, Nc, fir=h,
                                  delay_samples=SWEEP_DELAY, **draws), cfg)
    cpu = sweep_counts(ber_sweep(Modem(cfg, device="cpu"), SWEEP_SNRS, Nc,
                                 fir=h, delay_samples=SWEEP_DELAY, **draws),
                       cfg)
    diff = [int(np.abs(a - b).max()) for a, b in zip(card, cpu)]
    check(np.all(np.abs(card[0] - cpu[0]) <= 2 + 1e-3 * cpu[0])
          and np.all(np.abs(card[1] - cpu[1]) <= 2 + 1e-2 * cpu[1])
          and np.array_equal(card[2], cpu[2]), f"sweep: card and CPU "
          f"error counts differ: card {card}, CPU {cpu}")
    out = dict(frames=S * N, T=T, fir_taps=len(h), fir_energy_past_cp=tail,
               cut="kernel 6" if m._fused_cut_refuses(T) else "kernel 1",
               sweep_s=sweep_s, sweep_s_runs=times, frames_per_s=S * N / sweep_s,
               snr_db=list(SWEEP_SNRS), ber_pre_fec=pre.tolist(),
               ber_post_fec=post.tolist(), fer=fer.tolist(),
               check_counts_card=[c.tolist() for c in card],
               check_counts_cpu=[c.tolist() for c in cpu],
               check_max_count_diff=diff)
    print(f"sweep: {S} x {N} = {S * N} GF3 frames of {T} samples through a "
          f"{len(h)}-tap room ({100 * tail:.2f} % of its energy past the "
          f"CP) and a {SWEEP_DELAY}-sample delay; pre-FEC BER "
          f"{np.array2string(pre, precision=4)}, post-FEC "
          f"{np.array2string(post, precision=4)}, FER {fer.tolist()}; cut "
          f"by {out['cut']}; launches {launches}; {1e3 * sweep_s:.3f} ms "
          f"per sweep (median of 5), {out['frames_per_s']:.1f} frames/s; "
          f"card against CPU at {Nc} trials: error counts differ by at most "
          f"{diff} (pre, post, frames)", flush=True)
    return launches, out


def run_cli(dev, counters):
    """The `gf3x-torch` command line on the card (its default device),
    through `gf3x_torch.cli.main`: transmit → host channel (delay, gain,
    25 dB AWGN) → receive --json, the file back byte-equal; retransmit of
    frame 1, received alone (exit 2, seq 0 missing); info; adapt on a 22 dB
    probe, then transmit and receive --loading with its table (kernels A
    and B); `Modem.equalized_symbols` of the first recording, as receive
    --constellation computes it (this machine has no matplotlib to draw
    it); sweep --json at its defaults; bench, which prints its data
    symbols/s. Returns (launch counts summed, numbers)."""
    from gf3x_torch import GF3_STANDARD, Modem
    from gf3x_torch.channel import awgn, delay_gain
    from gf3x_torch.cli import main as cli
    from gf3x_torch.io import read_wav, write_wav

    total = {name: 0 for name in counters}

    def call(*argv):
        """(exit code, stdout) of one CLI call, its launches added up."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, launches = launch_counts(counters, lambda: cli(list(argv)))
        sum_counts(total, launches)
        return rc, buf.getvalue()

    def last_json(out):
        return json.loads([ln for ln in out.splitlines()
                           if ln.startswith("{")][-1])

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(3)
        data = bytes(rng.integers(0, 256, 1500, dtype=np.uint8))
        (tmp / "doc.bin").write_bytes(data)
        t0 = time.perf_counter()
        rc_t, _ = call("transmit", str(tmp / "doc.bin"), "-o",
                       str(tmp / "tx.wav"))
        x, _ = read_wav(tmp / "tx.wav")
        rx = awgn(delay_gain(x.astype(np.float64), 7000, 0.4,
                             total_len=x.size + 20000), 25.0, rng)
        write_wav(tmp / "rx.wav", rx)
        rc_r, rep = call("receive", str(tmp / "rx.wav"), "--json", "-o",
                         str(tmp / "out"))
        out["round_trip_s"] = time.perf_counter() - t0
        rep = last_json(rep)
        check(rc_t == 0 and rc_r == 0 and rep["complete"]
              and (tmp / "out" / "doc.bin").read_bytes() == data,
              f"cli: the transmit/receive round trip failed: {rep}")

        rc, rep1 = call("retransmit", str(tmp / "doc.bin"), "--seqs", "1",
                        "-o", str(tmp / "retx.wav"))
        rc2, rep1 = call("receive", str(tmp / "retx.wav"), "--json")
        rep1 = last_json(rep1)
        check(rc == 0 and rc2 == 2 and rep1["frames_crc_ok"] == 1
              and 0 in rep1["missing_seqs"], f"cli: retransmit: {rep1}")
        rc, info = call("info")
        check(rc == 0 and "payload capacity" in info, "cli: info failed")

        probe = Modem(GF3_STANDARD, device=dev).encode(b"probe payload",
                                                      "p.bin")
        prx = awgn(delay_gain(probe.astype(np.float64), 700, 0.9,
                              total_len=probe.size + 3000), 22.0, rng)
        write_wav(tmp / "probe.wav", prx)
        rc, adapt = call("adapt", str(tmp / "probe.wav"), "-o",
                         str(tmp / "table.json"), "--margin", "1.0",
                         "--json")
        adapt = last_json(adapt)
        check(rc == 0 and "bit_loading" in adapt, f"cli: adapt: {adapt}")
        loading = ["--loading", str(tmp / "table.json")]
        (tmp / "small.bin").write_bytes(data[:96])
        rc, _ = call(*loading, "transmit", str(tmp / "small.bin"), "-o",
                     str(tmp / "ltx.wav"))
        x, _ = read_wav(tmp / "ltx.wav")
        write_wav(tmp / "lrx.wav", awgn(delay_gain(
            x.astype(np.float64), 300, 0.9, total_len=x.size + 2000), 24.0,
            rng))
        rc2, lrep = call(*loading, "receive", str(tmp / "lrx.wav"), "--json",
                         "-o", str(tmp / "lout"))
        check(rc == 0 and rc2 == 0 and (tmp / "lout" / "small.bin")
              .read_bytes() == data[:96], f"cli: the --loading round trip "
              f"failed: {lrep}")

        m = Modem(GF3_STANDARD, device=dev)
        syms, launches = launch_counts(counters, lambda: m.equalized_symbols(
            rx, start=int(rep["starts"][0])))
        sum_counts(total, launches)
        d = np.min(np.abs(syms[..., None] - np.array(
            [1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / np.sqrt(2)), axis=-1)
        check(syms.shape == (GF3_STANDARD.n_data_symbols,
                             GF3_STANDARD.n_data_bins)
              and np.percentile(d, 99) < 0.35, "cli: equalized symbols off "
              f"the constellation (99th percentile {np.percentile(d, 99)})")
        out["equalized_symbols_p99_dist"] = float(np.percentile(d, 99))

    t0 = time.perf_counter()
    rc, sw = call("sweep", "--json")
    out["sweep_s"] = time.perf_counter() - t0
    sw = last_json(sw)
    check(rc == 0 and len(sw["snr_db"]) == len(SWEEP_SNRS)
          and sw["ber_post_fec"][-1] == 0.0, f"cli: sweep: {sw}")
    rc, bench = call("bench")
    bench = last_json(bench)
    check(rc == 0 and bench["metric"] > 0, f"cli: bench: {bench}")
    out.update(sweep=sw, bench=bench)
    for name in ("gather_cut", "fused_eq_demap", "eq_track", "demap_bins",
                 "minsum_totals", "cut_symbols"):
        check(total[name] > 0, f"cli: {name} did not launch")
    print(f"cli: transmit -> channel -> receive --json round trip "
          f"byte-equal ({len(data)} B, {out['round_trip_s']:.3f} s); "
          f"retransmit, info, adapt and the --loading round trip passed; "
          f"equalized symbols within {out['equalized_symbols_p99_dist']:.3f} "
          f"of QPSK (99th percentile); sweep --json at its defaults in "
          f"{out['sweep_s']:.3f} s, post-FEC {sw['ber_post_fec']}; bench "
          f"{bench['metric']:.1f} data symbols/s ({bench['step_ms']:.3f} "
          f"ms/step at B = {bench['batch']}); launches {total}", flush=True)
    return total, out


def run_golden(dev, counters):
    """The port's golden model (float64 NumPy, on the host) and its Modem on
    the card decode the same 7 dB frame — tests/test_observability.py's
    draws — of GF3 and of that test's small LDPC config: both CRC-ok with
    the planted payload, no unsatisfied codeword, and the Modem's pass count
    equal to the golden decoder's. Returns (launch counts, numbers)."""
    from gf3x_torch import GoldenModem, Modem, ModemConfig, preset
    from gf3x_torch.channel import awgn, delay_gain

    total, out = {name: 0 for name in counters}, {}
    for label, cfg in (("gf3", preset("gf3")),
                       ("test_observability", ModemConfig(**OBS_CFG)
                        .validate())):
        m, g = Modem(cfg, device=dev), GoldenModem(cfg)
        rng = np.random.default_rng(6)
        payload = bytes(rng.integers(0, 256, 60, dtype=np.uint8))
        wav = m.encode(payload)
        rx = awgn(delay_gain(wav.astype(np.float64), 500, 0.6,
                             total_len=len(wav) + 2000), 7.0, rng)
        res, launches = launch_counts(counters,
                                      lambda: m.decode(rx.astype(np.float32)))
        sum_counts(total, launches)
        gres = g.decode(rx)
        check(res.crc_ok and gres.crc_ok and res.payload == payload
              and gres.payload == payload, f"golden ({label}): a decode "
              "failed")
        check(int(res.diag.fec_unsat) == gres.diag["fec_unsat"] == 0,
              f"golden ({label}): unsatisfied codewords")
        check(int(res.diag.fec_iters) == gres.diag["ldpc_iters"],
              f"golden ({label}): {int(res.diag.fec_iters)} passes on the "
              f"card, {gres.diag['ldpc_iters']} in the golden model")
        out[label] = dict(fec_iters=int(res.diag.fec_iters),
                          golden_ldpc_iters=gres.diag["ldpc_iters"],
                          launches=launches)
        print(f"golden ({label}, 7 dB): Modem on the card and GoldenModem "
              f"both CRC-ok with the payload, fec_unsat 0, "
              f"{int(res.diag.fec_iters)} LDPC passes each; launches "
              f"{launches}", flush=True)
    for name in ("gather_cut", "fused_eq_demap", "minsum_totals"):
        check(total[name] > 0, f"golden: {name} did not launch")
    return total, out


def run_pilots(dev, counters):
    """Config 5's batch (B = 1024, 20 dB) on the four PILOT_LAYOUTS: on
    each, kernels A and B held against their plain versions, then — on a
    uniform config — kernel 2 against its plain version and bit for bit
    against A + B, kernel 3 on the tail's codeword LLRs, and
    `Modem.demodulate` once with every launch counter at 0 (1024/1024 rows
    CRC-ok with the planted payload, kernels 1, 2 or A and B, and 3
    launched), then its step timed. Returns (the launch counts summed over
    the four paths, {label: what was held and the step ms})."""
    from gf3x_torch import GF3_STANDARD, Modem

    total, out = {name: 0 for name in counters}, {}
    for label, kw, payload_bits in PILOT_LAYOUTS:
        kw = dict(kw)
        if kw.pop("loaded", False):
            kw["bit_loading"] = loading_table(
                GF3_STANDARD.replace(**kw).n_data_bins)
        cfg = GF3_STANDARD.replace(**kw)
        check(cfg.payload_bits_per_frame == payload_bits
              and not (cfg.strided_pilots and cfg.n_pilots >= 2),
              f"pilots {label}: payload {cfg.payload_bits_per_frame} bits, "
              f"strided {cfg.strided_pilots} with {cfg.n_pilots} pilots")
        modem = Modem(cfg, max_delay=MARGIN + cfg.cp, device=dev)
        rx_np, payload, delays = build_batch(modem, B, MARGIN,
                                             np.random.default_rng(0))
        rx = torch.as_tensor(rx_np, device=dev)
        _, _, _, _, Y, H, nv = path_inputs(modem, rx)
        pv = modem.pilot_vals
        tables = (modem.demap_used, modem.demap_bits, modem.demap_off)
        a_k = hold_eq_track(cfg, Y, H, nv, pv, label)
        b_k, errB, scaleB = hold_demap(cfg, a_k[0], H, a_k[3], tables, label)
        held = dict(n_pilots=cfg.n_pilots, n_data_bins=cfg.n_data_bins,
                    payload_bits=payload_bits, demap_bins_max_abs_err=errB,
                    demap_bins_mean_abs=scaleB)
        if cfg.bit_loading is None:
            out2, err2, scale2 = hold_fused(cfg, Y, H, nv, pv, label)
            held.update(fused_eq_demap_max_abs_err=err2,
                        fused_eq_demap_mean_abs=scale2,
                        split_pair_rel=hold_split(modem, Y, H, nv, out2,
                                                  f"pilots {label}"))
            llr, tail = out2[0], ("fused_eq_demap",)
        else:
            llr, tail = b_k[0], ("eq_track", "demap_bins")
        held["minsum"] = hold_minsum(modem._code,
                                     modem._codeword_llrs(llr).contiguous(),
                                     cfg.ldpc_iters, f"pilots {label}")
        del Y, H, nv, a_k, b_k, llr
        launches, _, diag, sync_err = run_path(
            modem, rx, payload, delays, counters, f"pilots {label}")
        for name in ("cut_symbols", "minsum_totals") + tail:
            check(launches[name] > 0, f"pilots {label}: {name} did not "
                  f"launch: {launches}")
        other = (("eq_track", "demap_bins") if cfg.bit_loading is None
                 else ("fused_eq_demap",))
        check(all(launches[n] == 0 for n in other), f"pilots {label}: the "
              f"other tail launched: {launches}")
        step = median_ms(lambda: modem.demodulate(rx))
        sum_counts(total, launches)
        out[label] = dict(held, step_ms=step, sync_err=sync_err,
                          launches=launches)
        print(f"pilots {label} ({cfg.n_pilots} pilots, {cfg.n_data_bins} "
              f"data bins, {payload_bits} payload bits): kernels A, B"
              f"{', 2' if cfg.bit_loading is None else ''} and 3 held against "
              f"their plain versions; demodulate {B}/{B} rows CRC-ok, sync "
              f"within {sync_err} samples, slope |max| "
              f"{float(diag.pilot_slope.abs().max()):.3g}, launches "
              f"{launches}; {step:.3f} ms/step", flush=True)
        del modem, rx
    return total, out


# the wide phase's cases: (label, WIDE_BANDS key, loaded, frames per batch);
# gf3-16384's frame is 523 025 samples, so 64 of them
WIDE_CASES = (("gf3-4096", "gf3-4096", False, 1024),
              ("gf3-8192", "gf3-8192", False, 1024),
              ("gf3-8192 loaded", "gf3-8192", True, 1024),
              ("gf3-16384", "gf3-16384", False, 64),
              ("gf3-16384 loaded", "gf3-16384", True, 64))
# each band's CP nearest N/4 whose cut gf3x's fused kernels take (every
# offset on the 128 grid; the N/4 CP puts the SC window off it): there
# `use_cut_dft` turns on kernel 8's n_fft range alone
WIDE_ALIGNED_CP = {"gf3-4096": 768, "gf3-8192": 1792}


# kernels 2 and A past the pilot bound of shared memory (11 621 pilots):
# the GF3 band widened to n_fft 65536 at pilot spacing 2 (U = 31 232, P =
# 15 616), a band no Modem reaches (its U x U host solves would need 7.8 GB
# a matrix), held at B = 4 on inputs built in the frequency domain
SPILL_BAND = dict(n_fft=65536, cp=16384, bin_lo=1536, bin_hi=32767,
                  pilot_spacing=2)
SPILL_B = 4


def spill_inputs(cfg, Bk: int, dev, seed: int = 11):
    """Spectra of Bk frames of `cfg` built directly (no Modem): every
    symbol's data bins random Gray QAM and its pilots the layout's values,
    through a random channel Ĥ with a per-symbol phase ramp (0.2 mrad a bin
    and a random common phase, which the pilot fit tracks) and AWGN of
    variance 1e-3. Returns (Y (Bk, K+D, U), Ĥ (Bk, U) complex64, the noise
    variance (Bk,))."""
    from gf3x_torch.config import layout
    from gf3x_torch.ops.constellation import qam_map

    lay = layout(cfg)
    S, U = cfg.n_known_symbols + cfg.n_data_symbols, cfg.n_used
    g = torch.Generator(device=dev).manual_seed(seed)
    bits = torch.randint(0, 2, (Bk, S, lay.data_pos.size,
                                cfg.bits_per_symbol), generator=g,
                         device=dev, dtype=torch.uint8)
    X = torch.zeros(Bk, S, U, dtype=torch.complex64, device=dev)
    X[..., torch.as_tensor(lay.data_pos, device=dev).long()] = qam_map(
        bits, cfg.bits_per_symbol)
    X[..., torch.as_tensor(lay.pilot_pos, device=dev).long()] = \
        torch.as_tensor(lay.pilot_vals, device=dev)
    H = torch.complex(1.0 + 0.3 * torch.randn(Bk, U, generator=g, device=dev),
                      0.3 * torch.randn(Bk, U, generator=g, device=dev))
    k = torch.arange(U, device=dev, dtype=torch.float32)
    cpe = 0.3 * torch.randn(Bk, S, 1, generator=g, device=dev)
    rot = torch.polar(torch.ones_like(cpe * k), 2e-4 * k + cpe)
    nvar = 1e-3
    noise = torch.complex(torch.randn(Bk, S, U, generator=g, device=dev),
                          torch.randn(Bk, S, U, generator=g, device=dev))
    Y = H[:, None] * X * rot + noise * float(np.sqrt(nvar / 2))
    return (Y.to(torch.complex64).contiguous(), H.contiguous(),
            torch.full((Bk,), nvar, device=dev))


def hold_spilled(label, fn, geo) -> list:
    """fn(geometry) in the launch its geometry picks (None) and in the
    spilled launch `geo` of the same warps, team and blocks: every output's
    sha256 equal. Returns the sha256s."""
    sha = [sha256_of(t) for t in fn(None)]
    check([sha256_of(t) for t in fn(geo)] == sha, f"{label}: the spilled "
          "layout's outputs differ from the picked one's")
    return sha


def run_spill(dev, rows) -> dict:
    """Kernels 2 and A past the pilot bound of shared memory: at
    SPILL_BAND (P = 15 616 > MAX_SHARED_PILOTS) on SPILL_B frames built by
    `spill_inputs`, the geometry picks the spilled layout and each kernel
    holds to its plain version with `hold_fused`'s and `hold_eq_track`'s
    checks; µs beside the bound (`tail_bytes`). Adds the rows' `spilled`
    entries and returns them."""
    from gf3x_torch import GF3_STANDARD
    from gf3x_torch.ops.kernels import eq_layout, fused_eq, split_eq

    cfg = GF3_STANDARD.replace(**SPILL_BAND)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    Y, H, nv = spill_inputs(cfg, SPILL_B, dev)
    out = {}
    for name, demap in (("fused_eq_demap", True), ("eq_track", False)):
        geo = eq_layout.fused_eq_geometry(cfg, SPILL_B, sms, demap=demap)
        check(geo.spill, f"{name} at P = {cfg.n_pilots}: {geo} is not the "
              "spilled layout")
        if demap:
            _, err, scale = hold_fused(cfg, Y, H, nv, None, "spilled")
            fn = lambda: fused_eq.fused_eq_demap(cfg, Y, H, nv)  # noqa: E731
        else:
            hold_eq_track(cfg, Y, H, nv, None, "spilled")
            a_k = split_eq.eq_track(cfg, Y, H, nv)
            a_p = split_eq.eq_track_plain(cfg, Y, H, nv)
            err = float((a_k[0] - a_p[0]).abs().max())
            scale = float(a_p[0].abs().mean())
            fn = lambda: split_eq.eq_track(cfg, Y, H, nv)  # noqa: E731
        out[name] = dict(
            n_used=cfg.n_used, n_pilots=cfg.n_pilots, batch=SPILL_B,
            geometry=str(geo), max_abs_err=err, mean_abs=scale,
            kernel_us=kernel_us(fn, [name])["us"],
            **bound(tail_bytes(cfg, SPILL_B, name)))
        rows[name]["spilled"] = out[name]
    print(f"spilled layout (n_fft {cfg.n_fft}, U = {cfg.n_used}, P = "
          f"{cfg.n_pilots}, B = {SPILL_B}): kernels 2 and A held against "
          f"their plain versions; "
          f"{ {n: (o['geometry'], round(o['kernel_us'], 1), round(1e3 * o['bound_ms'], 1)) for n, o in out.items()} } "
          "(layout, kernel us, bound us)", flush=True)
    return out


# the layouts phase: each band of kernels 2 and A at its batch — the wide
# bands (on spectra built in the frequency domain, `spill_inputs`), config
# 5 and the spilled band: (label, the band's replace keywords, bit-loaded,
# frames)
LAYOUT_BANDS = (("config 5", {}, False, 1024),
                ("gf3-4096", WIDE_BANDS["gf3-4096"], False, 1024),
                ("gf3-4096 B = 1", WIDE_BANDS["gf3-4096"], False, 1),
                ("gf3-8192", WIDE_BANDS["gf3-8192"], False, 1024),
                ("gf3-8192 loaded", WIDE_BANDS["gf3-8192"], True, 1024),
                ("gf3-16384", WIDE_BANDS["gf3-16384"], False, 64),
                ("spill", SPILL_BAND, False, SPILL_B))
# which outputs every layout must give bit for bit: kernel 2's llr, slope
# and cpe (its frame sums are added in another order where the teamed
# layout runs), all four of kernel A's
LAYOUT_HASHED = {"fused_eq_demap": 3, "eq_track": 4}
# the bands `time_tree` times and hashes kernels 2 and A at (A alone when
# loaded)
TREE_BANDS = ("gf3-4096", "gf3-8192", "gf3-8192 loaded", "gf3-16384",
              "spill")


def layout_config(replace: dict, loaded: bool):
    from gf3x_torch import GF3_STANDARD

    cfg = GF3_STANDARD.replace(**replace)
    if loaded:
        cfg = cfg.replace(bit_loading=loading_table(cfg.n_data_bins))
    return cfg


def layout_candidates(cfg, Bk: int, sms: int, demap: bool,
                      grid: bool = False) -> dict:
    """The launches of kernel 2 (`demap`) or A worth timing on a batch of
    Bk frames of `cfg`, by label: the one the geometry picks, the staged
    one where it fits, and for each team size the teamed launch
    `teamed_geometry` gives, with Ĥ read through L2 and staged in shared
    memory (" H"); past the pilot bound only the spilled ones. With
    `grid`, for each team size, Ĥ placement and count of blocks a frame
    the launch of most resident warps an SM (then fewest passes), labelled
    "T{team}{ H} x{blocks}". Equal launches are listed once."""
    from gf3x_torch.ops.kernels import eq_layout as fe

    U, P, D = cfg.n_used, cfg.n_pilots, cfg.n_data_symbols
    spill = P > fe.MAX_SHARED_PILOTS
    out = {"picked": fe.fused_eq_geometry(cfg, Bk, sms, demap=demap)}
    if not spill:
        staged = fe.pick_warps(D, Bk, sms, lambda w, nb:
                               fe.staged_smem_bytes(U, P, w, nb, demap))
        if staged is not None:
            out["staged"] = staged
    for T in fe.TEAMS:
        for sh in (False,) if spill else (False, True):
            if grid:
                if T == 1 and not sh:   # a warp a block: slowest of all
                    continue
                for b in sorted({g.blocks for g in fe.teamed_launches(
                        U, P, D, demap, T, sh, spill)}):
                    out[f"T{T}{' H' if sh else ''} x{b}"] = \
                        fe.teamed_geometry(U, P, D, Bk, sms, demap, T, b, sh,
                                           spill)
                continue
            g = fe.teamed_geometry(U, P, D, Bk, sms, demap, T, stage_h=sh,
                                   spill=spill)
            if g is not None:
                out[f"T{T}{' H' if sh else ''}"] = g
    seen, uniq = set(), {}
    for k, g in out.items():
        if g not in seen:
            seen.add(g)
            uniq[k] = g
    return uniq


def run_layouts(dev, grid: bool = False) -> dict:
    """Kernels 2 and A in every candidate launch (`layout_candidates`,
    `grid` passed on) on each band of LAYOUT_BANDS: every launch's
    LAYOUT_HASHED outputs hash as the picked one's (kernel 2's frame sums
    within 1e-4 rel), and each launch's µs (profiler). The picked launch
    is held against the plain version in the wide and spill phases.
    Returns {band: {kernel: {label: (layout, team, blocks, warps, passes,
    Ĥ staged, µs)}}}."""
    from gf3x_torch.ops.kernels import fused_eq, split_eq

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, replace, loaded, Bk in LAYOUT_BANDS:
        cfg = layout_config(replace, loaded)
        Y, H, nv = spill_inputs(cfg, Bk, dev)
        out[label] = {}
        for name, demap in (("fused_eq_demap", True), ("eq_track", False)):
            if demap and loaded:
                continue
            call = fused_eq.fused_eq_demap if demap else split_eq.eq_track
            ref = None
            res = {}
            for key, geo in layout_candidates(cfg, Bk, sms, demap,
                                              grid).items():
                got = call(cfg, Y, H, nv, geometry=geo)
                sha = [sha256_of(t) for t in got[:LAYOUT_HASHED[name]]]
                if ref is None:
                    ref = (sha, got)
                check(sha == ref[0], f"layouts {label}, {name}: {key} "
                      f"({geo}) differs from the picked launch")
                for a, b in zip(got[LAYOUT_HASHED[name]:],
                                ref[1][LAYOUT_HASHED[name]:]):
                    rel = float(((a - b).abs() / b.abs()).max())
                    check(rel <= 1e-4, f"layouts {label}, {name}: {key}'s "
                          f"frame sums differ by {rel} rel")
                del got
                res[key] = (geo.layout, geo.team, geo.blocks, geo.warps,
                            geo.passes, geo.stage_h, kernel_us(
                                lambda: call(cfg, Y, H, nv, geometry=geo),
                                [name], runs=10)["us"])
            out[label][name] = res
            print(f"layouts {label} (U = {cfg.n_used}, P = {cfg.n_pilots}, "
                  f"B = {Bk}) {name}: every launch hashes the same; "
                  + "; ".join(f"{k} {v[0]} T{v[1]} x{v[2]} {v[3]}w "
                              f"{v[4]}p{' H' if v[5] else ''}: {v[6]:.1f} us"
                              for k, v in res.items()), flush=True)
        del Y, H, nv
    return out


# the wide bands' other routes: a clock offset planted in the batch recipe
# (the port's channel.sims.resample_sfo); and the warped DFT's error
# against float64 that gf3x's float32 formula (2π/N)·n·k·(1+δ) gives at
# each n_fft (tests/test_torch_wide_routes.py measures 4096 and 8192 on the
# CPU), printed beside the port's (the chirp-z transform at these bands:
# ≤ WARPED_DFT_DB)
SFO_PPM = 150.0
WARPED_DFT_FORMULA_DB = {4096: -78.5, 8192: -72.4, 16384: -62.0}
WARPED_DFT_DB = -110.0


def resample_sinc(x: np.ndarray, ppm: float, taps: int = 64,
                  beta: float = 8.0) -> np.ndarray:
    """A sampling-clock offset of `ppm` by band-limited interpolation:
    output sample n reads input time n·(1 + ppm·1e-6), as
    `channel.sims.resample_sfo` does, through a Kaiser-windowed sinc of
    `taps` taps instead of a straight line. Linear interpolation filters
    each sample by a fractional delay that cycles every 1/δ samples (6667
    at 150 ppm) and errs by −11 dB at 13 kHz
    (tests/test_torch_wide_routes.py): within one gf3-16384 symbol
    (16 384 samples) that is a channel varying 2.5 times, whose
    inter-carrier interference alone leaves its 64-QAM frames undecodable
    after the loop has found δ. A real clock resamples the band-limited
    signal, which the windowed sinc does far below the frames' 20 dB
    noise up to 0.3·fs."""
    ratio = 1.0 + ppm * 1e-6
    n_out = int(np.floor((len(x) - 1) / ratio)) + 1
    half = taps // 2
    j = np.arange(-half + 1, half + 1)
    xp = np.concatenate([np.zeros(half), x, np.zeros(half)])
    out = np.empty(n_out)
    for a in range(0, n_out, 1 << 15):
        t = np.arange(a, min(n_out, a + (1 << 15))) * ratio
        i0 = np.floor(t).astype(np.int64)
        d = (t - i0)[:, None] - j[None, :]
        w = np.sinc(d) * np.i0(beta * np.sqrt(np.clip(
            1.0 - (d / half) ** 2, 0.0, 1.0))) / np.i0(beta)
        out[a: a + len(t)] = np.sum(xp[i0[:, None] + j[None, :] + half] * w,
                                    axis=1)
    return out


def sfo_batch(modem, Bk: int, ppm: float, rng):
    """`build_batch`'s recipe with the frame through a sampling-clock
    offset of `ppm` (`resample_sinc`): (rx, payload, delays)."""
    cfg = modem.cfg
    payload = rng.integers(0, 256, 540, dtype=np.uint8).tobytes()
    wav = resample_sinc(np.asarray(modem.encode(payload, "bench.bin"),
                                   np.float64), ppm).astype(np.float32)
    T = cfg.frame_len + MARGIN
    rx = np.zeros((Bk, T), dtype=np.float32)
    delays = rng.integers(0, MARGIN, size=Bk)
    for i in range(Bk):
        n = min(wav.size, T - delays[i])
        rx[i, delays[i]: delays[i] + n] = wav[:n]
    p = float(np.mean(wav ** 2))
    rx += (rng.standard_normal((Bk, T)) * np.sqrt(p / 100.0)).astype(
        np.float32)
    return rx, payload, delays


def warped_db(cfg, syms, delta, Y) -> float:
    """Y's error in dB against the δ-warped DFT of syms (..., n_fft) in
    float64 on syms' device, the angle 2π/N·n·k·(1+δ) exact in float64."""
    d = float(np.float32(float(delta)))
    n = torch.arange(cfg.n_fft, dtype=torch.float64, device=syms.device)
    k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=torch.float64,
                     device=syms.device)
    th = (2.0 * np.pi / cfg.n_fft) * n[:, None] * k[None, :] * (1.0 + d)
    x = syms.to(torch.float64)
    err = sig = 0.0
    for c, s in ((torch.cos(th), 1), (torch.sin(th), -1)):
        exact = s * (x @ c) / cfg.ofdm_scale
        got = (Y.real if s > 0 else Y.imag).to(torch.float64)
        err += float(((got - exact) ** 2).sum())
        sig += float((exact ** 2).sum())
        del exact, got
    return 10.0 * float(np.log10(err / sig))


def reduced_angle(cfg, delta, device) -> torch.Tensor:
    """The dense warped DFT's table angle with n·k reduced mod N in int64,
    (2π/N)·((n·k mod N) + n·k·δ) in float32 (−120 dB against float64 at
    gf3-8192): the table of the dense product that `library_ms` times
    beside the chirp-z transform (the port never runs it)."""
    n = torch.arange(cfg.n_fft, device=device)[:, None]
    k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, device=device)[None, :]
    nk = n * k
    th = torch.remainder(nk, cfg.n_fft).to(torch.float32)
    th.add_(nk.to(torch.float32).mul_(
        torch.as_tensor(delta, dtype=torch.float32, device=device)))
    return th.mul_(np.float32(2.0 * np.pi / cfg.n_fft))


def dense_dft(cfg, syms, delta, angle):
    """The warped DFT as a dense full-float32 product over the cos/sin
    tables of `angle(cfg, delta, device)`: the yardstick, and gf3x's
    formula with `unreduced_angle`."""
    from gf3x_torch.ops.ofdm import matmul_f32

    th = angle(cfg, delta, syms.device)
    inv = np.float32(1.0 / cfg.ofdm_scale)
    return torch.complex(matmul_f32(syms, torch.cos(th)) * inv,
                         -matmul_f32(syms, torch.sin(th)) * inv)


def hold_warped_dft(cfg, syms, delta) -> dict:
    """The δ-warped DFT on the card (the chirp-z transform at the wide
    bands) against the same function's plain versions on the host (the
    CPU's `ofdm_dft`), within 1e-4·mean|Y|, and against a float64 DFT at
    the loop's δ̂, at 0 and at −9e-4: ≤ WARPED_DFT_DB where the band takes
    the chirp-z transform, else the −80 dB gate; gf3x's float32 formula's
    dB beside it (WARPED_DFT_FORMULA_DB)."""
    from gf3x_torch.ops.ofdm import ofdm_dft, takes_czt, unreduced_angle

    d32 = np.float32(float(delta))
    got = ofdm_dft(cfg, syms, torch.tensor(d32, device=syms.device))
    host = ofdm_dft(cfg, syms.cpu(), torch.tensor(d32))
    err = float((got.cpu() - host).abs().max())
    scale = float(host.abs().mean())
    check(err <= 1e-4 * scale, f"warped DFT at n_fft {cfg.n_fft}: {err} "
          f"from the host's plain versions > 1e-4 x mean|Y| {scale}")
    gate = WARPED_DFT_DB if takes_czt(cfg) else -80.0
    dbs = {}
    for label, d in (("delta_hat", d32), ("zero", np.float32(0.0)),
                     ("minus_9e-4", np.float32(-9e-4))):
        dbs[label] = warped_db(cfg, syms, d, got if label == "delta_hat"
                               else ofdm_dft(cfg, syms, torch.tensor(
                                   d, device=syms.device)))
        check(dbs[label] <= gate, f"warped DFT at n_fft {cfg.n_fft}, "
              f"{label}: {dbs[label]:.1f} dB against float64 > {gate} dB")
    old = dense_dft(cfg, syms, d32, unreduced_angle)
    return dict(max_abs_err=err, mean_abs=scale, delta_ppm=float(d32) * 1e6,
                db_vs_float64=dbs["delta_hat"], db_by_delta=dbs,
                gate_db=gate, czt=takes_czt(cfg),
                formula_db_vs_float64=warped_db(cfg, syms, d32, old),
                formula_db_cpu_test=WARPED_DFT_FORMULA_DB.get(cfg.n_fft))


def device_ops(fn, runs: int = 5) -> dict:
    """{kernel name: µs per call} of every device kernel fn() runs, from
    torch.profiler over `runs` calls after a warm-up, largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for ev in prof.key_averages():
        us = float(getattr(ev, "self_device_time_total", None)
                   or getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0.0:
            ops[ev.key[:80]] = ops.get(ev.key[:80], 0.0) + us / runs
    return dict(sorted(ops.items(), key=lambda kv: -kv[1]))


# the warped-DFT phase's bands: the three wide bands, each held against a
# float64 DFT at B_WARPED rows of random symbols (gf3-8192 also on the
# clock-offset batch at B = 1024); FFT lengths timed at gf3-8192
WARPED_BANDS = ("gf3-4096", "gf3-8192", "gf3-16384")
B_WARPED = 16
CZT_LENGTHS = (12288, 16384)


def hold_czt_kernels(cfg, strided, delta, dev) -> dict:
    """The chirp-z passes at the route's shapes on the cut's strided view:
    `czt_pre` and `czt_post` against their plain versions on the card
    (`czt_pre` bit for bit; `czt_post`'s complex product within 2⁻²² of
    its largest output, torch's own kernel may contract it), then each
    timed beside its byte bound (inputs read once, outputs written once)
    and its plain version; no single PyTorch call computes either."""
    from gf3x_torch.ops.kernels import czt
    from gf3x_torch.ops.ofdm import chirp_tables, czt_length

    L, M = czt_length(cfg), cfg.n_used
    pre, post, H = chirp_tables(cfg, delta, dev, L)
    rows = strided.shape[0] * strided.shape[1]
    a = czt.czt_pre(strided, pre, L)
    check(torch.equal(a, czt.czt_pre_plain(strided, pre, L)),
          "czt_pre differs from its plain version on the card")
    z = torch.fft.ifft(torch.fft.fft(a).mul_(H), norm="forward")
    del a
    y = czt.czt_post(z, post)
    yp = czt.czt_post_plain(z, post)
    post_err = float((y - yp).abs().max() / yp.abs().max())
    check(post_err <= 2.0 ** -22, f"czt_post differs from its plain "
          f"version by {post_err} of its largest output")
    out = {"czt_pre": timed(
        lambda: czt.czt_pre(strided, pre, L),
        lambda: czt.czt_pre_plain(strided, pre, L),
        rows * (4 * cfg.n_fft + 8 * L), kernel="czt_pre_kernel"),
        "czt_post": timed(
        lambda: czt.czt_post(z, post), lambda: czt.czt_post_plain(z, post),
        rows * 16 * M, kernel="czt_post_kernel")}
    out["czt_pre"]["bit_for_bit"] = True
    out["czt_post"]["max_rel_diff"] = post_err
    out["czt_post"]["bit_for_bit"] = bool(torch.equal(y, yp))
    for name, row in out.items():
        row["shape"] = f"{rows} rows, N {cfg.n_fft}, L {L}, M {M}"
        print(f"{name}: {row['kernel_us']:.1f} us kernel, bound "
              f"{1e3 * row['bound_ms']:.1f} us, plain {row['plain_ms']:.3f} "
              f"ms host clock", flush=True)
    return out


# the fused chirp-z kernel against float64 (the bar the chain meets) and
# against its plain version (not bit for bit: the kernel's R-point DFTs are
# radix-2 networks with fused multiply-adds, the plain version's einsums over
# DFT matrices), largest |difference| over largest |output|
FUSED_DB = -125.0
FUSED_REL = 2e-6
FUSED_PLAIN_ROWS = 64     # rows held against the plain version on the host
FUSED_DB_ROWS = 256       # rows held against float64


def hold_czt_fused(band: str, Bk: int, dev) -> dict:
    """The fused chirp-z kernel at a wide band on Bk recordings of random
    symbols, read through the cut's strided view (row stride n_fft + cp):
    against its plain version on the host (FUSED_PLAIN_ROWS rows, within
    FUSED_REL of the largest output; also 8 rows cut to 99 samples short
    of 2L/3), against the chain around cuFFT on the card (same tables,
    within FUSED_REL), and against a float64 DFT (FUSED_DB_ROWS rows) at
    150 ppm, 0 and −9e-4 (≤ FUSED_DB); then the kernel's µs beside its byte bound (the real samples in, the bins out)
    and the chain's µs, both from torch.profiler, and CUDA-event ms of each
    call and of the chirp tables with the reordering of H."""
    from gf3x_torch import GF3_STANDARD
    from gf3x_torch.ops.kernels import czt
    from gf3x_torch.ops.ofdm import chirp_tables, czt_chain, czt_length

    cfg = GF3_STANDARD.replace(**WIDE_BANDS[band])
    N, M, L = cfg.n_fft, cfg.n_used, czt_length(cfg)
    check(czt.takes_fused(L, N, M), f"{band}: L {L} does not take the fused "
          "kernel")
    S = cfg.n_known_symbols + cfg.n_data_symbols
    g = torch.Generator(dev).manual_seed(Bk)
    body = torch.randn(Bk, S * cfg.symbol_len, device=dev, generator=g)
    strided = body.reshape(Bk, S, cfg.symbol_len)[..., cfg.cp:]
    rows = Bk * S
    out = dict(band=band, batch=Bk, rows=rows, N=N, L=L, M=M,
               radices=list(czt.fused_radices(L)),
               smem_bytes=czt.fused_smem_bytes(L), db={})
    flat = strided.reshape(rows, N)
    for label, d in (("150ppm", SFO_PPM * 1e-6), ("zero", 0.0),
                     ("minus_9e-4", -9e-4)):
        d = torch.tensor(np.float32(d), device=dev)
        pre, post, H = chirp_tables(cfg, d, dev, L)
        hf = czt.filter_table(H)
        y = czt.czt_fused(strided, pre, hf, post)
        n = min(rows, FUSED_DB_ROWS)
        out["db"][label] = warped_db(cfg, flat[:n], d, y[:n])
        check(out["db"][label] <= FUSED_DB, f"fused chirp-z at {band}, B = "
              f"{Bk}, {label}: {out['db'][label]:.1f} dB > {FUSED_DB}")
        if label == "150ppm":
            n = min(rows, FUSED_PLAIN_ROWS)
            yp = czt.czt_fused_plain(flat[:n].cpu(), pre.cpu(), hf.cpu(),
                                     post.cpu())
            out["rel_plain"] = float((y[:n].cpu() - yp).abs().max()
                                     / yp.abs().max())
            out["bit_for_bit_plain"] = bool(torch.equal(y[:n].cpu(), yp))
            ch = czt_chain(strided, pre, H, post)
            out["rel_chain"] = float((y - ch).abs().max() / ch.abs().max())
            out["db_chain"] = warped_db(cfg, flat[:min(rows, FUSED_DB_ROWS)],
                                        d, ch[:FUSED_DB_ROWS])
            del ch
            # fewer samples than the padding leaves room for: the loads
            # past N read as zeros
            n = 2 * L // 3 - 99
            ys = czt.czt_fused(flat[:8, :n], pre[:n].contiguous(), hf, post)
            yp = czt.czt_fused_plain(flat[:8, :n].cpu(), pre[:n].cpu(),
                                     hf.cpu(), post.cpu())
            out["rel_plain_short_rows"] = float((ys.cpu() - yp).abs().max()
                                                / yp.abs().max())
            for k in ("rel_plain", "rel_chain", "rel_plain_short_rows"):
                check(out[k] <= FUSED_REL, f"fused chirp-z at {band}, B = "
                      f"{Bk}: {k} {out[k]:.2e} > {FUSED_REL}")
            out["kernel_us"] = kernel_us(
                lambda: czt.czt_fused(strided, pre, hf, post),
                ["czt_fused_kernel"])["us"]
            out["chain_us"] = kernel_us(
                lambda: czt_chain(strided, pre, H, post),
                ["czt_pre_kernel", "fft", "elementwise", "czt_post_kernel"])
            out["fused_ms"] = event_ms(
                lambda: czt.czt_fused(strided, pre, hf, post), 20)
            out["chain_ms"] = event_ms(
                lambda: czt_chain(strided, pre, H, post), 20)
            out["tables_ms"] = event_ms(
                lambda: czt.filter_table(chirp_tables(cfg, d, dev, L)[2]), 20)
            out.update(bound(rows * (4 * N + 8 * M)))
    out["kernel_over_bound"] = 1e-3 * out["kernel_us"] / out["bound_ms"]
    print(f"{band} B = {Bk} ({rows} rows, L {L}): fused {out['kernel_us']:.1f}"
          f" us kernel (bound {1e3 * out['bound_ms']:.1f} us, "
          f"{out['kernel_over_bound']:.2f}x), chain "
          f"{out['chain_us']['us']:.1f} us; rel to plain "
          f"{out['rel_plain']:.2e}, to chain {out['rel_chain']:.2e}; dB "
          f"{ {k: round(v, 2) for k, v in out['db'].items()} }", flush=True)
    return out


def warped_dft_only() -> None:
    """`--warped-dft`: the δ-warped DFT of the clock-offset route on the
    card. At each wide band, B_WARPED rows of random symbols against a
    float64 DFT at 150 ppm (the cell's clock pair), 0 and −9e-4 (≤
    WARPED_DFT_DB). At gf3-8192 the recipe's batch at +SFO_PPM (B = 1024)
    cut and its δ̂ found by the loop: the whole batch's warped DFT against
    float64 at δ̂ (≤ FUSED_DB) beside gf3x's float32 formula's; the
    chain's `czt_pre` and `czt_post` against their plain versions and
    timed beside their bounds (`hold_czt_kernels`); the fused kernel at
    each wide band at B = 1024 and 1 (`hold_czt_fused`); CUDA-event ms of
    the whole warped call on the cut's strided view, as the route runs it,
    beside the chain's and the dense product over the reduced angle's
    tables (`library_ms`, which the port never runs), of the call at each
    FFT length of CZT_LENGTHS, its kernels by name, a `demodulate_sfo`
    step's counters (every warped row through the fused kernel), and the
    chirp tables' share of the step's device time; the step's peak memory.
    One JSON line, then the card's name and power limit."""
    from gf3x_torch import GF3_STANDARD, Modem
    from gf3x_torch.ops.kernels.czt import filter_table
    from gf3x_torch.ops.ofdm import (chirp_tables, czt_chain, czt_dft,
                                     czt_length, ofdm_dft, unreduced_angle)
    from gf3x_torch.utils import profiling
    from gf3x_torch.utils.device import kernel_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    kernel_lib()
    dev = torch.device("cuda", 0)
    out = dict(bands={})
    for band in WARPED_BANDS:
        cfg = GF3_STANDARD.replace(**WIDE_BANDS[band])
        syms = torch.randn(B_WARPED, cfg.n_fft, device=dev,
                           generator=torch.Generator(dev).manual_seed(5))
        dbs = {}
        for label, d in (("150ppm", SFO_PPM * 1e-6), ("zero", 0.0),
                         ("minus_9e-4", -9e-4)):
            d = torch.tensor(np.float32(d), device=dev)
            dbs[label] = warped_db(cfg, syms, d, ofdm_dft(cfg, syms, d))
            check(dbs[label] <= WARPED_DFT_DB, f"warped DFT at {band}, "
                  f"{label}: {dbs[label]:.1f} dB > {WARPED_DFT_DB}")
        out["bands"][band] = dict(L=czt_length(cfg), db=dbs)
        print(f"{band}: chirp-z (L {czt_length(cfg)}) against float64 "
              f"{ {k: round(v, 2) for k, v in dbs.items()} } dB", flush=True)
        del syms
    cfg = GF3_STANDARD.replace(**WIDE_BANDS["gf3-8192"])
    modem = Modem(cfg, max_delay=MARGIN + cfg.cp, device=dev)
    rx_np, _, _ = sfo_batch(modem, B, SFO_PPM, np.random.default_rng(3))
    rx = torch.as_tensor(rx_np, device=dev)
    del rx_np
    strided, sc_win, roll = modem._cut_frame(rx, modem._sync(rx)[0])
    check(not strided.is_contiguous(), "the cut's symbols are contiguous")
    delta = modem._two_pass_delta(strided, sc_win, roll)
    out.update(band="gf3-8192", batch=B,
               rows=strided.shape[0] * strided.shape[1],
               delta_ppm=float(delta) * 1e6)
    out["db_delta_hat"] = warped_db(cfg, strided, delta,
                                    ofdm_dft(cfg, strided, delta))
    check(out["db_delta_hat"] <= FUSED_DB, f"warped DFT at B = {B}, "
          f"δ̂: {out['db_delta_hat']:.1f} dB > {FUSED_DB}")
    out["db_gf3x_formula"] = warped_db(cfg, strided, delta, dense_dft(
        cfg, strided, delta, unreduced_angle))
    out["kernels"] = hold_czt_kernels(cfg, strided, delta, dev)
    out["fused"] = [hold_czt_fused(band, Bk, dev) for band in WARPED_BANDS
                    for Bk in (B, 1)]
    L0 = czt_length(cfg)
    out["table_ms"] = event_ms(lambda: chirp_tables(cfg, delta, dev, L0), 20)
    # a call's tables on the device: chirp_tables and H's reordering
    out["table_ops_us"] = device_ops(lambda: filter_table(chirp_tables(
        cfg, delta, dev, L0)[2]))
    out["warped_dft_ms"] = event_ms(lambda: ofdm_dft(cfg, strided, delta), 5)
    out["fft_length_ms"] = {L: event_ms(lambda: czt_dft(
        cfg, strided, delta, L), 5) for L in CZT_LENGTHS}
    pre, post, H = chirp_tables(cfg, delta, dev, L0)
    out["chain_ms"] = event_ms(lambda: czt_chain(strided, pre, H, post), 5)
    del pre, post, H
    out["warped_dft_ops_us"] = device_ops(lambda: ofdm_dft(cfg, strided,
                                                           delta))
    out["library_ms"] = event_ms(lambda: dense_dft(cfg, strided, delta,
                                                   reduced_angle), 3)
    profiling.reset()
    with profiling.recording():
        modem.demodulate_sfo(rx)
    out["counters"] = profiling.counters()
    profiling.reset()
    c = out["counters"]
    check(c["ofdm.czt_fused_rows"] == c["ofdm.czt_rows"]
          == c["ofdm.warped_rows"] == 2 * out["rows"], f"a demodulate_sfo "
          f"step's counters: {c}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out["step_ms"] = median_ms(lambda: modem.demodulate_sfo(rx), runs=5)
    out["step_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    # the step is the device's (the host runs well ahead of it), so the
    # tables cost it their device time; table_ms, CUDA events over
    # back-to-back calls, is the rate the host launches them at
    out["table_share_of_step_pct"] = (
        0.2 * sum(out["table_ops_us"].values()) / out["step_ms"])
    out["table_host_share_of_step_pct"] = (200.0 * out["table_ms"]
                                            / out["step_ms"])
    record("warped_dft", out, print_too=True)
    check(out["table_share_of_step_pct"] < 1.0, f"the chirp tables of the "
          f"two warped calls take {out['table_share_of_step_pct']:.2f} % of "
          "a step's device time")
    print(smi, flush=True)


def run_wide_routes(counters, total, modem, rx, payload, delays,
                    label) -> dict:
    """A wide band's other routes on the card, each once through
    `run_path` with every launch counter at 0 (every row CRC-ok, the first
    rows the CPU's): `demodulate_sfo` of the band's batch recipe at
    +SFO_PPM (clock_ppm within 10 ppm of it), the warped DFT at the loop's
    δ̂ against its host formula (`hold_warped_dft`), `demodulate_sc` with
    the loop on the same batch (SC timing starts early at CP = N/4, by up to
    0.36·cp in gf3x too: held within the CP), `demodulate_dd` on the band's
    batch, and `decode(dd='on')` and `decode(sync='sc', sfo='on')` of one
    recording of each; step ms of the three batch routes. Adds the
    launches to `total`."""
    cfg = modem.cfg
    Bk = rx.shape[0]
    rx_np, pay_s, del_s = sfo_batch(modem, Bk, SFO_PPM,
                                    np.random.default_rng(2))
    rx_s = torch.as_tensor(rx_np, device=rx.device)
    del rx_np
    out = {}
    for route, x, pay, dl, entry, kw, tol in (
            ("sfo", rx_s, pay_s, del_s, "demodulate_sfo", None, None),
            ("sc_sfo", rx_s, pay_s, del_s, "demodulate_sc",
             dict(sfo_correct=True), cfg.cp),
            ("dd", rx, payload, delays, "demodulate_dd", None, None)):
        launches, _, diag, sync_err = run_path(
            modem, x, pay, dl, counters, f"wide {label}, {route}",
            entry=entry, entry_kw=kw, sync_tol=tol)
        for name in ("minsum_totals", "fused_eq_demap"):
            check(launches[name] > 0, f"wide {label}, {route}: {name} did "
                  f"not launch: {launches}")
        # the loop's two warped DFTs, each one launch of the fused chirp-z
        # kernel (every wide band's L is one it is built for)
        want = 0 if route == "dd" else 2
        check(launches["czt_fused"] == want
              and launches["czt_pre"] == launches["czt_post"] == 0,
              f"wide {label}, {route}: the fused chirp-z kernel launched "
              f"{launches['czt_fused']} times, not {want}, the chain's passes "
              f"{launches['czt_pre']} and {launches['czt_post']}, not 0")
        sum_counts(total, launches)
        ppm = diag.clock_ppm.float()
        if route != "dd":
            check(float((ppm - SFO_PPM).abs().max()) < 10.0,
                  f"wide {label}, {route}: clock_ppm off the planted "
                  f"{SFO_PPM} by {float((ppm - SFO_PPM).abs().max())}")
        out[route] = dict(
            launches=launches, sync_err=sync_err,
            clock_ppm_median=float(ppm.median()),
            step_ms=median_ms(lambda: getattr(modem, entry)(
                x, **(kw or {})), runs=5))
    syms, sc_win, roll = modem._cut_frame(rx_s, modem._sync(rx_s)[0])
    delta = modem._two_pass_delta(syms, sc_win, roll)
    out["warped_dft"] = hold_warped_dft(cfg, syms[:2], delta)
    del syms, sc_win, roll
    for kw, x, pay in ((dict(dd="on"), rx, payload),
                       (dict(sync="sc", sfo="on"), rx_s, pay_s)):
        res, launches = launch_counts(counters, lambda: modem.decode(
            x[0].cpu().numpy(), **kw))
        check(res.crc_ok and res.payload == pay, f"decode of one {label} "
              f"recording with {kw}: not CRC-ok")
        sum_counts(total, launches)
        out["decode " + ", ".join(f"{k}={v}" for k, v in kw.items())] = \
            launches
    w = out["warped_dft"]
    print(f"wide {label} routes: demodulate_sfo at +{SFO_PPM:.0f} ppm "
          f"(clock_ppm median {out['sfo']['clock_ppm_median']:.2f}), "
          f"demodulate_sc with the loop (sync within "
          f"{out['sc_sfo']['sync_err']} samples), demodulate_dd: "
          f"{Bk}/{Bk} rows CRC-ok each, steps "
          f"{ {r: round(out[r]['step_ms'], 3) for r in ('sfo', 'sc_sfo', 'dd')} } "
          f"ms; warped DFT at {w['delta_ppm']:.2f} ppm within "
          f"{w['max_abs_err'] / w['mean_abs']:.2g} x mean|Y| of its host "
          f"formula, {w['db_vs_float64']:.1f} dB vs float64 (gate "
          f"{w['gate_db']} dB; gf3x's formula {w['formula_db_vs_float64']:.1f}"
          f" dB, {w['formula_db_cpu_test']} dB in the CPU test); "
          f"decode(dd='on') "
          f"and decode(sync='sc', sfo='on') of one recording CRC-ok",
          flush=True)
    del rx_s
    return out


# the onset phase's batches: (label, frames, through the loaded cell's room)
ISI_ONSET_CASES = (("room", B, True), ("room B = 1", 1, True),
                   ("one-tap", B, False), ("one-tap B = 1", 1, False))
ISI_ONSET_CELL = "gf3-8192-loaded.b1024-15db-room"


def run_isi_onset(dev, counters) -> dict:
    """The ISI profile's onset kernel (`isi_onset`) on the inputs the main
    path gives it at gf3-8192 (ISI_ONSET_CASES): through the room, the
    benchmark cell ISI_ONSET_CELL's loaded configuration on its traffic
    (`benchmark.traffic.make_inputs`, seed 1234567); one-tap, gf3-8192's
    uniform configuration on config 5's batch recipe. Each batch goes
    through `Modem.demodulate` once with every launch counter at 0: the
    onset kernel launches once (one channel estimate), and its inputs and
    output, copied there, are held bit for bit (`torch.equal`) against the
    plain version on the CPU; the kernel's µs beside its byte bound (h
    read once, the anchor and noise_var read once, the anchor written
    once). Returns {label: what was held and timed}."""
    from benchmark import harness
    from benchmark.traffic import make_inputs
    from gf3x_torch import GF3_STANDARD, Modem
    from gf3x_torch.ops import chanest
    from gf3x_torch.ops.kernels.isi_onset import isi_onset_plain

    cell = harness.load_cell(ISI_ONSET_CELL)
    loaded, rcfg = harness._configs(cell)
    uniform = GF3_STANDARD.replace(**WIDE_BANDS["gf3-8192"])
    modems = {}
    out = {}
    for label, Bk, room in ISI_ONSET_CASES:
        cfg = loaded if room else uniform
        margin = int(cell.traffic["margin"]) if room else MARGIN
        if room not in modems:
            modems[room] = Modem(cfg, max_delay=margin + cfg.cp, device=dev)
        modem = modems[room]
        if room:
            rx = make_inputs(rcfg, dict(cell.traffic, batch=Bk, ring=1),
                             1234567, dev).ring[0]
        else:
            rx_np, _, _ = build_batch(modem, Bk, MARGIN,
                                      np.random.default_rng(0))
            rx = torch.as_tensor(rx_np, device=dev)
            del rx_np
        seen = []
        kernel = chanest.isi_onset

        def spy(h, anchor, noise_var, **kw):
            a = kernel(h, anchor, noise_var, **kw)
            seen.append((h.clone(), anchor.clone(), noise_var.clone(), kw,
                         a.clone()))
            return a

        chanest.isi_onset = spy
        try:
            (_, diag), launches = launch_counts(
                counters, lambda: modem.demodulate(rx))
        finally:
            chanest.isi_onset = kernel
        check(launches["isi_onset"] == 1 and len(seen) == 1,
              f"isi_onset {label}: {launches['isi_onset']} launches and "
              f"{len(seen)} calls in one demodulate, not 1")
        h, a0, nv, kw, got = seen[0]
        want = isi_onset_plain(h.cpu(), a0.cpu(), nv.cpu(), **kw)
        check(torch.equal(got.cpu(), want), f"isi_onset {label}: the "
              "kernel's anchors differ from its plain version's")
        n = h.shape[-1]
        nbytes = Bk * n * 8 + 3 * Bk * 4
        t = kernel_us(lambda: kernel(h, a0, nv, **kw), ["isi_onset"])
        out[label] = dict(
            batch=Bk, n=n, D=kw["D"], span=kw["span"], g=kw["g"],
            moved=int((want != a0.cpu()).sum()),
            isi_db_max=float(diag.isi_db.max()),
            isi_db_median=float(diag.isi_db.median()),
            fec_unsat=int(diag.fec_unsat.sum()), launches=launches,
            kernel_us=t["us"], by=t["by"], **bound(nbytes))
        r = out[label]
        print(f"isi_onset {label} (B {Bk}, h {Bk} x {n}, D {kw['D']}, span "
              f"{kw['span']}): one launch in demodulate, bit for bit to the "
              f"plain version; {r['moved']}/{Bk} anchors moved; isi_db "
              f"median {r['isi_db_median']:.1f}, max {r['isi_db_max']:.1f} "
              f"dB; {r['kernel_us']:.1f} us ({r['by']}) against a bound of "
              f"{1e3 * r['bound_ms']:.1f} us", flush=True)
        del rx, seen, h, a0, nv, got, diag
    return out


def isi_onset_only() -> None:
    """`--isi-onset`: the onset phase alone after the build's ptxas report;
    prints its result as one JSON line and the card's name and power
    limit."""
    from gf3x_torch.utils.device import kernel_lib, library_path

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    kernel_lib()
    print("build: " + build_report(
        (library_path().parent / "build.log").read_text()), flush=True)
    record("isi_onset", run_isi_onset(torch.device("cuda", 0),
                                      launch_counters()), print_too=True)
    print(smi, flush=True)


# the histogram phase's cases on the main path: (label, benchmark cell
# whose configuration and traffic make the batch, or None for config 5 on
# its batch recipe, frames)
LLR_HIST_CASES = (("gf3-8192 20 dB", "gf3-8192.b1024-20db", B),
                  ("gf3-8192 20 dB B = 1", "gf3-8192.b1024-20db", 1),
                  ("gf3-8192 30 dB", "gf3-8192.b1024-30db", B),
                  ("loaded, room", "gf3-8192-loaded.b1024-15db-room", B),
                  ("loaded, room B = 1", "gf3-8192-loaded.b1024-15db-room",
                   1),
                  ("config 5", None, B))
# aten's kernels of the histogram the kernel replaced: the gather of every
# 8th LLR and the scatter_add_ into 16 bins
ATEN_HIST = ("index_elementwise_kernel", "_scatter_gather_elementwise")
# the synthetic rows: (rows, LLRs a row, samples in the table)
LLR_HIST_WIDE = (600, 640_000, 80_000)


def kernels_under(prof, span: str) -> tuple:
    """The device kernels launched from inside the host span `span` (a
    record_function of that name) in a profile, as [(kernel name, µs)],
    and the aten ops run inside it: each kernel matched by correlation id
    to the CUDA runtime call that launched it, kept where that call lies
    inside one of the span's host intervals."""
    from benchmark.trace import _RUNTIME   # the calls that launch device work

    cpu = torch.autograd.DeviceType.CPU
    evs = list(prof.profiler.kineto_results.events())
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
             if e.name() == span and e.device_type() == cpu]

    def inside(t):
        return any(a <= t <= b for a, b in spans)
    calls = {e.correlation_id(): e.start_ns() for e in evs
             if e.device_type() == cpu and _RUNTIME.match(e.name())}
    kernels = [(e.name(), e.duration_ns() * 1e-3) for e in evs
               if e.device_type() != cpu and not e.is_user_annotation()
               and e.correlation_id() in calls
               and inside(calls[e.correlation_id()])]
    ops = sorted({e.name() for e in evs if e.device_type() == cpu
                  and e.name().startswith("aten::")
                  and inside(e.start_ns())})
    return kernels, ops


def llr_hist_edge_values() -> dict:
    """The |LLR| histogram's edge values by group, float32: each bucket's
    lower edge 2^(k−2) and the float just below it for k = 0..16, zeros,
    the smallest denormal, the largest float, infinities and NaN."""
    f32 = np.float32
    edges = np.array([2.0 ** (k - 2) for k in range(17)], f32)
    return {"zeros": np.array([0.0, -0.0], f32),
            "denormal": np.array([np.finfo(f32).smallest_subnormal], f32),
            "edges": edges,
            "below_edges": np.nextafter(edges, f32(0.0)),
            "largest": np.array([np.finfo(f32).max], f32),
            "infinities": np.array([np.inf, -np.inf], f32),
            "nan": np.array([np.nan, -np.nan], f32)}


def llr_hist_edges(dev) -> torch.Tensor:
    """A synthetic (2, 4096) row pair of the edge values, tiled, the second
    row their negation."""
    row = np.resize(np.concatenate(list(llr_hist_edge_values().values())),
                    4096)
    return torch.as_tensor(np.stack([row, -row]), device=dev)


def run_llr_hist(dev, counters) -> dict:
    """The diagnostics' |LLR| histogram kernel (`llr_hist`) on the LLRs the
    main path gives it (LLR_HIST_CASES): each batch goes through
    `Modem.demodulate` once with every launch counter at 0 — one histogram
    launch — and the kernel's counts on that call's own LLRs and table,
    copied there, are held integer-equal to `llr_hist_plain` on the card;
    each row's counts sum to the table's length. Then synthetic rows: the
    edge values, and 600 rows of 640 000 LLRs at magnitudes over every
    bucket through an 80 000-sample table (a thread flushes its 8-bit
    fields mid-row), at B = 600 and 1 (a row split over blocks). A
    profiled `demodulate` at gf3-8192 20 dB shows which kernels the
    `gf3x.diag` spans launch: no aten scatter or index kernel. The kernel's
    µs at gf3-8192, B = 1024, against its byte bound (4 bytes a sample in,
    64 a row out) and the sector floor (the 32-byte sectors the table
    touches, a row each), with the plain version's times. Returns {label:
    what was held and timed}."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness
    from benchmark.traffic import make_inputs
    from gf3x_torch import GF3_STANDARD, Modem
    from gf3x_torch.models import modem as modem_mod
    from gf3x_torch.ops.kernels.llr_hist import llr_hist_plain

    kernel = modem_mod.llr_hist
    modems, out = {}, {}
    for label, cell_name, Bk in LLR_HIST_CASES:
        if cell_name is None:
            cfg, margin = GF3_STANDARD, MARGIN
        else:
            cell = harness.load_cell(cell_name)
            cfg, rcfg = harness._configs(cell)
            margin = int(cell.traffic["margin"])
        if cell_name not in modems:
            modems.clear()
            modems[cell_name] = Modem(cfg, max_delay=margin + cfg.cp,
                                      device=dev)
        modem = modems[cell_name]
        if cell_name is None:
            rx_np, _, _ = build_batch(modem, Bk, MARGIN,
                                      np.random.default_rng(0))
            rx = torch.as_tensor(rx_np, device=dev)
            del rx_np
        else:
            rx = make_inputs(rcfg, dict(cell.traffic, batch=Bk, ring=1),
                             2147483901, dev).ring[0]
        seen = []

        def spy(llr, index):
            h = kernel(llr, index)
            seen.append((llr.clone(), index, h.clone()))
            return h

        modem_mod.llr_hist = spy
        try:
            (_, diag), launches = launch_counts(
                counters, lambda: modem.demodulate(rx))
        finally:
            modem_mod.llr_hist = kernel
        check(launches["llr_hist"] == 1 and len(seen) == 1,
              f"llr_hist {label}: {launches['llr_hist']} launches and "
              f"{len(seen)} calls in one demodulate, not 1")
        llr, table, got = seen[0]
        want = llr_hist_plain(llr, table)
        check(torch.equal(got, want) and torch.equal(diag.llr_hist, got),
              f"llr_hist {label}: the kernel's counts differ from the plain "
              "version's")
        check(bool((got.sum(-1) == table.numel()).all()),
              f"llr_hist {label}: a row's counts do not sum to the table")
        n = table.numel()
        r = out[label] = dict(batch=Bk, raw_bits=llr.shape[1], samples=n,
                              launches=launches, counts=got.sum(0).tolist())
        if label == "gf3-8192 20 dB":
            sectors = int(torch.unique(table // 8).numel())
            r.update(timed(lambda: kernel(llr, table),
                           lambda: llr_hist_plain(llr, table),
                           4 * Bk * n + 64 * Bk, kernel="llr_hist"),
                     sectors_touched=sectors,
                     sectors_row=-(-llr.shape[1] // 8),
                     sector_floor_ms=Bk * sectors * 32 / HBM_BPS * 1e3)
            print(f"llr_hist gf3-8192 B = 1024: {r['kernel_us']:.1f} us "
                  f"kernel ({r['kernel_us_by']}), {1e3 * r['device_ms']:.1f}"
                  f" us by events, against a byte bound of "
                  f"{1e3 * r['bound_ms']:.1f} us and a sector floor of "
                  f"{1e3 * r['sector_floor_ms']:.1f} us ({sectors} of "
                  f"{r['sectors_row']} sectors a row); plain version "
                  f"{r['plain_ms']:.3f} ms host", flush=True)
            modem.demodulate(rx)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                modem.demodulate(rx)
                torch.cuda.synchronize()
            under, ops = kernels_under(prof, "gf3x.diag")
            r["diag_kernels"], r["diag_ops"] = under, ops
            print(f"llr_hist: kernels under gf3x.diag {under}; aten ops "
                  f"there {ops}", flush=True)
            check(any("llr_hist" in k for k, _ in under), "llr_hist: the "
                  "profiler saw no llr_hist kernel under gf3x.diag")
            check(not any(n in k for k, _ in under for n in ATEN_HIST)
                  and "aten::scatter_add_" not in ops
                  and "aten::index" not in ops, "llr_hist: aten's scatter or "
                  "index kernel under gf3x.diag")
        print(f"llr_hist {label} (B {Bk}, {n} samples a row): one launch in "
              f"demodulate, integer-equal to the plain version; counts "
              f"{r['counts']}", flush=True)
        del rx, seen, llr, got, want, diag

    modems.clear()
    torch.cuda.empty_cache()
    edges = llr_hist_edges(dev)
    idx = torch.arange(edges.shape[1], dtype=torch.int32, device=dev)
    got = kernel(edges, idx)
    check(torch.equal(got, llr_hist_plain(edges, idx)),
          "llr_hist edges: the kernel's counts differ from the plain "
          "version's")
    out["edges"] = dict(counts=got.tolist())
    rows, R, n = LLR_HIST_WIDE
    g = torch.Generator(device=dev).manual_seed(24)
    wide = (torch.randn(rows, R, device=dev, generator=g)
            * 10.0 ** (8.0 * torch.rand(rows, R, device=dev, generator=g)
                       - 4.0))
    table = torch.sort(torch.randperm(R, device=dev, generator=g)[:n]
                       ).values.to(torch.int32)
    for rows in (rows, 1):
        got = kernel(wide[:rows], table)
        check(torch.equal(got, llr_hist_plain(wide[:rows], table)),
              f"llr_hist synthetic B = {rows}: the kernel's counts differ "
              "from the plain version's")
        out[f"synthetic B = {rows}"] = dict(counts=got.sum(0).tolist())
    print("llr_hist: the edge values and 640 000-LLR rows (B = 600 and 1) "
          "integer-equal to the plain version", flush=True)
    return out


def llr_hist_only() -> None:
    """`--llr-hist`: the histogram phase alone after the build's ptxas
    report; prints its result as one JSON line and the card's name and
    power limit."""
    from gf3x_torch.utils.device import kernel_lib, library_path

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    kernel_lib()
    print("build: " + build_report(
        (library_path().parent / "build.log").read_text()), flush=True)
    record("llr_hist", run_llr_hist(torch.device("cuda", 0),
                                    launch_counters()), print_too=True)
    print(smi, flush=True)


def tail_bytes(cfg, Bk: int, kernel: str) -> float:
    """The bytes kernel 2, A or B must move on a batch of Bk frames: 2 reads
    the data symbols' spectra, Ĥ and the noise floor and writes the LLRs,
    slope and cpe and two per-frame sums (`tail_timed`); A reads the same
    and writes the derotated bins and three per-symbol rows; B reads the
    data bins' eq values, their Ĥ and the noise floor and writes the LLRs
    and two per-symbol rows."""
    D, U, nd = cfg.n_data_symbols, cfg.n_used, cfg.n_data_bins
    if kernel == "fused_eq_demap":
        return (8 * Bk * D * U + 8 * Bk * U + 4 * Bk
                + 4 * Bk * cfg.raw_bits_per_frame + 4 * 2 * Bk * D
                + 4 * 2 * Bk)
    if kernel == "eq_track":
        return 8 * Bk * D * U * 2 + 8 * Bk * U + 4 * Bk + 3 * 4 * Bk * D
    return (8 * Bk * D * nd + 8 * Bk * nd + 4 * Bk * D
            + 4 * Bk * cfg.raw_bits_per_frame + 2 * 4 * Bk * D)


def forced_layouts(cfg, Bk: int, sms: int, demap: bool) -> dict:
    """The launches of kernel 2 (`demap`) or A that a batch of Bk frames of
    `cfg` does not pick but must give the same bytes in: `teamed_geometry`'s
    (spilled past the pilot bound) and the picked launch spilled
    (`spilled_geometry`)."""
    from gf3x_torch.ops.kernels import eq_layout

    picked = eq_layout.fused_eq_geometry(cfg, Bk, sms, demap=demap)
    return {"teamed": eq_layout.teamed_geometry(
                cfg.n_used, cfg.n_pilots, cfg.n_data_symbols, Bk, sms, demap,
                spill=cfg.n_pilots > eq_layout.MAX_SHARED_PILOTS),
            "spilled": eq_layout.spilled_geometry(picked, cfg, demap)}


def hold_layouts(label, fn, n_hashed: int, forced: dict):
    """fn(geometry) in the launch its geometry picks (None) and in each
    launch of `forced` ({name: launch}): the first `n_hashed` outputs'
    sha256 equal, the rest (kernel 2's frame sums, added in another order
    by the teamed layout) within 1e-4 rel. Returns (the picked launch's
    outputs, the sha256s)."""
    natural = fn(None)
    sha = [sha256_of(t) for t in natural[:n_hashed]]
    for force, geo in forced.items():
        got = fn(geo)
        check([sha256_of(t) for t in got[:n_hashed]] == sha, f"{label}: "
              f"the {force} layout's outputs differ from the picked one's")
        for a, b in zip(got[n_hashed:], natural[n_hashed:]):
            rel = float(((a - b).abs() / b.abs()).max())
            check(rel <= 1e-4, f"{label}: the {force} layout's frame sums "
                  f"differ by {rel} rel")
    return natural, sha


def wide_timed(cfg, Bk, name, fn, geo) -> dict:
    """A tail kernel's µs (profiler) in the layout its geometry picks,
    beside its bound (bytes over HBM_BPS); the other layouts' times are
    the layouts phase's."""
    return dict(layout=geo.layout, geometry=str(geo),
                kernel_us=kernel_us(lambda: fn(None), [name])["us"],
                **bound(tail_bytes(cfg, Bk, name)))


def run_wide(dev, counters, rows):
    """The wide bands at full width (WIDE_CASES, bench.py's batch recipe):
    on each, kernels A and B — and on a uniform config kernel 2 — held
    against their plain versions, kernel 2 bit for bit against A + B, the
    picked launch against the forced ones (`forced_layouts`; kernel B's
    staged layout against the streamed one) by the sha256 of every output
    (at gf3-16384 kernel B streams), each kernel's µs beside its bound;
    then `Modem.demodulate` with every launch counter at 0 (every row
    CRC-ok; kernels 6, 2 or A and B, and 3 launched) and its step
    timed. Kernel 8 is held at gf3-4096's cut; `use_cut_dft=True` decodes
    gf3-4096 and gf3-8192 on the two-stage cut (gf3x's fused cut refuses
    their SC window offset) and, at the CPs of WIDE_ALIGNED_CP, takes kernel
    8 at n_fft 4096 and declines it at 8192; `Modem.decode` of one gf3-4096
    recording runs kernels 7, 2 and 3. Adds the kernels' wide rows to
    `rows`; returns (the launch counts summed over every drive, {label:
    what was held and the step ms})."""
    from gf3x_torch import Modem
    from gf3x_torch.ops.kernels import cut_dft, eq_layout, fused_eq, split_eq

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    total, out = {name: 0 for name in counters}, {}
    for label, key, loaded, Bk in WIDE_CASES:
        cfg = layout_config(WIDE_BANDS[key], loaded)
        t0 = time.perf_counter()
        modem = Modem(cfg, max_delay=MARGIN + cfg.cp, device=dev)
        build_s = time.perf_counter() - t0
        rx_np, payload, delays = build_batch(modem, Bk, MARGIN,
                                             np.random.default_rng(0))
        rx = torch.as_tensor(rx_np, device=dev)
        del rx_np
        q, roll, kw, _, Y, H, nv = path_inputs(modem, rx)
        pv = modem.pilot_vals
        tables = (modem.demap_used, modem.demap_bits, modem.demap_off)
        held = dict(n_used=cfg.n_used, n_pilots=cfg.n_pilots,
                    n_data_bins=cfg.n_data_bins, batch=Bk,
                    modem_build_s=build_s)

        def track(geo):
            return split_eq.eq_track(cfg, Y, H, nv, pv, geometry=geo)

        hold_eq_track(cfg, Y, H, nv, pv, label)
        a_k, held["eq_track_sha256"] = hold_layouts(
            f"eq_track {label}", track, LAYOUT_HASHED["eq_track"],
            forced_layouts(cfg, Bk, sms, False))
        eq, nv_sym = a_k[0], a_k[3]

        def demap(geo):
            return split_eq.demap_bins(cfg, eq, H, nv_sym, tables,
                                       geometry=geo)

        _, errB, scaleB = hold_demap(cfg, eq, H, nv_sym, tables, label)
        b_k = demap(None)
        held["demap_bins_sha256"] = [sha256_of(t) for t in b_k]
        check([sha256_of(t) for t in demap(eq_layout.streamed_geometry(
            cfg, Bk, sms))] == held["demap_bins_sha256"], f"demap_bins "
            f"{label}: the streamed layout's outputs differ from the staged "
            "one's")
        held.update(demap_bins_max_abs_err=errB, demap_bins_mean_abs=scaleB)
        geoB = eq_layout.demap_geometry(cfg, Bk, sms)
        times = {"eq_track": wide_timed(
                     cfg, Bk, "eq_track", track, eq_layout.fused_eq_geometry(
                         cfg, Bk, sms, demap=False)),
                 "demap_bins": dict(
                     layout=geoB.layout, geometry=str(geoB),
                     kernel_us=kernel_us(lambda: demap(None),
                                         ["demap_bins"])["us"],
                     **bound(tail_bytes(cfg, Bk, "demap_bins")))}
        tail = ("eq_track", "demap_bins")
        if cfg.bit_loading is None:
            def fused(geo):
                return fused_eq.fused_eq_demap(cfg, Y, H, nv, pv,
                                               geometry=geo)

            _, err2, scale2 = hold_fused(cfg, Y, H, nv, pv, label)
            out2, held["fused_eq_demap_sha256"] = hold_layouts(
                f"fused_eq_demap {label}", fused,
                LAYOUT_HASHED["fused_eq_demap"],
                forced_layouts(cfg, Bk, sms, True))
            held.update(fused_eq_demap_max_abs_err=err2,
                        fused_eq_demap_mean_abs=scale2,
                        split_pair_rel=hold_split(modem, Y, H, nv, out2,
                                                  f"wide {label}"))
            times["fused_eq_demap"] = wide_timed(
                cfg, Bk, "fused_eq_demap", fused,
                eq_layout.fused_eq_geometry(cfg, Bk, sms))
            tail = ("fused_eq_demap",)
            del out2
        for name, t in times.items():
            rows[name].setdefault("wide", {})[label] = t
        if key == "gf3-4096":
            held["cut_dft"] = hold_cut_dft_path(cfg, rx, q, roll, kw, label)
            rows["cut_dft"].setdefault("wide", {})[label] = held["cut_dft"]
        del Y, H, nv, a_k, b_k, eq, nv_sym
        launches, bits, _, sync_err = run_path(modem, rx, payload, delays,
                                               counters, f"wide {label}")
        for name in ("gather_cut_group", "minsum_totals") + tail:
            check(launches[name] > 0, f"wide {label}: {name} did not launch: "
                  f"{launches}")
        other = (("eq_track", "demap_bins") if cfg.bit_loading is None
                 else ("fused_eq_demap",))
        check(all(launches[n] == 0 for n in other + ("cut_symbols",
                                                      "cut_dft")),
              f"wide {label}: another cut or tail launched: {launches}")
        want = int(getattr(modem, "isi_M", None) is not None)
        check(launches["isi_onset"] == want, f"wide {label}: the ISI onset "
              f"kernel launched {launches['isi_onset']} times in one channel "
              f"estimate, not {want}")
        sum_counts(total, launches)
        step = median_ms(lambda: modem.demodulate(rx))
        held.update(step_ms=step, sync_err=sync_err, launches=launches,
                    data_symbols_per_s=Bk * cfg.n_data_symbols / (step / 1e3))
        print(f"wide {label} (n_fft {cfg.n_fft}, {cfg.n_used} used bins, "
              f"{cfg.n_pilots} pilots, {cfg.n_codewords} codewords, B {Bk}, "
              f"T {rx.shape[-1]}): kernels {', '.join(times)} held against "
              f"their plain versions and the layouts against each other "
              f"(sha256); "
              f"{ {n: (t['layout'], round(t['kernel_us'], 1), round(1e3 * t['bound_ms'], 1)) for n, t in times.items()} } "
              f"(layout, kernel us, bound us); demodulate "
              f"{Bk}/{Bk} rows CRC-ok, sync within {sync_err} samples, "
              f"launches {launches}; {step:.3f} ms/step; Modem({label}) "
              f"built in {build_s:.1f} s", flush=True)
        if not loaded:
            held["routes"] = run_wide_routes(counters, total, modem, rx,
                                             payload, delays, label)
        if not loaded and key in WIDE_ALIGNED_CP:
            held["use_cut_dft"] = run_wide_cut_dft(dev, counters, total,
                                                   modem, rx, payload,
                                                   delays, bits, label)
        if key == "gf3-4096":
            row0 = rx[0].cpu().numpy()
            res, launches = launch_counts(counters,
                                          lambda: modem.decode(row0))
            check(res.crc_ok and res.payload == payload, f"decode of one "
                  f"{label} recording: not CRC-ok")
            for name in ("gather_cut", "fused_eq_demap", "minsum_totals"):
                check(launches[name] > 0, f"decode of one {label} recording: "
                      f"{name} did not launch: {launches}")
            sum_counts(total, launches)
            held["decode_launches"] = launches
            print(f"decode of one {label} recording: CRC-ok, launches "
                  f"{launches}", flush=True)
        out[label] = held
        del modem, rx, q, roll, bits
    return total, out


def hold_cut_dft_path(cfg, rx, q, roll, kw, label) -> dict:
    """Kernel 8 against its plain version on a path's cut (spectra within
    1e-5 of their mean magnitude, the SC window equal), timed beside its
    bound: the symbol and SC windows in, the spectra and SC window out, and
    a real FFT (2.5·N·log2 N) plus the deroll (6 per bin) per symbol."""
    from gf3x_torch.ops.kernels import cut_dft

    kw8 = {k: kw[k] for k in ("valid", "block", "S", "body_off", "sc_off")}
    Y8, s8 = cut_dft.cut_dft(cfg, rx, q, roll, **kw8)
    Yp, sp = cut_dft.cut_dft_plain(cfg, rx, q, roll, **kw8)
    err, scale = float((Y8 - Yp).abs().max()), float(Yp.abs().mean())
    check(err <= 1e-5 * scale, f"cut_dft {label}: spectra differ from the "
          f"plain version by {err} > 1e-5 x mean|Y| {scale}")
    check(torch.equal(s8, sp), f"cut_dft {label}: SC window differs")
    Bk, S, N, U = rx.shape[0], kw8["S"], cfg.n_fft, cfg.n_used
    row = dict(max_abs_err=err, mean_abs=scale,
               geometry=str(cut_dft.cut_dft_geometry(N, S + 1)),
               kernel_us=kernel_us(lambda: cut_dft.cut_dft(
                   cfg, rx, q, roll, **kw8), ["cut_dft_kernel"])["us"],
               **bound(4 * Bk * (S + 1) * N + 8 * Bk * S * U + 4 * Bk * N
                       + 8 * Bk, Bk * S * (2.5 * N * np.log2(N) + 6.0 * U)))
    print(f"cut_dft at {label}'s cut ({Bk} x {rx.shape[-1]}): max |dY| "
          f"{err:.3g} (mean |Y| {scale:.3g}), SC window equal; "
          f"{row['geometry']}; kernel {row['kernel_us']:.1f} us, bound "
          f"{1e3 * row['bound_ms']:.1f} us", flush=True)
    return row


def run_wide_cut_dft(dev, counters, total, modem, rx, payload, delays, bits,
                     label) -> dict:
    """`use_cut_dft=True` on a wide band: on its own CP the two-stage cut
    (kernel 6; gf3x's fused cut refuses the geometry), no kernel 8 launch
    and the bits of `demodulate`; at WIDE_ALIGNED_CP's CP, kernel 8 at
    n_fft 4096 (held at that path's cut) and kernel 1 at 8192 (kernel 8
    declined by its n_fft range), every row CRC-ok. Adds the launches to
    `total`; returns what was held."""
    from gf3x_torch import Modem
    from gf3x_torch.ops.kernels import cut_dft

    cfg = modem.cfg
    m8 = Modem(cfg, max_delay=MARGIN + cfg.cp, device=dev, use_cut_dft=True)
    launches, bits8, _, _ = run_path(m8, rx, payload, delays, counters,
                                     f"wide {label}, use_cut_dft")
    check(launches["cut_dft"] == 0 and launches["gather_cut_group"] > 0
          and torch.equal(bits8, bits), f"wide {label}, use_cut_dft: "
          f"kernel 8 launched or bits differ: {launches}")
    sum_counts(total, launches)
    held = {"own_cp": launches}
    cfg_a = cfg.replace(cp=WIDE_ALIGNED_CP[label])
    m_a = Modem(cfg_a, max_delay=MARGIN + cfg_a.cp, device=dev,
                use_cut_dft=True)
    rx_np, payload_a, delays_a = build_batch(m_a, rx.shape[0], MARGIN,
                                             np.random.default_rng(1))
    rx_a = torch.as_tensor(rx_np, device=dev)
    del rx_np
    takes = cut_dft.takes(cfg_a)
    check(takes == (cfg_a.n_fft <= 4096) and m_a._takes_cut_dft(
        rx_a.shape[-1]) == takes, f"{label} at cp {cfg_a.cp}: route")
    if takes:
        q, roll, kw, _, _, _, _ = path_inputs(m_a, rx_a)
        held["kernel8"] = hold_cut_dft_path(cfg_a, rx_a, q, roll, kw,
                                            f"{label} at cp {cfg_a.cp}")
    launches, _, _, _ = run_path(m_a, rx_a, payload_a, delays_a, counters,
                                 f"wide {label} at cp {cfg_a.cp}, "
                                 "use_cut_dft")
    cut = "cut_dft" if takes else "cut_symbols"
    check(launches[cut] > 0 and launches["cut_dft" if not takes
                                         else "cut_symbols"] == 0,
          f"{label} at cp {cfg_a.cp}, use_cut_dft: {cut} must launch alone: "
          f"{launches}")
    sum_counts(total, launches)
    held[f"cp{cfg_a.cp}"] = launches
    print(f"use_cut_dft at {label}: own CP {cfg.cp} on the two-stage cut "
          f"(kernel 6, no kernel 8), bits equal; at CP {cfg_a.cp} (aligned) "
          f"{cut}, {rx.shape[0]}/{rx.shape[0]} rows CRC-ok", flush=True)
    return held


# a float diagnostic of the two-shard decode within this share of its mean
# magnitude of the one-batch decode's: 1e-4, but 1e-2 for the ISI floor and
# its tail/total ratio in dB, which come from a small difference of
# near-equal energies (`ops.chanest.isi_profile`), where the batch's matmul
# shape moves the last bits of each
MESH_DIAG_REL = dict(isi_var=1e-2, isi_db=1e-2)
MESH_INTEGER_DIAG = ("sync_start", "fec_iters", "fec_unsat")
# the |LLR| histogram counts LLRs by power-of-two bucket, so an LLR on a
# bucket edge may move one bucket when its last bits move: each frame's
# counts sum the same, and at most this share of the counts moves
MESH_HIST_MOVED = 1e-4


def run_mesh(dev, counters, meshes: dict, cfg=None):
    """`gf3x_torch.parallel` on the batch of `cfg` (config 5 by default;
    B = 1024) on `dev`, over each of `meshes` ({label: mesh}):
    `sharded_decode` gives bits equal to `Modem.demodulate`'s and, on a
    mesh of one shard, every diag field equal; on more shards (each on its own card, or two on one card) the
    integer diagnostics equal and the float ones within MESH_DIAG_REL;
    `sharded_pipeline_step` at 25 dB gives BER 0 and ok, its bits the
    planted ones. Returns (the launch counts summed, numbers with each
    entry's step ms)."""
    from gf3x_torch import GF3_STANDARD, Modem
    from gf3x_torch.parallel import sharded_decode, sharded_pipeline_step

    cfg = cfg or GF3_STANDARD
    tail = (("fused_eq_demap",) if cfg.bit_loading is None
            else ("eq_track", "demap_bins"))
    modem = Modem(cfg, max_delay=MARGIN + cfg.cp, device=dev)
    rx_np, payload, _ = build_batch(modem, B, MARGIN,
                                    np.random.default_rng(0))
    rx = torch.as_tensor(rx_np, device=dev)
    bits_u, diag_u = modem.demodulate(rx)
    total, out = {name: 0 for name in counters}, {}
    for label, mesh in meshes.items():
        dec = sharded_decode(modem, mesh)
        (bits, diag), launches = launch_counts(counters, lambda: dec(rx))
        sum_counts(total, launches)
        check(torch.equal(bits, bits_u), f"mesh {label}: bits differ from "
              "Modem.demodulate's")
        rel = {}
        for name in diag_u._fields:
            a, b = getattr(diag, name), getattr(diag_u, name)
            check(a.shape == b.shape and a.device == dev, f"mesh {label}: "
                  f"diag.{name} shape or device")
            if torch.equal(a, b):
                rel[name] = 0.0
                continue
            check(len(mesh) > 1 and name not in MESH_INTEGER_DIAG,
                  f"mesh {label}: diag.{name} differs from Modem.demodulate's")
            if name == "llr_hist":
                rel[name] = float((a - b).abs().sum() / 2 / b.sum())
                check(torch.equal(a.sum(-1), b.sum(-1))
                      and rel[name] <= MESH_HIST_MOVED, f"mesh {label}: "
                      f"{rel[name]} of the LLR histogram's counts moved")
                continue
            rel[name] = float((a - b).abs().max() / b.abs().mean())
            check(rel[name] <= MESH_DIAG_REL.get(name, 1e-4), f"mesh {label}: "
                  f"diag.{name} differs by {rel[name]} of its scale")
        for name in ("cut_symbols", "minsum_totals") + tail:
            check(launches[name] == len(mesh), f"mesh {label}: {name} "
                  f"launched {launches[name]} times on {len(mesh)} shards")
        step = median_ms(lambda: dec(rx))
        out[f"sharded_decode {label}"] = dict(step_ms=step, launches=launches,
                                              diag_rel=rel)
        same = ("every field equal" if len(mesh) == 1 else "integer fields "
                f"equal, float fields within {max(rel.values()):.3g} rel")
        print(f"sharded_decode on {label} ({len(mesh)} shard(s) of "
              f"{B // len(mesh)}): bits equal to Modem.demodulate's, diag "
              f"{same}, launches {launches}; {step:.3f} ms/step", flush=True)
    info = torch.as_tensor(np.random.default_rng(1).integers(
        0, 2, (B, cfg.payload_bits_per_frame), dtype=np.uint8))
    for label, mesh in meshes.items():
        step_fn = sharded_pipeline_step(modem, mesh)
        (ber, ok, bits), launches = launch_counts(
            counters, lambda: step_fn(info, 1, 25.0))
        sum_counts(total, launches)
        check(float(ber) == 0.0 and bool(ok)
              and torch.equal(bits.cpu(), info), f"pipeline step on {label}: "
              f"ber {float(ber)}, ok {bool(ok)}")
        step = median_ms(lambda: step_fn(info, 1, 25.0))
        out[f"pipeline_step {label}"] = dict(step_ms=step, launches=launches)
        print(f"sharded_pipeline_step on {label} at 25 dB, B = {B}: ber 0, ok,"
              f" bits the planted ones, launches {launches}; {step:.3f} ms/step",
              flush=True)
    return total, out


def run_examples(dev, counters):
    """The four walkthroughs of `gf3x_torch.examples` on the card, each
    `main(tmp, device='cuda')` into a temporary directory, with their own
    assertions; each must launch kernels, and the adaptive link's loaded
    transfer kernels A and B. Returns (the launch counts summed, seconds
    and launches per walkthrough)."""
    from gf3x_torch.examples import EXAMPLES

    total, out = {name: 0 for name in counters}, {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"gf3x_torch.examples.{name}")
        buf = io.StringIO()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                _, launches = launch_counts(
                    counters, lambda: mod.main(tmp, device="cuda"))
            secs = time.perf_counter() - t0
        sum_counts(total, launches)
        check(launches["minsum_totals"] > 0, f"example {name}: kernel 3 did "
              f"not launch: {launches}")
        if name == "adaptive_link":
            check(launches["eq_track"] > 0 and launches["demap_bins"] > 0,
                  f"example {name}: kernels A and B did not launch")
        out[name] = dict(seconds=secs, launches=launches)
        last = buf.getvalue().strip().splitlines()[-1]
        print(f"example {name}: passed its assertions in {secs:.3f} s; "
              f"launches {launches}; it ended: {last}", flush=True)
    return total, out


# kernel 3 at lifts above 512 ("lifts"): (z, rate, codewords) held bit for
# bit at σ = 0.8 — z = 520 (several checks a thread, messages in shared
# memory), 600 (z % 32 ≠ 0, messages in global memory), 768, 1024, 2048
# (past the check pass's 1076: four codewords a block), 2400 (the totals
# in global memory too) and 9000 (past 8609: the check pass's hard
# decisions in global memory); above z = 1024 on the all-zero codeword,
# since the host encoder's dense parity solve grows as z³ (tens of
# seconds at 2048, out of reach at 9000)
LIFTS = ((520, "1/2", 256), (600, "1/2", 256), (768, "1/2", 256),
         (1024, "1/2", 256), (2048, "1/2", 256), (2400, "1/2", 64),
         (9000, "1/2", 16))
# and the two wide configs whose codewords need those lifts, end to end:
# (WIDE_BANDS key, ldpc_z, frames per batch)
LIFT_PATHS = (("gf3-4096", 768, 1024), ("gf3-16384", 1024, 64))


class Lift:
    """Kernel 3's call at a lift and rate without an encoder (what
    `hold_minsum` needs of an LdpcCode)."""

    def __init__(self, z: int, rate: str):
        self.z, self.rate = z, rate

    def decode_totals(self, lam, iters):
        from gf3x_torch.ops.kernels import ldpc_bp

        return ldpc_bp.minsum_totals(lam, self.z, self.rate, iters)


def lift_llrs(z: int, rate: str, L: int, dev, sigma: float = 0.8):
    """L codewords' BPSK LLRs at σ, seeded by z: random codewords of
    `LdpcCode(z, rate)` up to z = 1024, else the all-zero codeword (any
    linear code's; min-sum treats every codeword alike)."""
    from gf3x_torch.fec.ldpc import LdpcCode

    g = torch.Generator(device=dev).manual_seed(z)
    if z <= 1024:
        code = LdpcCode(z, rate)
        u = torch.randint(0, 2, (L, code.k), generator=g, device=dev,
                          dtype=torch.uint8)
        bpsk = 1.0 - 2.0 * code.encode(u).to(torch.float32)
    else:
        code = Lift(z, rate)
        bpsk = torch.ones(L, 24 * z, device=dev)
    lam = (2.0 / sigma ** 2) * (bpsk + sigma * torch.randn(
        bpsk.shape, generator=g, device=dev))
    return code, lam.contiguous()


def run_lifts(dev, counters, rows) -> tuple:
    """Kernel 3 at lifts above 512: held bit for bit to its plain version
    at each of LIFTS (both passes launched), its µs per pass beside the
    bound (the LLRs in and the totals out, 2·L·24z·4 bytes over HBM_BPS)
    and the passes per codeword; then each of LIFT_PATHS through
    `Modem.demodulate` with every launch counter at 0: every row CRC-ok,
    kernel 3's check and decode passes launched. Returns (the launch
    counts summed, what was held and timed)."""
    from gf3x_torch import Modem
    from gf3x_torch.ops.kernels import ldpc_bp

    out = {}
    for z, rate, L in LIFTS:
        code, lam = lift_llrs(z, rate, L, dev)
        iters = 50
        held = hold_minsum(code, lam, iters, f"z = {z}, rate {rate}")
        k = kernel_us(lambda: code.decode_totals(lam, iters), MINSUM_KERNELS)
        geo = ldpc_bp.decode_geometry(z, rate)
        out[f"z={z}"] = dict(
            rate=rate, codewords=L, geometry=str(geo),
            check_warps=ldpc_bp.check_warps(z), kernel_us=k["us"],
            kernel_us_by_name=k["by_name"],
            passes_per_codeword=held["passes_sum"] / L, held=held,
            **bound(2 * L * 24 * z * 4))
        print(f"lifts z = {z} (rate {rate}, {L} codewords at sigma 0.8): "
              f"totals, unsat and passes bit-identical; {geo}, check pass "
              f"{ldpc_bp.check_warps(z)} codewords a block; kernel us "
              f"{k['by_name']}, bound {1e3 * out[f'z={z}']['bound_ms']:.1f} "
              f"us; {held['passes_sum'] / L:.2f} passes a codeword", flush=True)
        del lam
    rows["minsum_totals"]["lifts"] = out
    total = {name: 0 for name in counters}
    for key, z, Bk in LIFT_PATHS:
        cfg = layout_config(WIDE_BANDS[key], False).replace(ldpc_z=z)
        t0 = time.perf_counter()
        modem = Modem(cfg, max_delay=MARGIN + cfg.cp, device=dev)
        build_s = time.perf_counter() - t0
        rx_np, payload, delays = build_batch(modem, Bk, MARGIN,
                                             np.random.default_rng(0))
        rx = torch.as_tensor(rx_np, device=dev)
        del rx_np
        label = f"{key} at z = {z}"
        launches, _, _, sync_err = run_path(modem, rx, payload, delays,
                                            counters, label)
        for name in ("minsum_totals", "minsum_check", "minsum_decode"):
            check(launches[name] > 0, f"{label}: {name} did not launch")
        sum_counts(total, launches)
        step = median_ms(lambda: modem.demodulate(rx))
        out[label] = dict(codewords_per_frame=cfg.n_codewords,
                          n=cfg.ldpc_n, batch=Bk, step_ms=step,
                          modem_build_s=build_s, launches=launches)
        print(f"lifts {label}: {cfg.n_codewords} codewords of n = "
              f"{cfg.ldpc_n} a frame, {Bk}/{Bk} rows CRC-ok, sync within "
              f"{sync_err} samples, launches {launches}; {step:.3f} ms/step; "
              f"Modem built in {build_s:.1f} s", flush=True)
        del modem, rx
    return total, out


# the reports' tables as gf3x's tools write them (tools/stress.py,
# tools/perf_report.py, tools/adapt_report.py; docs/ holds edited copies):
# per report, each table's heading (a prefix), its column headings and its
# first column, at the gf3 preset; and the cell that says gf3 closes at
# its top SNR ((table, row label, column, value))
STRESS_TABLES = (
    ("Sampling-clock offset (18 dB SNR)", "| clock offset | success |",
     [f"{p:+d} ppm" for p in (0, 500, 1000, 1500, 2000, 3000, -1500)]),
    ("Reverberation (15 dB SNR, DRR 5 dB)", "| room | success |",
     [f"rt60 = {r:.2f} s" for r in (0.0, 0.04, 0.08, 0.12, 0.20, 0.30)]),
    ("AWGN-only SNR (rate-1/2 LDPC QPSK waterfall)", "| SNR | success |",
     [f"{s} dB" for s in (4, 2, 1, 0, -1, -2)]),
    ("Impulse/burst interference (16 dB SNR, 0 dB burst)",
     "| burst | success |",
     [f"{n} symbols (of 20) destroyed" for n in (1, 3, 5, 7, 9, 11)]),
    ("Hard clipping (16 dB SNR)", "| limiter | success |",
     [f"clip at {v:.0%} of peak" for v in (0.5, 0.25, 0.1, 0.05, 0.03,
                                           0.02)]),
    ("Clock drift within the frame (18 dB SNR, +150 ppm base, 10 ppm "
     "wobble)", "| drift rate | success |",
     [f"{d:+d} ppm/s" for d in (0, 25, 50, 100, 200, 400, -200)]),
    ("Speaker/mic response (15 dB SNR, 4th-order LP at 15 kHz, 3 dB "
     "ripple)", "| transducer | success |",
     [f"highpass corner {c} Hz" for c in (150, 400, 800, 1200, 2000,
                                          3000)]),
)
PERF_GRIDS = {"gf3-robust": [-2, -1, 0, 1, 2, 3, 4],
              "gf3": [-1, 0, 1, 2, 3, 4, 6],
              "gf3-fast": [4, 6, 7, 8, 9, 10, 12],
              "gf3-hicap": [8, 9, 10, 11, 12, 14, 16],
              "gf3-turbo": [10, 12, 13, 14, 15, 16, 18]}
PERF_TABLES = tuple(
    (f"{name} — ", "| SNR (dB) | pre-FEC BER | post-FEC BER | FER | room "
     "FER |", [str(s) for s in snrs]) for name, snrs in PERF_GRIDS.items())
ADAPT_SNRS = (8, 10, 12, 14, 16, 18, 20)
ADAPT_TABLES = (
    ("Uniform presets (fixed rate, one clearing SNR each)",
     "| config | net kbit/s | " + " | ".join(f"{s} dB" for s in ADAPT_SNRS)
     + " |", ["gf3", "gf3-fast", "gf3-hicap", "gf3-turbo"]),
    ("Adaptive (probe at the operating SNR → per-bin table → run there)",
     "| SNR | net kbit/s | FER |", [f"{s} dB" for s in ADAPT_SNRS]),
)
REPORTS = {"stress": (STRESS_TABLES, (2, "4 dB", 1, "100%"), []),
           "perf_report": (PERF_TABLES, (1, "6", 3, "0.00"),
                           ["--no-plots"]),
           "adapt_report": (ADAPT_TABLES, (0, "gf3", 8, "0.00"), [])}
REPORT_TRIALS = 2


def report_tables(text: str) -> list:
    """A markdown report's tables: [(heading, column headings, [row cells,
    ...])], each row's cells stripped."""
    tables, heading, cols, body = [], None, None, None
    for ln in text.splitlines() + [""]:
        if ln.startswith("## "):
            heading = ln[3:]
        elif ln.startswith("|") and cols is None:
            cols, body = ln, []
        elif ln.startswith("|---"):
            continue
        elif ln.startswith("|"):
            body.append([c.strip() for c in ln.strip("|").split("|")])
        elif cols is not None:
            tables.append((heading, cols, body))
            cols = None
    return tables


def run_reports(dev, counters) -> tuple:
    """The three evaluation reports (`gf3x_torch.bench.stress`,
    `perf_report`, `adapt_report`) through their command lines on the card
    at REPORT_TRIALS trials, each into a temporary directory with every
    launch counter at 0: each writes only its --out file; its tables have
    the tool's headings, columns and first column (REPORTS); gf3 closes at
    its top SNR (the cell REPORTS names); kernels launched. Returns (the
    launch counts summed, seconds and launches per report)."""
    total, out = {name: 0 for name in counters}, {}
    for name, (tables, (ti, label, col, value), extra) in REPORTS.items():
        mod = importlib.import_module(f"gf3x_torch.bench.{name}")
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "report" / f"{name}.md"
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                _, launches = launch_counts(counters, lambda: mod.main(
                    ["--trials", str(REPORT_TRIALS), "--out", str(path)]
                    + extra))
            secs = time.perf_counter() - t0
            written = sorted(str(p.relative_to(tmp))
                             for p in Path(tmp).rglob("*") if p.is_file())
            check(written == [f"report/{name}.md"], f"report {name} wrote "
                  f"{written}")
            got = report_tables(path.read_text())
        check(len(got) == len(tables), f"report {name}: {len(got)} tables, "
              f"the tool writes {len(tables)}")
        for (head, cols, body), (want_head, want_cols, labels) in zip(
                got, tables):
            check(head.startswith(want_head) and cols == want_cols
                  and [r[0] for r in body] == labels,
                  f"report {name}: table {head!r} {cols!r} "
                  f"{[r[0] for r in body]} is not the tool's {want_head!r} "
                  f"{want_cols!r} {labels}")
        row = {r[0]: r for r in got[ti][2]}[label]
        check(row[col] == value, f"report {name}: gf3 at its top SNR "
              f"({label}) reads {row[col]}, not {value}")
        check(launches["minsum_totals"] > 0, f"report {name}: kernel 3 did "
              f"not launch: {launches}")
        sum_counts(total, launches)
        out[name] = dict(seconds=secs, launches=launches,
                         top_snr_cell=row[col])
        print(f"report {name}: {len(got)} tables with the tool's headings, "
              f"columns and rows at {REPORT_TRIALS} trials, gf3 at {label}: "
              f"{row[col]}; only --out written; {secs:.2f} s; launches "
              f"{launches}", flush=True)
    return total, out


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; there is no CPU "
                           "route")
    import gf3x_torch
    from gf3x_torch import GF3_FAST, GF3_STANDARD, GF3_TURBO, Modem
    from gf3x_torch.ops.kernels import (cut_dft, eq_layout, fused_eq,
                                        gather_cut, ldpc_bp, split_eq)
    from gf3x_torch.ops.ofdm import deroll, ofdm_dft
    from gf3x_torch.utils.device import kernel_lib, library_path, sm_count

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"device: {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    kernel_lib()
    build_s = time.perf_counter() - t0
    log = (library_path().parent / "build.log").read_text()
    print(f"build: {build_s:.1f} s ({library_path().name}); "
          + build_report(log), flush=True)

    def batch(cfg):
        modem = Modem(cfg, max_delay=MARGIN + cfg.cp, device=dev)
        rx_np, payload, delays = build_batch(modem, B, MARGIN,
                                             np.random.default_rng(0))
        return modem, torch.as_tensor(rx_np, device=dev), payload, delays

    # ---- config 5: the main path's inputs, bench.py's batch built by the port
    cfg = GF3_STANDARD
    modem, rx, payload, delays = batch(cfg)

    # ---- kernel 1 vs plain at the path's cut geometry
    q, roll, kw, syms_k, Y, H, nv = path_inputs(modem, rx)
    syms_k, scw_k = gather_cut.cut_symbols(rx, q, **kw)
    syms_p, scw_p = gather_cut.cut_symbols_plain(rx, q, **kw)
    check(torch.equal(syms_k, syms_p) and torch.equal(scw_k, scw_p),
          "cut_symbols kernel differs from its plain version")
    n_fft, blk = kw["n_fft"], kw["block"]
    offs = torch.cat([kw["body_off"] + s * kw["sym_len"] + kw["cp"]
                      + torch.arange(n_fft, device=dev)
                      for s in range(kw["S"])]
                     + [kw["sc_off"] + torch.arange(n_fft, device=dev)])
    rows = {"cut_symbols": dict(
        name="cut_symbols", route="cuda",
        source="gf3x_torch/csrc/cut_symbols.cu",
        replaces="gf3x/ops/pallas/gather_cut.py:242", max_abs_err=0.0,
        **timed(lambda: gather_cut.cut_symbols(rx, q, **kw),
                lambda: gather_cut.cut_symbols_plain(rx, q, **kw),
                2 * 4 * (syms_k.numel() + scw_k.numel()) + 4 * q.numel(),
                lib=gather_call(rx, cut_index(q, blk, offs)),
                kernel="cut_symbols_kernel"))}
    print(f"cut_symbols: equal; {rows['cut_symbols']['ms']:.3f} ms vs plain "
          f"{rows['cut_symbols']['plain_ms']:.3f} ms", flush=True)

    # ---- kernel 7 vs plain on an odd batch, config 5's first B − 1 rows:
    # the window cut a batch of partial 8-row groups takes
    nb7 = gather_cut.window_blocks(kw["block"], kw["S"], kw["n_fft"],
                                   kw["body_off"], kw["sym_len"],
                                   kw["sc_off"])
    odd7 = hold_gather_cut(rx[: B - 1].contiguous(), q[: B - 1].contiguous(),
                           nb7, kw["block"], kw["valid"])
    print(f"gather_cut at {B - 1} rows ({B - 1} x {rx.shape[-1]} -> "
          f"{B - 1} x {nb7 * kw['block']}): equal; {odd7['ms']:.3f} ms vs "
          f"plain {odd7['plain_ms']:.3f} ms", flush=True)

    # ---- kernel 2 vs plain on the path's spectra and channel estimate
    pv = modem.pilot_vals
    out2, err, scale = hold_fused(cfg, Y, H, nv, pv, "QPSK")
    llr_k = out2[0]
    split_rel = hold_split(modem, Y, H, nv, out2, "config 5")
    # and at the batches of one recording and of an odd few, which take
    # other launch geometries (one symbol per warp)
    for nb2 in (1, 7):
        hold_fused(cfg, Y[:nb2].contiguous(), H[:nb2].contiguous(),
                   nv[:nb2].contiguous(), pv, f"QPSK, B = {nb2}")
    r2 = rows["fused_eq_demap"] = dict(
        name="fused_eq_demap", route="cuda",
        source="gf3x_torch/csrc/fused_eq.cu",
        replaces="gf3x/ops/pallas/fused_eq.py:295", max_abs_err=err,
        geometry=str(eq_layout.fused_eq_geometry(cfg, B, sm_count(0))),
        split_pair_rel=split_rel,
        **tail_timed(cfg, lambda: fused_eq.fused_eq_demap(cfg, Y, H, nv, pv),
                     lambda: fused_eq.fused_eq_demap_plain(cfg, Y, H, nv,
                                                           pv), Y))
    # the teamed layout at config 5: the same bytes
    hold_layouts("fused_eq_demap config 5", lambda geo: fused_eq
                 .fused_eq_demap(cfg, Y, H, nv, pv, geometry=geo),
                 LAYOUT_HASHED["fused_eq_demap"],
                 {"teamed": forced_layouts(cfg, B, sm_count(0),
                                           True)["teamed"]})
    # the spilled layout (pilot scratch in global memory) forced at config
    # 5: kernels 2 and A give the picked layout's bytes
    spilled2, spilledA = (eq_layout.spilled_geometry(
        eq_layout.fused_eq_geometry(cfg, B, sm_count(0), demap=d), cfg, d)
        for d in (True, False))
    r2["spilled_sha256"] = hold_spilled(
        "fused_eq_demap config 5", lambda geo: fused_eq.fused_eq_demap(
            cfg, Y, H, nv, pv, geometry=geo), spilled2)
    spilled_A5 = hold_spilled(
        "eq_track config 5", lambda geo: split_eq.eq_track(
            cfg, Y, H, nv, pv, geometry=geo), spilledA)
    r2["spilled_kernel_us"] = kernel_us(lambda: fused_eq.fused_eq_demap(
        cfg, Y, H, nv, pv, geometry=spilled2), ["fused_eq_demap"])["us"]
    print(f"spilled layout forced at config 5: kernels 2 and A equal the "
          f"staged layout's sha256; kernel 2 "
          f"{r2['spilled_kernel_us']:.1f} us spilled", flush=True)
    print(f"fused_eq_demap: hard decisions equal, max |dLLR| {err:.3g} "
          f"(mean |LLR| {scale:.3g}), held at B = 1 and 7 too; llr, slope "
          f"and cpe bit-identical to the split pair's (evm, mean|llr| within "
          f"{split_rel:.2g} rel); {r2['geometry']}; {r2['ms']:.3f} ms vs "
          f"plain {r2['plain_ms']:.3f} ms; device {r2['device_ms']:.4f} ms, "
          f"kernel {r2['kernel_us']:.1f} us, bound {r2['bound_ms']:.4f} ms "
          f"({EXPECTED['fused_eq_demap']})", flush=True)

    # ---- kernel 3 vs plain: the path's codeword LLRs (20 dB, every
    # codeword valid before the first sweep: nothing queued), the same
    # codewords as BPSK LLRs at σ = 0.8 (nearly every codeword queued, a
    # few left unsatisfied) and a mixed batch (every fourth codeword noisy:
    # a partial work list); the loaded path's LLRs are held below
    lam = modem._codeword_llrs(llr_k).contiguous()
    code, iters = modem._code, cfg.ldpc_iters
    gen = torch.Generator(device=dev).manual_seed(1)
    noise = torch.randn(lam.shape, generator=gen, device=dev)
    noisy = (2.0 / 0.64) * (torch.sign(lam) + 0.8 * noise)
    mixed = lam.clone()
    mixed[::4] = noisy[::4]
    inputs3 = {"20 dB": lam, "sigma 0.8": noisy, "mixed": mixed}
    held3 = {label: hold_minsum(code, x, iters, label)
             for label, x in inputs3.items()}
    check(held3["20 dB"]["queued"] == 0
          and 0 < held3["mixed"]["queued"] < lam.shape[0],
          f"minsum_totals: work lists {held3}")
    # bound: the LLRs in, the totals, unsat (bool) and passes out, and four
    # operations per edge per sweep run (the loop ends early by data); the
    # decode pass's yardstick at σ = 0.8: its shared-memory traffic, 20
    # bytes per edge per sweep (pass 1 reads the total and the message,
    # pass 2 writes both, the check reads the total) at 128 bytes per
    # clock per SM
    E = sum(len(r) for r in ldpc_bp.row_edges(code.z, code.rate))
    edges = E * code.z

    def minsum_row(x, label):
        return timed(lambda: code.decode_totals(x, iters),
                     lambda: ldpc_bp.minsum_totals_plain(x, code.z, code.rate,
                                                         iters),
                     8 * x.numel() + 5 * x.shape[0],
                     4.0 * edges * held3[label]["passes_sum"],
                     kernel=MINSUM_KERNELS)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f_sm = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    smem_bytes = 20.0 * edges * held3["sigma 0.8"]["passes_sum"]
    r3 = rows["minsum_totals"] = dict(
        name="minsum_totals", route="cuda",
        source="gf3x_torch/csrc/ldpc_bp.cu",
        replaces="gf3x/ops/pallas/ldpc_bp.py:158", max_abs_err=0.0,
        **minsum_row(lam, "20 dB"),
        noisy=minsum_row(noisy, "sigma 0.8"),
        mixed=minsum_row(mixed, "mixed"),
        held=held3,
        readings={"0_sweeps": readings(
            lambda: code.decode_totals(lam, iters), MINSUM_KERNELS),
            "sigma_0.8": readings(
                lambda: code.decode_totals(noisy, iters), MINSUM_KERNELS)},
        smem_yardstick=dict(
            bytes=smem_bytes, edges_per_sweep=edges,
            sweeps=held3["sigma 0.8"]["passes_sum"], sms=sms,
            max_sm_mhz=f_sm,
            ms=1e3 * smem_bytes / (sms * 128 * f_sm * 1e6)))
    for label, key in (("0 sweeps", None), ("sigma 0.8", "noisy"),
                       ("mixed", "mixed")):
        t = r3 if key is None else r3[key]
        print(f"minsum_totals {label}: {t['ms']:.3f} ms vs plain "
              f"{t['plain_ms']:.3f} ms; device {t['device_ms']:.4f} ms, "
              f"kernel {t['kernel_us']:.1f} us ({t['kernel_records_per_call']}"
              f" kernel records per call; by kernel "
              f"{t['kernel_us_by_name']}), bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']}", flush=True)
    for label, rd in r3["readings"].items():
        print(f"minsum_totals readings {label}: event_ms {rd['event_ms']}, "
              f"kernel_us {rd['kernel_us']}, graph_us {rd['graph_us']}, "
              f"SM clock / power {rd['smi']}", flush=True)
    print(f"minsum_totals at sigma 0.8: shared-memory yardstick "
          f"{r3['smem_yardstick']['ms']:.4f} ms ({smem_bytes:.4g} B = 20 B x "
          f"{edges} edges x {held3['sigma 0.8']['passes_sum']} sweeps, at "
          f"{sms} SMs x 128 B x {f_sm:.0f} MHz); "
          f"({EXPECTED['minsum_totals']})", flush=True)

    # ---- kernel 3 at two other lifts, whose syndrome takes the other code
    # path (z = 24: one check per thread; z = 32: one bit word per column)
    # and whose rows have other degrees: every other codeword at σ = 0.3,
    # the rest at 0.7
    from gf3x_torch.fec.ldpc import LdpcCode

    for z3, rate3 in ((24, "1/2"), (32, "5/6")):
        code3 = LdpcCode(z3, rate3)
        g3 = torch.Generator(device=dev).manual_seed(z3)
        u3 = torch.randint(0, 2, (2048, code3.k), generator=g3, device=dev,
                           dtype=torch.uint8)
        bpsk = 1.0 - 2.0 * code3.encode(u3).to(torch.float32)
        sig = torch.where(torch.arange(2048, device=dev)[:, None] % 2 == 0,
                          0.3, 0.7)
        lam3 = (2.0 / sig ** 2) * (bpsk + sig * torch.randn(
            bpsk.shape, generator=g3, device=dev))
        r3["held"][f"z={z3} rate {rate3}"] = hold_minsum(
            code3, lam3.contiguous(), iters, f"z = {z3}, rate {rate3}")

    # ---- the config-5 main path, once, through the user's entry point
    counters = launch_counters()
    launches5, bits5, _, sync_err = run_path(modem, rx, payload, delays,
                                             counters, "config 5")
    for name in ("cut_symbols", "fused_eq_demap", "fec_gather",
                 "minsum_totals"):
        check(launches5[name] > 0, f"config 5: {name} did not launch: "
              f"{launches5}")
    check(launches5["gather_cut"] == 0 and launches5["gather_cut_group"] == 0,
          "config 5: kernel 7 or 6 launched on an aligned batch of whole "
          "8-row groups")
    step_ms = median_ms(lambda: modem.demodulate(rx))
    sps = B * cfg.n_data_symbols / (step_ms / 1e3)
    print(f"demodulate: {B}/{B} rows CRC-ok with the planted payload, "
          f"sync within {sync_err} samples, launches {launches5}; "
          f"{step_ms:.3f} ms/step, {sps:.1f} data symbols/s", flush=True)

    # ---- the FEC gather against its plain version at every case's shape
    rows["fec_gather"] = run_fec_gather(dev)

    # ---- demod DFT precision against a float64 NumPy DFT (gate −80 dB)
    ref = np.fft.rfft(syms_k.cpu().numpy().astype(np.float64), axis=-1)
    ref = ref[..., cfg.bin_lo: cfg.bin_hi + 1] / cfg.ofdm_scale
    got = ofdm_dft(cfg, syms_k).cpu().numpy().astype(np.complex128)
    db = 10 * np.log10(np.sum(np.abs(got - ref) ** 2) / np.sum(np.abs(ref) ** 2))
    check(db <= -80.0, f"demod DFT error {db:.1f} dB > -80 dB")
    print(f"dft precision: {db:.1f} dB (gate -80 dB)", flush=True)

    # ---- kernel 8 vs plain at the path's cut geometry: spectra within
    # 1e-5 of their mean magnitude, the SC window equal to kernel 1's, and
    # the −80 dB gate against a float64 NumPy DFT of the same windows
    kw8 = {k: kw[k] for k in ("valid", "block", "S", "body_off", "sc_off")}
    Y8, scw8 = cut_dft.cut_dft(cfg, rx, q, roll, **kw8)
    Y8p, _ = cut_dft.cut_dft_plain(cfg, rx, q, roll, **kw8)
    err8 = float((Y8 - Y8p).abs().max())
    scale8 = float(Y8p.abs().mean())
    check(err8 <= 1e-5 * scale8, f"cut_dft spectra differ from the plain "
          f"version by {err8} > 1e-5 x mean|Y| {scale8}")
    check(torch.equal(scw8, scw_k), "cut_dft SC window differs from kernel "
          "1's")
    kk = np.arange(cfg.bin_lo, cfg.bin_hi + 1)
    ref8 = ref * np.exp(2j * np.pi * kk * roll.cpu().numpy()[:, None, None]
                        / cfg.n_fft)
    got8 = Y8.cpu().numpy().astype(np.complex128)
    db8 = 10 * np.log10(np.sum(np.abs(got8 - ref8) ** 2)
                        / np.sum(np.abs(ref8) ** 2))
    check(db8 <= -80.0, f"cut_dft error {db8:.1f} dB > -80 dB")
    # bound: the symbol and SC windows in, the spectra and SC window out,
    # and a real FFT (2.5·N·log2 N) plus the deroll (6 per bin) per symbol.
    # No single PyTorch call computes the cut with the DFT, so there is no
    # library yardstick; the chain rfft + slice + deroll on kernel 1's cut
    # (without the cut) is timed beside it as `rfft_chain_ms`
    S8, U8 = kw["S"], cfg.n_used
    rows["cut_dft"] = dict(
        name="cut_dft", route="cuda", source="gf3x_torch/csrc/cut_dft.cu",
        replaces="gf3x/ops/pallas/cut_dft.py:182", max_abs_err=err8,
        mean_abs=scale8, max_err_over_mean_abs=err8 / scale8,
        **timed(lambda: cut_dft.cut_dft(cfg, rx, q, roll, **kw8),
                lambda: cut_dft.cut_dft_plain(cfg, rx, q, roll, **kw8),
                4 * B * (S8 + 1) * n_fft + 8 * B * S8 * U8
                + 4 * B * n_fft + 8 * B,
                B * S8 * (2.5 * n_fft * np.log2(n_fft) + 6.0 * U8),
                kernel="cut_dft_kernel"),
        rfft_chain_ms=median_ms(lambda: deroll(cfg, torch.fft.rfft(
            syms_k, dim=-1)[..., cfg.bin_lo: cfg.bin_hi + 1], roll)))
    r8 = rows["cut_dft"]
    r8["geometry"] = str(cut_dft.cut_dft_geometry(
        n_fft, S8 + (kw["sc_off"] >= 0)))
    print(f"cut_dft: max |dY| {err8:.3g} (mean |Y| {scale8:.3g}), SC window "
          f"equal to kernel 1's, {db8:.1f} dB vs float64 (gate -80 dB); "
          f"{r8['geometry']}; {r8['ms']:.3f} ms vs plain "
          f"{r8['plain_ms']:.3f} ms; device {r8['device_ms']:.4f} ms, kernel "
          f"{r8['kernel_us']:.1f} us, bound {r8['bound_ms']:.4f} ms "
          f"({EXPECTED['cut_dft']})", flush=True)
    r8["shapes"] = hold_cut_dft_shapes(dev)
    del Y8, Y8p, scw8, got8, ref8, ref, got

    # ---- the fused cut+DFT route, once, then both routes' steps in turns
    modem8 = Modem(cfg, max_delay=MARGIN + cfg.cp, device=dev,
                   use_cut_dft=True)
    launches8, bits8, _, sync_err = run_path(modem8, rx, payload, delays,
                                             counters, "cut+DFT route")
    check(launches8["cut_dft"] > 0 and launches8["cut_symbols"] == 0,
          f"cut+DFT route: cut_dft must launch and cut_symbols not: "
          f"{launches8}")
    for name in ("fused_eq_demap", "minsum_totals"):
        check(launches8[name] > 0, f"cut+DFT route: {name} did not launch")
    check(torch.equal(bits8, bits5), "cut+DFT route: bits differ from the "
          "two-stage route's")
    check(launches8["gather_cut_group"] == 0, "cut+DFT route: kernel 6 "
          "launched")
    turns, blocks = in_turns({"two_stage": lambda: modem.demodulate(rx),
                              "cut_dft": lambda: modem8.demodulate(rx)})
    print(f"demodulate, cut+DFT route: {B}/{B} rows CRC-ok, bits equal to "
          f"the two-stage route's, launches {launches8}; in turns (8 blocks "
          f"of 10 steps): cut+DFT {turns['cut_dft']:.3f} ms/step, two-stage "
          f"{turns['two_stage']:.3f} ms/step; block medians "
          f"{ {k: [round(x, 3) for x in v] for k, v in blocks.items()} }",
          flush=True)
    del modem8, bits8

    # ---- the clock-offset loop on the same batch: δ̂ near 0 (the batch
    # has no clock offset), the δ̂-warped DFT at −80 dB against float64
    launchesS, _, diagS, sync_err = run_path(
        modem, rx, payload, delays, counters, "demodulate_sfo",
        entry="demodulate_sfo")
    for name in ("cut_symbols", "fused_eq_demap", "minsum_totals"):
        check(launchesS[name] > 0, f"demodulate_sfo: {name} did not launch")
    check(launchesS["cut_dft"] == 0 and launchesS["gather_cut_group"] == 0,
          "demodulate_sfo: cut_dft or kernel 6 launched")
    syms_s, sc_s, roll_s = modem._cut_frame(rx, modem._sync(rx)[0])
    delta = modem._two_pass_delta(syms_s, sc_s, roll_s)
    check(abs(float(delta)) * 1e6 < 20.0, f"demodulate_sfo: |delta| "
          f"{float(delta) * 1e6:.2f} ppm on a batch without clock offset")
    x64 = syms_s[:64].cpu().numpy().astype(np.float64)
    th = (2 * np.pi / cfg.n_fft * np.arange(cfg.n_fft)[:, None] * kk
          * (1.0 + float(delta)))
    refS = (x64 @ np.exp(-1j * th)) / cfg.ofdm_scale
    gotS = ofdm_dft(cfg, syms_s[:64], delta).cpu().numpy()
    dbS = 10 * np.log10(np.sum(np.abs(gotS - refS) ** 2)
                        / np.sum(np.abs(refS) ** 2))
    check(dbS <= -80.0, f"warped DFT error {dbS:.1f} dB > -80 dB")
    sfo_ms = median_ms(lambda: modem.demodulate_sfo(rx))
    print(f"demodulate_sfo: {B}/{B} rows CRC-ok, delta "
          f"{float(delta) * 1e6:.3f} ppm, clock_ppm |max| "
          f"{float(diagS.clock_ppm.abs().max()):.2f}, warped DFT "
          f"{dbS:.1f} dB vs float64 (gate -80 dB), launches {launchesS}; "
          f"{sfo_ms:.3f} ms/step", flush=True)
    del modem, rx, syms_k, syms_p, Y, H, nv, lam, noisy, noise, syms_s
    del mixed, inputs3

    # ---- kernel 2 at 16-QAM (gf3-fast) and 64-QAM (gf3-turbo), and on
    # gf3-turbo the split pair against it at the full batch
    for cfg_u, label in ((GF3_FAST, "16-QAM"), (GF3_TURBO, "64-QAM")):
        m_u, rx_u, _, _ = batch(cfg_u)
        _, _, _, _, Y, H, nv = path_inputs(m_u, rx_u)
        pv = m_u.pilot_vals
        out_k, err, scale = hold_fused(cfg_u, Y, H, nv, pv, label)
        print(f"fused_eq_demap {label}: hard decisions equal, max |dLLR| "
              f"{err:.3g} (mean |LLR| {scale:.3g})", flush=True)
        if cfg_u is not GF3_TURBO:
            continue
        rel = hold_split(m_u, Y, H, nv, out_k, "gf3-turbo")
        fused_ms = median_ms(lambda: m_u._fused_eq_demap(Y, H, nv))
        split_ms = median_ms(lambda: m_u._split_eq_demap(Y, H, nv))
        turbo = dict(fused_ms=fused_ms, split_ms=split_ms, max_abs_err=0.0,
                     evm_mabs_rel=rel)
        print(f"gf3-turbo tail: kernel 2's llr, slope and cpe bit-identical "
              f"to the split pair's (evm, mean|llr| within {rel:.2g} rel); "
              f"split {split_ms:.3f} ms vs fused {fused_ms:.3f} ms",
              flush=True)
        del m_u, rx_u, Y, H, nv, out_k

    # ---- the bit-loaded path's inputs
    cfg = GF3_STANDARD.replace(
        bit_loading=loading_table(GF3_STANDARD.n_data_bins))
    modem, rx, payload, delays = batch(cfg)
    check(modem._tail_route() == "split", "the loaded config must take the "
          "split tail")
    _, _, _, _, Y, H, nv = path_inputs(modem, rx)
    pv = modem.pilot_vals

    # ---- kernel A vs plain on the loaded batch's spectra, and at the
    # batches of one recording and of an odd few, which take other launch
    # geometries
    D_, U_ = cfg.n_data_symbols, cfg.n_used
    a_k = hold_eq_track(cfg, Y, H, nv, pv, f"B = {B}")
    for nbA in (1, 7):
        hold_eq_track(cfg, Y[:nbA].contiguous(), H[:nbA].contiguous(),
                      nv[:nbA].contiguous(), pv, f"B = {nbA}")
    a_p = split_eq.eq_track_plain(cfg, Y, H, nv, pv)
    rA = rows["eq_track"] = dict(
        name="eq_track", route="cuda", source="gf3x_torch/csrc/split_eq.cu",
        replaces="gf3x/ops/pallas/split_eq.py:140",
        max_abs_err=float((a_k[0] - a_p[0]).abs().max()),
        geometry=str(eq_layout.fused_eq_geometry(cfg, B, sms, demap=False)),
        # bound: the data symbols' spectra, Ĥ and the noise floor in, the
        # derotated bins and three per-symbol rows out; 12 operations per
        # cell (EQ and derotation)
        **timed(lambda: split_eq.eq_track(cfg, Y, H, nv, pv),
                lambda: split_eq.eq_track_plain(cfg, Y, H, nv, pv),
                8 * B * D_ * U_ * 2 + 8 * B * U_ + 4 * B + 3 * 4 * B * D_,
                12.0 * B * D_ * U_, kernel="eq_track"))
    rA["spilled_sha256_config5"] = spilled_A5
    print(f"eq_track: held at B = {B}, 1 and 7; {rA['geometry']}; "
          f"{rA['ms']:.3f} ms vs plain {rA['plain_ms']:.3f} ms; device "
          f"{rA['device_ms']:.4f} ms, kernel {rA['kernel_us']:.1f} us, bound "
          f"{rA['bound_ms']:.4f} ms ({EXPECTED['eq_track']})", flush=True)

    # ---- kernel B vs plain on kernel A's output
    eq, _, _, nv_sym = a_k
    tables = (modem.demap_used, modem.demap_bits, modem.demap_off)
    b_k, err, scale = hold_demap(cfg, eq, H, nv_sym, tables, "bit-loaded")
    rows["demap_bins"] = dict(
        name="demap_bins", route="cuda", source="gf3x_torch/csrc/split_eq.cu",
        replaces="gf3x/ops/pallas/split_eq.py:279", max_abs_err=err,
        # bound: the data bins' equalized values and Ĥ and the per-symbol
        # noise floor in, the LLRs and two per-symbol rows out; 4
        # operations per LLR
        **timed(lambda: split_eq.demap_bins(cfg, eq, H, nv_sym, tables),
                lambda: split_eq.demap_bins_plain(cfg, eq, H, nv_sym),
                8 * B * D_ * cfg.n_data_bins + 8 * B * cfg.n_data_bins
                + 4 * B * D_ + 4 * B * cfg.raw_bits_per_frame
                + 2 * 4 * B * D_,
                4.0 * B * cfg.raw_bits_per_frame, kernel="demap_bins_kernel"))
    rB = rows["demap_bins"]
    rB["geometry"] = str(eq_layout.demap_geometry(cfg, B, sms))
    # A in the forced layouts and B in the streamed one on the loaded
    # batch: the same bytes; B's own time
    hold_layouts("eq_track bit-loaded", lambda geo: split_eq.eq_track(
        cfg, Y, H, nv, pv, geometry=geo), LAYOUT_HASHED["eq_track"],
        forced_layouts(cfg, B, sms, False))
    streamedB = eq_layout.streamed_geometry(cfg, B, sms)
    check([sha256_of(t) for t in split_eq.demap_bins(
        cfg, eq, H, nv_sym, tables, geometry=streamedB)]
        == [sha256_of(t) for t in split_eq.demap_bins(
            cfg, eq, H, nv_sym, tables)],
        "demap_bins bit-loaded: the streamed layout's outputs differ from "
        "the staged one's")
    rB["streamed_kernel_us"] = kernel_us(lambda: split_eq.demap_bins(
        cfg, eq, H, nv_sym, tables, geometry=streamedB),
        ["demap_bins_kernel"])["us"]
    print(f"demap_bins: hard decisions equal, max |dLLR| {err:.3g} (mean "
          f"|LLR| {scale:.3g}); {rB['geometry']}; {rB['ms']:.3f} ms vs plain "
          f"{rB['plain_ms']:.3f} ms; device {rB['device_ms']:.4f} ms, kernel "
          f"{rB['kernel_us']:.1f} us, bound {rB['bound_ms']:.4f} ms "
          f"({EXPECTED['demap_bins']}); streamed layout (same bytes) "
          f"{rB['streamed_kernel_us']:.1f} us", flush=True)

    # ---- kernels 2 and A past the pilot bound of shared memory, then
    # every candidate launch of both at each band
    spill = run_spill(dev, rows)
    layouts = run_layouts(dev)

    # ---- kernel 3 on the loaded path's LLRs, which carry raw bit errors
    lam = modem._codeword_llrs(b_k[0]).contiguous()
    code = modem._code
    held3L = hold_minsum(code, lam, cfg.ldpc_iters, "the loaded path's LLRs")
    rows["minsum_totals"]["held"]["loaded"] = held3L
    tot_k, _, _ = code.decode_totals(lam, cfg.ldpc_iters)
    raw_err = float(((lam < 0) != (tot_k < 0)).float().mean())
    print(f"minsum_totals, loaded LLRs: raw bit error rate {raw_err:.3g}, "
          f"passes mean {held3L['passes_sum'] / lam.shape[0]:.3f}, max "
          f"{held3L['passes_max']}", flush=True)
    del a_k, a_p, b_k, eq, lam, tot_k

    # ---- the bit-loaded main path, once, through the user's entry point
    launchesL, _, diag, sync_err = run_path(modem, rx, payload, delays,
                                            counters, "bit-loaded")
    for name in ("cut_symbols", "eq_track", "demap_bins", "minsum_totals"):
        check(launchesL[name] > 0, f"bit-loaded: {name} did not launch: "
              f"{launchesL}")
    check(launchesL["fused_eq_demap"] == 0
          and launchesL["gather_cut_group"] == 0, "bit-loaded: the fused "
          "kernel or kernel 6 launched")
    stepL_ms = median_ms(lambda: modem.demodulate(rx))
    spsL = B * cfg.n_data_symbols / (stepL_ms / 1e3)
    print(f"demodulate, bit-loaded ({cfg.n_active_bins} active bins, "
          f"{cfg.bits_per_ofdm_symbol} bits/symbol, {cfg.n_codewords} "
          f"codewords): {B}/{B} rows CRC-ok with the planted payload, sync "
          f"within {sync_err} samples, fec_iters mean "
          f"{float(diag.fec_iters.float().mean()):.3f} max "
          f"{int(diag.fec_iters.max())}, launches {launchesL}; "
          f"{stepL_ms:.3f} ms/step, {spsL:.1f} data symbols/s", flush=True)
    del modem, rx

    # ---- gf3-longcp: kernel 6 on its path
    launchesLC, longcp_ms, longcp_dft = run_longcp(dev, counters, rows)

    # ---- the six frozen captures through decode_stream, then one of them
    # through decode's other routes
    launchesC, cap_s = run_captures(dev, counters)
    launchesR, held7 = run_routes(dev, counters)

    # ---- HARQ, ARQ and the long recordings
    launchesH, harq_s, harq_ppm = run_harq(dev, counters)
    launchesA, arq_s = run_arq(dev, counters)
    launchesT, long_s = run_long_recordings(dev, counters)

    # ---- the evaluation and command-line surface: the BER sweep at full
    # width, the CLI, the golden model against the Modem
    launchesW, sweep = run_sweep(dev, counters)
    launchesI, cli = run_cli(dev, counters)
    launchesG, golden = run_golden(dev, counters)

    # ---- every pilot layout (kernels 2, A and B from their tables), the
    # mesh and the four walkthroughs
    launchesP, pilots = run_pilots(dev, counters)
    launchesWd, wide = run_wide(dev, counters, rows)
    isi_onset_held = run_isi_onset(dev, counters)
    llr_hist_held = run_llr_hist(dev, counters)
    from gf3x_torch.parallel import make_mesh
    check(len(make_mesh()) == torch.cuda.device_count() == 1,
          f"make_mesh() has {len(make_mesh())} devices on a one-card run")
    launchesM, mesh = run_mesh(dev, counters, {"one card": make_mesh(),
                                               "two shards": (dev, dev)})
    launchesE, examples = run_examples(dev, counters)

    # ---- kernel 3 above z = 512, and the three evaluation reports
    launchesLf, lifts = run_lifts(dev, counters, rows)
    launchesRp, reports = run_reports(dev, counters)
    rows["gather_cut"] = dict(
        name="gather_cut", route="cuda",
        source="gf3x_torch/csrc/gather_cut.cu",
        replaces="gf3x/ops/pallas/gather_cut.py:157",
        **dict(held7, max_abs_err=max(held7["max_abs_err"],
                                      odd7["max_abs_err"])),
        odd_batch={k: v for k, v in odd7.items() if k != "max_abs_err"})

    check("jax" not in sys.modules and "gf3x" not in sys.modules,
          "jax or gf3x was imported")
    by_path = {"config5": launches5, "cut_dft_route": launches8,
               "sfo": launchesS, "bit_loaded": launchesL,
               "longcp": launchesLC, "captures": launchesC,
               "routes": launchesR, "harq": launchesH, "arq": launchesA,
               "long_recordings": launchesT, "sweep": launchesW,
               "cli": launchesI, "golden": launchesG, "pilots": launchesP,
               "wide": launchesWd, "mesh": launchesM, "examples": launchesE,
               "lifts": launchesLf, "reports": launchesRp}
    check(len(rows) == 9 and all(
        sum(c[name] for c in by_path.values()) > 0 for name in rows),
          "a kernel has no row or never launched on a path")
    for name, row in rows.items():
        row["launches"] = sum(c[name] for c in by_path.values())
        row["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
    # kernel 3's two passes launch once each per call, on every path
    for name in ("minsum_check", "minsum_decode"):
        n = sum(c[name] for c in by_path.values())
        check(n == rows["minsum_totals"]["launches"], f"{name} launched {n} "
              f"times in {rows['minsum_totals']['launches']} calls")
        rows["minsum_totals"][f"{name}_launches"] = n
    record("chip_smoke", {"kernels": list(rows.values()), "step_ms": step_ms,
                      "data_symbols_per_s": sps, "loaded_step_ms": stepL_ms,
                      "loaded_data_symbols_per_s": spsL,
                      "in_turns_ms": turns, "sfo_step_ms": sfo_ms,
                      "captures_s": cap_s, "gf3_turbo_tail": turbo,
                      "longcp_step_ms": longcp_ms, "longcp_dft": longcp_dft,
                      "harq_s": harq_s, "harq_joint_ppm": harq_ppm,
                      "arq_s": arq_s, "long_recording_s": long_s,
                      "sweep": sweep, "cli": cli, "golden": golden,
                      "pilots": pilots, "wide": wide,
                      "isi_onset": isi_onset_held,
                      "llr_hist": llr_hist_held, "mesh": mesh,
                      "examples": examples, "lifts": lifts,
                      "reports": reports, "spilled": spill,
                      "layouts": layouts,
                      "decision_ties": DECISION_TIES,
                      "build_s": build_s, "build": build_report(log),
                      "package": gf3x_torch.__name__},
           print_too=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def record(name: str, obj, print_too: bool = False) -> None:
    """Write obj as JSON to chip_records/<name>.json beside this script
    (the whole record, which may outgrow a terminal's tail), and with
    `print_too` print it as one line."""
    out = Path(__file__).resolve().parent / "chip_records"
    out.mkdir(exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(obj))
    if print_too:
        print(json.dumps(obj), flush=True)


def smi_sampler():
    """Start nvidia-smi sampling the SM clock (MHz) and power draw (W)
    every 20 ms; stop() ends it and returns [(clock, watts), ...]."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop():
        proc.terminate()
        vals = []
        for ln in proc.communicate(timeout=30)[0].splitlines():
            try:
                vals.append(tuple(float(x) for x in ln.split(",")))
            except ValueError:
                continue
        return vals
    return stop


def readings(fn, names) -> dict:
    """fn's device time read three ways, twice in mirrored order (events,
    profiler, graph, graph, profiler, events): `event_ms` (CUDA events
    over back-to-back calls, the wrapper's allocations and any extra
    launches included), `kernel_us` (torch.profiler's durations of the
    kernels whose names contain one of `names`, None where it records
    none; beside it the kernel records it kept per call) and `graph_us`
    (the calls replayed from one CUDA graph), each with the SM clock and
    power nvidia-smi sampled while it ran."""
    kept = []

    def prof_us():
        k = kernel_us(fn, names, runs=100)
        kept.append(k["per_call"])
        return k["us"] if k["by"] == "profiler" else None

    ways = {"event_ms": lambda: event_ms(fn, 200), "kernel_us": prof_us,
            "graph_us": lambda: graph_us(fn)}
    out = {k: [] for k in ways}
    clocks = {k: [] for k in ways}
    for k in list(ways) + list(ways)[::-1]:
        stop = smi_sampler()
        time.sleep(0.1)
        out[k].append(ways[k]())
        clocks[k] += stop()
    return dict(out, kernel_records_per_call=kept, smi={k: dict(
        sm_mhz=sorted({c for c, _ in v}), max_w=max((w for _, w in v),
                                                    default=None))
        for k, v in clocks.items()})


def sha256_of(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def time_tree(tree: Path) -> dict:
    """`--time TREE`: kernels 2, 3, A, B and 8 of the gf3x_torch package in
    TREE, on this run's card, through the calls every version of the port
    has (`fused_eq.fused_eq_demap`, `LdpcCode.decode_totals`,
    `split_eq.eq_track`, `split_eq.demap_bins`, `cut_dft.cut_dft`): kernel 2
    on the config-5 and gf3-turbo batches' spectra, kernel 3 on the config-5
    batch's codeword LLRs (0 sweeps), on the same codewords as BPSK LLRs at
    σ = 0.8 and on a mixed batch (every fourth codeword noisy), kernel 8 on
    the config-5 batch's cut, kernels A and B on the bit-loaded batch
    (B on A's output), each read three ways (`readings`); kernel 3's passes
    checked equal over repeated calls, and the sha256 of the bytes of
    kernel 2's LLRs, slope and cpe, kernel A's eq, slope, cpe and nv_sym and
    kernel B's LLRs (`sha256`); and kernels 2 and A at the bands of
    TREE_BANDS (kernel 2's llr, slope and cpe and A's four outputs
    hashed)."""
    sys.path.insert(0, str(tree))
    import gf3x_torch
    from gf3x_torch import GF3_STANDARD, GF3_TURBO, Modem
    from gf3x_torch.ops.kernels import cut_dft, fused_eq, split_eq
    from gf3x_torch.utils.device import kernel_lib

    check(Path(gf3x_torch.__file__).resolve().is_relative_to(tree.resolve()),
          f"gf3x_torch imported from {gf3x_torch.__file__}, not {tree}")
    from gf3x_torch.utils.device import library_path

    dev = torch.device("cuda", 0)
    kernel_lib()
    out = {"build": {"registers": build_report(
        (library_path().parent / "build.log").read_text())}}
    for cfg, label in ((GF3_STANDARD, "config5"), (GF3_TURBO, "gf3_turbo"),
                       (GF3_STANDARD.replace(bit_loading=loading_table(
                           GF3_STANDARD.n_data_bins)), "bit_loaded")):
        modem = Modem(cfg, max_delay=MARGIN + cfg.cp, device=dev)
        rx, _, _ = build_batch(modem, B, MARGIN, np.random.default_rng(0))
        rx = torch.as_tensor(rx, device=dev)
        q, roll, kw, _, Y, H, nv = path_inputs(modem, rx)
        pv = modem.pilot_vals
        if label == "bit_loaded":
            out["eq_track"] = dict(readings(
                lambda: split_eq.eq_track(cfg, Y, H, nv, pv),
                ["eq_track"]), sha256=[sha256_of(t) for t in
                                              split_eq.eq_track(cfg, Y, H,
                                                                nv, pv)])
            eq, _, _, nv_sym = split_eq.eq_track(cfg, Y, H, nv, pv)
            tables = (modem.demap_used, modem.demap_bits, modem.demap_off)
            llr = split_eq.demap_bins(cfg, eq, H, nv_sym, tables)[0]
            out["demap_bins"] = dict(readings(
                lambda: split_eq.demap_bins(cfg, eq, H, nv_sym, tables),
                ["demap_bins"]), sha256=[sha256_of(llr)])
            continue
        out2 = fused_eq.fused_eq_demap(cfg, Y, H, nv, pv)
        out[f"fused_eq_demap_{label}"] = dict(readings(
            lambda: fused_eq.fused_eq_demap(cfg, Y, H, nv, pv),
            ["fused_eq_demap"]), sha256=[sha256_of(t) for t in out2[:3]])
        if label == "gf3_turbo":
            del rx, Y, H, nv, out2
            continue
        kw8 = {k: kw[k] for k in ("valid", "block", "S", "body_off",
                                  "sc_off")}
        out["cut_dft"] = readings(
            lambda: cut_dft.cut_dft(cfg, rx, q, roll, **kw8), ["cut_dft"])
        llr = out2[0]
        lam = modem._codeword_llrs(llr).contiguous()
        gen = torch.Generator(device=dev).manual_seed(1)
        noise = torch.randn(lam.shape, generator=gen, device=dev)
        noisy = (2.0 / 0.64) * (torch.sign(lam) + 0.8 * noise)
        mixed = lam.clone()
        mixed[::4] = noisy[::4]
        code = modem._code
        for name, x in (("minsum_0_sweeps", lam), ("minsum_sigma_0.8", noisy),
                        ("minsum_mixed", mixed)):
            runs = [code.decode_totals(x, cfg.ldpc_iters) for _ in range(3)]
            check(all(torch.equal(r[2], runs[0][2]) for r in runs),
                  f"{name}: passes differ between calls")
            out[name] = dict(readings(
                lambda: code.decode_totals(x, cfg.ldpc_iters), ["minsum"]),
                sha256=[sha256_of(t) for t in runs[0]],
                by_kernel=kernel_us(
                    lambda: code.decode_totals(x, cfg.ldpc_iters),
                    ["minsum_check", "minsum_decode", "minsum_kernel"],
                    runs=100)["by_name"],
                passes_sum=int(runs[0][2].sum()),
                passes_max=int(runs[0][2].max()),
                unsat=int(runs[0][1].sum()))
        del rx, Y, H, nv, out2, llr, lam, noise, noisy, mixed
    # kernels 2 and A at the wide bands and the spilled band, on spectra
    # built in the frequency domain (this script's `spill_inputs` on the
    # tree's own config and constellation code)
    for label, replace, loaded, Bk in LAYOUT_BANDS:
        if label not in TREE_BANDS:
            continue
        cfg = layout_config(replace, loaded)
        Y, H, nv = spill_inputs(cfg, Bk, dev)
        key = label.replace(" ", "_")
        if not loaded:
            out2 = fused_eq.fused_eq_demap(cfg, Y, H, nv)
            out[f"fused_eq_demap_{key}"] = dict(readings(
                lambda: fused_eq.fused_eq_demap(cfg, Y, H, nv),
                ["fused_eq_demap"]), sha256=[sha256_of(t) for t in out2[:3]])
            del out2
        outA = split_eq.eq_track(cfg, Y, H, nv)
        out[f"eq_track_{key}"] = dict(readings(
            lambda: split_eq.eq_track(cfg, Y, H, nv), ["eq_track"]),
            sha256=[sha256_of(t) for t in outA])
        del Y, H, nv, outA
    return out


def compare_trees(other: Path) -> None:
    """`--against TREE`: `time_tree` of TREE and of this script's own tree
    in turns (TREE, this, this, TREE), each in its own process on this
    run's card; prints each run's numbers as one JSON line, then each
    kernel's profiler µs of this tree over TREE's (the two runs of each
    averaged); fails unless the outputs of kernels 2, A and B hash the same
    in all four runs."""
    here = Path(__file__).resolve().parent
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    sha, us, runs = {}, {}, []
    for label, tree in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--time", str(tree)], capture_output=True,
                             text=True, timeout=600)
        check(res.returncode == 0, f"--time {tree} failed:\n{res.stderr}")
        got = json.loads(res.stdout.splitlines()[-1])
        for name, row in got.items():
            if "kernel_us" not in row:
                continue
            if "sha256" in row:
                sha.setdefault(name, set()).add(tuple(row["sha256"]))
            us.setdefault(name, {}).setdefault(label, []).extend(
                x for x in row["kernel_us"] if x is not None)
        runs.append({"tree": label, "path": str(tree), **got})
        print(json.dumps(runs[-1]), flush=True)
    ratio = {name: float(np.mean(v["this"]) / np.mean(v["other"]))
             for name, v in us.items() if v.get("this") and v.get("other")}
    record("against", {"kernel_us_this_over_other": ratio, "runs": runs},
           print_too=True)
    check(len(sha) == 7 + 2 * len(TREE_BANDS) - 1
          and all(len(v) == 1 for v in sha.values()),
          f"the outputs of kernels 2, 3, A and B differ between the trees: "
          f"{sha}")
    print(f"outputs of {sorted(sha)} hash the same in all four runs",
          flush=True)
    print(smi, flush=True)


def layouts_only() -> None:
    """`--layouts`: the layouts phase alone over the whole grid of teamed
    launches (`run_layouts(grid=True)`) after the build's ptxas report;
    prints its numbers as one JSON line and the card's name and power
    limit."""
    from gf3x_torch.utils.device import kernel_lib, library_path

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    kernel_lib()
    print("build: " + build_report(
        (library_path().parent / "build.log").read_text()), flush=True)
    record("layouts", run_layouts(torch.device("cuda", 0), grid=True))
    print(smi, flush=True)


def mesh_cards() -> None:
    """`--mesh`: the mesh phase alone across every card of the machine:
    `run_mesh` on the one-card mesh and on `make_mesh()` (all cards), on
    config 5's batch and on the bit-loaded one (kernel B asks for more
    than 48 KB of shared memory, an attribute each card keeps), timing
    both; prints the numbers as one JSON line and the cards' names and
    power limits."""
    from gf3x_torch import GF3_STANDARD
    from gf3x_torch.parallel import make_mesh
    from gf3x_torch.utils.device import kernel_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    n = torch.cuda.device_count()
    print(f"devices: {n}\n{smi}", flush=True)
    kernel_lib()
    meshes = {"one card": make_mesh(1), f"{n} cards": make_mesh()}
    out = {}
    for label, cfg in (("config5", GF3_STANDARD), ("bit_loaded",
                       GF3_STANDARD.replace(bit_loading=loading_table(
                           GF3_STANDARD.n_data_bins)))):
        _, out[label] = run_mesh(torch.device("cuda", 0), launch_counters(),
                                 meshes, cfg)
    print(json.dumps(out), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] == "--mesh":
        if not torch.cuda.is_available():
            raise RuntimeError("chip_smoke needs a CUDA device")
        mesh_cards()
    elif len(sys.argv) == 3 and sys.argv[1] == "--time":
        if not torch.cuda.is_available():
            raise RuntimeError("chip_smoke needs a CUDA device")
        print(json.dumps(time_tree(Path(sys.argv[2]))), flush=True)
    elif len(sys.argv) == 2 and sys.argv[1] == "--fec-gather":
        if not torch.cuda.is_available():
            raise RuntimeError("chip_smoke needs a CUDA device")
        fec_gather_only()
    elif len(sys.argv) == 2 and sys.argv[1] == "--warped-dft":
        if not torch.cuda.is_available():
            raise RuntimeError("chip_smoke needs a CUDA device")
        warped_dft_only()
    elif len(sys.argv) == 2 and sys.argv[1] == "--isi-onset":
        if not torch.cuda.is_available():
            raise RuntimeError("chip_smoke needs a CUDA device")
        isi_onset_only()
    elif len(sys.argv) == 2 and sys.argv[1] == "--llr-hist":
        if not torch.cuda.is_available():
            raise RuntimeError("chip_smoke needs a CUDA device")
        llr_hist_only()
    elif len(sys.argv) == 2 and sys.argv[1] == "--layouts":
        if not torch.cuda.is_available():
            raise RuntimeError("chip_smoke needs a CUDA device")
        layouts_only()
    elif len(sys.argv) == 3 and sys.argv[1] == "--against":
        if not torch.cuda.is_available():
            raise RuntimeError("chip_smoke needs a CUDA device")
        compare_trees(Path(sys.argv[2]).resolve())
    else:
        main()
