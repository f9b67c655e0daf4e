#!/usr/bin/env python3
"""Smoke run of the gf3x_torch port on one CUDA card (an H100 for sm_90a).

Drives the config-5 receive path — `Modem(GF3_STANDARD, max_delay=4096 +
cp).demodulate` on bench.py's 1024-frame batch — once through the port's
entry points, after building the three CUDA kernels from
`gf3x_torch/csrc/` and holding each against its plain PyTorch version on
the card at the shapes that path gives it. Any failed check raises, so the
exit code is non-zero; there is no CPU route.

Run from the repository root:  python3 chip_smoke.py

Phases print one line each. The last lines are a JSON object with every
kernel's measurements, the card's name and power limit as nvidia-smi
reports them, and `{"ok": true, "device": {...}}`.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

B = 1024            # frames per batch (config 5)
MARGIN = 4096       # random onset headroom per recording, as in bench.py
TIMED_RUNS = 20     # median over this many synchronised runs


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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; there is no CPU "
                           "route")
    import bench
    import gf3x_torch
    from gf3x_torch import GF3_STANDARD, Modem
    from gf3x_torch.ops import sync
    from gf3x_torch.ops.kernels import fused_eq, gather_cut, ldpc_bp
    from gf3x_torch.ops.ofdm import ofdm_dft
    from gf3x_torch.utils.device import kernel_lib, library_path

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
    log = (library_path().parent / "build.log").read_text().splitlines()
    usage = [ln.split("ptxas info    : ")[-1] for ln in log
             if "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.1f} s ({library_path().name}); "
          + " | ".join(usage), flush=True)

    # ---- the main path's inputs: bench.py's batch, built by the port
    cfg = GF3_STANDARD
    modem = Modem(cfg, max_delay=MARGIN + cfg.cp, device=dev)
    rng = np.random.default_rng(0)
    rx_np, payload, delays = bench.build_batch(modem, B, MARGIN, rng)
    rx = torch.as_tensor(rx_np, device=dev)
    T = rx.shape[-1]

    # ---- kernel 1 vs plain at the path's cut geometry
    start, _ = sync.find_frame_start(cfg, rx, modem.chirp,
                                     search_len=modem.max_delay, decimate=2)
    base, S, sc_off = modem._cut_geom(rx, start)
    geo = dict(S=S, n_fft=cfg.n_fft, sym_len=cfg.symbol_len,
               sc_off=sc_off, body_off=cfg.sc_len, block=modem._cut_block)
    q, valid, roll = sync.cut_plan(T, base, **geo)
    kw = dict(geo, cp=cfg.cp, valid=valid)
    syms_k, scw_k = gather_cut.cut_symbols(rx, q, **kw)
    syms_p, scw_p = gather_cut.cut_symbols_plain(rx, q, **kw)
    check(torch.equal(syms_k, syms_p) and torch.equal(scw_k, scw_p),
          "cut_symbols kernel differs from its plain version")
    rows = [dict(name="cut_symbols", route="cuda",
                 source="gf3x_torch/csrc/cut_symbols.cu",
                 replaces="gf3x/ops/pallas/gather_cut.py:242",
                 max_abs_err=0.0,
                 ms=median_ms(lambda: gather_cut.cut_symbols(rx, q, **kw)),
                 plain_ms=median_ms(
                     lambda: gather_cut.cut_symbols_plain(rx, q, **kw)))]
    print(f"cut_symbols: equal; {rows[-1]['ms']:.3f} ms vs plain "
          f"{rows[-1]['plain_ms']:.3f} ms", flush=True)

    # ---- kernel 2 vs plain on the path's spectra and channel estimate
    Y, H, nv, _, _ = modem._estimate(syms_k, roll)
    out_k = fused_eq.fused_eq_demap(cfg, Y, H, nv, modem.pilot_vals)
    out_p = fused_eq.fused_eq_demap_plain(cfg, Y, H, nv, modem.pilot_vals)
    llr_k, llr_p = out_k[0], out_p[0]
    scale = float(llr_p.abs().mean())
    err = float((llr_k - llr_p).abs().max())
    check(torch.equal(llr_k < 0, llr_p < 0),
          "fused_eq_demap hard decisions differ from its plain version")
    check(err <= 2e-4 * scale, f"fused_eq_demap LLR error {err} > "
          f"2e-4 x mean|LLR| {scale}")
    for i, name in ((1, "slope"), (2, "cpe")):
        d = float((out_k[i] - out_p[i]).abs().max())
        check(d <= 1e-4, f"fused_eq_demap {name} differs by {d} rad")
    for i, name in ((3, "evm"), (4, "mean|llr|")):
        d = float(((out_k[i] - out_p[i]).abs() / out_p[i].abs()).max())
        check(d <= 1e-4, f"fused_eq_demap {name} differs by {d} rel")
    rows.append(dict(
        name="fused_eq_demap", route="cuda",
        source="gf3x_torch/csrc/fused_eq.cu",
        replaces="gf3x/ops/pallas/fused_eq.py:295", max_abs_err=err,
        ms=median_ms(lambda: fused_eq.fused_eq_demap(cfg, Y, H, nv,
                                                     modem.pilot_vals)),
        plain_ms=median_ms(lambda: fused_eq.fused_eq_demap_plain(
            cfg, Y, H, nv, modem.pilot_vals))))
    print(f"fused_eq_demap: hard decisions equal, max |dLLR| {err:.3g} "
          f"(mean |LLR| {scale:.3g}); {rows[-1]['ms']:.3f} ms vs plain "
          f"{rows[-1]['plain_ms']:.3f} ms", flush=True)

    # ---- kernel 3 vs plain on the path's codeword LLRs
    lam = modem._codeword_llrs(llr_k).contiguous()
    code = modem._code
    tot_k, uns_k, pas_k = code.decode_totals(lam, cfg.ldpc_iters)
    tot_p, uns_p, pas_p = ldpc_bp.minsum_totals_plain(lam, code.z, code.rate,
                                                      cfg.ldpc_iters)
    check(torch.equal(tot_k, tot_p), "minsum_totals totals are not "
          "bit-identical to its plain version")
    check(torch.equal(uns_k, uns_p) and torch.equal(pas_k, pas_p),
          "minsum_totals unsat/passes differ from its plain version")
    rows.append(dict(
        name="minsum_totals", route="cuda",
        source="gf3x_torch/csrc/ldpc_bp.cu",
        replaces="gf3x/ops/pallas/ldpc_bp.py:158",
        max_abs_err=float((tot_k - tot_p).abs().max()),
        ms=median_ms(lambda: code.decode_totals(lam, cfg.ldpc_iters)),
        plain_ms=median_ms(lambda: ldpc_bp.minsum_totals_plain(
            lam, code.z, code.rate, cfg.ldpc_iters))))
    # at the batch's 20 dB every codeword is valid before the first sweep,
    # so hold the message updates too: the same codewords as BPSK LLRs at
    # σ = 0.8, which take several sweeps and leave some unsatisfied
    gen = torch.Generator(device=dev).manual_seed(1)
    noise = torch.randn(lam.shape, generator=gen, device=dev)
    noisy = (2.0 / 0.64) * (torch.sign(lam) + 0.8 * noise)
    tot_k, uns_k, pas_k = code.decode_totals(noisy, cfg.ldpc_iters)
    tot_p, uns_p, pas_p = ldpc_bp.minsum_totals_plain(
        noisy, code.z, code.rate, cfg.ldpc_iters)
    check(torch.equal(tot_k, tot_p) and torch.equal(uns_k, uns_p)
          and torch.equal(pas_k, pas_p), "minsum_totals differs from its "
          "plain version on noisy LLRs")
    noisy_ms = median_ms(lambda: code.decode_totals(noisy, cfg.ldpc_iters))
    noisy_plain_ms = median_ms(lambda: ldpc_bp.minsum_totals_plain(
        noisy, code.z, code.rate, cfg.ldpc_iters))
    print(f"minsum_totals: totals bit-identical over {lam.shape[0]} "
          f"codewords; {rows[-1]['ms']:.3f} ms vs plain "
          f"{rows[-1]['plain_ms']:.3f} ms (0 sweeps); noisy: mean passes "
          f"{float(pas_k.float().mean()):.2f}, max {int(pas_k.max())}, "
          f"unsat {int(uns_k.sum())}, {noisy_ms:.3f} ms vs plain "
          f"{noisy_plain_ms:.3f} ms", flush=True)

    # ---- the main path, once, through the user's entry point
    counters = {"cut_symbols": gather_cut.cut_symbols,
                "fused_eq_demap": fused_eq.fused_eq_demap,
                "minsum_totals": ldpc_bp.minsum_totals}
    for fn in counters.values():
        fn.launches = 0
    bits, diag = modem.demodulate(rx)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path did not launch: {launches}")
    for row in rows:
        row["launches"] = launches[row["name"]]
    bits_np = bits.cpu().numpy()
    check(bits_np.shape == (B, cfg.payload_bits_per_frame), "bits shape")
    for i in range(B):
        res = modem._result(bits_np[i], None)
        check(res.crc_ok and res.payload == payload,
              f"row {i} did not decode to the planted payload")
    for name in ("sync_metric", "sc_metric", "H", "noise_var", "pilot_slope",
                 "common_phase", "evm", "mean_abs_llr", "clock_ppm",
                 "isi_var", "isi_db"):
        check(bool(torch.isfinite(getattr(diag, name)).all()),
              f"diag.{name} is not finite")
    check(int(diag.fec_unsat.sum()) == 0, "codewords left unsatisfied")
    sync_err = int((diag.sync_start.cpu() - torch.as_tensor(delays)).abs()
                   .max())
    check(sync_err <= cfg.cp // 4, f"sync off by {sync_err} samples")
    # a small input against the same path on the CPU (plain versions)
    cpu = Modem(cfg, max_delay=MARGIN + cfg.cp)
    bits_cpu, _ = cpu.demodulate(rx[:4].cpu())
    check(torch.equal(bits_cpu, bits[:4].cpu()),
          "card and CPU decodes of the first rows differ")
    step_ms = median_ms(lambda: modem.demodulate(rx))
    sps = B * cfg.n_data_symbols / (step_ms / 1e3)
    print(f"demodulate: {B}/{B} rows CRC-ok with the planted payload, "
          f"sync within {sync_err} samples, launches {launches}; "
          f"{step_ms:.3f} ms/step, {sps:.1f} data symbols/s", flush=True)

    # ---- demod DFT precision against a float64 NumPy DFT (gate −80 dB)
    ref = np.fft.rfft(syms_k.cpu().numpy().astype(np.float64), axis=-1)
    ref = ref[..., cfg.bin_lo: cfg.bin_hi + 1] / cfg.ofdm_scale
    got = ofdm_dft(cfg, syms_k).cpu().numpy().astype(np.complex128)
    db = 10 * np.log10(np.sum(np.abs(got - ref) ** 2) / np.sum(np.abs(ref) ** 2))
    check(db <= -80.0, f"demod DFT error {db:.1f} dB > -80 dB")
    print(f"dft precision: {db:.1f} dB (gate -80 dB)", flush=True)

    check("jax" not in sys.modules and "gf3x" not in sys.modules,
          "jax or gf3x was imported")
    print(json.dumps({"kernels": rows, "step_ms": step_ms,
                      "data_symbols_per_s": sps, "build_s": build_s,
                      "package": gf3x_torch.__name__}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
