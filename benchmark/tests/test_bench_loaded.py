"""The reference's bit-loaded band (`benchmark/reference/loading.py`): its
transmitter against the program's, and a loaded cell added to a copy of the
benchmark as files alone (a configuration whose `replace` carries the
loading table as a JSON list, a traffic file naming a room, a workload
file) that runs `correct` on the CPU, while the TF32 control and two faulty
loaded steps do not."""

import json
import shutil
import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import config as ref_config
from benchmark.reference.modem import encode_frames, info_bits

WIDE = {"n_fft": 8192, "cp": 2048, "bin_lo": 192, "bin_hi": 2431,
        "bits_per_symbol": 6}
CELL = "gf3-8192-loaded.b8-20db-room"
# test_bench_traffic.py's wide-band room: 1835 taps against CP 2048
ROOM = {"room_seed": 11, "rt60_s": 0.03, "drr_db": 6.0, "lowcut_hz": 150,
        "highcut_hz": 15000, "ripple_db": 3.0, "taps": 513}

# The loaded cell's limits: the 20 dB cell's own (the same band, SNR,
# stages and float32 arithmetic; PERF.md §2). On the CPU the program's
# readings sit 6-60x under them and the TF32 control over most of them;
# the deployment's own limits come from its sound runs and its control on
# the card.
LIMITS = {"sync_start": 0, "sync_metric": 7e-06, "H": 0.0003,
          "noise_var": 5e-05, "pilot_slope": 1e-08, "common_phase": 2e-05,
          "evm": 4e-05, "mean_abs_llr": 9e-05, "clock_ppm": 4e-05,
          "fec_iters": 0, "fec_unsat": 0, "bits_ref": 0, "bits_sent": 0}


def four_orders(n: int, seed: int) -> tuple:
    """A table of n bins that uses 0, 2, 4 and 6 bits."""
    rng = np.random.default_rng(seed)
    t = rng.choice([0, 2, 4, 6], size=n, p=[0.1, 0.2, 0.3, 0.4])
    t[:4] = (0, 2, 4, 6)
    return tuple(int(b) for b in t)


@pytest.mark.parametrize("replace", [{}, WIDE], ids=["gf3-standard",
                                                     "gf3-8192"])
def test_loaded_transmitter_matches_the_port(replace):
    from gf3x_torch import Modem
    from gf3x_torch.config import preset

    cfg = ref_config.preset("gf3-standard").replace(**replace)
    table = four_orders(cfg.n_data_bins, 3)
    cfg = cfg.replace(bit_loading=table)
    payload = bytes(range(200)) * 2
    ours = encode_frames(cfg, info_bits(cfg, payload, "bench.bin")[None])
    port = Modem(preset("gf3-standard").replace(**replace,
                                                bit_loading=table),
                 device="cpu").encode(payload, "bench.bin")
    assert ours.shape == (1, port.size)
    assert np.max(np.abs(ours[0] - port)) < 1e-6


@pytest.fixture(scope="module")
def loaded_root(tmp_path_factory):
    """A copy of the benchmark with the loaded cell added as files: gf3-8192
    with the table the program's `bit_loading_from_probe` gives (margin
    1 dB) for a probe decode of gf3-8192 through ROOM at 20 dB."""
    from gf3x_torch import Modem
    from gf3x_torch.ops.adapt import bit_loading_from_probe

    from benchmark.traffic import make_inputs

    root = tmp_path_factory.mktemp("loaded")
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = root / "benchmark"
    traffic = {"entry": "demodulate", "batch": 8, "snr_db": 20.0,
               "clock_ppm": 0.0, "margin": 4096, "frames": 8,
               "payload_bytes": 540, "ring": 2, "channel": ROOM}
    probe_cell = harness.load_cell("gf3-8192.b1024-20db")
    pcfg, rcfg = harness._configs(probe_cell)
    probe = make_inputs(rcfg, dict(traffic, ring=1), 1234567, "cpu").ring[0]
    _, diag = Modem(pcfg, max_delay=4096 + pcfg.cp, device="cpu").demodulate(
        probe)
    table = bit_loading_from_probe(diag, pcfg, margin_db=1.0)
    assert set(table) == {0, 2, 4, 6}
    (base / "configs" / "gf3-8192-loaded.json").write_text(json.dumps(
        {"preset": "gf3-standard", "replace": dict(WIDE,
                                                   bit_loading=list(table)),
         "reduced": []}))
    (base / "traffic" / "b8-20db-room.json").write_text(json.dumps(traffic))
    (base / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"warmup_steps": 1, "profile_steps": 2, "sample_rows": 8,
         "limits": LIMITS}))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gf3-8192-loaded", "source": "a test",
                             "file": "benchmark/configs/gf3-8192-loaded.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "gf3-8192-loaded",
                               "traffic": "b8-20db-room", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, seed=2 ** 35 + 1):
    cell = harness.load_cell(CELL, root=root)
    return harness.run(cell, seed, 0.01, False, "cpu", time.perf_counter())


def test_a_loaded_cell_is_files_alone(loaded_root):
    cell = harness.load_cell(CELL, root=loaded_root)
    pcfg, rcfg = harness._configs(cell)
    assert isinstance(rcfg.bit_loading, tuple)
    assert pcfg.bit_loading == rcfg.bit_loading
    assert rcfg.bits_per_ofdm_symbol != 1960 * 6
    result, lines = run(loaded_root)
    assert result["failed"] == 0 and result["attempted"] >= 8
    assert result["checks"]["bits_sent"]["value"] == 0
    assert result["checks"]["bits_ref"]["value"] == 0
    assert result["correct"] is True, "\n".join(lines)


def test_the_loaded_control_is_not_correct(loaded_root):
    from benchmark.control import control

    ok, judged = control(harness.load_cell(CELL, root=loaded_root), 4242,
                         "cpu")
    assert ok is False
    assert [k for k, v in judged.items() if v["value"] > v["limit"]], judged


def negate_a_group(monkeypatch, cfg):
    """The 16-QAM group's LLRs negated where the split tail produces them."""
    from gf3x_torch.models.modem import Modem

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
def test_a_faulty_loaded_step_is_not_correct(loaded_root, fault,
                                             monkeypatch):
    cfg = harness.reference_config(harness.load_cell(CELL, root=loaded_root))
    fault(monkeypatch, cfg)
    result, lines = run(loaded_root, seed=91)
    assert result["checks"]["bits_sent"]["value"] > 0
    assert result["correct"] is False, "\n".join(lines)
