"""The config-5 step (bench.py's workload on the port): `Modem(GF3_STANDARD,
max_delay=4096 + cp).demodulate` on a (B, frame_len + 4096) float32 batch
of B recordings, each one frame with a 540-byte payload at a random onset
in 20 dB AWGN. `run` times it and reports data symbols/s.

    python -m gf3x_torch.cli bench [--batch 1024] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

__all__ = ["MARGIN", "RUNS", "build_batch", "run"]

MARGIN = 4096       # random onset headroom per recording (samples)
RUNS = 20           # timed steps, of which `run` reports the median


def build_batch(modem, B: int, margin: int, rng):
    """B copies of a real frame at random delays + 20 dB AWGN (decodable):
    (rx (B, frame_len + margin) float32, payload, delays).

    A copy of bench.py:37-49 (`build_batch`, the JAX benchmark's config-5
    batch recipe), kept here so that the port imports nothing of the JAX
    side; tests/test_torch_launch.py holds the two equal."""
    cfg = modem.cfg
    payload = rng.integers(0, 256, 540, dtype=np.uint8).tobytes()
    wav = modem.encode(payload, "bench.bin")
    T = cfg.frame_len + margin
    rx = np.zeros((B, T), dtype=np.float32)
    delays = rng.integers(0, margin, size=B)
    for i in range(B):
        rx[i, delays[i]: delays[i] + wav.size] = wav
    p = float(np.mean(wav**2))
    rx += (rng.standard_normal((B, T)) * np.sqrt(p / 100.0)).astype(np.float32)
    return rx, payload, delays


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device="cuda", batch: int = 1024) -> dict:
    """Time the config-5 step on `device`: the batch is built once and
    resident, the first rows must decode to the planted payload, then the
    median of `RUNS` synchronised `demodulate` calls after one warm-up.
    Prints and returns {"metric": data symbols/s, "unit", "step_ms",
    "frames_per_s", "batch", "device"}."""
    from .. import GF3_STANDARD, Modem

    cfg = GF3_STANDARD
    modem = Modem(cfg, max_delay=MARGIN + cfg.cp, device=device)
    rx_np, payload, _ = build_batch(modem, batch, MARGIN,
                                    np.random.default_rng(0))
    rx = torch.as_tensor(rx_np, device=modem.device)
    bits, _ = modem.demodulate(rx)
    for row in bits[: min(batch, 2)].cpu().numpy():
        res = modem._result(row, None)
        if not (res.crc_ok and res.payload == payload):
            raise RuntimeError("the config-5 step does not decode its batch")
    times = []
    for _ in range(RUNS):
        _sync(modem.device)
        t0 = time.perf_counter()
        modem.demodulate(rx)
        _sync(modem.device)
        times.append(time.perf_counter() - t0)
    step = float(np.median(times))
    out = {"metric": batch * cfg.n_data_symbols / step,
           "unit": "data symbols/s", "step_ms": 1e3 * step,
           "frames_per_s": batch / step, "batch": batch,
           "device": str(modem.device)}
    print(json.dumps(out), flush=True)
    return out
