"""The traffic generator: one general recipe that every traffic file
(`benchmark/traffic/<name>.json`) parameterises.

A cell's inputs are a ring of resident batches, each (B, frame_len +
margin) float32 on the device: `frames` distinct frames with random
`payload_bytes`-byte payloads from the reference's transmitter, row r
carrying frame r mod `frames` at an onset uniform in [0, margin), optionally
through a fixed speaker-and-room channel (a `channel` block: the FIR of
`reference.channel.room_fir`, drawn from its own `room_seed`, never longer
than the cyclic prefix; the reverberant tail cut where the recording ends),
then optionally a sampling-clock offset of `clock_ppm` (one TX/RX clock
pair for the whole cell), in white noise at `snr_db` below the received
frame's mean power. The payloads and onsets come from NumPy's generator,
the noise from a torch generator on the device, both seeded by `--seed`:
the same seed gives the same inputs, and the room is the same for every
seed. Every seed gives the same sizes; only the payloads, onsets and noise
differ."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .reference.channel import convolve, noise_std, resample_sinc, room_fir
from .reference.modem import encode_frames, info_bits

__all__ = ["Inputs", "channel_fir", "make_inputs", "FILENAME"]

FILENAME = "bench.bin"     # the name in every frame's header (bench.py's)


class Inputs(NamedTuple):
    ring: list             # ring_batches × (B, T) float32 on the device
    sent: torch.Tensor     # (frames, payload_bits) uint8 on the device
    frame_of_row: torch.Tensor   # (B,) int64: the frame row r carries
    onsets: np.ndarray     # (ring_batches, B) int64


def _seed(seed: int) -> int:
    return int(seed) % (1 << 63)


def channel_fir(cfg, block: dict) -> np.ndarray:
    """The FIR of a traffic file's `channel` block, refused where it is
    longer than the configuration's cyclic prefix."""
    from .harness import RunError

    h = room_fir(block, cfg.fs)
    if len(h) > cfg.cp:
        raise RunError(f"the traffic's channel has {len(h)} taps, more than "
                       f"the cyclic prefix's {cfg.cp}")
    return h


def make_inputs(cfg, traffic: dict, seed: int, device) -> Inputs:
    """The ring of batches `traffic` describes, for the reference
    configuration `cfg` (see the module doc)."""
    B, F = int(traffic["batch"]), int(traffic["frames"])
    margin, ring = int(traffic["margin"]), int(traffic["ring"])
    rng = np.random.default_rng(_seed(seed))
    payloads = [rng.integers(0, 256, int(traffic["payload_bytes"]),
                             dtype=np.uint8).tobytes() for _ in range(F)]
    info = np.stack([info_bits(cfg, p, FILENAME) for p in payloads])
    wav = torch.as_tensor(encode_frames(cfg, info), device=device)
    if "channel" in traffic:
        wav = convolve(wav, channel_fir(cfg, traffic["channel"]))
    ppm = float(traffic.get("clock_ppm", 0.0))
    if ppm:
        wav = resample_sinc(wav, ppm)
    sigma = noise_std(wav, float(traffic["snr_db"])).to(torch.float32)
    frames = wav.to(torch.float32)
    L, T = frames.shape[1], cfg.frame_len + margin
    rows = torch.arange(B, device=device) % F
    gen = torch.Generator(device=device).manual_seed(_seed(seed))
    onsets = rng.integers(0, margin, size=(ring, B))
    batches = []
    for j in range(ring):
        rx = torch.randn(B, T, generator=gen, dtype=torch.float32,
                         device=device)
        rx.mul_(sigma[rows][:, None])
        for r in range(B):
            d = int(onsets[j, r])
            rx[r, d: d + L] += frames[r % F, : T - d]
        batches.append(rx)
    return Inputs(batches, torch.as_tensor(info, device=device), rows,
                  onsets)
