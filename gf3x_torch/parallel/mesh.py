"""Multi-GPU decode (counterpart of gf3x/parallel/mesh.py): the frame batch
split over devices, each shard decoded by a replica of the modem on its
device, in one process.

Frames are independent, so the split is pure data parallelism, as gf3x's
`shard_map` route over the batch axis: every shard runs the whole
single-device receiver (the CUDA kernels at the shard's own batch) on its
rows, and only the outputs — the bits, the per-frame diagnostics and, in
the pipeline step, three scalar sums — are gathered on the first device.
The host issues each shard's work in turn without waiting on any of them,
so the cards run at once. A mesh may name one device more than once (two
shards on one card) or the CPU.

gf3x's second route, GSPMD with the sample axis sharded (`seq_axis`), is
not ported: it traces every kernel router to its XLA twin so that XLA can
partition the FFTs over chips, which is TPU enablement. A recording too
long for one card's correlation goes through the port's overlap-save scan
(`ops.sync.streaming_matched_filter`).

    mesh = make_mesh()                       # every CUDA device
    bits, diag = sharded_decode(modem, mesh)(rx)
    step = sharded_pipeline_step(modem, mesh)
    ber, ok, bits = step(info_bits, seed=1, snr_db=25.0)
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["make_mesh", "shard_batch", "sharded_decode",
           "sharded_pipeline_step"]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> tuple:
    """A 1-D mesh: the tuple of torch devices that shard i of a batch goes
    to, over `devices` (torch devices or their names), by default every
    CUDA device of this process; the first `n_devices` of them when
    given."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)[:n_devices]
    if not mesh:
        raise ValueError("make_mesh: no devices (torch sees no CUDA device; "
                         "pass devices= for the CPU)")
    return mesh


def shard_batch(x, mesh: tuple) -> list:
    """Split a batch over the mesh along its leading axis: one piece per
    device, copied there. The batch must divide by the shard count."""
    x = torch.as_tensor(x)
    if x.shape[0] % len(mesh):
        raise ValueError(f"shard_batch: a batch of {x.shape[0]} does not "
                         f"divide into {len(mesh)} shards")
    return [piece.to(dev, non_blocking=True)
            for piece, dev in zip(x.split(x.shape[0] // len(mesh)), mesh)]


def _on(device: torch.device):
    """The context that makes `device` current, for a CUDA device."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _replicas(modem, mesh: tuple) -> list:
    """One modem per shard: `modem` itself on its own device, elsewhere a
    replica built from its config and options, with its tables on that
    device (one replica per distinct device)."""
    from ..models import Modem

    reps = {modem.device: modem}
    for dev in mesh:
        if dev not in reps:
            with _on(dev):
                reps[dev] = Modem(modem.cfg, max_delay=modem.max_delay,
                                  device=dev, use_cut_dft=modem.use_cut_dft)
    return [reps[dev] for dev in mesh]


def _gather(pieces: list, device: torch.device):
    """Concatenate shard outputs — tensors, or NamedTuples of them such as
    DecodeDiag — along the batch axis on `device`."""
    first = pieces[0]
    if isinstance(first, tuple):
        parts = [_gather(list(f), device) for f in zip(*pieces)]
        return type(first)(*parts) if hasattr(first, "_fields") else \
            tuple(parts)
    return torch.cat([p.to(device) for p in pieces])


def sharded_decode(modem, mesh: tuple):
    """`modem.demodulate` over the mesh: f(rx) → (bits, diag), rx (B, T)
    float32 with B divisible by the shard count (or the shards
    `shard_batch` made). Shard i runs its replica's `demodulate` on its
    B / n rows on mesh[i]; bits and every DecodeDiag field come
    back concatenated on the first device."""
    reps = _replicas(modem, mesh)

    def decode(rx):
        shards = (list(rx) if isinstance(rx, (list, tuple))
                  else shard_batch(rx, mesh))
        outs = []
        for rep, x in zip(reps, shards):
            with _on(rep.device):
                outs.append(rep.demodulate(x))
        return _gather(outs, mesh[0])

    return decode


def _shard_generator(seed: int, shard: int,
                     device: torch.device) -> torch.Generator:
    """Shard `shard`'s noise generator on `device`, seeded from (seed,
    shard): distinct per shard and reproducible, as gf3x's fold_in of the
    shard index into the key."""
    state = np.random.SeedSequence([int(seed), int(shard)]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def sharded_pipeline_step(modem, mesh: tuple, margin: int = 512):
    """The whole framework step over the mesh (gf3x's
    `sharded_pipeline_step`): f(info_bits (B, payload_bits) uint8, seed,
    snr_db) → (ber, ok, bits). Each shard modulates its rows, delays each by
    a random 0..margin−1 samples (a per-row roll of the padded frame), adds
    AWGN at `snr_db` of the row's power, and decodes with the chirp sync,
    drawing from its own generator (`_shard_generator`). ber is the
    payload bit errors over the bits, ok that no row has a bit error or a
    sync error beyond cp/4, both reduced over the shards on the first
    device; bits (B, payload_bits) come back concatenated there."""
    reps = _replicas(modem, mesh)
    cfg = modem.cfg

    def local(rep, info, gen, snr_db):
        dev = rep.device
        wav = rep.modulate_frames(info)                       # (b, frame_len)
        pad = torch.nn.functional.pad(wav, (0, margin))
        b, L = pad.shape
        delays = torch.randint(0, margin, (b,), generator=gen, device=dev)
        idx = (torch.arange(L, device=dev) - delays[:, None]) % L
        rx = torch.gather(pad, 1, idx)                        # row-wise roll
        p = torch.mean(rx ** 2, dim=-1, keepdim=True)
        nvar = p / 10.0 ** (snr_db / 10.0)
        rx = rx + torch.randn(rx.shape, generator=gen, device=dev) \
            * torch.sqrt(nvar)
        bits, diag = rep.demodulate(rx)
        ok_rows = torch.all(bits == info, dim=-1)
        sync_err = torch.abs(diag.sync_start.to(torch.int64) - delays)
        bad = (~ok_rows | (sync_err > cfg.cp // 4)).sum()
        return (torch.sum(bits != info), bad), bits

    def step(info_bits, seed: int, snr_db: float):
        shards = shard_batch(torch.as_tensor(info_bits, dtype=torch.uint8),
                             mesh)
        sums, bits = [], []
        for i, (rep, info) in enumerate(zip(reps, shards)):
            with _on(rep.device):
                s, b = local(rep, info, _shard_generator(seed, i, rep.device),
                             float(snr_db))
            sums.append(s)
            bits.append(b)
        first = mesh[0]
        nerr = sum(s[0].to(first) for s in sums)
        nbad = sum(s[1].to(first) for s in sums)
        bits = _gather(bits, first)
        return nerr.to(torch.float32) / bits.numel(), nbad == 0, bits

    return step
