"""BER-vs-SNR sweep (counterpart of gf3x/bench/ber.py), the reference's
benchmark config 3: every (snr, trial) cell carries its own random payload
through modulate → [FIR] → delay → AWGN → demodulate at the known onset,
as one batch on the modem's device. Pre-FEC and post-FEC BER come out of
the same demodulation pass."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..channel.torch_sims import apply_fir, awgn, delay

__all__ = ["ber_sweep"]


@torch.no_grad()
def ber_sweep(modem, snrs_db, n_trials: int = 16,
              generator: Optional[torch.Generator] = None,
              fir: Optional[np.ndarray] = None, delay_samples: int = 0, *,
              info=None, noise=None) -> dict:
    """Run the sweep on `modem.device` → dict of NumPy arrays: `snr_db`
    (S,), `ber_pre_fec` (S,) — the hard demapper decisions against the
    coded-stream bits —, `ber_post_fec` (S,) — the decoded payload bits
    (equal to pre-FEC when fec='none') —, `fer` (S,), `n_trials` and
    `bits_per_point`.

    The payload bits (S, n_trials, payload_bits) and the unit-normal noise
    (S, n_trials, T) are drawn from `generator` (a torch.Generator on the
    modem's device, seeded 0 when None), bits first; `info` and `noise`
    replace either draw (arrays of those shapes, e.g. another
    implementation's draws). T is frame_len + delay_samples: the frame is
    padded before the delay, so its tail is not cut off."""
    cfg = modem.cfg
    dev = modem.device
    snrs = torch.as_tensor(np.asarray(snrs_db, dtype=np.float32), device=dev)
    S, N = snrs.shape[0], n_trials
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if info is None:
        info = torch.rand((S, N, cfg.payload_bits_per_frame),
                          generator=generator, device=dev) < 0.5
    elif not torch.is_tensor(info):
        info = torch.as_tensor(np.array(info))
    info = info.to(dev, torch.uint8)

    wav = modem.modulate_frames(info)                          # (S, N, T)
    if fir is not None:
        wav = apply_fir(wav, np.asarray(fir, dtype=np.float32))
    if delay_samples:
        wav = delay(torch.nn.functional.pad(wav, (0, delay_samples)),
                    delay_samples)
    if noise is not None and not torch.is_tensor(noise):
        noise = torch.as_tensor(np.array(noise))
    rx = awgn(wav, snrs[:, None], generator=generator, noise=noise)
    start = torch.full((S, N), delay_samples, dtype=torch.int32, device=dev)

    # one demodulation feeds both BERs: the hard decisions of its LLRs give
    # the pre-FEC errors, the FEC decode of the same LLRs the post-FEC
    # errors. The pre-FEC count is taken in the coded-stream domain:
    # scrambling and interleaving only flip and move bits, so the count is
    # that of the channel bits
    (llr, _), _ = modem._demod_llr(rx, start)
    bits, _, _, _ = modem._payload_bits(llr)
    err = bits.reshape(S, N, -1) != info
    coded = modem._fec_coded_bits(info)
    hard = (modem.coded_stream_llr(llr) < 0).to(torch.uint8)
    raw_err = hard.reshape(S, N, -1) != coded
    n_post = err.sum(dim=(1, 2)).cpu().numpy()
    n_pre = raw_err.sum(dim=(1, 2)).cpu().numpy()
    n_fail = err.any(dim=-1).sum(dim=-1).cpu().numpy()
    return {
        "snr_db": snrs.cpu().numpy(),
        "ber_pre_fec": n_pre / float(N * cfg.raw_bits_per_frame),
        "ber_post_fec": n_post / float(N * cfg.payload_bits_per_frame),
        "fer": n_fail / float(N),
        "n_trials": N,
        "bits_per_point": N * cfg.payload_bits_per_frame,
    }
