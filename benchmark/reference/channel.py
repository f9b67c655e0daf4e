"""The channel the traffic generator puts every frame through: optionally a
fixed speaker-and-room FIR (the speaker and microphone's response convolved
with a synthetic room impulse response: NumPy copies of the program's
`channel/sims.py` `speaker_mic_fir` and `room_impulse_response`, the same
samples for the same seed) applied in float64; a sampling clock offset by a
Kaiser-windowed sinc, chip_smoke.py's `resample_sinc` in torch on the
device (gf3x's linear resampler errs by −11 dB at 13 kHz); and the noise
level of AWGN at an SNR against the frame's mean power, as
`gf3x_torch.bench.step.build_batch` and `channel.torch_sims.awgn` define it."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["speaker_mic_fir", "room_impulse_response", "room_fir",
           "convolve", "resample_sinc", "noise_std"]


def speaker_mic_fir(fs: int, lowcut: float, highcut: float,
                    ripple_db: float, taps: int,
                    rng: np.random.Generator) -> np.ndarray:
    """A linear-phase FIR of `taps` taps for a speaker and microphone: a
    2nd-order Butterworth highpass at `lowcut`, a 4th-order lowpass at
    `highcut` and, unless `ripple_db` is 0, a smooth random ±`ripple_db`
    ripple drawn from `rng`; by frequency sampling on 4096 points, centred,
    Hann-windowed."""
    nfft = 4096
    f = np.fft.rfftfreq(nfft, 1.0 / fs)
    with np.errstate(divide="ignore"):
        r2 = (f / lowcut) ** 2
    hp = r2 / np.sqrt(1.0 + r2 * r2)
    lp = 1.0 / np.sqrt(1.0 + (f / highcut) ** 8)
    mag = hp * lp
    if ripple_db:
        rough = rng.normal(size=mag.shape)
        k = np.exp(-0.5 * (np.arange(-128, 129) / 32.0) ** 2)
        smooth = np.convolve(rough, k / k.sum(), mode="same")
        smooth = smooth / (np.max(np.abs(smooth)) + 1e-12)
        mag = mag * 10.0 ** (ripple_db * smooth / 20.0)
    h = np.fft.irfft(mag, nfft)
    h = np.roll(h, taps // 2)[:taps]
    return h * np.hanning(taps)


def room_impulse_response(rng: np.random.Generator, fs: int, rt60: float,
                          drr_db: float) -> np.ndarray:
    """A synthetic room of rt60·fs taps: a direct path and a Gaussian tail
    decaying by 60 dB over `rt60` seconds, `drr_db` the
    direct-to-reverberant energy ratio, unit energy."""
    length = int(rt60 * fs)
    t = np.arange(length) / fs
    tail = rng.normal(size=length) * np.exp(-6.9 * t / rt60)
    tail[0] = 0.0
    te = np.sum(tail ** 2)
    if te > 0:
        tail *= np.sqrt(10.0 ** (-drr_db / 10.0) / te)
    h = tail
    h[0] = 1.0
    return h / np.sqrt(np.sum(h ** 2))


def room_fir(block: dict, fs: int) -> np.ndarray:
    """A traffic file's `channel` block → its FIR: the speaker and
    microphone (`lowcut_hz`, `highcut_hz`, `ripple_db`, `taps`), then the
    room (`rt60_s`, `drr_db`), both drawn in that order from
    default_rng(`room_seed`): one room whatever the run's seed."""
    rng = np.random.default_rng(int(block["room_seed"]))
    spk = speaker_mic_fir(fs, float(block["lowcut_hz"]),
                          float(block["highcut_hz"]), float(block["ripple_db"]),
                          int(block["taps"]), rng)
    room = room_impulse_response(rng, fs, float(block["rt60_s"]),
                                 float(block["drr_db"]))
    return np.convolve(spk, room)


def convolve(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """Rows x (F, L) through the FIR h in float64 (by FFT, on x's device)
    → (F, L + len(h) − 1), the whole tail kept."""
    n = x.shape[-1] + len(h) - 1
    nfft = 1 << int(np.ceil(np.log2(n)))
    hf = torch.fft.rfft(torch.as_tensor(h, dtype=torch.float64,
                                        device=x.device), nfft)
    return torch.fft.irfft(torch.fft.rfft(x.to(torch.float64), nfft) * hf,
                           nfft)[..., :n]


def resample_sinc(x: torch.Tensor, ppm: float, taps: int = 64,
                  beta: float = 8.0) -> torch.Tensor:
    """A sampling-clock offset of `ppm` on rows x (F, L) float64 (on any
    device): output sample n reads input time n·(1 + ppm·1e-6) through a
    Kaiser-windowed sinc of `taps` taps."""
    ratio = 1.0 + ppm * 1e-6
    F, L = x.shape
    n_out = int(np.floor((L - 1) / ratio)) + 1
    half = taps // 2
    dev = x.device
    j = torch.arange(-half + 1, half + 1, device=dev)
    xp = torch.nn.functional.pad(x.to(torch.float64), (half, half))
    i0b = float(np.i0(beta))
    out = torch.empty(F, n_out, dtype=torch.float64, device=dev)
    for a in range(0, n_out, 1 << 15):
        t = torch.arange(a, min(n_out, a + (1 << 15)), dtype=torch.float64,
                         device=dev) * ratio
        i0 = torch.floor(t).to(torch.int64)
        d = (t - i0)[:, None] - j[None, :]
        w = torch.sinc(d) * torch.special.i0(beta * torch.sqrt(torch.clamp(
            1.0 - (d / half) ** 2, 0.0, 1.0))) / i0b
        idx = (i0[:, None] + j[None, :] + half).reshape(-1)
        out[:, a: a + len(t)] = torch.sum(
            xp[:, idx].reshape(F, len(t), taps) * w, dim=-1)
    return out


def noise_std(frames: torch.Tensor, snr_db: float) -> torch.Tensor:
    """The standard deviation of white noise at `snr_db` below each frame's
    mean power: frames (F, L) → (F,)."""
    p = torch.mean(frames.to(torch.float64) ** 2, dim=-1)
    return torch.sqrt(p / 10.0 ** (snr_db / 10.0))
