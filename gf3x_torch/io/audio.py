# Copied from gf3x/io/audio.py (NumPy and SciPy only), so that gf3x_torch
# never imports jax.
"""Host audio I/O: WAV files at 44.1 kHz, and live play/record through
`sounddevice` where it is installed (an optional import; without it those
two raise with guidance). float32 waveforms in [-1, 1] cross this module
as 16-bit PCM."""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.io import wavfile

__all__ = ["write_wav", "read_wav", "play", "record", "have_live_audio"]


def write_wav(path: str | Path, waveform: np.ndarray, fs: int = 44100) -> None:
    """float waveform in [-1, 1] → 16-bit PCM WAV (clipped, not wrapped)."""
    x = np.clip(np.asarray(waveform, dtype=np.float64), -1.0, 1.0)
    wavfile.write(str(path), fs, (x * 32767.0).astype(np.int16))


def read_wav(path: str | Path, expect_fs: int | None = 44100) -> tuple[np.ndarray, int]:
    """WAV → (float32 waveform in [-1, 1], fs). Stereo is averaged to mono;
    int16/int32/uint8/float inputs normalized."""
    fs, data = wavfile.read(str(path))
    if expect_fs is not None and fs != expect_fs:
        raise ValueError(f"{path}: sample rate {fs} != expected {expect_fs}")
    # normalize BEFORE the stereo mixdown — mean() promotes to float and
    # would make every PCM dtype miss its branch
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)
    return x, fs


def have_live_audio() -> bool:
    try:
        import sounddevice  # noqa: F401
        return True
    except Exception:
        return False


def play(waveform: np.ndarray, fs: int = 44100) -> None:
    """Play through the default output device (requires sounddevice)."""
    try:
        import sounddevice as sd
    except ImportError as e:
        raise RuntimeError(
            "live playback needs the `sounddevice` package (not in this "
            "image); write a WAV with write_wav() and play it externally"
        ) from e
    sd.play(np.asarray(waveform, dtype=np.float32), fs)
    sd.wait()


def record(seconds: float, fs: int = 44100) -> np.ndarray:
    """Record from the default input device (requires sounddevice)."""
    try:
        import sounddevice as sd
    except ImportError as e:
        raise RuntimeError(
            "live capture needs the `sounddevice` package (not in this "
            "image); record externally and decode the WAV with read_wav()"
        ) from e
    x = sd.rec(int(seconds * fs), samplerate=fs, channels=1, dtype="float32")
    sd.wait()
    return x[:, 0]
