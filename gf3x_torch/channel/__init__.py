"""Channel simulators (counterpart of gf3x.channel, host-side NumPy)."""

from .sims import (Chain, Impairment, awgn, clip, delay_gain, multipath,
                   resample_sfo, room_impulse_response, speaker_mic_fir)

__all__ = ["awgn", "delay_gain", "multipath", "room_impulse_response",
           "clip", "resample_sfo", "speaker_mic_fir", "Impairment", "Chain"]
