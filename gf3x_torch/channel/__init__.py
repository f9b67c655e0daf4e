"""Channel simulators: gf3x.channel's host-side NumPy simulators (copied),
and their device counterparts on torch tensors in the `torch_sims`
submodule (gf3x.channel.jax_sims's)."""

from . import torch_sims
from .sims import (Chain, Impairment, awgn, clip, delay_gain, multipath,
                   resample_sfo, room_impulse_response, speaker_mic_fir)

__all__ = ["awgn", "delay_gain", "multipath", "room_impulse_response",
           "clip", "resample_sfo", "speaker_mic_fir", "Impairment", "Chain",
           "torch_sims"]
