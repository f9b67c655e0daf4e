"""gf3x_torch — the PyTorch/CUDA port of gf3x, beside the JAX package it is
held against. It runs every decode route of gf3x's Modem (chirp or
Schmidl–Cox sync, frame cut — alone or fused with the used-band DFT —, LS
estimate, EQ/track/demap — fused for uniform configs, split for bit-loaded
ones —, LDPC, the clock-offset loop and the decision-directed retry), the
multi-frame stream decoder with its long-recording frame scan, HARQ chase
combining, the ARQ state machines, the channel simulators (host and
device), the BER sweep, the transmit path, link adaptation, the `gf3x-torch`
command line (`cli.py`) and the float64 golden model, with eight
hand-written CUDA kernels for sm_90a on the card and their plain PyTorch
versions on the CPU. It never imports jax or gf3x.

A `Modem` lives on the card unless the caller asks for the CPU:

    from gf3x_torch import GF3_STANDARD, Modem
    modem = Modem(GF3_STANDARD, max_delay=4352)  # on torch.device("cuda")
    bits, diag = modem.demodulate(rx)            # rx: (B, T) float32
    res = modem.decode(recording)                # one WAV's samples
    cpu = Modem(GF3_STANDARD, device="cpu")      # the plain versions
"""

import torch

# Full float32 everywhere: the LDPC encode is a float matmul taken mod 2,
# and the 280×280 complex denoise and ISI products need every bit.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import (CONFIG1_LOOPBACK, GF3_FAST, GF3_HICAP,  # noqa: E402
                     GF3_ROBUST, GF3_STANDARD, GF3_TURBO, ModemConfig,
                     layout, preset)
from .golden import GoldenModem  # noqa: E402
from .models import DecodeDiag, DecodeResult, Modem  # noqa: E402

__all__ = ["ModemConfig", "preset", "layout", "GF3_STANDARD", "GF3_FAST",
           "GF3_HICAP", "GF3_TURBO", "GF3_ROBUST", "CONFIG1_LOOPBACK",
           "Modem", "DecodeDiag", "DecodeResult", "GoldenModem"]
