"""The FEC gather (`csrc/fec_gather.cu`) with its plain PyTorch version:
scrambled wire-order LLRs (B, raw_bits) → descrambled LLRs in codeword
order (B, used), used = n_codewords · n, in one pass — the deinterleaver's
static gather with the descrambler's sign folded in. It replaces no TPU
kernel: gf3x leaves the same gather and multiply to XLA.

On the card it is one of two kernels, picked from the shapes: where the
caller names the three axes whose reversal the index is (`axes`, the
interleaver's (D, B2, A2); see `reversal_index`), the tiled kernel, which
moves whole input runs through shared memory; for any other index the
indexed kernel. Each launch spreads every row over enough blocks to fill
the card (`fec_gather_tiles`, `fec_gather_chunk`).

The wrapper runs the plain version for CPU tensors and launches a kernel
for CUDA tensors (or raises), and counts launches in `.launches`.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.device import launch, sm_count

__all__ = ["fec_gather", "fec_gather_plain", "fec_gather_chunk",
           "fec_gather_tiles", "tile_pitch", "reversal_index"]

PASS = 1024         # outputs an indexed block stores a pass: 256 threads × 4
MAX_CHUNK = 4096    # outputs an indexed block walks at most
FILL_BLOCKS = 32    # indexed blocks an SM should get: 8 resident, 4 waves
TILE_A = 16         # columns a tile (the kernel's kTileA): 64-byte runs
TILE_SMEM = 24 * 1024   # shared memory a tile takes at most


def reversal_index(D: int, B2: int, A2: int) -> np.ndarray:
    """The index that reads input (D, B2, A2) as output (A2, B2, D):
    output (a, b, d) takes input (d, b, a). gf3x's deinterleaver is this
    with D data symbols and the bin scatter's (B2, A2)."""
    return np.arange(D * B2 * A2).reshape(D, B2, A2).transpose(
        2, 1, 0).reshape(-1)


def fec_gather_plain(llr: torch.Tensor, index: torch.Tensor,
                     scramble: torch.Tensor) -> torch.Tensor:
    """llr (B, R), index (used,) into [0, R), scramble (R,) bits → (B, used):
    llr[:, index] · (1 − 2·scramble[:used])."""
    used = index.shape[0]
    sign = 1.0 - 2.0 * scramble[:used].to(torch.float32)
    return llr[:, index.long()] * sign


def fec_gather_chunk(B: int, used: int, sms: int) -> int:
    """The outputs of one row that one indexed block walks: the most, up to
    MAX_CHUNK, that still give each of `sms` SMs FILL_BLOCKS blocks, and at
    least one pass. Few rows then run at once, so their inputs stay in L2
    while the blocks' scattered reads come back for them."""
    per_row = -(-sms * FILL_BLOCKS // max(B, 1))
    chunk = -(-used // per_row)
    return max(PASS, min(MAX_CHUNK, -(-chunk // PASS) * PASS))


def tile_pitch(D: int, tb: int) -> int:
    """The floats one staged column of a tile takes: its tb·D outputs,
    rounded up to 4 mod 32 — a multiple of 4 for the float4 reads, and the
    transposing stores at most two to a bank."""
    return tb * D + (4 - tb * D) % 32


def fec_gather_tiles(B: int, axes: tuple, sms: int) -> int | None:
    """The tiled kernel's rows a tile (TB) for a batch of B over `axes` =
    (D, B2, A2): the most of 16, 8, 4, 2, 1 (and at most B2) whose 16
    staged columns fit TILE_SMEM, halved while the grid gives fewer than
    two blocks an SM; None where not even one row fits."""
    D, B2, A2 = axes
    fits = [tb for tb in (16, 8, 4, 2, 1)
            if 4 * TILE_A * tile_pitch(D, tb) <= TILE_SMEM]
    if not fits:
        return None
    tb = min(fits[0], B2)
    while tb > 1 and B * -(-A2 // TILE_A) * -(-B2 // tb) < 2 * sms:
        tb //= 2
    return tb


def fec_gather(llr: torch.Tensor, index: torch.Tensor,
               scramble: torch.Tensor, axes: tuple | None = None
               ) -> torch.Tensor:
    """`fec_gather_plain` for CPU tensors; a CUDA kernel for CUDA ones.
    Takes llr (B, R) float32 (rows may be a wider tensor's), index (used,)
    int32 and scramble (R,) uint8 on one device, and refuses anything else.
    `axes` = (D, B2, A2) with
    D·B2·A2 = R tells the card that `index` is `reversal_index(D, B2,
    A2)[:used]` (the caller holds it to that): the tiled kernel, which reads
    no index. Without it the indexed kernel, which needs `used` a multiple
    of 4 (an LDPC codeword is 24·z bits)."""
    if (llr.dtype != torch.float32 or index.dtype != torch.int32
            or scramble.dtype != torch.uint8 or llr.dim() != 2
            or index.dim() != 1 or scramble.shape != llr.shape[1:]
            or index.shape[0] > llr.shape[1]
            or (axes is not None and int(np.prod(axes)) != llr.shape[1])):
        raise ValueError(
            f"fec_gather: needs llr (B, R) float32, index (used,) int32 with "
            f"used <= R, scramble (R,) uint8 and axes of R entries; got llr "
            f"{tuple(llr.shape)} {llr.dtype}, index {tuple(index.shape)} "
            f"{index.dtype}, scramble {tuple(scramble.shape)} "
            f"{scramble.dtype}, axes {axes}")
    dev = llr.device
    if dev.type == "cpu" and index.device == scramble.device == dev:
        return fec_gather_plain(llr, index, scramble)
    if dev.type != "cuda" or index.device != dev or scramble.device != dev:
        raise ValueError(f"fec_gather: llr on {dev}, index on {index.device}"
                         f", scramble on {scramble.device}: all must be on "
                         "the CPU or on one CUDA device")
    B, used = llr.shape[0], index.shape[0]
    sms = sm_count(dev.index)
    tb = None if axes is None else fec_gather_tiles(B, axes, sms)
    if tb is None and used % 4:
        raise ValueError(f"fec_gather: the indexed kernel stores 4 outputs "
                         f"at a time; used = {used} is not a multiple of 4")
    # the kernels load four indices and four sign bytes at a time, and
    # read rows of `llr` at its row stride
    if (not index.is_contiguous() or index.data_ptr() % 16
            or not scramble.is_contiguous() or scramble.data_ptr() % 4
            or llr.stride(1) != 1):
        raise ValueError("fec_gather: needs contiguous tables starting on "
                         "their own allocations and llr rows of unit stride")
    out = torch.empty(B, used, device=dev)
    if tb is None:
        launch("gf3x_fec_gather", dev.index, llr.data_ptr(),
               index.data_ptr(), scramble.data_ptr(), out.data_ptr(), B,
               llr.stride(0), used, fec_gather_chunk(B, used, sms))
    else:
        D, B2, A2 = axes
        launch("gf3x_fec_gather_tile", dev.index, llr.data_ptr(),
               scramble.data_ptr(), out.data_ptr(), B, llr.stride(0), used,
               D, B2, A2, tb, tile_pitch(D, tb))
    fec_gather.launches += 1
    return out


fec_gather.launches = 0
