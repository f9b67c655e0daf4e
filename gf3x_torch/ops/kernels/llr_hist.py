"""The diagnostics' |LLR| histogram (`csrc/llr_hist.cu`) with its plain
PyTorch version: scrambled wire-order LLRs (B, R) float32 and a sample
table (n,) of positions in [0, R) → 16 counts a row (B, 16) int32, bucket
k ⇔ |x| ∈ [2^(k−2), 2^(k−1)) read from the float's exponent field
(`hist16_of`, gf3x's `_hist16_of`): ±0 and denormals in 0, inf and NaN in
15. It replaces no TPU kernel: gf3x leaves the histogram to XLA.

The Modem's table is gf3x's every-8th coded-stream position, sorted
(`sample_table`): a count does not depend on the order of its samples,
and sorted, neighbouring threads read neighbouring floats.

On the card one kernel counts each row in registers and shared memory and
stores 16 counts a row — no global atomics per sample. Its bound is bytes:
4 a sample (at gf3-8192, B = 1024: 120 MB, 0.036 ms at 3.35 TB/s); the
sample set touches a quarter of each row's 32-byte sectors, four samples
in each, so the card moves about twice that. The grid is a block a row
where the rows fill the card, else each row split into equal chunks
(`llr_hist_chunk`), whose blocks add into a zeroed output.

The wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors (or raises), and counts launches in `.launches`."""

from __future__ import annotations

import torch

from ...utils.device import launch, sm_count

__all__ = ["llr_hist", "llr_hist_plain", "llr_hist_chunk", "hist16_of",
           "sample_table", "BINS"]

BINS = 16
STRIDE = 8          # every 8th coded-stream position is sampled
FILL_BLOCKS = 4     # blocks an SM should get: half the 8 resident at 256
MIN_CHUNK = 2048    # samples a block counts at least: 8 a thread


def hist16_of(x: torch.Tensor) -> torch.Tensor:
    """16-bin log2 bucket of each element: bucket k ⇔ |x| ∈
    [2^(k-2), 2^(k-1)), clipped to [0, 15] (zeros land in 0), read
    from the float exponent bits."""
    e = ((x.abs().view(torch.int32) >> 23) & 0xFF) - 125
    return torch.clamp(e, 0, 15)


def sample_table(fec_index: torch.Tensor) -> torch.Tensor:
    """The histogram's samples: `fec_index[::8]` (the wire positions of
    every 8th coded-stream bit), sorted, as int32."""
    return torch.sort(fec_index[::STRIDE]).values.to(torch.int32)


def llr_hist_plain(llr: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """llr (B, R), index (n,) into [0, R) → (B, 16) int32: the buckets of
    llr[:, index] counted row by row."""
    bkt = hist16_of(llr[:, index.long()]).long()
    hist = torch.zeros(llr.shape[0], BINS, dtype=torch.int32,
                       device=llr.device)
    hist.scatter_add_(1, bkt, torch.ones_like(bkt, dtype=torch.int32))
    return hist


def llr_hist_chunk(B: int, n: int, sms: int) -> int:
    """The samples of one row that one block counts: the whole row where
    B rows give `sms` SMs FILL_BLOCKS blocks each, else the row in as many
    equal chunks as do, of at least MIN_CHUNK samples."""
    per_row = min(-(-sms * FILL_BLOCKS // max(B, 1)), n // MIN_CHUNK)
    return -(-n // max(per_row, 1))


def llr_hist(llr: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """`llr_hist_plain` for CPU tensors; the kernel for CUDA ones. Takes
    llr (B, R) float32 with rows of unit stride and index (n,) int32, n ≥
    1, on one device, and refuses anything else; the kernel trusts the
    caller that every entry lies in [0, R) (the Modem checks its
    `fec_index`)."""
    if (llr.dtype != torch.float32 or llr.dim() != 2
            or index.dtype != torch.int32 or index.dim() != 1
            or index.shape[0] < 1):
        raise ValueError(f"llr_hist: needs llr (B, R) float32 and index "
                         f"(n,) int32, n >= 1; got llr {tuple(llr.shape)} "
                         f"{llr.dtype}, index {tuple(index.shape)} "
                         f"{index.dtype}")
    dev = llr.device
    if dev.type == "cpu" and index.device == dev:
        return llr_hist_plain(llr, index)
    if dev.type != "cuda" or index.device != dev:
        raise ValueError(f"llr_hist: llr on {dev}, index on {index.device}: "
                         "both must be on the CPU or on one CUDA device")
    if llr.stride(1) != 1 or not index.is_contiguous():
        raise ValueError("llr_hist: needs llr rows of unit stride and a "
                         "contiguous index")
    B, n = llr.shape[0], index.shape[0]
    chunk = llr_hist_chunk(B, n, sm_count(dev.index))
    hist = (torch.empty if chunk >= n else torch.zeros)(
        B, BINS, dtype=torch.int32, device=dev)
    launch("gf3x_llr_hist", dev.index, llr.data_ptr(), index.data_ptr(),
           hist.data_ptr(), B, llr.stride(0), n, chunk)
    llr_hist.launches += 1
    return hist


llr_hist.launches = 0
