"""The chirp-z transform's two pointwise passes (`csrc/czt.cu`) with their
plain PyTorch versions. They wrap the clock-offset route's δ-warped
used-band DFT, computed as a chirp-z transform (`ops.ofdm.czt_dft`): the
pre-chirp pass before cuFFT's forward transform, the post-chirp pass after
its inverse. They replace no TPU kernel: gf3x's warped DFT is XLA's dense
matmul over cos/sin tables (gf3x/ops/ofdm.py), with no Pallas kernel.

- `czt_pre`: CP-stripped real symbols (..., S, N) float32, read at their
  own strides (the cut's view, row stride N + CP, with no copy), times the
  pre-chirp (N,) complex64 → (rows, L) complex64, zero past N: the padded
  rows the length-L FFT takes.
- `czt_post`: the inverse FFT's rows (rows, L) complex64, their first M
  entries times the post-chirp (M,) complex64 → (rows, M) complex64.

Each wrapper runs the plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises), and counts launches in `.launches`.
"""

from __future__ import annotations

import torch

from ...utils.device import launch

__all__ = ["czt_pre", "czt_pre_plain", "czt_post", "czt_post_plain"]


def czt_pre_plain(sym: torch.Tensor, pre: torch.Tensor,
                  L: int) -> torch.Tensor:
    """sym (..., N) float32, pre (N,) complex64 → (rows, L) complex64:
    sym·pre in the first N columns of each row, zeros after."""
    N = sym.shape[-1]
    x = sym.reshape(-1, N)
    out = torch.zeros(x.shape[0], L, dtype=torch.complex64, device=x.device)
    out[:, :N] = x * pre
    return out


def czt_post_plain(z: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
    """z (rows, L) complex64, post (M,) complex64 → (rows, M) complex64:
    the first M columns times post."""
    return z[:, : post.shape[0]] * post


def _on_cpu(name: str, *tensors) -> bool:
    """True where every tensor lies on the CPU (the plain version runs),
    False where all lie on one CUDA device (the kernel runs); raises
    otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) == 1:
        dev = devs.pop()
        if dev.type == "cpu":
            return True
        if dev.type == "cuda":
            return False
    raise ValueError(f"{name}: tensors on {sorted(map(str, devs))}: all must "
                     "be on the CPU or on one CUDA device")


def czt_pre(sym: torch.Tensor, pre: torch.Tensor, L: int) -> torch.Tensor:
    """`czt_pre_plain` for CPU tensors; a CUDA kernel for CUDA ones. Takes
    sym (..., S, N) float32 with unit stride along N (any strides above),
    pre (N,) complex64 contiguous and L ≥ N; refuses anything else."""
    if (sym.dtype != torch.float32 or pre.dtype != torch.complex64
            or sym.dim() < 1 or pre.shape != sym.shape[-1:]
            or L < sym.shape[-1]):
        raise ValueError(
            f"czt_pre: needs sym (..., N) float32, pre (N,) complex64 and "
            f"L >= N; got sym {tuple(sym.shape)} {sym.dtype}, pre "
            f"{tuple(pre.shape)} {pre.dtype}, L {L}")
    if _on_cpu("czt_pre", sym, pre):
        return czt_pre_plain(sym, pre, L)
    N = sym.shape[-1]
    x = sym.reshape(-1, *sym.shape[-2:]) if sym.dim() > 1 else sym[None, None]
    if x.stride(2) != 1 or not pre.is_contiguous():
        raise ValueError("czt_pre: needs symbol rows of unit stride and a "
                         "contiguous pre-chirp")
    A, S = x.shape[0], x.shape[1]
    out = torch.empty(A * S, L, dtype=torch.complex64, device=sym.device)
    if out.numel():
        launch("gf3x_czt_pre", sym.device.index, x.data_ptr(), pre.data_ptr(),
               out.data_ptr(), A, S, x.stride(0), x.stride(1), N, L)
    czt_pre.launches += 1
    return out


czt_pre.launches = 0


def czt_post(z: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
    """`czt_post_plain` for CPU tensors; a CUDA kernel for CUDA ones. Takes
    z (rows, L) complex64 contiguous and post (M,) complex64 contiguous
    with M ≤ L; refuses anything else."""
    if (z.dtype != torch.complex64 or post.dtype != torch.complex64
            or z.dim() != 2 or post.dim() != 1
            or post.shape[0] > z.shape[1]):
        raise ValueError(
            f"czt_post: needs z (rows, L) complex64 and post (M,) complex64 "
            f"with M <= L; got z {tuple(z.shape)} {z.dtype}, post "
            f"{tuple(post.shape)} {post.dtype}")
    if _on_cpu("czt_post", z, post):
        return czt_post_plain(z, post)
    if not z.is_contiguous() or not post.is_contiguous():
        raise ValueError("czt_post: needs contiguous rows and post-chirp")
    R, L = z.shape
    M = post.shape[0]
    out = torch.empty(R, M, dtype=torch.complex64, device=z.device)
    if out.numel():
        launch("gf3x_czt_post", z.device.index, z.data_ptr(), post.data_ptr(),
               out.data_ptr(), R, L, M)
    czt_post.launches += 1
    return out


czt_post.launches = 0
