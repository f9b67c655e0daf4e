"""The clock-offset route's δ-warped used-band DFT, computed as a chirp-z
transform (`ops.ofdm.czt_dft`), as CUDA kernels (`csrc/czt.cu`) with their
plain PyTorch versions. They replace no TPU kernel: gf3x's warped DFT is
XLA's dense matmul over cos/sin tables (gf3x/ops/ofdm.py), with no Pallas
kernel.

- `czt_fused`: the whole transform of each row in one block, where L is
  one of FUSED_LENGTHS (6144, 12 288, 24 576: gf3-4096, gf3-8192,
  gf3-16384) and the block's shared memory holds the row (`takes_fused`).
  CP-stripped real symbols (..., S, N) float32 at their own strides, the
  pre-chirp (N,), H in the kernel's digit-reversed order (`filter_table`)
  and the post-chirp (M,) → (rows, M) complex64. The plain version,
  `czt_fused_plain`, runs the kernel's factorisation (`fused_radices`) in
  float32 torch ops: a radix-3 stage, radix-2^b stages decimating in
  frequency with the twiddles of `twiddle_table`, the product with H in
  digit-reversed order, the inverse stages decimating in time.
- `czt_pre` and `czt_post`, at every other L: the pointwise passes around
  cuFFT. `czt_pre`: the symbols times the pre-chirp → (rows, L) complex64,
  zero past N: the padded rows the length-L FFT takes. `czt_post`: the
  inverse FFT's rows (rows, L) complex64, their first M entries times the
  post-chirp (M,) complex64 → (rows, M) complex64.

Each wrapper runs the plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises), and counts launches in `.launches`.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.device import SMEM_BLOCK, launch

__all__ = ["czt_pre", "czt_pre_plain", "czt_post", "czt_post_plain",
           "FUSED_LENGTHS", "fused_radices", "fused_smem_bytes",
           "takes_fused", "twiddle_table", "digit_reversed", "filter_table",
           "czt_fused", "czt_fused_plain"]


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


# the lengths czt_fused_kernel is built for: 3·2^a, a radix-3 stage and
# radix-2^b ones
FUSED_LENGTHS = (6144, 12288, 24576)


def fused_radices(L: int) -> tuple:
    """The fused kernel's forward stages, first to last: radix 3 over
    stride L/3, then one radix-2^b stage where log2(L/3) is not a multiple
    of 4, then radix 16 ((3, 8, 16, 16) at 6144, (3, 16, 16, 16) at
    12 288, (3, 2, 16, 16, 16) at 24 576); the inverse runs them in
    reverse."""
    a = (L // 3).bit_length() - 1
    if L != 3 << a or a < 4:
        raise ValueError(f"fused_radices: L {L} is not 3·2^a, a >= 4")
    b = a % 4
    return (3,) + ((1 << b,) if b else ()) + (16,) * (a // 4)


def fused_smem_bytes(L: int) -> int:
    """Dynamic shared memory of the fused kernel's block: the row, one pad
    slot after every 16 points, and the twiddle tables."""
    return 8 * (L + L // 16 + 64 + L // 64 + 256)


def takes_fused(L: int, N: int, M: int) -> bool:
    """Whether the chirp-z transform of FFT length L, N samples in and M
    bins out is the fused kernel: L is one it is built for, its block fits
    in shared memory, and the zero padding is at least the radix-3 stage's
    third input and the bins at most its first output (N ≤ 2L/3, M ≤ L/3:
    every band whose `czt_length` is 3·2^a); else the chain around
    cuFFT."""
    return (L in FUSED_LENGTHS and fused_smem_bytes(L) <= SMEM_BLOCK
            and 0 < 3 * N <= 2 * L and 0 < 3 * M <= L)


_TWIDDLES: dict = {}   # (L, device) → table


def _fine_slot(f: np.ndarray) -> np.ndarray:
    """Where the kernel keeps fine entry f: each run of 16 rotated by 3 per
    run (`fine_slot` in csrc/czt.cu)."""
    return (f & ~15) | ((f + 3 * (f >> 4)) & 15)


def twiddle_table(L: int, device) -> torch.Tensor:
    """(64 + L/64 + 256,) complex64, each entry rounded once from float64
    (ω_L = e^{−2πi/L}): ω_L^f for f < 64 at `_fine_slot(f)`, ω_L^{64c} for
    c < L/64, then ω_256^{kq} at 16·k + q for k, q < 16; ω_L^e =
    coarse[e >> 6]·fine[e & 63]. Cached per device."""
    key = (L, str(device))
    got = _TWIDDLES.get(key)
    if got is None:
        fine = np.empty(64, np.int64)
        fine[_fine_slot(np.arange(64))] = np.arange(64)
        kq = np.outer(np.arange(16), np.arange(16)).ravel()
        e = np.concatenate([fine, 64 * np.arange(L // 64), L // 256 * kq])
        got = torch.as_tensor(np.exp(-2j * np.pi * e / L).astype(
            np.complex64)).to(device)
        _TWIDDLES[key] = got
    return got


def _stage_twiddles(L: int, S: int, R: int, device) -> torch.Tensor:
    """(R, S/R) complex64: ω_S^{q·k} for k < R and q < S/R as the kernel
    forms it: at each power of two k from the tables (at S = 256 the
    ω_256 table, else ω_L^{e·k}, e = (L/S)·q, as coarse·fine), at any
    other k the product w[k − h]·w[h], h the highest power of two in k."""
    tab = twiddle_table(L, device)
    fine = tab[torch.as_tensor(_fine_slot(np.arange(64)), device=device)]
    q = torch.arange(S // R, device=device)
    w = [torch.ones_like(tab[:1].expand(S // R))]
    for k in range(1, R):
        h = 1 << (k.bit_length() - 1)
        if h != k:
            w.append(w[k - h] * w[h])
        elif S == 256:
            w.append(tab[64 + L // 64 + 16 * k + q])
        else:
            e = (L // S) * q * k
            w.append(tab[64 + (e >> 6)] * fine[e & 63])
    return torch.stack(w)


def digit_reversed(H: torch.Tensor) -> torch.Tensor:
    """H (L,) in the order the fused kernel's forward transform leaves the
    spectrum: position k1·L/r1 + k2·L/(r1·r2) + … holds bin
    k1 + r1·k2 + r1·r2·k3 + … for the radices r of `fused_radices`."""
    rad = fused_radices(H.shape[0])
    n = len(rad)
    return H.reshape(rad[::-1]).permute(tuple(reversed(range(n)))).reshape(-1)


_FILTER_INDEX: dict = {}   # (L, device) → int64 gather index


def filter_table(H: torch.Tensor) -> torch.Tensor:
    """H (L,) as the fused kernel reads it, one gather: `digit_reversed`,
    then each run of 512 (32 lanes' 16 points) as (8, 32) pairs, so that
    the pair 16g + 2k, 16g + 2k + 1 lies at pair 256·(g // 32) + 32·k +
    g % 32 and a warp's 16-byte loads of one k are contiguous."""
    L = H.shape[0]
    key = (L, str(H.device))
    idx = _FILTER_INDEX.get(key)
    if idx is None:
        rev = digit_reversed(torch.arange(L))
        idx = rev.view(L // 512, 32, 8, 2).transpose(1, 2).reshape(L)
        idx = _FILTER_INDEX[key] = idx.to(H.device)
    return H[idx]


def _digit_order(hf: torch.Tensor) -> torch.Tensor:
    """`filter_table`'s H back in `digit_reversed` order."""
    L = hf.shape[0]
    return hf.view(L // 512, 8, 32, 2).transpose(1, 2).reshape(L)


_STAGES: dict = {}   # (L, device) → per stage (R, span, DFT matrix, twiddles)


def _fused_stages(L: int, device) -> list:
    """The plain version's stages, first to last forward: (R, span S, the
    R-point DFT matrix ω_R^{jk} in complex64, the twiddles ω_S^{q·k}
    (R, S/R) as the kernel forms them (`_stage_twiddles`), or None at
    S = R)."""
    key = (L, str(device))
    got = _STAGES.get(key)
    if got is None:
        got, S = [], L
        for R in fused_radices(L):
            j = np.arange(R)
            W = torch.as_tensor(np.exp(-2j * np.pi * np.outer(j, j) / R)
                                .astype(np.complex64)).to(device)
            got.append((R, S, W, _stage_twiddles(L, S, R, device)
                        if S > R else None))
            S //= R
        _STAGES[key] = got
    return got


def czt_fused_plain(sym: torch.Tensor, pre: torch.Tensor, hf: torch.Tensor,
                    post: torch.Tensor) -> torch.Tensor:
    """sym (..., N) float32, pre (N,), hf (L,) (H in `filter_table`'s
    order) and post (M,) complex64 → (rows, M) complex64: the chirp-z
    transform in the fused kernel's factorisation. x·pre zero-padded to L;
    each forward stage of radix R and span S takes the R points q + j·S/R
    of every block of S through the R-point DFT and multiplies output k by
    ω_S^{qk} (`_stage_twiddles`), leaving the spectrum in digit-reversed
    order; times H in that order; each inverse stage, in reverse,
    multiplies by the conjugate twiddles and takes the unscaled inverse
    DFT; the first M outputs times post."""
    N, L, M = sym.shape[-1], hf.shape[0], post.shape[0]
    x = sym.reshape(-1, N)
    rows = x.shape[0]
    stages = _fused_stages(L, x.device)
    y = torch.zeros(rows, L, dtype=torch.complex64, device=x.device)
    y[:, :N] = x * pre
    for R, S, W, tw in stages:
        b = torch.einsum("nbjq,jk->nbkq", y.view(rows, L // S, R, S // R), W)
        y = (b if tw is None else b * tw).reshape(rows, L)
    y = y * _digit_order(hf)
    for R, S, W, tw in reversed(stages):
        v = y.view(rows, L // S, R, S // R)
        if tw is not None:
            v = v * tw.conj()
        y = torch.einsum("nbkq,kj->nbjq", v, W.conj()).reshape(rows, L)
    return y[:, :M] * post


def czt_fused(sym: torch.Tensor, pre: torch.Tensor, hf: torch.Tensor,
              post: torch.Tensor) -> torch.Tensor:
    """`czt_fused_plain` for CPU tensors; the fused CUDA kernel for CUDA
    ones. Takes sym (..., S, N) float32 with unit stride along N (any
    strides above), pre (N,), hf (L,) (H in `filter_table`'s order) and
    post (M,) complex64 contiguous, L one of FUSED_LENGTHS, N ≤ 2L/3 and
    M ≤ L/3 (`takes_fused`); refuses anything else."""
    L = hf.shape[0] if hf.dim() == 1 else -1
    if (sym.dtype != torch.float32 or pre.dtype != torch.complex64
            or hf.dtype != torch.complex64 or post.dtype != torch.complex64
            or sym.dim() < 1 or pre.shape != sym.shape[-1:]
            or post.dim() != 1
            or not takes_fused(L, sym.shape[-1], post.shape[0])):
        raise ValueError(
            f"czt_fused: needs sym (..., N) float32, pre (N,), hf (L,) and "
            f"post (M,) complex64 with L in {FUSED_LENGTHS}, N <= 2L/3 and "
            f"M <= L/3; got sym {tuple(sym.shape)} {sym.dtype}, pre "
            f"{tuple(pre.shape)} {pre.dtype}, hf {tuple(hf.shape)} "
            f"{hf.dtype}, post {tuple(post.shape)} {post.dtype}")
    if _on_cpu("czt_fused", sym, pre, hf, post):
        return czt_fused_plain(sym, pre, hf, post)
    N, M = sym.shape[-1], post.shape[0]
    x = sym.reshape(-1, *sym.shape[-2:]) if sym.dim() > 1 else sym[None, None]
    if (x.stride(2) != 1 or not pre.is_contiguous()
            or not hf.is_contiguous() or not post.is_contiguous()
            or hf.data_ptr() % 16):
        raise ValueError("czt_fused: needs symbol rows of unit stride, "
                         "contiguous tables and hf on 16 bytes")
    A, S = x.shape[0], x.shape[1]
    tw = twiddle_table(L, sym.device)
    out = torch.empty(A * S, M, dtype=torch.complex64, device=sym.device)
    if out.numel():
        launch("gf3x_czt_fused", sym.device.index, x.data_ptr(),
               pre.data_ptr(), hf.data_ptr(), post.data_ptr(), tw.data_ptr(),
               out.data_ptr(), A, S, x.stride(0), x.stride(1), N, L, M)
    czt_fused.launches += 1
    return out


czt_fused.launches = 0
