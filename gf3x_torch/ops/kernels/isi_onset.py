"""The ISI profile's onset search (`csrc/isi_onset.cu`) with its plain
PyTorch version: from each frame's band-limited impulse response h (B, n)
complex64 (Ĥ under a Hann taper through an n-point inverse DFT, a sample
every D taps) and gf3x's anchor ŝ − t0, the tap the ISI profile moves to
tap 0 (`ops/chanest.py` `isi_anchor` says why). It replaces no TPU kernel:
gf3x anchors at ŝ − t0 alone.

e = |h|² (re·re + im·im); P = max e at its first sample `at`; the onset is
the first sample from `span` before `at` up to `at` whose e clears
max(peak_share·P, noise_coef·noise_var), times D. Where the onset lies
before ŝ − t0 (modulo N), the anchor is the onset less g; elsewhere ŝ − t0.

The wrapper runs the plain version for CPU tensors and launches the kernel
(one block a frame) for CUDA tensors (or raises), and counts launches in
`.launches`."""

from __future__ import annotations

import numpy as np
import torch

from ...utils.device import launch

__all__ = ["isi_onset", "isi_onset_plain"]


def _wrap(x: torch.Tensor, N: int) -> torch.Tensor:
    return torch.remainder(x + N // 2, N) - N // 2


def isi_onset_plain(h: torch.Tensor, anchor: torch.Tensor,
                    noise_var: torch.Tensor, *, D: int, span: int, g: int,
                    N: int, peak_share: float, noise_coef: float
                    ) -> torch.Tensor:
    """h (B, n) complex64, anchor = ŝ − t0 and noise_var (B,) float32 →
    the anchor (B,) float32 (see the module doc)."""
    n = h.shape[-1]
    hr = torch.view_as_real(h)
    e = hr[..., 0] * hr[..., 0] + hr[..., 1] * hr[..., 1]
    peak, at = torch.max(e, dim=-1)
    thr = torch.maximum(np.float32(peak_share) * peak,
                        np.float32(noise_coef) * noise_var)
    offsets = torch.arange(-span, 1, device=h.device)
    hit = torch.gather(e, 1, torch.remainder(at[:, None] + offsets, n)
                       ) >= thr[:, None]
    found, first = torch.max(hit, dim=-1)
    onset = (at - span + first) * D
    a0 = anchor.to(torch.int64)
    move = found & (_wrap(onset - a0, N) < 0)
    return torch.where(move, _wrap(onset - g, N), a0).to(torch.float32)


def isi_onset(h: torch.Tensor, anchor: torch.Tensor, noise_var: torch.Tensor,
              *, D: int, span: int, g: int, N: int, peak_share: float,
              noise_coef: float) -> torch.Tensor:
    """`isi_onset_plain` for CPU tensors; the kernel for CUDA ones. Takes
    h (B, n) complex64 and anchor, noise_var (B,) float32 on one device,
    0 ≤ span < n, and refuses anything else."""
    B, n = h.shape
    if (h.dtype != torch.complex64 or anchor.shape != (B,)
            or noise_var.shape != (B,) or anchor.dtype != torch.float32
            or noise_var.dtype != torch.float32 or not 0 <= span < n):
        raise ValueError(f"isi_onset: needs h (B, n) complex64, anchor and "
                         f"noise_var (B,) float32, 0 <= span < n; got h "
                         f"{tuple(h.shape)} {h.dtype}, anchor "
                         f"{tuple(anchor.shape)} {anchor.dtype}, noise_var "
                         f"{tuple(noise_var.shape)} {noise_var.dtype}, "
                         f"span {span}")
    kw = dict(D=D, span=span, g=g, N=N, peak_share=peak_share,
              noise_coef=noise_coef)
    dev = h.device
    if dev.type == "cpu" and anchor.device == noise_var.device == dev:
        return isi_onset_plain(h, anchor, noise_var, **kw)
    if dev.type != "cuda" or anchor.device != dev or noise_var.device != dev:
        raise ValueError(f"isi_onset: h on {dev}, anchor on {anchor.device}"
                         f", noise_var on {noise_var.device}: all must be on "
                         "the CPU or on one CUDA device")
    h, anchor, noise_var = (t.contiguous() for t in (h, anchor, noise_var))
    out = torch.empty(B, device=dev)
    launch("gf3x_isi_onset", dev.index, h.data_ptr(), anchor.data_ptr(),
           noise_var.data_ptr(), out.data_ptr(), B, n, D, span, g, N,
           float(np.float32(peak_share)), float(np.float32(noise_coef)))
    isi_onset.launches += 1
    return out


isi_onset.launches = 0
