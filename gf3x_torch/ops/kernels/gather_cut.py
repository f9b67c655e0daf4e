"""The frame cut's three kernels, each with its plain PyTorch version:

- kernel 1, `cut_symbols`: fused frame cut + CP strip
  (`csrc/cut_symbols.cu`, replacing
  gf3x/ops/pallas/gather_cut.py:cut_symbols_tpu); plain version: the
  window cut + reshape/slice of gf3x/ops/sync.py:398-402;
- kernel 7, `gather_cut`: the block-aligned window cut alone
  (`csrc/gather_cut.cu`, replacing gf3x/ops/pallas/gather_cut.py:
  gather_cut_tpu), which gf3x's `cut_symbols` falls back to for a batch
  that is not a whole number of 8-row groups; plain version: one
  `torch.gather`;
- kernel 6, `gather_cut_group`: the same window cut over whole 8-row
  groups (`csrc/gather_cut_group.cu`, replacing gf3x/ops/pallas/
  gather_cut.py:gather_cut_group_tpu), which gf3x's `cut_symbols` takes
  for such a batch when the fused cut refuses the geometry; plain version:
  `gather_cut_plain` over the whole-block prefix.

Each wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); `<wrapper>.launches` counts the
launches."""

from __future__ import annotations

import torch

from ...utils.device import launch

__all__ = ["gather_cut", "gather_cut_plain", "gather_cut_group",
           "gather_cut_group_plain", "window_blocks", "group_blocks",
           "window_symbols", "cut_symbols", "cut_symbols_plain"]


def gather_cut_plain(rx: torch.Tensor, q: torch.Tensor, nb: int, block: int,
                     valid: int) -> torch.Tensor:
    """Per-row block-aligned window: (B, T) → (B, nb·block) with row i =
    rx[i, q[i]·block:][:nb·block], samples at or past `valid` read as 0."""
    cols = (q.to(torch.int64)[:, None] * block
            + torch.arange(nb * block, device=rx.device))
    got = torch.gather(rx, 1, cols.clamp(0, max(valid - 1, 0)))
    return torch.where(cols < valid, got, torch.zeros((), device=rx.device))


_F32, _I32 = torch.float32, torch.int32


def gather_cut(rx: torch.Tensor, q: torch.Tensor, nb: int, block: int,
               valid: int) -> torch.Tensor:
    """`gather_cut_plain` for a CPU tensor; the CUDA kernel otherwise.

    On one recording the kernel runs about 2 µs, so this call path is kept
    to the checks that guard the kernel, each tensor attribute read once:
    the decode of one recording pays it on every cut."""
    if not rx.is_cuda and rx.device.type == "cpu":
        return gather_cut_plain(rx, q, nb, block, valid)
    shape, dev = rx.shape, rx.get_device()
    if (not rx.is_cuda or len(shape) != 2 or q.shape != shape[:1]
            or q.get_device() != dev or rx.dtype is not _F32
            or q.dtype is not _I32 or not rx.is_contiguous()
            or not q.is_contiguous() or not 0 <= valid <= shape[1]):
        raise ValueError(f"gather_cut: needs contiguous rx (B, T) float32 "
                         f"and q (B,) int32 on one CUDA device and 0 <= valid "
                         f"<= T; got rx {tuple(shape)} {rx.dtype} on "
                         f"{rx.device}, q {tuple(q.shape)} {q.dtype} on "
                         f"{q.device}, valid={valid}")
    B, T = shape
    L = nb * block
    win = rx.new_empty(B, L)
    launch("gf3x_gather_cut", dev, rx.data_ptr(), q.data_ptr(),
           win.data_ptr(), B, T, valid, L, block)
    gather_cut.launches += 1
    return win


gather_cut.launches = 0


def gather_cut_group_plain(rx: torch.Tensor, q: torch.Tensor, nb: int,
                           block: int) -> torch.Tensor:
    """`gather_cut_plain` with `valid` the whole-block prefix
    floor(T/block)·block, the values of `gather_cut_group_tpu`: (B, T) →
    (B, nb·block), row i = rx[i, q[i]·block:][:nb·block], zeros past the
    prefix."""
    return gather_cut_plain(rx, q, nb, block, (rx.shape[-1] // block) * block)


def gather_cut_group(rx: torch.Tensor, q: torch.Tensor, nb: int,
                     block: int) -> torch.Tensor:
    """`gather_cut_group_plain` for a CPU tensor; the CUDA kernel
    otherwise. The batch must be whole 8-row groups."""
    if rx.dim() != 2 or rx.shape[0] % 8:
        raise ValueError(f"gather_cut_group: needs rx (B, T) with B % 8 == 0,"
                         f" got {tuple(rx.shape)}")
    if rx.device.type == "cpu":
        return gather_cut_group_plain(rx, q, nb, block)
    if rx.device.type != "cuda" or q.device != rx.device:
        raise ValueError(f"gather_cut_group: rx on {rx.device}, q on "
                         f"{q.device}; both must be on one CUDA device")
    if (rx.dtype != torch.float32 or q.dtype != torch.int32
            or q.shape != rx.shape[:1] or not rx.is_contiguous()
            or not q.is_contiguous()):
        raise ValueError("gather_cut_group: needs contiguous rx (B, T) "
                         "float32 and q (B,) int32")
    B, T = rx.shape
    L = nb * block
    win = torch.empty(B, L, device=rx.device)
    launch("gf3x_gather_cut_group", rx.device.index, rx.data_ptr(),
           q.data_ptr(), win.data_ptr(), B, T, (T // block) * block, L, block)
    gather_cut_group.launches += 1
    return win


gather_cut_group.launches = 0


def window_symbols(win: torch.Tensor, *, S: int, n_fft: int, body_off: int,
                   sym_len: int, cp: int, sc_off: int):
    """Cut windows (B, ≥ need) → (syms (B, S, n_fft) view, scw (B, n_fft)
    view or None): symbol s at body_off + s·sym_len + cp, scw at sc_off."""
    body = win[:, body_off: body_off + S * sym_len]
    syms = body.reshape(-1, S, sym_len)[..., cp: cp + n_fft]
    scw = win[:, sc_off: sc_off + n_fft] if sc_off >= 0 else None
    return syms, scw


def window_blocks(block: int, S: int, n_fft: int, body_off: int,
                  sym_len: int, sc_off: int) -> int:
    """Blocks of the window the cut needs: the S symbols and the SC
    window."""
    need = max(body_off + S * sym_len, sc_off + n_fft if sc_off >= 0 else 0)
    return -(-need // block)


def group_blocks(block: int, S: int, n_fft: int, body_off: int,
                 sym_len: int, sc_off: int) -> int:
    """gf3x's `gather_cut` window in blocks (gf3x/ops/sync.py:307-308): the
    cut's need plus a block of roll slack, rounded up to whole 8-block
    tiles. Kernel 6's output width and the `nb` of the cut's q clip."""
    nb = window_blocks(block, S, n_fft, body_off, sym_len, sc_off) + 1
    return -(-nb // 8) * 8


def cut_symbols_plain(rx: torch.Tensor, q: torch.Tensor, *, valid: int,
                      block: int, S: int, n_fft: int, body_off: int,
                      sym_len: int, cp: int, sc_off: int):
    """rx (B, T) f32, q (B,) int32 window block of each row → (syms
    (B, S, n_fft), scw (B, n_fft) or None): symbol s of row i is
    rx[i, q·block + body_off + s·sym_len + cp :][:n_fft] and scw the n_fft
    window at q·block + sc_off (None when sc_off < 0)."""
    nb = window_blocks(block, S, n_fft, body_off, sym_len, sc_off)
    return window_symbols(gather_cut_plain(rx, q, nb, block, valid), S=S,
                          n_fft=n_fft, body_off=body_off, sym_len=sym_len,
                          cp=cp, sc_off=sc_off)


def cut_symbols(rx: torch.Tensor, q: torch.Tensor, *, valid: int,
                block: int, S: int, n_fft: int, body_off: int, sym_len: int,
                cp: int, sc_off: int):
    """`cut_symbols_plain` for a CPU tensor; the CUDA kernel otherwise."""
    kw = dict(valid=valid, block=block, S=S, n_fft=n_fft, body_off=body_off,
              sym_len=sym_len, cp=cp, sc_off=sc_off)
    if rx.device.type == "cpu":
        return cut_symbols_plain(rx, q, **kw)
    if rx.device.type != "cuda" or q.device != rx.device:
        raise ValueError(f"cut_symbols: rx on {rx.device}, q on {q.device}; "
                         "both must be on one CUDA device")
    if (rx.dtype != torch.float32 or q.dtype != torch.int32 or rx.dim() != 2
            or q.shape != rx.shape[:1] or not rx.is_contiguous()
            or not q.is_contiguous()):
        raise ValueError("cut_symbols: needs contiguous rx (B, T) float32 "
                         "and q (B,) int32")
    B, T = rx.shape
    if not 0 <= valid <= T:
        raise ValueError(f"cut_symbols: valid={valid} outside [0, {T}]")
    syms = torch.empty(B, S, n_fft, device=rx.device)
    scw = torch.empty(B, n_fft if sc_off >= 0 else 0, device=rx.device)
    launch("gf3x_cut_symbols", rx.device.index, rx.data_ptr(), q.data_ptr(),
           syms.data_ptr(), scw.data_ptr(), B, T, valid, block, S, n_fft,
           body_off, sym_len, cp, sc_off)
    cut_symbols.launches += 1
    return syms, (scw if sc_off >= 0 else None)


cut_symbols.launches = 0
