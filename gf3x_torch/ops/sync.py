"""Frame synchronization on torch tensors (counterpart of gf3x/ops/sync.py):
the FFT chirp matched filter and its overlap-save form for long
recordings, bounded and decimated onset search with first-arrival
refinement, the block-aligned frame cut alone (kernel 1, 6 or 7, by gf3x's
rule) or fused with the used-band DFT (kernel 8), the spectrum cut (a
window cut from the sync FFT by the shift theorem), and Schmidl–Cox timing
and metrics.

The correlation stays an FFT (`torch.fft`, cuFFT on the card); the TPU's
bf16 Toeplitz form is a TPU artefact. The cut follows `gather_cut`'s
semantics (window block q = clip(start // block, 0, nf + 8 − nb), roll
r = start − q·block, samples past the whole-block prefix read as zero), the
values the JAX CPU path computes; the TPU kernels' per-group span staging
and their 8 MiB staging budget have no counterpart because a GPU block
reads its own window directly."""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModemConfig
from ..utils.profiling import count
from .kernels import cut_dft as _cut_dft
from .kernels import gather_cut as _cut

__all__ = ["sync_nfft", "bounded_sync_nfft", "bounded_mf_shape",
           "rx_spectrum", "matched_filter_spec", "extract_windows_spec",
           "matched_filter", "streaming_matched_filter", "find_frame_start",
           "max_cut_start", "cut_plan", "fused_cut_refuses", "cut_symbols",
           "cut_dft_spectra", "sc_metric_window", "schmidl_cox_metric",
           "find_frame_start_sc", "sc_metric_at"]


def _next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(2, n))))


def sync_nfft(T: int, chirp_len: int) -> int:
    """Static FFT length for linear (non-circular) correlation."""
    return _next_pow2(T + chirp_len)


def bounded_sync_nfft(T: int, search_len: int, chirp_len: int,
                      decimate: int = 1) -> int:
    """Correlation FFT length of a bounded (optionally decimated) search on
    a length-T recording: only lags < search_len are read, so
    next_pow2(max(len(seg), n_lags + len(chirp))) is wraparound-free."""
    seg_len, n_lags = bounded_mf_shape(T, search_len, chirp_len, decimate)
    c_len = -(-chirp_len // decimate)
    return _next_pow2(max(seg_len, n_lags + c_len))


def bounded_mf_shape(T: int, search_len: int, chirp_len: int,
                     decimate: int = 2) -> tuple[int, int]:
    """(seg_len, n_lags) of the bounded matched filter
    `find_frame_start(search_len=..., decimate=...)` runs on (..., T)."""
    S = min(search_len, T)
    seg_len = -(-min(S + chirp_len, T) // decimate)
    return seg_len, min(S // decimate, seg_len)


def _chirp_spectrum(chirp, nfft: int, device) -> torch.Tensor:
    """conj(rfft(chirp, nfft)) in float64, rounded to complex64."""
    c = torch.as_tensor(chirp, dtype=torch.float64, device=device)
    return torch.conj(torch.fft.rfft(c, nfft)).to(torch.complex64)


def rx_spectrum(rx: torch.Tensor, nfft: int) -> torch.Tensor:
    """rfft of the recording at the sync FFT length: (..., T) →
    (..., nfft // 2 + 1) complex64, computed once and shared by the
    matched filter (`matched_filter_spec`) and the window cut
    (`extract_windows_spec`)."""
    return torch.fft.rfft(rx, nfft, dim=-1)


def matched_filter_spec(R: torch.Tensor, chirp, T: int, nfft: int
                        ) -> torch.Tensor:
    """The matched filter from a precomputed R = rx_spectrum(rx, nfft):
    (..., T) float32, `matched_filter`'s output at that length."""
    M = torch.fft.irfft(R * _chirp_spectrum(chirp, nfft, R.device), nfft,
                        dim=-1)
    return M[..., :T]


def extract_windows_spec(R: torch.Tensor, starts: torch.Tensor, need: int,
                         nfft: int) -> torch.Tensor:
    """rx[start : start + need] per row, cut from R = rx_spectrum(rx, nfft)
    by the shift theorem: rolling rx left by `start` multiplies bin k by
    e^{+2πik·start/nfft}, then one irfft. R (..., nfft // 2 + 1), starts
    (...,) int → (..., need) float32; samples at or past the recording's end
    read as the zero padding.

    start·k is reduced mod nfft in integers before any float: it reaches
    2⁴⁴ on minute-long recordings, where float32 would corrupt the phase by
    ~0.7 rad. nfft is a power of two, so the mod is a mask."""
    if nfft & (nfft - 1):
        raise ValueError(f"extract_windows_spec: nfft {nfft} is not a power "
                         "of two")
    k = torch.arange(R.shape[-1], dtype=torch.int64, device=R.device)
    s = torch.as_tensor(starts, device=R.device).to(torch.int64)[..., None]
    m = (s * k) & (nfft - 1)                      # (start·k) mod nfft, exact
    ang = np.float32(2.0 * np.pi / nfft) * m.to(torch.float32)
    rolled = torch.fft.irfft(R * torch.complex(torch.cos(ang),
                                               torch.sin(ang)), nfft, dim=-1)
    return rolled[..., :need]


def matched_filter(rx: torch.Tensor, chirp, nfft: int | None = None
                   ) -> torch.Tensor:
    """m[n] = Σ_i rx[n+i]·c[i] by FFT cross-correlation: (..., T) → (..., T).
    The default length is linear at every lag; a smaller `nfft` (≥ T) is
    exact only for lags n ≤ nfft − len(chirp)."""
    T = rx.shape[-1]
    if nfft is None:
        nfft = sync_nfft(T, len(chirp))
    R = torch.fft.rfft(rx, nfft, dim=-1)
    M = torch.fft.irfft(R * _chirp_spectrum(chirp, nfft, rx.device), nfft,
                        dim=-1)
    return M[..., :T]


def streaming_matched_filter(rx: torch.Tensor, chirp,
                             chunk: int = 1 << 15) -> torch.Tensor:
    """Overlap-save matched filter for unbounded recordings: the values of
    `matched_filter` (up to FFT rounding) computed chunk by chunk, so the
    FFT workspace is O(chunk + len(chirp)) instead of one next-pow2(T)
    transform. rx (..., T) → (..., T)."""
    *lead, T = rx.shape
    L = len(chirp)
    n_chunks = -(-T // chunk)
    F = _next_pow2(chunk + L)
    c_f = _chirp_spectrum(chirp, F, rx.device)
    rx_pad = torch.nn.functional.pad(rx, (0, n_chunks * chunk + L - T))
    out = torch.empty(*lead, n_chunks * chunk, dtype=rx.dtype,
                      device=rx.device)
    for i in range(n_chunks):
        seg = rx_pad[..., i * chunk: i * chunk + chunk + L]
        m = torch.fft.irfft(torch.fft.rfft(seg, F, dim=-1) * c_f, F, dim=-1)
        out[..., i * chunk: (i + 1) * chunk] = m[..., :chunk]
    return out[..., :T]


def _first_arrival(mabs: torch.Tensor, peak: torch.Tensor,
                   peak_val: torch.Tensor, back: int) -> torch.Tensor:
    """Earliest tap within 6 dB of the peak in the `back`-wide window before
    it (the strongest tap can be a reflection): one masked argmax, which
    returns the first True."""
    idx = torch.arange(mabs.shape[-1], device=mabs.device)
    p = peak[..., None]
    valid = ((mabs >= 0.5 * peak_val[..., None])
             & (idx >= p - back) & (idx <= p))
    return torch.argmax(valid.to(torch.int32), dim=-1).to(torch.int32)


def find_frame_start(cfg: ModemConfig, rx: torch.Tensor, chirp,
                     search_len: int | None = None, decimate: int = 1):
    """Chirp sync: (..., T) recording → (start (...,) int32, metric (...,)
    f32) — argmax |m|, first-arrival refinement, peak over mean |m|.

    `search_len` bounds the onset to [0, search_len): the correlation runs
    on the prefix rx[:search_len + len(chirp)] with a small FFT. `decimate`
    (only with search_len) correlates every decimate-th sample; the timing
    granularity becomes `decimate` samples, inside the CP backoff."""
    chirp = torch.as_tensor(chirp, dtype=torch.float64)
    T = rx.shape[-1]
    back = cfg.cp
    if search_len is not None:
        seg = rx[..., : min(min(search_len, T) + len(chirp), T)]
        F = bounded_sync_nfft(T, search_len, len(chirp), decimate)
        _, n_lags = bounded_mf_shape(T, search_len, len(chirp), decimate)
        seg, chirp = seg[..., ::decimate], chirp[::decimate]
        back = cfg.cp // decimate
        mabs = torch.abs(matched_filter(seg, chirp, nfft=F))[..., :n_lags]
    else:
        decimate = 1
        mabs = torch.abs(matched_filter(rx, chirp))
    peak_val, peak = torch.max(mabs, dim=-1)
    start = _first_arrival(mabs, peak, peak_val, back)
    metric = peak_val / (torch.mean(mabs, dim=-1) + 1e-12)
    return (decimate * start).to(torch.int32), metric


def max_cut_start(T: int, need: int, block: int = 128) -> int:
    """Largest window start whose `need` samples the cut returns verbatim:
    it reads whole blocks of the recording prefix, so the last partial
    block reads as zeros."""
    return max((T // block) * block - need, 0)


def cut_plan(T: int, starts: torch.Tensor, *, S: int, n_fft: int,
             sym_len: int, sc_off: int, body_off: int, block: int = 128):
    """The cut's per-row geometry on a length-T recording: (q (B,) int32
    window block, valid — samples of each row the cut may read, the rest
    read as zero —, roll (B,) int32). q = clip(start // block, 0,
    nf + 8 − nb) and roll = start − q·block clipped to [0, block), as
    gf3x's `gather_cut` computes them."""
    nb = _cut.group_blocks(block, S, n_fft, body_off, sym_len, sc_off)
    nf = T // block
    s = starts.to(torch.int32).reshape(-1)
    if nf + 8 - nb < 0:
        # recording shorter than one window: cut at block 0, reading the
        # whole recording zero-extended (degenerate input)
        return torch.zeros_like(s), T, torch.clamp(s, 0, block - 1)
    q = torch.clamp(torch.div(s, block, rounding_mode="floor"), 0,
                    nf + 8 - nb)
    return q, nf * block, torch.clamp(s - q * block, 0, block - 1)


def fused_cut_refuses(T: int, *, S: int, n_fft: int, sym_len: int, cp: int,
                      body_off: int, sc_off: int, block: int) -> bool:
    """Whether gf3x's fused cut kernels (`cut_symbols_tpu`, `cut_dft_tpu`)
    refuse this geometry (gf3x/ops/sync.py:_cut_plan and its callers'
    tests, :388-389, :527): an extraction offset — `block`, `body_off`,
    `cp`, `sym_len`, or `sc_off` when ≥ 0 — not a multiple of 128 (Mosaic
    lane alignment), or a window of more blocks than the recording's
    whole-block prefix holds."""
    nb = _cut.group_blocks(block, S, n_fft, body_off, sym_len, sc_off)
    aligned = all(v % 128 == 0 for v in (block, body_off, cp, sym_len)) and (
        sc_off < 0 or sc_off % 128 == 0)
    return not aligned or nb > T // block


def cut_symbols(rx: torch.Tensor, starts: torch.Tensor, *, S: int,
                n_fft: int, sym_len: int, cp: int, body_off: int,
                sc_off: int, block: int = 128):
    """Fused frame cut + CP strip: (syms (..., S, n_fft), scw (..., n_fft)
    or None, roll (...,) int32). Symbol s of row i is
    rx[i, q·block + body_off + s·sym_len + cp :][:n_fft] (`cut_plan`), scw
    the n_fft window at q·block + sc_off (None when sc_off < 0).

    Three routes, gf3x's (gf3x/ops/sync.py:329-348, 388-402), all with the
    same values:

    - a batch that is not whole 8-row groups (`Modem.decode` of one
      recording): kernel 7 (`ops.kernels.gather_cut.gather_cut`) cuts the
      windows and the symbols are sliced out of them;
    - whole 8-row groups with a 128-sample block on a geometry the fused
      cut refuses (`fused_cut_refuses`; CP = N/4 at N = 2048): kernel 6
      (`gather_cut_group`) cuts gf3x's 8-block-rounded windows, then the
      same slice;
    - otherwise (tiny-CP blocks under 128 included): kernel 1
      (`ops.kernels.gather_cut.cut_symbols`), the fused cut.

    While tracing is on, the rows each route cut are counted from the
    shapes: `cut.window_rows` (kernel 7), `cut.group_rows` (kernel 6),
    `cut.fused_rows` (kernel 1)."""
    *lead, T = rx.shape
    starts = torch.broadcast_to(starts.to(rx.device), tuple(lead))
    q, valid, r = cut_plan(T, starts, S=S, n_fft=n_fft, sym_len=sym_len,
                           sc_off=sc_off, body_off=body_off, block=block)
    rx2, q = rx.reshape(-1, T).contiguous(), q.contiguous()
    geo = dict(S=S, n_fft=n_fft, body_off=body_off, sym_len=sym_len,
               sc_off=sc_off)
    if rx2.shape[0] % 8:
        count("cut.window_rows", rx2.shape[0])
        win = _cut.gather_cut(rx2, q, _cut.window_blocks(block, **geo),
                              block, valid)
        syms, scw = _cut.window_symbols(win, cp=cp, **geo)
    elif block % 128 == 0 and fused_cut_refuses(T, cp=cp, block=block,
                                                **geo):
        count("cut.group_rows", rx2.shape[0])
        win = _cut.gather_cut_group(rx2, q, _cut.group_blocks(block, **geo),
                                    block)
        syms, scw = _cut.window_symbols(win, cp=cp, **geo)
    else:
        count("cut.fused_rows", rx2.shape[0])
        syms, scw = _cut.cut_symbols(rx2, q, valid=valid, block=block,
                                     cp=cp, **geo)
    syms = syms.reshape(*lead, S, n_fft)
    scw = scw.reshape(*lead, n_fft) if scw is not None else None
    return syms, scw, r.reshape(tuple(lead))


def cut_dft_spectra(cfg: ModemConfig, rx: torch.Tensor, starts: torch.Tensor,
                    *, S: int, body_off: int, sc_off: int, block: int = 128):
    """Fused `cut_symbols` + used-band DFT + deroll: (Y (..., S, n_used)
    complex64, already derolled, scw (..., n_fft) or None). The same cut
    geometry as `cut_symbols` (`cut_plan`); Y equals
    deroll(ofdm_dft(syms), roll) of that cut. Runs kernel 8 on the card
    (`ops.kernels.cut_dft.cut_dft`): the symbol matrix never reaches device
    memory."""
    *lead, T = rx.shape
    starts = torch.broadcast_to(starts.to(rx.device), tuple(lead))
    q, valid, r = cut_plan(T, starts, S=S, n_fft=cfg.n_fft,
                           sym_len=cfg.symbol_len, sc_off=sc_off,
                           body_off=body_off, block=block)
    Y, scw = _cut_dft.cut_dft(
        cfg, rx.reshape(-1, T).contiguous(), q.contiguous(), r.contiguous(),
        valid=valid, block=block, S=S, body_off=body_off, sc_off=sc_off)
    Y = Y.reshape(*lead, S, cfg.n_used)
    scw = scw.reshape(*lead, cfg.n_fft) if scw is not None else None
    return Y, scw


def sc_metric_window(cfg: ModemConfig, win: torch.Tensor) -> torch.Tensor:
    """SC metric M = P²/R² of one n_fft window over its two halves, on
    guarded sub-windows (half//4 samples skipped at each end) so ±half//4
    samples of misplacement keep the half-periodicity: win (..., n_fft) →
    (...,), ≈1 on the repeated-half SC symbol."""
    half = cfg.n_fft // 2
    guard = half // 4
    L = half - 2 * guard
    h1 = win[..., guard: guard + L]
    h2 = win[..., guard + half: guard + half + L]
    P = torch.sum(h1 * h2, dim=-1)
    Rw = torch.sum(h2 * h2, dim=-1)
    tot = torch.sum(h1 * h1, dim=-1) + Rw
    Rw = torch.maximum(Rw, 0.05 * tot + 1e-24)
    return (P * P) / (Rw * Rw)


#: Above this length the window sums of the SC metric come from a
#: correlation with a ones kernel instead of float32 prefix sums, which
#: cancel catastrophically once they grow to the whole recording's energy.
_SC_CUMSUM_MAX = 1 << 20


def schmidl_cox_metric(cfg: ModemConfig, rx: torch.Tensor) -> torch.Tensor:
    """M(d) = P(d)²/R(d)² over the half-symbol lag: P(d) = Σ_{m<N/2}
    r[d+m]·r[d+m+N/2], R(d) = Σ r[d+m+N/2]². rx (..., T) → (..., T − n_fft)
    float32. Window sums from prefix sums up to `_SC_CUMSUM_MAX` samples,
    from the FFT correlation with a ones kernel beyond; R is floored at 5 %
    of its maximum so near-silent windows do not spike to M ≈ 1."""
    half = cfg.n_fft // 2
    prod = rx[..., :-half] * rx[..., half:]
    energy = rx[..., half:] ** 2
    n = rx.shape[-1] - cfg.n_fft
    if rx.shape[-1] <= _SC_CUMSUM_MAX:
        zero = torch.zeros(*rx.shape[:-1], 1, dtype=rx.dtype,
                           device=rx.device)
        cs_p = torch.cat([zero, torch.cumsum(prod, dim=-1)], dim=-1)
        cs_r = torch.cat([zero, torch.cumsum(energy, dim=-1)], dim=-1)
        P = cs_p[..., half: half + n] - cs_p[..., :n]
        R = cs_r[..., half: half + n] - cs_r[..., :n]
    else:
        ones = np.ones(half, dtype=np.float32)
        P = matched_filter(prod, ones)[..., :n]
        R = torch.clamp(matched_filter(energy, ones)[..., :n], min=0.0)
    R = torch.maximum(R, 0.05 * torch.amax(R, dim=-1, keepdim=True) + 1e-24)
    return (P * P) / (R * R)


def find_frame_start_sc(cfg: ModemConfig, rx: torch.Tensor):
    """Schmidl–Cox timing, the fallback when the chirp is unusable: the
    repeated-half SC symbol makes an M ≈ 1 plateau of about a CP's width;
    its centre is the centre of mass of M⁴ in a (2·cp+1)-wide window at the
    argmax, then backed off to the chirp onset (cp/8 early: plateau smear
    under multipath and clock offset pushes the centre late). rx (..., T) →
    (start (...,) int32, peak M (...,) f32)."""
    if not cfg.use_schmidl_cox:
        raise ValueError("SC sync needs use_schmidl_cox=True: this config "
                         "transmits no repeated-half symbol to lock onto")
    M = schmidl_cox_metric(cfg, rx)
    peak = torch.argmax(M, dim=-1)
    peak_val = torch.gather(M, -1, peak[..., None])[..., 0]
    W = 2 * cfg.cp + 1
    flat = M.reshape(-1, M.shape[-1])
    base = torch.clamp(peak.reshape(-1) - cfg.cp, min=0)
    # the window is read from the clamped start as jax's dynamic_slice does
    # when it would run past the end, while the centre adds to the
    # unclamped base (the reference's arithmetic, kept for parity)
    lo = torch.clamp(base, max=max(flat.shape[-1] - W, 0))
    win = torch.gather(flat, 1, lo[:, None]
                       + torch.arange(W, device=rx.device))
    w = win ** 4
    idx = torch.arange(W, dtype=torch.float32, device=rx.device)
    com = torch.sum(w * idx, dim=-1) / torch.clamp(torch.sum(w, dim=-1),
                                                   min=1e-12)
    center = (base + com.to(torch.int32)).reshape(peak.shape)
    start = center + cfg.cp // 2 - cfg.cp - cfg.chirp_len - cfg.cp // 8
    return torch.clamp(start, min=0).to(torch.int32), peak_val


def sc_metric_at(cfg: ModemConfig, rx: torch.Tensor, d: torch.Tensor,
                 R: torch.Tensor | None = None,
                 nfft: int | None = None) -> torch.Tensor:
    """SC metric at one window start per row (clipped into the recording):
    rx (..., T), d (...,) int → (...,) f32, ≈ 1 where the repeated-half SC
    symbol sits at d. Touches only the n_fft samples there: gathered from
    rx, or, given R = rx_spectrum(rx, nfft), cut from that sync spectrum
    (`extract_windows_spec`)."""
    T = rx.shape[-1]
    d = torch.broadcast_to(torch.as_tensor(d, device=rx.device),
                           rx.shape[:-1])
    d = torch.clamp(d.to(torch.int64), 0, max(T - cfg.n_fft, 0))
    if R is not None:
        return sc_metric_window(cfg, extract_windows_spec(R, d, cfg.n_fft,
                                                          nfft))
    cols = d.reshape(-1)[:, None] + torch.arange(cfg.n_fft, device=rx.device)
    win = torch.gather(rx.reshape(-1, T), 1, cols)
    return sc_metric_window(cfg, win.reshape(*rx.shape[:-1], cfg.n_fft))
