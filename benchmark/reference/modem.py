"""The benchmark's plain reference of the GF3 modem: the transmitter that
makes every cell's frames, and the receive step the timed path is judged
against, in float64 (NumPy on the host for the transmitter, plain torch on
any device for the receiver).

It follows the receive semantics of the modem under test where they differ
from gf3x's golden model, because a comparison at float32 rounding needs the
same arithmetic on the same samples: the bounded, decimated chirp sync with
its first-arrival pick; the frame cut on a block grid with the roll undone
after the DFT (the window's samples, and so its noise, are the cut's); the
LS estimate with its tap denoise; one-tap EQ with the pilot-slope ladder and
the per-symbol noise floor; the max-log demap; the deinterleave and
descramble into codewords; layered normalised min-sum with a per-codeword
freeze; and, for the clock-offset route, the SC coarse estimate, a warped
demod whose pilot slopes give one batch-wide offset, and the final warped
demod. A bit-loaded band (a `bit_loading` table) maps and demaps each
bin at its own order (`loading.py`), its interleaver at R = Σ table. Every
table (chirp, known symbols, pilots, scrambler, interleaver, loading
groups, denoise projector, the code's edges and parity projector) is
rebuilt here from the configuration; nothing is taken from the program.

`Precision` sets the arithmetic: `F64` is the reference; `CONTROL` computes
in float32 and rounds the recording and every stage's output (spectra, Ĥ,
noise, equalised bins, LLRs) to TF32's 10-bit mantissa, the precision below
the float32 (TF32 off) the program computes in; its caller runs the
matrix products in TF32 where the device has it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .bits import bytes_to_bits, pack_header
from .codes import N_BLOCK_COLS, build_H_blocks, gf2_solve_parity
from .config import ModemConfig, layout
from .loading import axis_llr, gray_levels, gray_map, loaded_demap, \
    loaded_map, loading

__all__ = ["Precision", "F64", "CONTROL", "make_chirp", "info_bits",
           "encode_frames", "Receiver"]

_ALPHA = 0.8          # min-sum normalisation
_BIG = 1e30


class Precision(NamedTuple):
    real: torch.dtype
    cplx: torch.dtype
    round: Optional[Callable[[torch.Tensor], torch.Tensor]]


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to the nearest float32 with a 10-bit mantissa (TF32's),
    ties to even."""
    if t.is_complex():
        return torch.complex(_tf32(t.real), _tf32(t.imag))
    if not t.is_floating_point():
        return t
    i = t.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32).to(t.dtype)


F64 = Precision(torch.float64, torch.complex128, None)
CONTROL = Precision(torch.float32, torch.complex64, _tf32)


# ----------------------------------------------------------------- transmit

def make_chirp(cfg: ModemConfig) -> np.ndarray:
    """Linear chirp f0 → f1 over chirp_duration with raised-cosine fades."""
    n = cfg.chirp_len
    t = np.arange(n, dtype=np.float64) / cfg.fs
    T = n / cfg.fs
    phase = 2.0 * np.pi * (cfg.chirp_f0 * t
                           + 0.5 * (cfg.chirp_f1 - cfg.chirp_f0) * t * t / T)
    nf = max(1, int(round(cfg.chirp_fade * cfg.fs)))
    win = np.ones(n)
    ramp = 0.5 * (1 - np.cos(np.pi * np.arange(nf) / nf))
    win[:nf] = ramp
    win[-nf:] = ramp[::-1]
    return cfg.chirp_amplitude * np.sin(phase) * win


def interleave_bits(cfg: ModemConfig, arr, inverse: bool = False):
    """The channel-bit interleaver: an (R × D) symbol spread, then an
    (A2 × B2) bin scatter with B2 the divisor of R nearest √R."""
    *lead, _ = arr.shape
    R, D = cfg.bits_per_ofdm_symbol, cfg.n_data_symbols
    B2 = 1
    for d in range(2, R):
        if R % d == 0 and abs(d - R ** 0.5) < abs(B2 - R ** 0.5):
            B2 = d
    A2 = R // B2
    if not inverse:
        x = arr.reshape(*lead, A2, B2, D).swapaxes(-3, -2)
        return x.reshape(*lead, R, D).swapaxes(-2, -1).reshape(*lead, R * D)
    x = arr.reshape(*lead, D, R).swapaxes(-2, -1)
    x = x.reshape(*lead, B2, A2, D).swapaxes(-3, -2)
    return x.reshape(*lead, R * D)


def info_bits(cfg: ModemConfig, payload: bytes, filename: str) -> np.ndarray:
    """One frame's info bits: the GF3X header and payload, zero-padded to
    payload_bits_per_frame."""
    bits = bytes_to_bits(pack_header(payload, filename))
    cap = cfg.payload_bits_per_frame
    if bits.size > cap:
        raise ValueError(f"payload needs {bits.size} info bits; the frame "
                         f"carries {cap}")
    out = np.zeros(cap, dtype=np.uint8)
    out[: bits.size] = bits
    return out


def _ofdm_modulate(cfg: ModemConfig, bins: np.ndarray) -> np.ndarray:
    """(F, S, n_used) bins → (F, S·(N+CP)) samples."""
    lay = layout(cfg)
    spec = np.zeros(bins.shape[:-1] + (cfg.n_bins,), dtype=np.complex128)
    spec[..., lay.used_bins] = bins
    x = np.fft.irfft(spec, cfg.n_fft, axis=-1) * cfg.ofdm_scale
    x = np.concatenate([x[..., -cfg.cp:], x], axis=-1)
    return x.reshape(*bins.shape[:-2], -1)


def encode_frames(cfg: ModemConfig, info: np.ndarray) -> np.ndarray:
    """Info bits (F, payload_bits_per_frame) → waveforms (F, frame_len)
    float64: systematic LDPC [u | P·u], pad, scramble, interleave, Gray QAM
    (each bin at its loaded order on a loaded band) with pilots, known
    symbols, OFDM with CP, after the chirp and the SC symbol."""
    lay = layout(cfg)
    F = info.shape[0]
    if cfg.fec == "ldpc":
        u = info.reshape(F * cfg.n_codewords, cfg.ldpc_k).astype(np.float64)
        P = gf2_solve_parity(cfg.ldpc_z, cfg.ldpc_rate).astype(np.float64)
        p = np.remainder(u @ P.T, 2.0)        # exact: sums ≤ k ≪ 2⁵³
        coded = np.concatenate([u, p], axis=-1).astype(np.uint8)
        coded = coded.reshape(F, cfg.n_codewords * cfg.ldpc_n)
        coded = np.pad(coded, ((0, 0), (0, cfg.raw_bits_per_frame
                                        - coded.shape[1])))
    else:
        coded = info.astype(np.uint8)
    coded = coded ^ lay.scramble[None, :]
    if cfg.interleave:
        coded = interleave_bits(cfg, coded)
    if cfg.bit_loading is None:
        bps = cfg.bits_per_symbol
        dsym = gray_map(coded.reshape(F, cfg.n_data_symbols,
                                      cfg.n_data_bins, bps), bps)
    else:
        dsym = loaded_map(cfg, coded.reshape(F, cfg.n_data_symbols,
                                             cfg.bits_per_ofdm_symbol))
    data = np.zeros((F, cfg.n_data_symbols, cfg.n_used), np.complex128)
    data[..., lay.data_pos] = dsym
    data[..., lay.pilot_pos] = lay.pilot_vals
    known = np.broadcast_to(lay.known_syms.astype(np.complex128),
                            (F, cfg.n_known_symbols, cfg.n_used))
    body = _ofdm_modulate(cfg, np.concatenate([known, data], axis=1))
    parts = [np.broadcast_to(make_chirp(cfg), (F, cfg.chirp_len))]
    if cfg.use_schmidl_cox:
        sc = _ofdm_modulate(cfg, lay.sc_sym[None, None, :].astype(
            np.complex128))
        parts.append(np.broadcast_to(sc, (F, cfg.symbol_len)))
    wav = np.concatenate(parts + [body], axis=-1)
    assert wav.shape[-1] == cfg.frame_len
    return wav


def denoise_projection(cfg: ModemConfig) -> np.ndarray:
    """P = W (WᴴW)⁻¹ Wᴴ onto the channels of ≤ est_taps taps, W[k,t] =
    e^{−2πi·k·t/N} over the used band (complex128)."""
    k = np.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=np.float64)
    t = np.arange(cfg.est_taps, dtype=np.float64)
    W = np.exp(-2j * np.pi * np.outer(k, t) / cfg.n_fft)
    G = W.conj().T @ W + 1e-9 * np.eye(cfg.est_taps)
    return W @ np.linalg.solve(G, W.conj().T)


def _next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(2, n))))


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median of all elements, the mean of the two middle ones."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


# ------------------------------------------------------------------ receive

class Receiver:
    """The receive step on (n, T) recordings. `demodulate(rx)` and
    `demodulate_sfo(rx, rows)` return a dict of per-row outputs: bits
    (n, payload_bits) uint8, sync_start, sync_metric, H (n, U), noise_var,
    pilot_slope (n, D), common_phase (n, D), evm, mean_abs_llr, clock_ppm,
    fec_iters, fec_unsat."""

    def __init__(self, cfg: ModemConfig, max_delay: int, device,
                 precision: Precision = F64):
        self.cfg, self.max_delay = cfg, max_delay
        self.dev = torch.device(device)
        self.R, self.C = precision.real, precision.cplx
        self.q = precision.round or (lambda t: t)
        lay = layout(cfg)
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,  # noqa
                                          device=self.dev)
        self.chirp = t(make_chirp(cfg), self.R)
        self.known = t(lay.known_syms, self.C)
        self.pilots = t(lay.pilot_vals, self.C)
        self.ppos = t(lay.pilot_pos, torch.long)
        self.dpos = t(lay.data_pos, torch.long)
        self.loading = (loading(cfg) if cfg.bit_loading is not None
                        else None)
        self.kp = lay.pilot_pos.astype(np.float64)
        self.scramble = t(lay.scramble, torch.long)
        fec = np.arange(cfg.raw_bits_per_frame)
        self.fec_index = t(interleave_bits(cfg, fec, inverse=True)
                           if cfg.interleave else fec, torch.long)
        self.P = t(denoise_projection(cfg), self.C) if cfg.est_taps else None
        self.decimate = 2 if cfg.chirp_f1 * 4 <= cfg.fs * 0.95 else 1
        self.block = max(1, min(128, cfg.cp // 2))
        edges = (build_H_blocks(cfg.ldpc_z, cfg.ldpc_rate)
                 if cfg.fec == "ldpc" else [])
        self.rows = [[] for _ in range(max((i for i, _, _ in edges),
                                           default=-1) + 1)]
        for i, j, s in edges:
            self.rows[i].append((j, s))

    # ---- sync: bounded to the first max_delay samples, decimated
    def sync(self, rx: torch.Tensor):
        cfg, dec = self.cfg, self.decimate
        T, Lc = rx.shape[-1], self.chirp.numel()
        S = min(self.max_delay, T)
        seg_full = min(S + Lc, T)
        seg = rx[:, :seg_full][:, ::dec]
        c = self.chirp[::dec]
        n_lags = min(S // dec, seg.shape[-1])
        F = _next_pow2(max(seg.shape[-1], n_lags + c.numel()))
        m = torch.fft.irfft(torch.fft.rfft(seg, F) * torch.conj(
            torch.fft.rfft(c, F)), F)[:, :n_lags].abs()
        peak_val, peak = torch.max(m, dim=-1)
        idx = torch.arange(n_lags, device=rx.device)
        back = cfg.cp // dec
        valid = ((m >= 0.5 * peak_val[:, None])
                 & (idx >= peak[:, None] - back) & (idx <= peak[:, None]))
        start = torch.argmax(valid.to(torch.int32), dim=-1) * dec
        return start, peak_val / (torch.mean(m, dim=-1) + 1e-12)

    # ---- cut on the block grid: (symbols (n, S, N), SC window, roll)
    def cut(self, rx: torch.Tensor, start: torch.Tensor):
        cfg, blk = self.cfg, self.block
        T = rx.shape[-1]
        S = cfg.n_known_symbols + cfg.n_data_symbols
        cut_len = cfg.sc_len + S * cfg.symbol_len
        hi = min(max(T - cut_len, 0), max((T // blk) * blk - cut_len, 0))
        base = torch.clamp(start + cfg.chirp_len - cfg.cp // 4, 0, hi)
        sc_off = (cfg.cp + cfg.cp // 4 + blk // 2
                  if cfg.use_schmidl_cox else -1)
        need = max(cfg.sc_len + S * cfg.symbol_len,
                   sc_off + cfg.n_fft if sc_off >= 0 else 0)
        nb = -(-(-(-need // blk) + 1) // 8) * 8
        nf = T // blk
        q = torch.clamp(torch.div(base, blk, rounding_mode="floor"), 0,
                        max(nf + 8 - nb, 0))
        roll = torch.clamp(base - q * blk, 0, blk - 1)
        valid = nf * blk
        offs = (cfg.sc_len + cfg.cp
                + cfg.symbol_len * torch.arange(S, device=rx.device)[:, None]
                + torch.arange(cfg.n_fft, device=rx.device)[None, :])
        cols = q[:, None, None] * blk + offs[None]
        syms = torch.where(cols < valid, torch.gather(
            rx, 1, cols.clamp(max=T - 1).reshape(rx.shape[0], -1)
        ).reshape(cols.shape), torch.zeros((), dtype=rx.dtype,
                                           device=rx.device))
        scw = None
        if sc_off >= 0:
            c = q[:, None] * blk + sc_off + torch.arange(cfg.n_fft,
                                                        device=rx.device)
            scw = torch.where(c < valid, torch.gather(rx, 1, c.clamp(
                max=T - 1)), torch.zeros((), dtype=rx.dtype,
                                         device=rx.device))
        return syms, scw, roll

    # ---- used-band DFT (warped by δ when given), then the roll undone
    def spectra(self, syms, roll, delta=None):
        cfg = self.cfg
        if delta is None:
            Y = torch.fft.rfft(syms, cfg.n_fft)[..., cfg.bin_lo:
                                                cfg.bin_hi + 1]
        else:
            n = torch.arange(cfg.n_fft, dtype=self.R, device=self.dev)
            k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=self.R,
                             device=self.dev)
            th = (2.0 * np.pi / cfg.n_fft) * n[:, None] * k[None, :] * (
                1.0 + delta)
            Y = torch.complex(syms @ torch.cos(th), -(syms @ torch.sin(th)))
        Y = Y / cfg.ofdm_scale
        k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, device=self.dev)
        ang = (2.0 * np.pi / cfg.n_fft) * ((roll[:, None, None] * k)
                                           % cfg.n_fft).to(self.R)
        return self.q(Y * torch.polar(torch.ones_like(ang), ang))

    # ---- LS estimate on the K known symbols, the tap denoise
    def chanest(self, Y, delta=None):
        cfg = self.cfg
        X = Y[:, : cfg.n_known_symbols]
        if delta is not None:
            k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=self.R,
                             device=self.dev)[None, :]
            r = torch.arange(cfg.n_known_symbols, dtype=self.R,
                             device=self.dev)[:, None]
            ang = (-2.0 * np.pi / cfg.n_fft) * k * (delta * cfg.symbol_len
                                                     ) * r
            X = X * torch.polar(torch.ones_like(ang), ang)
        H = torch.mean(X / self.known, dim=-2)
        resid = X - H[:, None, :] * self.known
        nv = torch.mean(torch.abs(resid) ** 2, dim=(-2, -1))
        if self.P is not None:
            k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=self.R,
                             device=self.dev)
            a = torch.angle(torch.sum(H[:, 1:] * torch.conj(H[:, :-1]), -1))
            s = torch.round(-a * (cfg.n_fft / (2.0 * np.pi)))
            ang = (2.0 * np.pi / cfg.n_fft) * k * (
                s - cfg.est_taps // 4)[:, None]
            ramp = torch.polar(torch.ones_like(ang), ang)
            H = ((H * ramp) @ self.P.T) * torch.conj(ramp)
        return self.q(H), self.q(nv)

    # ---- one-tap EQ, pilot-slope ladder, noise floor, max-log demap (per
    #      group on a loaded band)
    def tail(self, Y, H, nv):
        cfg = self.cfg
        eq = Y[:, cfg.n_known_symbols:] / H[:, None, :]
        Pn = cfg.n_pilots
        B, D = eq.shape[:2]
        zero = torch.zeros(B, D, dtype=self.R, device=self.dev)
        slope, cpe = zero, zero
        csi = torch.abs(H) ** 2
        if Pn >= 2:
            z = eq[..., self.ppos] * torch.conj(self.pilots)
            z = z * csi[:, None, self.ppos]
            kp = self.kp
            inc = z[..., 1:] * torch.conj(z[..., :-1])
            a = torch.angle(torch.sum(inc, dim=-1)) / float(
                np.mean(np.diff(kp)))
            k = torch.as_tensor(kp, dtype=self.R, device=self.dev)
            rot = lambda x, ph: x * torch.polar(torch.ones_like(ph), -ph)  # noqa
            for Q in sorted({max(2, Pn // 8), Pn // 2}):
                if not 1 <= Q < Pn:
                    continue
                zd = rot(z, a[..., None] * k)
                corr = torch.sum(zd[..., Q:] * torch.conj(zd[..., :-Q]), -1)
                a = a + torch.angle(corr) / float(np.mean(kp[Q:] - kp[:-Q]))
            b = torch.angle(torch.sum(rot(z, a[..., None] * k), dim=-1))
            kk = torch.arange(cfg.n_used, dtype=self.R, device=self.dev)
            eq = rot(eq, a[..., None] * kk + b[..., None])
            slope, cpe = a, b
        eq = self.q(eq)
        if Pn:
            perr = torch.abs(eq[..., self.ppos] - self.pilots) ** 2
            sig = torch.sum(csi[:, None, self.ppos] * perr, dim=-1) / Pn
            nv_sym = torch.maximum(nv[:, None], sig)
        else:
            nv_sym = nv[:, None].expand(B, D)
        data = eq[..., self.dpos]
        inv_csi = 1.0 / torch.clamp(csi[:, self.dpos], min=1e-12)
        nv_eff = torch.clamp(nv_sym[..., None] * inv_csi[:, None, :],
                             min=1e-12)
        if self.loading is not None:
            llr3, evm = loaded_demap(self.loading, data, nv_eff)
            llr = self.q(llr3.reshape(B, cfg.raw_bits_per_frame))
            return llr, slope, cpe, evm, torch.mean(torch.abs(llr), dim=-1)
        bps, m = cfg.bits_per_symbol, cfg.bits_per_symbol // 2
        lv = torch.as_tensor(gray_levels(bps), dtype=self.R, device=self.dev)
        llr3 = torch.cat([axis_llr(data.real, lv, m),
                          axis_llr(data.imag, lv, m)], -1) / nv_eff[..., None]
        hard = (llr3 < 0).to(torch.long)
        w = torch.as_tensor(1 << np.arange(m - 1, -1, -1), device=self.dev)
        xd = torch.complex(lv[(hard[..., :m] * w).sum(-1)],
                           lv[(hard[..., m:] * w).sum(-1)])
        evm = torch.mean(torch.abs(data - xd) ** 2, dim=(-2, -1))
        llr = self.q(llr3.reshape(B, cfg.raw_bits_per_frame))
        return llr, slope, cpe, evm, torch.mean(torch.abs(llr), dim=-1)

    # ---- deinterleave + descramble into codewords, layered min-sum
    def fec(self, llr):
        cfg = self.cfg
        B = llr.shape[0]
        if cfg.fec != "ldpc":
            lam = llr[:, self.fec_index] * (1.0 - 2.0 * self.scramble)
            zeros = torch.zeros(B, dtype=torch.int32, device=self.dev)
            return (lam < 0).to(torch.uint8), zeros, zeros
        used = cfg.n_codewords * cfg.ldpc_n
        lam = (llr[:, self.fec_index[:used]]
               * (1.0 - 2.0 * self.scramble[:used]).to(self.R))
        tot, unsat, passes = self.minsum(lam.reshape(-1, cfg.ldpc_n))
        bits = (tot[:, : cfg.ldpc_k] < 0).to(torch.uint8)
        ncw = cfg.n_codewords
        return (bits.reshape(B, ncw * cfg.ldpc_k),
                passes.reshape(B, ncw).amax(dim=1),
                unsat.reshape(B, ncw).sum(dim=1, dtype=torch.int32))

    def _unsat(self, tot):
        hard = tot < 0
        bad = torch.zeros(tot.shape[0], dtype=torch.bool, device=self.dev)
        for row in self.rows:
            par = torch.zeros_like(hard[:, 0])
            for j, s in row:
                par = par ^ torch.roll(hard[:, j], -s, dims=-1)
            bad = bad | torch.any(par, dim=-1)
        return bad

    def minsum(self, lam):
        """(L, 24z) → (totals, unsat (L,), passes (L,)): each block row
        reads the current totals and writes its message delta back at
        once; a codeword whose hard decisions satisfy every check freezes
        before a sweep."""
        cfg, z = self.cfg, self.cfg.ldpc_z
        L = lam.shape[0]
        tot = lam.reshape(L, N_BLOCK_COLS, z).clone()
        c2v = [torch.zeros(len(r), L, z, dtype=self.R, device=self.dev)
               for r in self.rows]
        passes = torch.zeros(L, dtype=torch.int32, device=self.dev)
        for _ in range(cfg.ldpc_iters):
            active = self._unsat(tot)
            if not bool(active.any()):
                break
            upd = active.to(self.R)[:, None]
            for row, msg in zip(self.rows, c2v):
                v2c = torch.stack([torch.roll(tot[:, j], -s, dims=-1) - msg[e]
                                   for e, (j, s) in enumerate(row)])
                mag = torch.abs(v2c)
                sgn = torch.where(v2c < 0, -1.0, 1.0).to(self.R)
                prod = torch.prod(sgn, dim=0, keepdim=True)
                m1 = torch.amin(mag, dim=0, keepdim=True)
                am = torch.argmin(mag, dim=0, keepdim=True)
                mask = torch.arange(len(row), device=self.dev)[
                    :, None, None] == am
                m2 = torch.amin(torch.where(mask, _BIG, mag), dim=0,
                                keepdim=True)
                new = _ALPHA * (prod * sgn) * torch.where(mask, m2, m1)
                for e, (j, s) in enumerate(row):
                    delta = (new[e] - msg[e]) * upd
                    tot[:, j] = tot[:, j] + torch.roll(delta, s, dims=-1)
                    msg[e] = msg[e] + delta
            passes += active.to(torch.int32)
        return tot.reshape(L, -1), self._unsat(tot), passes

    # ---- clock offset: the SC coarse estimate and the pilot-slope fit
    def sc_offset(self, scw):
        cfg, lay = self.cfg, layout(self.cfg)
        half = cfg.n_fft // 2
        guard = half // 4
        L = half - 2 * guard
        used = lay.used_bins
        qn = (used[(used % 2) == 0] // 2).astype(np.float64)
        n = np.arange(L, dtype=np.float64)[:, None]
        th = torch.as_tensor(2.0 * np.pi * n * qn[None, :] / half,
                             dtype=self.R, device=self.dev)
        cos, sin = torch.cos(th), torch.sin(th)
        h1 = scw[:, guard: guard + L]
        h2 = scw[:, guard + half: guard + half + L]
        y1 = torch.complex(h1 @ cos, -(h1 @ sin))
        y2 = torch.complex(h2 @ cos, -(h2 @ sin))
        rho = torch.conj(y1) * y2
        a = torch.angle(torch.sum(rho[:, 1:] * torch.conj(rho[:, :-1]), -1)
                        ) / float(np.mean(np.diff(qn)))
        Q = max(2, len(qn) // 4)
        qt = torch.as_tensor(qn, dtype=self.R, device=self.dev)
        for lag in ([Q] if Q <= 96 else [32, Q]):
            zd = rho * torch.polar(torch.ones_like(qt), -a[:, None] * qt)
            corr = torch.sum(zd[:, lag:] * torch.conj(zd[:, :-lag]), -1)
            a = a + torch.angle(corr) / float(np.mean(qn[lag:] - qn[:-lag]))
        return a * (half / (2.0 * np.pi)) / half

    def slope_offset(self, slope):
        D = self.cfg.n_data_symbols
        if D < 2:
            return torch.zeros(slope.shape[:-1], dtype=self.R,
                               device=self.dev)
        d = torch.arange(D, dtype=self.R, device=self.dev)
        dc = d - d.mean()
        a = torch.sum(dc * slope, -1) / torch.sum(dc * dc)
        return a * (self.cfg.n_fft / (2.0 * np.pi * self.cfg.symbol_len))

    # ---- the routes
    def _finish(self, start, metric, syms, roll, delta=None):
        Y = self.spectra(syms, roll, delta)
        H, nv = self.chanest(Y, delta)
        llr, slope, cpe, evm, mabs = self.tail(Y, H, nv)
        bits, iters, unsat = self.fec(llr)
        return dict(bits=bits, sync_start=start, sync_metric=metric, H=H,
                    noise_var=nv, pilot_slope=slope, common_phase=cpe,
                    evm=evm, mean_abs_llr=mabs,
                    clock_ppm=self.slope_offset(slope) * 1e6,
                    fec_iters=iters, fec_unsat=unsat)

    def _prepare(self, rx):
        rx = self.q(rx.to(self.dev, self.R))
        start, metric = self.sync(rx)
        syms, scw, roll = self.cut(rx, start)
        return rx, start, metric, syms, scw, roll

    @torch.no_grad()
    def demodulate(self, rx: torch.Tensor) -> dict:
        """The plain route on rows rx (n, T)."""
        _, start, metric, syms, _, roll = self._prepare(rx)
        return self._finish(start, metric, syms, roll)

    @torch.no_grad()
    def demodulate_sfo(self, rx: torch.Tensor, rows: torch.Tensor,
                       chunk: int = 256) -> dict:
        """The clock-offset route: one δ̂ for the whole batch rx (B, T) —
        the median SC estimate over its rows seeds a warped demod of every
        row, whose pilot slopes' median is δ̂ — then the final warped demod
        of `rows` alone."""
        def each(fn):
            return torch.cat([fn(self._prepare(rx[i: i + chunk]))
                              for i in range(0, rx.shape[0], chunk)])
        d0 = _median(each(lambda p: self.sc_offset(p[4])))

        def slopes(p):
            Y = self.spectra(p[3], p[5], d0)
            H, nv = self.chanest(Y, d0)
            return self.slope_offset(self.tail(Y, H, nv)[1])
        delta = _median(each(slopes))
        _, start, metric, syms, _, roll = self._prepare(rx[rows])
        return self._finish(start, metric, syms, roll, delta)
