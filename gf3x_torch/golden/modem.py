# Copied from gf3x/golden/modem.py (float64 NumPy), so that gf3x_torch never
# imports jax. Its lazy imports point at the port's NumPy helpers, and the
# LDPC parity is computed here on the host from the code's projector P
# (the port's `LdpcCode.encode` takes tensors); it does no tensor work.
"""Golden model: the complete GF3 signal chain in float64 NumPy.

This is the in-repo stand-in for the reference implementation (the reference
mount was empty — SURVEY.md §0), written FIRST per the build plan
(SURVEY.md §8 step 1): small, slow, obviously correct. It is the parity
oracle for the TPU path — `decode(encode(x)) == x` here defines "correct",
and the JAX modem must produce bit-identical *decoded payloads* (not
bit-identical floats; SURVEY.md §8 risk "Bit-exactness across float32 TPU
vs float64 NumPy").

Covers reference layers L0–L7 (SURVEY.md §2) in one deliberately-plain file:
chirp + Schmidl–Cox sync, OFDM mod/demod, LS channel estimation, one-tap EQ,
pilot phase tracking, Gray QPSK/QAM map + max-log LLR demap, optional LDPC.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import Layout, ModemConfig, layout
from ..utils.bits import bits_to_bytes, bytes_to_bits, pack_header, parse_header

__all__ = ["GoldenModem", "GoldenDecodeResult"]


# --------------------------------------------------------------- constellation

def pam_label_levels(m: int) -> np.ndarray:
    """Gray-coded PAM lookup: label integer ℓ (m bits) → amplitude.

    Level positions idx = 0..M−1 carry amplitudes (M−1)−2·idx (descending,
    so the all-zeros label lands on the most positive level) and Gray label
    g = idx ^ (idx>>1). For m=1 this reduces to the canonical 1−2b map
    (SURVEY.md Appendix "QPSK").
    """
    M = 1 << m
    idx = np.arange(M)
    gray = idx ^ (idx >> 1)
    lut = np.empty(M, dtype=np.float64)
    lut[gray] = (M - 1) - 2 * idx
    return lut


def _qam_norm(bits_per_symbol: int) -> float:
    """Scale so the square QAM constellation has unit average power.

    Per-axis E[l²] over ±1, ±3, … ±(M−1) is (M²−1)/3; two axes double it.
    """
    M = 1 << (bits_per_symbol // 2)
    return 1.0 / np.sqrt(2.0 * (M * M - 1) / 3.0)


def qam_map(bits: np.ndarray, bits_per_symbol: int) -> np.ndarray:
    """Gray-coded square QAM map. bits: (..., bits_per_symbol) → complex.

    First m bits drive the I axis (MSB-first), last m the Q axis. QPSK case
    matches SURVEY.md Appendix: (b0,b1) → ((1−2b0) + j(1−2b1))/√2.
    """
    m = bits_per_symbol // 2
    lut = pam_label_levels(m)
    w = 1 << np.arange(m - 1, -1, -1)
    b = np.asarray(bits, dtype=np.int64)
    bi = b[..., :m] @ w
    bq = b[..., m:] @ w
    return (lut[bi] + 1j * lut[bq]) * _qam_norm(bits_per_symbol)


def qam_demap_llr(y: np.ndarray, noise_var: np.ndarray, bits_per_symbol: int) -> np.ndarray:
    """Max-log LLRs for Gray square QAM. Positive LLR ⇒ bit 0.

    LLR_j = (min_{bit_j=1}(x−l)² − min_{bit_j=0}(x−l)²) / noise_var, per
    axis (square QAM is separable). y: (...,) complex equalized symbols;
    noise_var: broadcastable effective post-EQ noise variance.
    Returns (..., bits_per_symbol): I-axis bits then Q-axis bits.
    """
    m = bits_per_symbol // 2
    M = 1 << m
    lv = pam_label_levels(m) * _qam_norm(bits_per_symbol)  # (M,) by label int

    def axis_llr(x: np.ndarray) -> np.ndarray:
        d = (x[..., None] - lv) ** 2  # (..., M)
        out = np.empty(x.shape + (m,), dtype=np.float64)
        for j in range(m):
            bitj = (np.arange(M) >> (m - 1 - j)) & 1
            d0 = np.min(np.where(bitj == 0, d, np.inf), axis=-1)
            d1 = np.min(np.where(bitj == 1, d, np.inf), axis=-1)
            out[..., j] = d1 - d0
        return out

    nv = np.maximum(np.asarray(noise_var, dtype=np.float64), 1e-12)
    lre = axis_llr(np.real(y)) / nv[..., None]
    lim = axis_llr(np.imag(y)) / nv[..., None]
    return np.concatenate([lre, lim], axis=-1)


# ------------------------------------------------------------------- results

@dataclass
class GoldenDecodeResult:
    payload: bytes
    filename: str
    crc_ok: bool
    bits: np.ndarray                      # decoded info bits (pre-header-strip)
    diag: dict = field(default_factory=dict)


# --------------------------------------------------------------------- modem

class GoldenModem:
    """Float64 NumPy implementation of the full GF3 transceiver (L0–L6)."""

    def __init__(self, cfg: ModemConfig):
        self.cfg = cfg.validate()
        self.lay: Layout = layout(cfg)
        self._ldpc = None
        if cfg.fec == "ldpc":
            from ..fec.ldpc import LdpcCode  # lazy: heavy table build
            self._ldpc = LdpcCode.for_config(cfg)

    # ------------------------------------------------------------- chirp (L4)
    def make_chirp(self) -> np.ndarray:
        """Linear chirp with raised-cosine fades (SURVEY.md Appendix)."""
        c = self.cfg
        n = c.chirp_len
        t = np.arange(n, dtype=np.float64) / c.fs
        T = n / c.fs
        phase = 2.0 * np.pi * (c.chirp_f0 * t + 0.5 * (c.chirp_f1 - c.chirp_f0) * t * t / T)
        x = np.sin(phase)
        nf = max(1, int(round(c.chirp_fade * c.fs)))
        win = np.ones(n)
        ramp = 0.5 * (1 - np.cos(np.pi * np.arange(nf) / nf))
        win[:nf] = ramp
        win[-nf:] = ramp[::-1]
        return c.chirp_amplitude * x * win

    def find_frame_start(self, rx: np.ndarray) -> tuple[int, float]:
        """Chirp matched filter via FFT cross-correlation → (start, peak metric).

        m[n] = Σ_i rx[n+i]·c[i] computed as irfft(rfft(rx)·conj(rfft(c)));
        frame start = argmax |m| (SURVEY.md Appendix "Chirp sync").
        """
        chirp = self.make_chirp()
        L = int(len(rx) + len(chirp))
        nfft = 1 << int(np.ceil(np.log2(L)))
        M = np.fft.irfft(np.fft.rfft(rx, nfft) * np.conj(np.fft.rfft(chirp, nfft)), nfft)
        mabs = np.abs(M[: len(rx)])
        peak = int(np.argmax(mabs))
        # In multipath the strongest correlation tap can be a reflection;
        # lock to the FIRST arrival: earliest tap within 6 dB of the peak in
        # the preceding CP-length window (the matched-filter output is the
        # channel impulse response smeared by the chirp autocorrelation).
        lo = max(0, peak - self.cfg.cp)
        win = mabs[lo: peak + 1]
        first = lo + int(np.argmax(win >= 0.5 * mabs[peak]))
        metric = float(mabs[peak] / (np.median(mabs) + 1e-12))
        return first, metric

    def schmidl_cox_metric(self, rx: np.ndarray) -> np.ndarray:
        """M(d) = |P(d)|² / R(d)² with half-symbol lag (SURVEY.md Appendix)."""
        half = self.cfg.n_fft // 2
        prod = rx[:-half] * rx[half:]          # real signal: conj is identity
        energy = rx[half:] ** 2
        cs_p = np.concatenate([[0.0], np.cumsum(prod)])
        cs_r = np.concatenate([[0.0], np.cumsum(energy)])
        n = len(rx) - self.cfg.n_fft
        if n <= 0:
            return np.zeros(0)
        d = np.arange(n)
        P = cs_p[d + half] - cs_p[d]
        R = cs_r[d + half] - cs_r[d]
        # energy floor: windows with almost no signal (recording edges) have
        # P ≈ R ≈ 0 and the raw ratio spikes to ~1 on noise
        R = np.maximum(R, 0.05 * R.max() + 1e-24)
        return (P * P) / (R * R)

    # ------------------------------------------------------- clock offset (L4/L5)
    def sc_clock_offset(self, sc_win: np.ndarray) -> float:
        """Coarse SFO (fractional clock offset) from the SC symbol's halves —
        the real-passband adaptation of Schmidl–Cox fractional CFO
        ∠P/(πT_half) (SURVEY.md:133, :399): per-bin phase slope between the
        DFTs of the two halves. Twin of `gf3x.ops.sfo.sc_clock_offset`."""
        c, lay = self.cfg, self.lay
        half = c.n_fft // 2
        guard = half // 4          # tolerate ±guard window misalignment
        L = half - 2 * guard
        used = lay.used_bins
        q = (used[(used % 2) == 0] // 2).astype(np.float64)
        n = np.arange(L, dtype=np.float64)[:, None]
        W = np.exp(-2j * np.pi * n * q[None, :] / half)
        y1 = sc_win[guard: guard + L] @ W
        y2 = sc_win[guard + half: guard + half + L] @ W
        rho = np.conj(y1) * y2
        inc = rho[1:] * np.conj(rho[:-1])
        a = np.angle(np.sum(inc)) / float(np.mean(np.diff(q)))
        Q = max(2, len(q) // 4)
        zd = rho * np.exp(-1j * a * q)
        corr = np.sum(zd[Q:] * np.conj(zd[:-Q]))
        a = a + np.angle(corr) / float(np.mean(q[Q:] - q[:-Q]))
        tau = a * half / (2.0 * np.pi)
        return float(tau / half)

    def slope_clock_offset(self, slopes: np.ndarray) -> float:
        """Fine SFO from the per-symbol pilot-slope regression (rad/bin →
        fractional offset). Twin of `gf3x.ops.sfo.slope_clock_offset`."""
        c = self.cfg
        if len(slopes) < 2:
            return 0.0    # a single point fixes no line (twin of ops.sfo)
        d = np.arange(len(slopes), dtype=np.float64)
        dc = d - d.mean()
        a = float(np.sum(dc * slopes) / np.sum(dc * dc))
        return a * c.n_fft / (2.0 * np.pi * c.symbol_len)

    # -------------------------------------------------------------- OFDM (L3)
    def ofdm_modulate(self, sym_bins: np.ndarray) -> np.ndarray:
        """(S, n_used) complex bin values → (S·(N+CP),) real samples."""
        c, lay = self.cfg, self.lay
        S = sym_bins.shape[0]
        spec = np.zeros((S, c.n_bins), dtype=np.complex128)
        spec[:, lay.used_bins] = sym_bins
        x = np.fft.irfft(spec, c.n_fft, axis=-1) * c.ofdm_scale
        with_cp = np.concatenate([x[:, -c.cp:], x], axis=-1)
        return with_cp.reshape(-1)

    def ofdm_demodulate(self, samples: np.ndarray, delta: float = 0.0) -> np.ndarray:
        """(S·(N+CP),) real samples → (S, n_used) complex bin values.

        `delta` ≠ 0 demodulates at clock-offset-warped frequencies k(1+δ)
        (the SFO correction — twin of the JAX warped-DFT path)."""
        c, lay = self.cfg, self.lay
        sym = samples.reshape(-1, c.symbol_len)[:, c.cp:]
        if delta:
            n = np.arange(c.n_fft, dtype=np.float64)[:, None]
            k = lay.used_bins.astype(np.float64)[None, :]
            W = np.exp(-2j * np.pi * n * k * (1.0 + delta) / c.n_fft)
            return (sym @ W) / c.ofdm_scale
        spec = np.fft.rfft(sym, c.n_fft, axis=-1) / c.ofdm_scale
        return spec[:, lay.used_bins]

    # ------------------------------------------------------ channel est. (L5)
    def estimate_channel(self, known_rx: np.ndarray,
                         delta: float = 0.0) -> tuple[np.ndarray, float]:
        """LS estimate Ĥ[k] = mean_r(Y_r[k]/X_r[k]) + scalar noise variance.

        SURVEY.md Appendix "LS channel estimate". noise_var is the residual
        power of Y − Ĥ·X averaged over bins and repeats (used to scale LLRs).
        `delta` derotates each known symbol's SFO drift ramp before the
        average (twin of `gf3x.ops.chanest.estimate_channel`).
        """
        lay = self.lay
        if delta:
            c = self.cfg
            k = lay.used_bins.astype(np.float64)[None, :]
            r = np.arange(c.n_known_symbols, dtype=np.float64)[:, None]
            known_rx = known_rx * np.exp(
                -2j * np.pi * k * (delta * c.symbol_len) * r / c.n_fft)
        ratio = known_rx / lay.known_syms
        H = ratio.mean(axis=0)
        # noise_var from the RAW residual (before denoising) — conservative
        resid = known_rx - H[None, :] * lay.known_syms
        noise_var = float(np.mean(np.abs(resid) ** 2))
        if self.cfg.est_taps:
            from ..ops.chanest import denoise_projection
            c = self.cfg
            # delay-recentred projection (twin of gf3x.ops.chanest): shift
            # the IR to tap est_taps//4 before truncating, undo after
            k = lay.used_bins.astype(np.float64)
            a = np.angle(np.sum(H[1:] * np.conj(H[:-1])))
            r0 = np.round(-a * c.n_fft / (2.0 * np.pi)) - c.est_taps // 4
            ramp = np.exp(2j * np.pi * k * r0 / c.n_fft)
            P = denoise_projection(c).astype(np.complex128)
            H = (P @ (H * ramp)) * np.conj(ramp)
        return H, noise_var

    def equalize(self, data_rx: np.ndarray, H: np.ndarray) -> np.ndarray:
        """One-tap FD EQ X̂ = Y/Ĥ (SURVEY.md Appendix)."""
        return data_rx / H[None, :]

    def pilot_phase_correct(self, eq: np.ndarray,
                            H: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Residual phase/timing-drift correction from pilot phase slopes.

        Per data symbol fit ∠(X̂_pilot·p*) ≈ a·k + b (SURVEY.md Appendix
        "Pilot phase tracking"), two-stage: a coarse slope from
        adjacent-pilot increments (unwrap-free, unambiguous to ±π/spacing)
        is refined on the half-band baseline — slope noise scales with
        1/baseline, and a noisy slope corrupts band edges by ±a_err·k
        radians (the intercept only recenters the tilt at the pilot
        centroid). Returns (corrected, slope_per_bin a, intercept b).
        """
        c, lay = self.cfg, self.lay
        if c.n_pilots < 2:
            return eq, np.zeros(eq.shape[0]), np.zeros(eq.shape[0])
        z = eq[:, lay.pilot_pos] * np.conj(lay.pilot_vals)[None, :]   # (D, P)
        if H is not None:
            # CSI weighting (twin of gf3x.ops.chanest): notch pilots carry
            # EQ-amplified noise and must not dominate the fit
            z = z * (np.abs(H[lay.pilot_pos]) ** 2)[None, :]
        dk = np.diff(lay.pilot_pos.astype(np.float64))                # (P-1,)
        inc = z[:, 1:] * np.conj(z[:, :-1])                           # (D, P-1)
        a = np.angle(np.sum(inc, axis=1)) / float(np.mean(dk))        # coarse
        k = lay.pilot_pos.astype(np.float64)[None, :]
        # baseline ladder: each refinement's ±π ambiguity range must cover
        # the previous stage's noise (a single long-baseline step aliases
        # when coarse_err · baseline > π — observed as whole symbols rotated
        # by ~π/2 at moderate SNR)
        P = c.n_pilots
        for Q in sorted({max(2, P // 8), P // 2}):
            if not 1 <= Q < P:       # degenerate pilot counts (P == 2)
                continue
            zd = z * np.exp(-1j * a[:, None] * k)
            corr = np.sum(zd[:, Q:] * np.conj(zd[:, :-Q]), axis=1)
            base = float(np.mean(k[0, Q:] - k[0, :-Q]))
            a = a + np.angle(corr) / base
        b = np.angle(np.sum(z * np.exp(-1j * a[:, None] * k), axis=1))
        kk = np.arange(c.n_used, dtype=np.float64)[None, :]
        corr = np.exp(-1j * (a[:, None] * kk + b[:, None]))
        return eq * corr, a, b

    # ------------------------------------------------------------- frame (L6)
    def _frame_symbols(self, coded_bits: np.ndarray) -> np.ndarray:
        """Coded channel bits → (K+D, n_used) bin matrix (known ∥ data)."""
        c, lay = self.cfg, self.lay
        assert coded_bits.size == c.raw_bits_per_frame
        if c.bit_loading is not None:
            # per-bin loading twin (SPEC.md §5b group-sorted wire order):
            # per-group Gray map, one static permutation, nulled bins 0,
            # active bins boosted by `gain`
            from ..models.frame import loading_tables
            t = loading_tables(c)
            rows = coded_bits.reshape(c.n_data_symbols, c.bits_per_ofdm_symbol)
            dsym = np.zeros((c.n_data_symbols, c.n_data_bins), np.complex128)
            off = 0
            for m, pos in t.groups:
                n = len(pos)
                grp = rows[:, off: off + n * m].reshape(c.n_data_symbols, n, m)
                dsym[:, pos] = qam_map(grp, m) * t.gain
                off += n * m
        else:
            grp = coded_bits.reshape(c.n_data_symbols, c.n_data_bins, c.bits_per_symbol)
            dsym = qam_map(grp, c.bits_per_symbol)                    # (D, n_data_bins)
        data = np.zeros((c.n_data_symbols, c.n_used), dtype=np.complex128)
        data[:, lay.data_pos] = dsym
        data[:, lay.pilot_pos] = lay.pilot_vals[None, :]
        return np.concatenate([lay.known_syms.astype(np.complex128), data], axis=0)

    def _channel_bits(self, info_bits: np.ndarray) -> np.ndarray:
        """Info bits (payload_bits_per_frame) → scrambled channel bits.

        The PRBS scrambler keeps constant payloads/padding noise-like so no
        data symbol collapses into a time-domain impulse (PAPR control)."""
        c = self.cfg
        assert info_bits.size == c.payload_bits_per_frame
        if c.fec == "ldpc":
            u = info_bits.reshape(c.n_codewords, c.ldpc_k).astype(np.uint8)
            # systematic codeword [u | P·u mod 2] (gf3x's host encode)
            p = (u.astype(np.int64) @ self._ldpc.P.T.astype(np.int64)) & 1
            coded = np.concatenate([u, p.astype(np.uint8)], axis=-1).reshape(-1)
            pad = np.zeros(c.raw_bits_per_frame - coded.size, dtype=np.uint8)
            coded = np.concatenate([coded, pad])
        else:
            coded = info_bits.astype(np.uint8)
        coded = coded ^ self.lay.scramble
        if c.interleave:
            from ..models.frame import interleave_bits
            coded = np.asarray(interleave_bits(c, coded))
        return coded

    # --------------------------------------------------------- public API (L6)
    def encode(self, payload: bytes, filename: str = "") -> np.ndarray:
        """bytes → real float64 waveform (BASELINE.json:5 public API)."""
        c = self.cfg
        stream = pack_header(payload, filename)
        bits = bytes_to_bits(stream)
        cap = c.payload_bits_per_frame
        if bits.size > cap:
            raise ValueError(
                f"payload needs {bits.size} info bits; frame carries {cap} "
                f"(≤ {cap // 8} bytes incl. header)"
            )
        info = np.zeros(cap, dtype=np.uint8)
        info[: bits.size] = bits
        coded = self._channel_bits(info)
        syms = self._frame_symbols(coded)
        ofdm = self.ofdm_modulate(syms)
        parts = [self.make_chirp()]
        if c.use_schmidl_cox:
            parts.append(self.ofdm_modulate(self.lay.sc_sym[None, :]))
        parts.append(ofdm)
        wav = np.concatenate(parts)
        assert wav.size == c.frame_len
        return wav

    def demod_frame(self, rx: np.ndarray, start: int,
                    delta: float = 0.0) -> tuple[np.ndarray, dict]:
        """Demodulate one frame whose chirp begins at `start` → (LLRs, diag).
        `delta` applies the clock-offset-warped demod."""
        c = self.cfg
        backoff = c.cp // 4  # start FFT windows inside the CP (SURVEY.md §8)
        ofdm_start = start + c.preamble_len - backoff
        n_sym = c.n_known_symbols + c.n_data_symbols
        need = n_sym * c.symbol_len
        if ofdm_start < 0 or ofdm_start + need > rx.size:
            raise ValueError("frame extends past the recording")
        Y = self.ofdm_demodulate(rx[ofdm_start: ofdm_start + need], delta)
        H, noise_var = self.estimate_channel(Y[: c.n_known_symbols], delta)
        eq = self.equalize(Y[c.n_known_symbols:], H)
        eq, slope, cpe = self.pilot_phase_correct(eq, H)
        csi = np.abs(H) ** 2  # (n_used,)
        if c.n_pilots:
            # per-symbol noise floor from CSI-weighted pilot residuals (twin of
            # Modem._eq_syms): burst-hit symbols demap as erasures
            pil = eq[:, self.lay.pilot_pos]
            w = csi[self.lay.pilot_pos]
            perr = np.abs(pil - self.lay.pilot_vals[None, :]) ** 2
            sig_d = (perr * w[None, :]).sum(axis=1) / c.n_pilots      # (D,)
            nv_sym = np.maximum(noise_var, sig_d)
        else:
            # pilotless config: no residual floor (the 0/0 NaN-LLR bug,
            # VERDICT r2 weak #1) — global LS noise only
            nv_sym = np.full(eq.shape[0], noise_var)
        data = eq[:, self.lay.data_pos]
        inv_csi = 1.0 / np.maximum(csi[self.lay.data_pos], 1e-12)
        nv = nv_sym[:, None] * inv_csi[None, :]
        if c.bit_loading is not None:
            # per-group demap twin of models.frame.loaded_demap_llr
            from ..models.frame import loading_tables
            t = loading_tables(c)
            parts, err = [], 0.0
            for m, pos in t.groups:
                y = data[:, pos] / t.gain
                l3 = qam_demap_llr(
                    y, np.broadcast_to(nv[:, pos] / t.gain**2, y.shape), m)
                parts.append(l3.reshape(c.n_data_symbols, len(pos) * m))
                err += float(np.sum(
                    np.abs(y - qam_map((l3 < 0).astype(np.uint8), m)) ** 2))
            evm = err / (c.n_data_symbols * c.n_active_bins)
            llr = np.concatenate(parts, axis=1).reshape(-1)
        else:
            llr3 = qam_demap_llr(data, np.broadcast_to(nv, data.shape),
                                 c.bits_per_symbol)         # (D, n_data_bins, bps)
            hard = (llr3 < 0).astype(np.uint8)
            evm = float(np.mean(np.abs(data - qam_map(hard, c.bits_per_symbol)) ** 2))
            llr = llr3.reshape(-1)
        diag = {
            "H": H, "noise_var": noise_var, "pilot_slope": slope,
            "common_phase": cpe, "evm": evm,
            # pilot slopes measure the full timing drift (= δ) on warped
            # and unwarped demods alike
            "clock_ppm": self.slope_clock_offset(slope) * 1e6,
        }
        return llr, diag

    def decode(self, rx: np.ndarray, start: Optional[int] = None,
               sfo: str = "auto") -> GoldenDecodeResult:
        """waveform → bytes (BASELINE.json:5 public API).

        `start` overrides sync (loopback tests); otherwise chirp matched
        filtering locates the frame. sfo: 'off' | 'auto' | 'on' — the
        clock-offset correction loop (SC coarse estimate → warped demod →
        pilot-slope residual → final warped demod), twin of
        `Modem.demodulate_sfo`.
        """
        from ..ops.sfo import auto_retry_needed, prefer_retry

        c = self.cfg
        rx = np.asarray(rx, dtype=np.float64)
        if start is None:
            start, peak_metric = self.find_frame_start(rx)
        else:
            peak_metric = float("inf")

        def demod(delta: float) -> tuple[np.ndarray, dict]:
            llr, diag = self.demod_frame(rx, start, delta)
            diag["sync_start"] = start
            diag["sync_peak_metric"] = peak_metric
            return llr, diag

        def correction_delta() -> float:
            # the SC coarse estimate only SEEDS the warped pass (fixing its
            # ICI); that pass's pilot slopes measure δ itself (see the JAX
            # twin `_two_pass_delta`)
            d0 = 0.0
            if c.use_schmidl_cox:
                o = start + c.chirp_len + c.cp
                if 0 <= o and o + c.n_fft <= rx.size:
                    d0 = self.sc_clock_offset(rx[o: o + c.n_fft])
            _, diag_a = self.demod_frame(rx, start, d0)
            return self.slope_clock_offset(diag_a["pilot_slope"])

        try:
            if sfo == "on":
                res = self._finish(*demod(correction_delta()))
            else:
                res = self._finish(*demod(0.0))
                if (sfo == "auto" and c.use_schmidl_cox
                        and auto_retry_needed(res.crc_ok,
                                              res.diag["clock_ppm"])):
                    retry = self._finish(*demod(correction_delta()))
                    if prefer_retry(res.crc_ok, retry.crc_ok):
                        res = retry
        except ValueError:
            # no (complete) frame at the sync position — failed decode, not a crash
            return GoldenDecodeResult(
                payload=b"", filename="", crc_ok=False,
                bits=np.zeros(0, dtype=np.uint8),
                diag={"sync_start": start, "sync_peak_metric": peak_metric,
                      "error": "frame extends past the recording"},
            )
        return res

    def _finish(self, llr: np.ndarray, diag: dict) -> GoldenDecodeResult:
        """Descramble → FEC decode → header parse (the L1 tail of decode)."""
        c = self.cfg
        if c.interleave:
            from ..models.frame import interleave_bits
            llr = np.asarray(interleave_bits(c, llr, inverse=True))
        llr = llr * (1.0 - 2.0 * self.lay.scramble)   # descramble channel bits
        if c.fec == "ldpc":
            used = c.n_codewords * c.ldpc_n
            lw = llr[:used].reshape(c.n_codewords, c.ldpc_n)
            info_bits, iters, unsat = self._ldpc.decode_diag(lw, c.ldpc_iters)
            bits = info_bits.reshape(-1)
            diag["ldpc_iters"] = iters
            # codewords whose final hard decisions still violate a parity
            # check — decoder stress short of CRC failure (twin of
            # DecodeDiag.fec_unsat)
            diag["fec_unsat"] = int(np.sum(unsat))
        else:
            bits = (llr < 0).astype(np.uint8)
        stream = bits_to_bytes(bits)
        try:
            payload, name, crc_ok = parse_header(stream)
        except ValueError:
            payload, name, crc_ok = b"", "", False
        return GoldenDecodeResult(payload=payload, filename=name, crc_ok=crc_ok,
                                  bits=bits, diag=diag)
