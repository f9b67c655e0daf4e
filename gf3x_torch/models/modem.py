"""The modem as a torch module: batched `encode(bytes) → waveform` and every
decode route of gf3x/models/modem.py — chirp or Schmidl–Cox sync, the
clock-offset loop, the decision-directed retry, prewindowed frames —,
`decode` with gf3x's retry policy, and the HARQ surface (`coded_llrs`,
`joint_clock_offset`, `decode_stream_llr`) that chase combining runs on.

Receive path of one (B, T) float32 batch:

    find_frame_start (bounded, 2× decimated when `max_delay` is set),
        or find_frame_start_sc (`demodulate_sc`)
    → cut_symbols            by gf3x's rule: kernel 1 (frame cut + CP
                             strip); kernel 6's window cut of whole 8-row
                             groups where gf3x's fused cut refuses the
                             geometry (CP = N/4 at N = 2048); kernel 7's
                             window cut for a batch that is not whole
                             8-row groups (`decode` of one recording)
    → ofdm_dft + deroll      cuFFT, one phase ramp for the block-grid roll;
                             the δ-warped DFT in the clock-offset loop: a
                             chirp-z transform past config 5's band
                             (`czt_pre`, cuFFT, `czt_post`), gf3x's dense
                             product at it (the `warped_dft` span inside
                             `dft`)
      (with `use_cut_dft`, on the plain route of a geometry the fused cut
       takes and kernel 8's FFT takes, n_fft ≤ 4096: cut_dft_spectra,
       kernel 8 — cut, DFT and deroll in one launch)
    → estimate_channel       LS + tap denoise + ISI profile on K symbols
    → the EQ/demap tail, by config (`_tail_route`):
        uniform:     fused_eq_demap       kernel 2 (EQ, pilot tracking, demap)
        bit-loaded:  eq_track → demap_bins  kernels A and B (the split tail)
      (the DD retry runs the tail twice, the second time on Ĥ re-estimated
       from the first pass's decisions)
    → one static gather      deinterleave + descramble into codewords
    → LDPC min-sum           kernel 3
    → info bits + DecodeDiag

Each public entry is a root span of `utils.profiling` (`demodulate`,
`demodulate_sfo`, ...) and each stage above a child span (`sync`, `cut`
or `cut_dft`, `dft`, `chanest`, `eq_demap`, `clock_offset`,
`dd_estimate`, `fec_gather`, `ldpc`, `diag`), so that every op of a call
runs inside a stage; with tracing off a span is one flag check.

The module holds no learned weights. Its buffers are the static tables the
config defines — chirp, known symbols, pilots, SC symbol, scrambler, the
denoise projector, the ISI operator, the LDPC parity projector, the FEC
gather index and the demap kernel's per-data-bin tables — built here
exactly as gf3x builds them and replaceable through
`gf3x_torch.convert.load_reference_tables`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import ModemConfig, layout
from ..fec.ldpc import LdpcCode
from ..ops.chanest import _isi_operator, denoise_projection, estimate_channel
from ..ops.chirp import make_chirp
from ..ops.constellation import hard_bits, qam_map
from ..ops.kernels import cut_dft as _cut_dft
from ..ops.kernels.fec_gather import fec_gather, reversal_index
from ..ops.kernels.fused_eq import fused_eq_demap
from ..ops.kernels.llr_hist import llr_hist, sample_table
from ..ops.kernels.split_eq import demap_bins, eq_track
from ..ops.ofdm import deroll, ofdm_dft, ofdm_modulate
from ..ops.sfo import (auto_retry_needed, prefer_retry, sc_clock_offset,
                       slope_clock_offset)
from ..ops.sync import (cut_dft_spectra, cut_symbols, find_frame_start,
                        find_frame_start_sc, fused_cut_refuses,
                        max_cut_start, sc_metric_window)
from ..utils.bits import (bits_to_bytes, bytes_to_bits, pack_header,
                          parse_frame_header)
from ..utils.profiling import count, span
from .frame import (data_symbols_from_bits, demap_bin_tables,
                    frame_bin_matrix, interleave_bits, interleave_pilots,
                    loaded_qam_map, scatter_factors, split_pilots)

__all__ = ["Modem", "DecodeDiag", "DecodeResult"]


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median of all elements, the mean of the two middle values for an
    even count (jnp.median; torch.median returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


class DecodeDiag(NamedTuple):
    """Per-frame decode diagnostics, the fields of gf3x's DecodeDiag."""

    sync_start: torch.Tensor     # (...,) int32 — chirp onset sample
    sync_metric: torch.Tensor    # (...,) f32 — correlation peak / mean |m|
    sc_metric: torch.Tensor      # (...,) f32 — Schmidl–Cox M at the SC window
    H: torch.Tensor              # (..., n_used) complex64 — channel estimate
    noise_var: torch.Tensor      # (...,) f32 — LS residual power
    pilot_slope: torch.Tensor    # (..., D) f32 — rad/bin timing drift
    common_phase: torch.Tensor   # (..., D) f32 — per-symbol phase error
    evm: torch.Tensor            # (...,) f32 — mean |X̂ − hard decision|²
    mean_abs_llr: torch.Tensor   # (...,) f32 — demapper confidence
    clock_ppm: torch.Tensor      # (...,) f32 — clock offset from the slopes
    fec_iters: torch.Tensor      # (...,) int32 — most LDPC sweeps any of the
                                 # frame's codewords ran (per codeword, so
                                 # not gf3x's batch-wide count; ≤ ldpc_iters)
    fec_unsat: torch.Tensor      # (...,) int32 — codewords left with a
                                 # violated parity check
    isi_var: torch.Tensor        # (..., n_used) f32 — beyond-CP ISI floor
    isi_db: torch.Tensor         # (...,) f32 — tail/total channel energy, dB
    llr_hist: torch.Tensor       # (..., 16) int32 — |LLR| log2 histogram of
                                 # every 8th coded-stream LLR


@dataclass
class DecodeResult:
    payload: bytes
    filename: str
    crc_ok: bool
    bits: np.ndarray
    diag: Optional[DecodeDiag] = None
    seq: int = 0
    total: int = 1


class Modem(torch.nn.Module):
    """PyTorch implementation of the GF3 transceiver.

    >>> m = Modem(GF3_STANDARD, max_delay=4352)  # buffers on the card
    >>> bits, diag = m.demodulate(rx)            # (B, T) float32 on the card
    >>> res = m.decode(recording)                # np waveform → DecodeResult
    >>> cpu = Modem(GF3_STANDARD, device="cpu")  # plain versions, no card
    """

    def __init__(self, cfg: ModemConfig, max_delay: Optional[int] = None,
                 device=None, use_cut_dft: bool = False):
        """`max_delay` (samples) bounds the frame onset the sync searches
        for (the streaming receiver's case); None searches the recording.
        `device` holds the buffers: the card (`cuda`) by default, which
        raises as torch raises where there is none; `device="cpu"` is the
        explicit CPU route, on the kernels' plain versions. `use_cut_dft`
        routes the plain decode (no clock-offset loop, no DD) through
        kernel 8, the fused cut + DFT + deroll; off by default, as in
        gf3x, and a setting of this instance only."""
        super().__init__()
        self.cfg = cfg.validate()
        self.max_delay = max_delay
        self.use_cut_dft = use_cut_dft
        # decimate the bounded sync correlation when the chirp band fits the
        # decimated Nyquist (timing granularity 2, inside the backoff)
        self._sync_decimate = 2 if cfg.chirp_f1 * 4 <= cfg.fs * 0.95 else 1
        self.lay = layout(cfg)
        self._code = LdpcCode.for_config(cfg) if cfg.fec == "ldpc" else None
        lay = self.lay
        tables = {
            "chirp": make_chirp(cfg),
            "known_syms": lay.known_syms,
            "pilot_vals": lay.pilot_vals,
            "sc_sym": lay.sc_sym,
            "scramble": lay.scramble,
            # wire order → coded-stream order: the deinterleaver, or none
            # for a config that sends its coded bits uninterleaved
            "fec_index": (np.asarray(interleave_bits(
                cfg, np.arange(cfg.raw_bits_per_frame), inverse=True))
                if cfg.interleave else np.arange(cfg.raw_bits_per_frame)),
        }
        (tables["demap_used"], tables["demap_bits"],
         tables["demap_off"]) = demap_bin_tables(cfg)
        if cfg.est_taps:
            tables["denoise"] = denoise_projection(cfg)
        if _isi_operator(cfg) is not None:
            tables["isi_M"], tables["isi_q"], _ = _isi_operator(cfg)
        if self._code is not None:
            tables["ldpc_parity"] = self._code.P
        for name, arr in tables.items():
            self.register_buffer(name, torch.as_tensor(np.array(arr)))
        self._set_fec_tables()
        self.to(torch.device("cuda" if device is None else device))

    @property
    def device(self) -> torch.device:
        return self.chirp.device

    # ------------------------------------------------------------ transmit
    def _fec_coded_bits(self, info_bits: torch.Tensor) -> torch.Tensor:
        """Info bits (..., payload_bits) → coded-STREAM bits (..., raw_bits)
        uint8: the FEC codewords and their pad, before scrambling and
        interleaving (the domain `coded_stream_llr` demaps into)."""
        cfg = self.cfg
        coded = info_bits.to(torch.uint8)
        if cfg.fec != "ldpc":
            return coded
        *lead, _ = info_bits.shape
        u = coded.reshape(*lead, cfg.n_codewords, cfg.ldpc_k)
        coded = self._code.encode(u, self.ldpc_parity).reshape(
            *lead, cfg.n_codewords * cfg.ldpc_n)
        pad = cfg.raw_bits_per_frame - coded.shape[-1]
        return torch.nn.functional.pad(coded, (0, pad))

    def fec_encode(self, info_bits: torch.Tensor) -> torch.Tensor:
        """Info bits (..., payload_bits_per_frame) → scrambled, interleaved
        channel bits (..., raw_bits_per_frame) uint8."""
        coded = self._fec_coded_bits(info_bits) ^ self.scramble
        return interleave_bits(self.cfg, coded) if self.cfg.interleave else coded

    def modulate_frames(self, info_bits: torch.Tensor) -> torch.Tensor:
        """(..., payload_bits_per_frame) uint8 → (..., frame_len) float32:
        FEC → QAM map → pilots and known symbols → irfft + CP → chirp and
        SC preamble."""
        cfg = self.cfg
        syms = frame_bin_matrix(
            cfg, data_symbols_from_bits(cfg, self.fec_encode(info_bits),
                                        self.pilot_vals), self.known_syms)
        ofdm = ofdm_modulate(cfg, syms)
        *lead, _ = ofdm.shape
        parts = [self.chirp.to(torch.float32).expand(*lead, cfg.chirp_len)]
        if cfg.use_schmidl_cox:
            sc = ofdm_modulate(cfg, self.sc_sym[None, :])
            parts.append(sc.expand(*lead, cfg.symbol_len))
        parts.append(ofdm)
        return torch.cat(parts, dim=-1)

    def _info_bits(self, payload: bytes, filename: str, seq: int = 0,
                   total: int = 1) -> np.ndarray:
        cap = self.cfg.payload_bits_per_frame
        bits = bytes_to_bits(pack_header(payload, filename, seq=seq,
                                         total=total))
        if bits.size > cap:
            raise ValueError(
                f"payload needs {bits.size} info bits; frame carries {cap} "
                f"(≤ {cap // 8} bytes incl. header)")
        out = np.zeros(cap, dtype=np.uint8)
        out[: bits.size] = bits
        return out

    @torch.no_grad()
    def encode(self, payload: bytes, filename: str = "", seq: int = 0,
               total: int = 1) -> np.ndarray:
        """bytes → float32 waveform (single frame)."""
        info = torch.as_tensor(self._info_bits(payload, filename, seq, total),
                               device=self.device)
        return self.modulate_frames(info).cpu().numpy()

    @torch.no_grad()
    def encode_batch(self, payloads: Sequence[bytes],
                     filenames: Optional[Sequence[str]] = None,
                     seqs: Optional[Sequence[int]] = None,
                     total: int = 1) -> np.ndarray:
        """List of payloads → (B, frame_len) float32 waveforms."""
        filenames = filenames or [""] * len(payloads)
        seqs = seqs if seqs is not None else [0] * len(payloads)
        bits = np.stack([self._info_bits(p, f, s, total)
                         for p, f, s in zip(payloads, filenames, seqs)])
        info = torch.as_tensor(bits, device=self.device)
        return self.modulate_frames(info).cpu().numpy()

    # ------------------------------------------------------------- receive
    @property
    def _cut_block(self) -> int:
        """Grid of the coarse frame cut: the ≤ block-sample misalignment is
        derotated after the DFT, so backoff (cp//4) + block must stay within
        3·cp//4; capped at 128."""
        return max(1, min(128, self.cfg.cp // 2))

    def _cut_geom(self, rx: torch.Tensor, start: torch.Tensor):
        """(clamped cut base (...,), symbol count S, SC window offset)."""
        cfg = self.cfg
        T = rx.shape[-1]
        S = cfg.n_known_symbols + cfg.n_data_symbols
        cut_len = cfg.sc_len + S * cfg.symbol_len
        backoff = cfg.cp // 4
        # the cut reads whole blocks of the recording prefix: clamp the base
        # to the largest start it returns verbatim
        hi = min(max(T - cut_len, 0),
                 max_cut_start(T, cut_len, self._cut_block))
        base = torch.clamp(start + cfg.chirp_len - backoff, 0, hi)
        base = torch.broadcast_to(base, rx.shape[:-1])
        return base, S, self._cut_geom_sc_off()

    def _cut_geom_sc_off(self) -> int:
        """SC window offset within the cut window (−1 without SC): the
        ±block misalignment centred inside the SC guard budget."""
        cfg = self.cfg
        return (cfg.cp + cfg.cp // 4 + self._cut_block // 2
                if cfg.use_schmidl_cox else -1)

    def _cut_frame(self, rx: torch.Tensor, start: torch.Tensor):
        """Sync position → (syms (B, S, n_fft) on the flat batch, SC window
        (..., n_fft) or None, roll (B,))."""
        cfg = self.cfg
        with span("cut"):
            base, S, sc_off = self._cut_geom(rx, start)
            syms, sc_win, roll = cut_symbols(
                rx, base, S=S, n_fft=cfg.n_fft, sym_len=cfg.symbol_len,
                cp=cfg.cp, body_off=cfg.sc_len, sc_off=sc_off,
                block=self._cut_block)
            return syms.reshape(-1, S, cfg.n_fft), sc_win, roll.reshape(-1)

    def _fused_cut_refuses(self, T: int) -> bool:
        """Whether gf3x's fused cut kernels refuse this config's cut of a
        length-T recording (`ops.sync.fused_cut_refuses`)."""
        cfg = self.cfg
        S = cfg.n_known_symbols + cfg.n_data_symbols
        sc_off = self._cut_geom_sc_off()
        return fused_cut_refuses(T, S=S, n_fft=cfg.n_fft,
                                 sym_len=cfg.symbol_len, cp=cfg.cp,
                                 body_off=cfg.sc_len, sc_off=sc_off,
                                 block=self._cut_block)

    def _takes_cut_dft(self, T: int) -> bool:
        """Whether `use_cut_dft` takes kernel 8 for a length-T recording:
        gf3x's fused cut must take the geometry (its cut_dft_spectra yields
        where `_fused_cut_refuses`), and kernel 8 its n_fft
        (`cut_dft.takes`: a power of two up to 4096; gf3x's declines those
        above by its VMEM budget). Both are static in the config."""
        return not self._fused_cut_refuses(T) and _cut_dft.takes(self.cfg)

    def _cut_dft_frame(self, rx: torch.Tensor, start: torch.Tensor):
        """Fused cut + used-band DFT + deroll (kernel 8), the same cut as
        `_cut_frame`: sync position → (Y (B, S, n_used) derolled spectra on
        the flat batch, SC window or None)."""
        cfg = self.cfg
        with span("cut_dft"):
            base, S, sc_off = self._cut_geom(rx, start)
            Y, sc_win = cut_dft_spectra(cfg, rx, base, S=S,
                                        body_off=cfg.sc_len, sc_off=sc_off,
                                        block=self._cut_block)
            return Y.reshape(-1, S, cfg.n_used), sc_win

    def _sym_matrix(self, body: torch.Tensor) -> torch.Tensor:
        """CP-aligned OFDM body (..., S·symbol_len) → CP-stripped symbols
        (..., S, n_fft)."""
        cfg = self.cfg
        *lead, T = body.shape
        S = T // cfg.symbol_len
        return body.reshape(*lead, S, cfg.symbol_len)[..., cfg.cp:]

    def _spectra(self, syms: torch.Tensor, delta=None, roll=None):
        """CP-stripped symbols (B, K+D, n_fft) → derolled used-band spectra
        (B, K+D, n_used); δ-warped when `delta` is given."""
        with span("dft"):
            return deroll(self.cfg, ofdm_dft(self.cfg, syms, delta), roll)

    def _chanest(self, Y: torch.Tensor, delta=None):
        """Spectra (B, K+D, U) → (H, noise_var, isi_var, isi_ratio): the LS
        estimate, denoise and ISI profile on the K known symbols."""
        with span("chanest"):
            H, noise_var, (isi_var, isi_ratio) = estimate_channel(
                self.cfg, Y[:, : self.cfg.n_known_symbols], delta,
                with_isi=True, known_syms=self.known_syms,
                P=getattr(self, "denoise", None),
                M=getattr(self, "isi_M", None), q=getattr(self, "isi_q", None))
        return H, noise_var, isi_var, isi_ratio

    def _estimate(self, syms: torch.Tensor, roll=None, delta=None):
        """CP-stripped symbols (B, K+D, n_fft) → (Y (B, K+D, n_used)
        derolled spectra, H, noise_var, isi_var, isi_ratio)."""
        Y = self._spectra(syms, delta, roll)
        return (Y, *self._chanest(Y, delta))

    def _tail_route(self) -> str:
        """The EQ/demap tail of this config (gf3x's `_tail_route`), static:
        'split' (kernels A and B) for a bit-loaded config, 'fused' (kernel
        2, which takes every uniform order up to 64-QAM) otherwise."""
        return "split" if self.cfg.bit_loading is not None else "fused"

    def _fused_eq_demap(self, Y: torch.Tensor, H: torch.Tensor,
                        noise_var: torch.Tensor):
        """Post-estimate tail on kernel 2: Y (B, K+D, U), H (B, U),
        noise_var (B,) → (llr (B, raw_bits), slope, cpe, evm, mean|llr|)."""
        return fused_eq_demap(self.cfg, Y, H, noise_var, self.pilot_vals)

    def _split_eq_demap(self, Y: torch.Tensor, H: torch.Tensor,
                        noise_var: torch.Tensor):
        """The same tail on the split pair, for any config (uniform too):
        kernel A equalizes, tracks and derotates, kernel B demaps each data
        bin at its order with the modem's per-bin tables. Same return
        contract as `_fused_eq_demap`. Each kernel has its span, and counts
        from shapes the frames it equalizes and the LLRs it demaps."""
        with span("eq_track"):
            count("eq_track.rows", Y.shape[0])
            eq, slope, cpe, nv_sym = eq_track(self.cfg, Y, H, noise_var,
                                              self.pilot_vals)
        with span("demap_bins"):
            count("demap_bins.llrs", Y.shape[0] * self.cfg.raw_bits_per_frame)
            llr, evm, mabs = demap_bins(
                self.cfg, eq, H, nv_sym,
                (self.demap_used, self.demap_bits, self.demap_off))
        return llr, slope, cpe, evm, mabs

    def _tail(self, Y: torch.Tensor, H: torch.Tensor,
              noise_var: torch.Tensor):
        """The config's EQ/demap tail (`_tail_route`)."""
        with span("eq_demap"):
            if self._tail_route() == "split":
                return self._split_eq_demap(Y, H, noise_var)
            return self._fused_eq_demap(Y, H, noise_var)

    def _demod_spectra(self, Y: torch.Tensor, delta=None):
        """Derolled spectra (B, K+D, n_used) → (llr (B, raw_bits), (H,
        noise_var, slope, cpe, evm, mean|llr|, isi_var, isi_ratio)): the
        channel estimate, then the config's EQ/demap tail."""
        H, noise_var, isi_var, isi_ratio = self._chanest(Y, delta)
        llr, slope, cpe, evm, mabs = self._tail(Y, H, noise_var)
        return llr, (H, noise_var, slope, cpe, evm, mabs, isi_var, isi_ratio)

    def _demod_syms(self, syms: torch.Tensor, delta=None, roll=None):
        """CP-stripped symbols (B, K+D, n_fft) → `_demod_spectra`'s
        contract; `delta` warps the DFT, `roll` derotates a block-grid
        cut."""
        return self._demod_spectra(self._spectra(syms, delta, roll), delta)

    def _demod_prewindowed(self, body: torch.Tensor, delta=None, roll=None):
        """A CP-aligned OFDM body (B, (K+D)·symbol_len) through
        `_demod_syms`."""
        return self._demod_syms(self._sym_matrix(body), delta, roll)

    def _decided_bins(self, llr: torch.Tensor) -> torch.Tensor:
        """The tail's scrambled wire-order LLRs (B, raw_bits) → the decided
        TX bins of the data symbols (B, D, n_used), pilots exact: gf3x's
        `_xla_demap` hard decisions (Xd) with the pilots interleaved."""
        cfg = self.cfg
        B, D = llr.shape[0], cfg.n_data_symbols
        if cfg.bit_loading is not None:
            bits = hard_bits(llr.reshape(B, D, cfg.bits_per_ofdm_symbol))
            Xd = loaded_qam_map(cfg, bits)
        else:
            bits = hard_bits(llr.reshape(B, D, cfg.n_data_bins,
                                         cfg.bits_per_symbol))
            Xd = qam_map(bits, cfg.bits_per_symbol)
        return interleave_pilots(cfg, Xd, self.pilot_vals)

    def _demod_syms_dd(self, syms: torch.Tensor, delta=None, roll=None):
        """Two-pass decision-directed demod, the CRC-failure retry: Ĥ is
        re-estimated from all D data symbols' first-pass decisions (pilots
        exact) after derotating each by its measured phase, blended with
        the known-symbol estimate by observation count (K·Ĥ + D·Ĥ_dd)/(K+D),
        and the tail runs again. Both passes run the config's tail kernel,
        whose values equal gf3x's XLA tail. Same contract as
        `_demod_syms`."""
        cfg = self.cfg
        K, D = cfg.n_known_symbols, cfg.n_data_symbols
        Y = self._spectra(syms, delta, roll)
        H, noise_var, isi_var, isi_ratio = self._chanest(Y, delta)
        llr, slope, cpe, _, _ = self._tail(Y, H, noise_var)
        with span("dd_estimate"):
            Xhat = self._decided_bins(llr)
            kk = torch.arange(cfg.n_used, dtype=torch.float32,
                              device=Y.device)
            ph = slope[..., None] * kk + cpe[..., None]         # (B, D, U)
            Yd = Y[:, K:] * torch.exp(-1j * ph)
            H_dd = (torch.sum(Yd * torch.conj(Xhat), dim=-2)
                    / torch.clamp(torch.sum(torch.abs(Xhat) ** 2, dim=-2),
                                  min=1e-12))
            H2 = (K * H + D * H_dd) / (K + D)
        llr, slope, cpe, evm, mabs = self._tail(Y, H2, noise_var)
        return llr, (H2, noise_var, slope, cpe, evm, mabs, isi_var,
                     isi_ratio)

    def _two_pass_delta(self, syms: torch.Tensor,
                        sc_win: Optional[torch.Tensor], roll=None):
        """The clock-offset loop, coarse → fine: the SC estimate δ₀ seeds a
        δ₀-warped demod, whose pilot slopes give δ̂ (they measure the whole
        drift, not the residual). Rows combine by median, so one
        burst-destroyed frame cannot drag the shared estimate: one scalar
        δ̂, one TX/RX clock pair per call."""
        cfg = self.cfg
        with span("clock_offset"):
            if sc_win is not None:
                d0 = _median(sc_clock_offset(cfg, sc_win))
            else:
                d0 = torch.zeros((), device=syms.device)
            _, (_, _, slope_a, *_) = self._demod_syms(syms, delta=d0,
                                                      roll=roll)
            return _median(slope_clock_offset(cfg, slope_a))

    def _set_fec_tables(self) -> None:
        """The tables derived from `fec_index`, whose entries the card's
        kernels trust (checked here to lie in the frame): for every config
        the histogram's sorted sample table (the `hist_index` buffer,
        `llr_hist`); with LDPC the FEC gather's, the codewords' part as
        int32 (`codeword_index`) and, where that is the reversal of the
        interleaver's three axes (D, B2, A2), those axes, with which the
        card takes the tiled kernel (`fec_gather`)."""
        cfg = self.cfg
        fi = self.fec_index
        if fi.numel() and not (0 <= int(fi.min())
                               and int(fi.max()) < cfg.raw_bits_per_frame):
            raise ValueError("fec_index: entries must lie in [0, raw_bits)")
        self._set_table("hist_index", sample_table(fi))
        if self._code is None:
            return
        idx = fi[:cfg.n_codewords * cfg.ldpc_n].to(torch.int32)
        self._set_table("codeword_index", idx)
        A2, B2 = scatter_factors(cfg.bits_per_ofdm_symbol)
        axes = (cfg.n_data_symbols, B2, A2)
        rev = reversal_index(*axes)[:idx.numel()]
        self._fec_axes = (axes if np.array_equal(idx.cpu().numpy(), rev)
                          else None)

    def _set_table(self, name: str, value: torch.Tensor) -> None:
        """Buffer `name` := value: registered at construction, rewritten in
        place (on its device) afterwards."""
        if name in self._buffers:
            self.get_buffer(name).copy_(value)
        else:
            self.register_buffer(name, value)

    def _codeword_llrs(self, llr: torch.Tensor) -> torch.Tensor:
        """Scrambled wire-order LLRs (B, raw_bits) → descrambled LLRs in
        codeword order (B·ncw, n): the FEC ingest, one static gather
        (deinterleave) with the descrambler sign folded in (`fec_gather`:
        one pass on the card)."""
        with span("fec_gather"):
            lam = fec_gather(llr, self.codeword_index, self.scramble,
                             self._fec_axes)
            return lam.reshape(-1, self.cfg.ldpc_n)

    def coded_stream_llr(self, llr: torch.Tensor) -> torch.Tensor:
        """The tails' scrambled wire-order LLRs (..., raw_bits) →
        descrambled LLRs in coded-STREAM order (..., raw_bits), positive ⇒
        the coded bit is 0: gf3x's `coded_stream_llr`, the canonical
        layout LLRs are compared and chase-combined in."""
        return llr[..., self.fec_index] * (
            1.0 - 2.0 * self.scramble.to(torch.float32))

    def _payload_bits(self, llr: torch.Tensor):
        """Scrambled wire-order LLRs (B, raw_bits) → (info bits (B,
        payload_bits) uint8, fec_iters (B,), fec_unsat (B,), llr_hist
        (B, 16)); kernel 3 decodes the codewords."""
        cfg = self.cfg
        B = llr.shape[0]
        with span("diag"), span("llr_hist"):
            count("llr_hist.samples", B * self.hist_index.shape[0])
            hist = llr_hist(llr, self.hist_index)
        if cfg.fec != "ldpc":
            with span("fec_gather"):
                zeros = torch.zeros(B, dtype=torch.int32, device=llr.device)
                bits = hard_bits(self.coded_stream_llr(llr))
            return bits, zeros, zeros, hist
        ncw, k = cfg.n_codewords, cfg.ldpc_k
        lam = self._codeword_llrs(llr)
        with span("ldpc"):
            tot, unsat, passes = self._code.decode_totals(lam, cfg.ldpc_iters)
            del lam   # freed before the bits are taken (the step's peak)
            bits = (tot[:, :k] < 0).to(torch.uint8).reshape(B, ncw * k)
            iters = passes.reshape(B, ncw).amax(dim=1)
            unsat = unsat.reshape(B, ncw).sum(dim=1, dtype=torch.int32)
        return bits, iters, unsat, hist

    def _finish(self, out, lead: tuple, start: torch.Tensor,
                metric: torch.Tensor, sc_win: Optional[torch.Tensor]):
        """A demod's (llr, pieces) on the flat batch → (bits (...,
        payload_bits), DecodeDiag) in the caller's lead shape: FEC, then
        the diagnostics."""
        cfg = self.cfg
        llr, (H, nv, slope, cpe, evm, mabs, isi_var, isi_ratio) = out
        bits, fec_iters, fec_unsat, hist = self._payload_bits(llr)
        with span("diag"):
            sc = (sc_metric_window(cfg, sc_win) if sc_win is not None
                  else torch.zeros(lead, device=llr.device))
            shape = lambda t, *tl: t.reshape(tuple(lead) + tl)  # noqa: E731
            # pilot slopes measure the whole timing drift on warped and
            # plain passes alike, so clock_ppm needs no δ added
            diag = DecodeDiag(
                sync_start=torch.broadcast_to(start, lead).to(torch.int32),
                sync_metric=torch.broadcast_to(metric, lead).to(
                    torch.float32),
                sc_metric=sc.to(torch.float32),
                H=shape(H, cfg.n_used), noise_var=shape(nv),
                pilot_slope=shape(slope, cfg.n_data_symbols),
                common_phase=shape(cpe, cfg.n_data_symbols),
                evm=shape(evm), mean_abs_llr=shape(mabs),
                clock_ppm=shape(slope_clock_offset(cfg, slope) * 1e6),
                fec_iters=shape(fec_iters), fec_unsat=shape(fec_unsat),
                isi_var=shape(isi_var, cfg.n_used),
                isi_db=shape(10.0 * torch.log10(isi_ratio + 1e-12)),
                llr_hist=shape(hist, 16),
            )
            return shape(bits, bits.shape[-1]), diag

    def _demod_synced(self, rx: torch.Tensor, start: torch.Tensor,
                      metric: torch.Tensor, sfo_correct: bool = False,
                      dd: bool = False):
        """Shared tail once the frame start is known: cut → demap → FEC →
        DecodeDiag. rx (..., T), start (...,) or scalar; the routes are
        `_demod_llr`'s."""
        out, sc_win = self._demod_llr(rx, start, sfo_correct, dd)
        return self._finish(out, tuple(rx.shape[:-1]), start, metric, sc_win)

    def _demod_llr(self, rx: torch.Tensor, start: torch.Tensor,
                   sfo_correct: bool = False, dd: bool = False):
        """Cut and demodulate frames whose chirp onset is `start`: rx
        (..., T), start (...,) or scalar → (`_demod_spectra`'s (llr (B,
        raw_bits), pieces) on the flat batch, SC window or None).
        `sfo_correct` inserts the clock-offset loop, `dd` takes the
        decision-directed demod; the plain route takes kernel 8 when
        `use_cut_dft` is set and the geometry suits gf3x's fused cut and
        kernel 8 (`_takes_cut_dft`; the other two re-demodulate the symbol
        matrix, so they keep the two-stage cut)."""
        if (self.use_cut_dft and not sfo_correct and not dd
                and self._takes_cut_dft(rx.shape[-1])):
            Y, sc_win = self._cut_dft_frame(rx, start)
            out = self._demod_spectra(Y)
        else:
            syms, sc_win, roll = self._cut_frame(rx, start)
            delta = (self._two_pass_delta(syms, sc_win, roll)
                     if sfo_correct else None)
            demod = self._demod_syms_dd if dd else self._demod_syms
            out = demod(syms, delta=delta, roll=roll)
        return out, sc_win

    def _sync(self, rx: torch.Tensor):
        """Chirp sync of (..., T): bounded and 2× decimated with
        `max_delay`."""
        with span("sync"):
            return find_frame_start(
                self.cfg, rx, self.chirp, search_len=self.max_delay,
                decimate=self._sync_decimate if self.max_delay else 1)

    @torch.no_grad()
    def demodulate(self, rx: torch.Tensor):
        """Full receive path: sync → cut → DFT → LS estimate → EQ/track/
        demap → FEC. rx (..., T) float32 → (bits (..., payload_bits) uint8,
        DecodeDiag). With `max_delay` the sync correlates only the
        recording prefix, 2× decimated."""
        with span("demodulate"):
            return self._demod_synced(rx, *self._sync(rx))

    @torch.no_grad()
    def demodulate_at(self, rx: torch.Tensor, start, sfo_correct: bool = False,
                      dd: bool = False):
        """Decode with a known chirp onset `start` (loopback paths)."""
        with span("demodulate_at"):
            with span("sync"):
                start = torch.as_tensor(start, dtype=torch.int32,
                                        device=rx.device)
                inf = torch.full((), float("inf"), device=rx.device)
            return self._demod_synced(rx, start, inf,
                                      sfo_correct=sfo_correct, dd=dd)

    @torch.no_grad()
    def demodulate_dd(self, rx: torch.Tensor):
        """The receive path through the decision-directed two-pass demod,
        the CRC-failure retry `decode(dd='auto')` takes."""
        with span("demodulate_dd"):
            return self._demod_synced(rx, *self._sync(rx), dd=True)

    @torch.no_grad()
    def demodulate_sfo(self, rx: torch.Tensor):
        """Clock-offset-robust receive: chirp sync, then the SC coarse δ̂ →
        warped-DFT demod → pilot-slope δ̂ → final warped demod. One δ̂ for
        the whole batch (one TX/RX clock pair)."""
        with span("demodulate_sfo"):
            return self._demod_synced(rx, *self._sync(rx), sfo_correct=True)

    @torch.no_grad()
    def demodulate_sc(self, rx: torch.Tensor, sfo_correct: bool = False,
                      dd: bool = False):
        """The receive path synced by the Schmidl–Cox plateau instead of the
        chirp (the fallback when the chirp is clipped or collided);
        diag.sc_metric is the plateau's peak."""
        with span("demodulate_sc"):
            with span("sync"):
                start, sc_peak = find_frame_start_sc(self.cfg, rx)
                nan = torch.full((), float("nan"), device=rx.device)
            bits, diag = self._demod_synced(rx, start, nan,
                                            sfo_correct=sfo_correct, dd=dd)
            with span("diag"):
                return bits, diag._replace(
                    sc_metric=sc_peak.to(torch.float32))

    @torch.no_grad()
    def demodulate_prewindowed(self, windows: torch.Tensor,
                               sfo_correct: bool = False):
        """Decode frames already cut at their chirp onset: windows
        (..., frame_len) → (bits, DecodeDiag). The body is a static slice
        (the streaming receiver cuts windows on the host), so no cut kernel
        runs; `sfo_correct` inserts the clock-offset loop."""
        cfg = self.cfg
        lead = tuple(windows.shape[:-1])
        B = int(np.prod(lead))
        need = (cfg.n_known_symbols + cfg.n_data_symbols) * cfg.symbol_len
        a = cfg.preamble_len - cfg.cp // 4   # a + need = frame_len − backoff
        with span("demodulate_prewindowed"):
            with span("cut"):
                syms = self._sym_matrix(
                    windows[..., a: a + need].reshape(B, need))
                sc_win = None
                if cfg.use_schmidl_cox:
                    o = cfg.chirp_len + cfg.cp   # SC body within the window
                    sc_win = windows[..., o: o + cfg.n_fft]
            delta = (self._two_pass_delta(syms, sc_win) if sfo_correct
                     else None)
            with span("sync"):
                zeros = torch.zeros(lead, dtype=torch.int32,
                                    device=windows.device)
                inf = torch.full((), float("inf"), device=windows.device)
            return self._finish(self._demod_syms(syms, delta=delta), lead,
                                zeros, inf, sc_win)

    # --------------------------------------------------------- host wrappers
    def _result(self, bits: np.ndarray, diag) -> DecodeResult:
        stream = bits_to_bytes(bits)
        try:
            h = parse_frame_header(stream)
        except ValueError:
            return DecodeResult(payload=b"", filename="", crc_ok=False,
                                bits=bits, diag=diag)
        return DecodeResult(payload=h.payload, filename=h.filename,
                            crc_ok=h.crc_ok, bits=bits, diag=diag,
                            seq=h.seq, total=h.total)

    def _host_result(self, bits: torch.Tensor, diag) -> DecodeResult:
        """One frame's device (bits, DecodeDiag) → DecodeResult with the
        diagnostics as NumPy arrays."""
        host = DecodeDiag(*(t.cpu().numpy() for t in diag))
        return self._result(bits.cpu().numpy(), host)

    def decode(self, rx: np.ndarray, start: Optional[int] = None,
               sync: str = "chirp", sfo: str = "auto",
               dd: str = "auto") -> DecodeResult:
        """waveform → DecodeResult, with gf3x's routes and retry policy.
        `start` overrides the sync (loopback); sync='sc' times the frame by
        the Schmidl–Cox plateau instead of the chirp.

        sfo: 'off' | 'auto' | 'on' — the clock-offset loop
        (`demodulate_sfo`). 'auto' retries through it when the plain decode
        fails CRC or reports |clock_ppm| beyond `SLOPE_PPM_RANGE`.

        dd: 'off' | 'auto' | 'on' — the decision-directed demod
        (`_demod_syms_dd`). 'auto' retries it once when everything else
        failed CRC and the channel shows a measurable tail (max isi_db
        > −25 dB); 'on' decodes through it directly, without the
        clock-offset loop (gf3x's limit, kept for parity)."""
        if sync not in ("chirp", "sc"):
            raise ValueError(f"unknown sync method {sync!r}; use 'chirp' or "
                             "'sc'")
        x = torch.as_tensor(np.asarray(rx, dtype=np.float32),
                            device=self.device)
        if dd == "on":
            if start is not None:
                out = self.demodulate_at(x, start, dd=True)
            elif sync == "sc":
                out = self.demodulate_sc(x, dd=True)
            else:
                out = self.demodulate_dd(x)
            return self._host_result(*out)
        correct = sfo == "on"
        if start is not None:
            out = self.demodulate_at(x, start, sfo_correct=correct)
        elif sync == "sc":
            out = self.demodulate_sc(x, sfo_correct=correct)
        elif correct:
            out = self.demodulate_sfo(x)
        else:
            out = self.demodulate(x)
        res = self._host_result(*out)
        if (sfo == "auto" and self.cfg.use_schmidl_cox
                and auto_retry_needed(res.crc_ok, res.diag.clock_ppm)):
            retry = self.decode(rx, start=start, sync=sync, sfo="on",
                                dd="off")
            if prefer_retry(res.crc_ok, retry.crc_ok):
                return retry
        if (dd == "auto" and not res.crc_ok
                and float(np.max(res.diag.isi_db)) > -25.0):
            retry = self.decode(rx, start=start, sync=sync, sfo="off",
                                dd="on")
            if retry.crc_ok:
                return retry
        return res

    # ---------------------------------------------- HARQ (chase combining)
    def _cut_one(self, rx, start: int):
        """One recording's cut on the modem's device: (syms (1, S, n_fft),
        SC window (1, n_fft) or None, roll (1,)) — a batch of one, so
        kernel 7 cuts it, as gf3x's `cut_symbols` does."""
        x = torch.as_tensor(np.asarray(rx, dtype=np.float32),
                            device=self.device)
        s = torch.as_tensor(int(start), dtype=torch.int32, device=self.device)
        return self._cut_frame(x[None], s)

    @torch.no_grad()
    def coded_llrs(self, rx: np.ndarray, start: int,
                   sfo_correct: bool = False,
                   delta: Optional[float] = None) -> np.ndarray:
        """One reception's descrambled coded-stream LLRs
        (raw_bits_per_frame,) float32 — the soft input `chase_combine` sums
        over repeated receptions of one frame (the tails scale LLRs by
        1/σ², so the plain sum is maximum-ratio combining). `delta`
        demodulates through the δ-warped DFT at a known clock offset (the
        joint estimate of `joint_clock_offset`); `sfo_correct` estimates δ
        from this reception alone through the two-pass loop."""
        syms, sc_win, roll = self._cut_one(rx, start)
        if delta is not None:
            d = torch.as_tensor(delta, dtype=torch.float32,
                                device=self.device)
        elif sfo_correct:
            d = self._two_pass_delta(syms, sc_win, roll)
        else:
            d = None
        llr, _ = self._demod_syms(syms, delta=d, roll=roll)
        return self.coded_stream_llr(llr)[0].cpu().numpy()

    @torch.no_grad()
    def joint_clock_offset(self, receptions) -> float:
        """One shared δ̂ from every reception of a frame (the copies ride
        one TX/RX clock pair, so the offset is one unknown): each
        reception is cut alone, the SC per-bin correlations of all of them
        sum coherently before the phase read (`sc_clock_offset(pool=
        True)`), and one δ₀-warped demod of the stacked receptions gives
        pilot slopes per row, combined by their median (gf3x's midpoint
        median). receptions: iterable of (recording, chirp onset)."""
        cuts = [self._cut_one(rx, start) for rx, start in receptions]
        syms = torch.cat([c[0] for c in cuts])
        roll = torch.cat([c[2] for c in cuts])
        if cuts[0][1] is not None:
            d0 = sc_clock_offset(self.cfg, torch.cat([c[1] for c in cuts]),
                                 pool=True)
        else:
            d0 = torch.zeros((), device=self.device)
        _, (_, _, slope, *_) = self._demod_syms(syms, delta=d0, roll=roll)
        return float(_median(slope_clock_offset(self.cfg, slope)))

    @torch.no_grad()
    def decode_stream_llr(self, llr: np.ndarray) -> DecodeResult:
        """Descrambled coded-stream LLRs (raw_bits_per_frame,) →
        DecodeResult: the FEC decode (kernel 3 on the modem's device, in
        float32 where gf3x runs its NumPy float64 min-sum) and the header
        parse, no demodulation — `chase_combine`'s tail on summed LLRs."""
        cfg = self.cfg
        llr = np.asarray(llr, dtype=np.float32)
        if cfg.fec != "ldpc":
            return self._result((llr < 0).astype(np.uint8), None)
        used = cfg.n_codewords * cfg.ldpc_n
        lam = torch.tensor(llr[:used], device=self.device).reshape(
            cfg.n_codewords, cfg.ldpc_n)
        info, _, _ = self._code.decode(lam, cfg.ldpc_iters)
        return self._result(info.reshape(-1).cpu().numpy(), None)

    @torch.no_grad()
    def equalized_symbols(self, rx: np.ndarray,
                          start: Optional[int] = None) -> np.ndarray:
        """The equalized, phase-tracked data symbols of recordings rx
        (..., T) → (..., D, n_data_bins) complex64, for constellation plots
        and analysis: the chirp sync over the whole recording (or the given
        `start`), the cut, the DFT, the channel estimate and kernel A's
        EQ/tracking (`eq_track`), then the data bins."""
        cfg = self.cfg
        x = torch.as_tensor(np.asarray(rx, dtype=np.float32),
                            device=self.device)
        lead = tuple(x.shape[:-1])
        x = x.reshape(-1, x.shape[-1])
        if start is None:
            s, _ = find_frame_start(cfg, x, self.chirp)
        else:
            s = torch.as_tensor(int(start), dtype=torch.int32,
                                device=self.device)
        syms, _, roll = self._cut_frame(x, s)
        Y, H, noise_var, _, _ = self._estimate(syms, roll)
        eq, _, _, _ = eq_track(cfg, Y, H, noise_var, self.pilot_vals)
        _, data = split_pilots(cfg, eq)
        return data.reshape(*lead, *data.shape[1:]).cpu().numpy()

    def _host_results(self, bits: torch.Tensor,
                      diag) -> list[DecodeResult]:
        """A batch's device (bits (B, ·), DecodeDiag) → one DecodeResult
        per row, with one host copy per field."""
        bits = bits.cpu().numpy()
        host = [t.cpu().numpy() for t in diag]
        return [self._result(bits[i], DecodeDiag(*(f[i] for f in host)))
                for i in range(bits.shape[0])]

    def decode_batch(self, rx: np.ndarray) -> list[DecodeResult]:
        """(B, T) recordings → one DecodeResult per row, from one
        `demodulate` call (chirp sync, bounded by `max_delay` when set)."""
        x = torch.as_tensor(np.asarray(rx, dtype=np.float32),
                            device=self.device)
        return self._host_results(*self.demodulate(x))
