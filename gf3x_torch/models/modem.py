"""The modem as a torch module: batched `encode(bytes) → waveform` and the
chirp-synced receive path `demodulate` (counterpart of
gf3x/models/modem.py, plain route only).

Receive path of one (B, T) float32 batch:

    find_frame_start (bounded, 2× decimated when `max_delay` is set)
    → cut_symbols            kernel 1 (frame cut + CP strip)
    → ofdm_dft + deroll      cuFFT, one phase ramp for the block-grid roll
    → estimate_channel       LS + tap denoise + ISI profile on K symbols
    → the EQ/demap tail, by config (`_tail_route`):
        uniform:     fused_eq_demap       kernel 2 (EQ, pilot tracking, demap)
        bit-loaded:  eq_track → demap_bins  kernels A and B (the split tail)
    → one static gather      deinterleave + descramble into codewords
    → LDPC min-sum           kernel 3
    → info bits + DecodeDiag

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
from ..ops.constellation import hard_bits
from ..ops.kernels.fused_eq import fused_eq_demap
from ..ops.kernels.split_eq import demap_bins, eq_track
from ..ops.ofdm import ofdm_dft, ofdm_modulate
from ..ops.sfo import slope_clock_offset
from ..ops.sync import (cut_symbols, find_frame_start, max_cut_start,
                        sc_metric_window)
from ..utils.bits import (bits_to_bytes, bytes_to_bits, pack_header,
                          parse_frame_header)
from .frame import (data_symbols_from_bits, demap_bin_tables,
                    frame_bin_matrix, interleave_bits)

__all__ = ["Modem", "DecodeDiag", "DecodeResult"]

_NOT_PORTED = ("is not ported to gf3x_torch yet (ROADMAP queue 1, item 7: "
               "other decode routes)")


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

    >>> m = Modem(GF3_STANDARD, max_delay=4352, device="cuda")
    >>> bits, diag = m.demodulate(rx)            # (B, T) float32 on the card
    >>> res = m.decode(recording)                # np waveform → DecodeResult
    """

    def __init__(self, cfg: ModemConfig, max_delay: Optional[int] = None,
                 device=None):
        """`max_delay` (samples) bounds the frame onset the sync searches
        for (the streaming receiver's case); None searches the recording."""
        super().__init__()
        self.cfg = cfg.validate()
        self.max_delay = max_delay
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
            "fec_index": np.asarray(interleave_bits(
                cfg, np.arange(cfg.raw_bits_per_frame), inverse=True)),
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
        if device is not None:
            self.to(device)

    @property
    def device(self) -> torch.device:
        return self.chirp.device

    # ------------------------------------------------------------ transmit
    def fec_encode(self, info_bits: torch.Tensor) -> torch.Tensor:
        """Info bits (..., payload_bits_per_frame) → scrambled, interleaved
        channel bits (..., raw_bits_per_frame) uint8."""
        cfg = self.cfg
        coded = info_bits.to(torch.uint8)
        if cfg.fec == "ldpc":
            *lead, _ = info_bits.shape
            u = info_bits.reshape(*lead, cfg.n_codewords, cfg.ldpc_k)
            coded = self._code.encode(u, self.ldpc_parity).reshape(
                *lead, cfg.n_codewords * cfg.ldpc_n)
            pad = cfg.raw_bits_per_frame - coded.shape[-1]
            coded = torch.nn.functional.pad(coded, (0, pad))
        coded = coded ^ self.scramble
        return interleave_bits(cfg, coded) if cfg.interleave else coded

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
        sc_off = (cfg.cp + backoff + self._cut_block // 2
                  if cfg.use_schmidl_cox else -1)
        return base, S, sc_off

    def _cut_frame(self, rx: torch.Tensor, start: torch.Tensor):
        """Sync position → (syms (..., S, n_fft), SC window or None, roll)."""
        cfg = self.cfg
        base, S, sc_off = self._cut_geom(rx, start)
        return cut_symbols(rx, base, S=S, n_fft=cfg.n_fft,
                           sym_len=cfg.symbol_len, cp=cfg.cp,
                           body_off=cfg.sc_len, sc_off=sc_off,
                           block=self._cut_block)

    def _deroll(self, Y: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
        """Undo an early window cut of `roll` samples:
        Y[k]·e^{+2πik·roll/N} (the CP makes the shift circular).
        Y: (..., S, n_used); roll: (...,) int."""
        cfg = self.cfg
        k = torch.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=torch.float32,
                         device=Y.device)
        ang = (np.float32(2.0 * np.pi / cfg.n_fft)
               * roll.to(torch.float32)[..., None, None] * k)
        return Y * torch.complex(torch.cos(ang), torch.sin(ang))

    @staticmethod
    def _hist16_of(x: torch.Tensor) -> torch.Tensor:
        """16-bin log2 bucket of each element: bucket k ⇔ |x| ∈
        [2^(k-2), 2^(k-1)), clipped to [0, 15] (zeros land in 0), read
        from the float exponent bits."""
        e = ((x.abs().view(torch.int32) >> 23) & 0xFF) - 125
        return torch.clamp(e, 0, 15)

    def _estimate(self, syms: torch.Tensor, roll=None):
        """CP-stripped symbols (B, K+D, n_fft) → (Y (B, K+D, n_used) derolled
        spectra, H, noise_var, isi_var, isi_ratio): DFT, deroll, LS
        estimate on the K known symbols."""
        cfg = self.cfg
        Y = ofdm_dft(cfg, syms)
        if roll is not None:
            Y = self._deroll(Y, roll)
        H, noise_var, (isi_var, isi_ratio) = estimate_channel(
            cfg, Y[:, : cfg.n_known_symbols], with_isi=True,
            known_syms=self.known_syms, P=getattr(self, "denoise", None),
            M=getattr(self, "isi_M", None), q=getattr(self, "isi_q", None))
        return Y, H, noise_var, isi_var, isi_ratio

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
        contract as `_fused_eq_demap`."""
        eq, slope, cpe, nv_sym = eq_track(self.cfg, Y, H, noise_var,
                                          self.pilot_vals)
        llr, evm, mabs = demap_bins(
            self.cfg, eq, H, nv_sym,
            (self.demap_used, self.demap_bits, self.demap_off))
        return llr, slope, cpe, evm, mabs

    def _demod_syms(self, syms: torch.Tensor, roll=None):
        """CP-stripped symbols (B, K+D, n_fft) → (llr (B, raw_bits),
        (H, noise_var, slope, cpe, evm, mean|llr|, isi_var, isi_ratio)):
        `_estimate`, then the config's EQ/demap tail."""
        Y, H, noise_var, isi_var, isi_ratio = self._estimate(syms, roll)
        tail = (self._split_eq_demap if self._tail_route() == "split"
                else self._fused_eq_demap)
        llr, slope, cpe, evm, mabs = tail(Y, H, noise_var)
        return llr, (H, noise_var, slope, cpe, evm, mabs, isi_var, isi_ratio)

    def _codeword_llrs(self, llr: torch.Tensor) -> torch.Tensor:
        """Scrambled wire-order LLRs (B, raw_bits) → descrambled LLRs in
        codeword order (B·ncw, n): the FEC ingest, one static gather
        (deinterleave) with the descrambler sign folded in."""
        cfg = self.cfg
        used = cfg.n_codewords * cfg.ldpc_n
        sign = 1.0 - 2.0 * self.scramble[:used].to(torch.float32)
        lam = llr[:, self.fec_index[:used]] * sign
        return lam.reshape(-1, cfg.ldpc_n)

    def _payload_bits(self, llr: torch.Tensor):
        """Scrambled wire-order LLRs (B, raw_bits) → (info bits (B,
        payload_bits) uint8, fec_iters (B,), fec_unsat (B,), llr_hist
        (B, 16)); kernel 3 decodes the codewords."""
        cfg = self.cfg
        B = llr.shape[0]
        bkt = self._hist16_of(llr[:, self.fec_index[::8]]).long()
        hist = torch.zeros(B, 16, dtype=torch.int32, device=llr.device)
        hist.scatter_add_(1, bkt, torch.ones_like(bkt, dtype=torch.int32))
        if cfg.fec != "ldpc":
            sign = 1.0 - 2.0 * self.scramble.to(torch.float32)
            zeros = torch.zeros(B, dtype=torch.int32, device=llr.device)
            return hard_bits(llr[:, self.fec_index] * sign), zeros, zeros, hist
        ncw, k = cfg.n_codewords, cfg.ldpc_k
        tot, unsat, passes = self._code.decode_totals(
            self._codeword_llrs(llr), cfg.ldpc_iters)
        bits = (tot[:, :k] < 0).to(torch.uint8).reshape(B, ncw * k)
        iters = passes.reshape(B, ncw).amax(dim=1)
        unsat = unsat.reshape(B, ncw).sum(dim=1, dtype=torch.int32)
        return bits, iters, unsat, hist

    def _demod_synced(self, rx: torch.Tensor, start: torch.Tensor,
                      metric: torch.Tensor):
        """Shared tail once the frame start is known: cut → demap → FEC →
        DecodeDiag. rx (..., T), start (...,) or scalar."""
        cfg = self.cfg
        lead = rx.shape[:-1]
        syms, sc_win, roll = self._cut_frame(rx, start)
        B = syms[..., 0, 0].numel()
        llr, (H, nv, slope, cpe, evm, mabs, isi_var, isi_ratio) = \
            self._demod_syms(syms.reshape(B, *syms.shape[-2:]),
                             roll.reshape(B))
        bits, fec_iters, fec_unsat, hist = self._payload_bits(llr)
        sc = (sc_metric_window(cfg, sc_win) if sc_win is not None
              else torch.zeros(lead, device=rx.device))
        shape = lambda t, *tail: t.reshape(tuple(lead) + tail)  # noqa: E731
        diag = DecodeDiag(
            sync_start=torch.broadcast_to(start, lead).to(torch.int32),
            sync_metric=torch.broadcast_to(metric, lead).to(torch.float32),
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

    @torch.no_grad()
    def demodulate(self, rx: torch.Tensor):
        """Full receive path: sync → cut → DFT → LS estimate → EQ/track/
        demap → FEC. rx (..., T) float32 → (bits (..., payload_bits) uint8,
        DecodeDiag). With `max_delay` the sync correlates only the
        recording prefix, 2× decimated."""
        start, metric = find_frame_start(
            self.cfg, rx, self.chirp, search_len=self.max_delay,
            decimate=self._sync_decimate if self.max_delay else 1)
        return self._demod_synced(rx, start, metric)

    @torch.no_grad()
    def demodulate_at(self, rx: torch.Tensor, start: torch.Tensor):
        """Decode with a known chirp onset `start` (loopback paths)."""
        start = torch.as_tensor(start, dtype=torch.int32, device=rx.device)
        inf = torch.full((), float("inf"), device=rx.device)
        return self._demod_synced(rx, start, inf)

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

    def decode(self, rx: np.ndarray, start: Optional[int] = None,
               sync: str = "chirp", sfo: str = "off",
               dd: str = "off") -> DecodeResult:
        """waveform → DecodeResult on the plain chirp route (`start`
        overrides the sync). The Schmidl–Cox sync, the clock-offset loop and
        the decision-directed retry are not ported yet."""
        if sync != "chirp":
            raise NotImplementedError(f"sync={sync!r} {_NOT_PORTED}")
        if sfo != "off":
            raise NotImplementedError(f"sfo={sfo!r} {_NOT_PORTED}")
        if dd != "off":
            raise NotImplementedError(f"dd={dd!r} {_NOT_PORTED}")
        x = torch.as_tensor(np.asarray(rx, dtype=np.float32),
                            device=self.device)
        if start is None:
            bits, diag = self.demodulate(x)
        else:
            bits, diag = self.demodulate_at(x, start)
        host = DecodeDiag(*(t.cpu().numpy() for t in diag))
        return self._result(bits.cpu().numpy(), host)

    def decode_batch(self, rx: np.ndarray) -> list[DecodeResult]:
        """(B, T) recordings → one DecodeResult per row, from one
        `demodulate` call (chirp sync, bounded by `max_delay` when set)."""
        x = torch.as_tensor(np.asarray(rx, dtype=np.float32),
                            device=self.device)
        bits, diag = self.demodulate(x)
        bits = bits.cpu().numpy()
        host = [t.cpu().numpy() for t in diag]
        return [self._result(bits[i], DecodeDiag(*(f[i] for f in host)))
                for i in range(bits.shape[0])]
