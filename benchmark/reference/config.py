# Frozen copy of gf3x_torch/config.py (NumPy only) for the benchmark's reference, which
# imports nothing of the program. Do not edit: the benchmark's yardstick.
"""Modem configuration — the GF3 "standard" parameter module.

The reference keeps a module of class-standard constants (fs=44100 Hz, FFT/CP
geometry, used-bin range, pilot layout, constellation, code rate) consumed by
every layer (SURVEY.md §2 cross-cutting row, §6.6; BASELINE.json:7-8). Here it
is a frozen, hashable dataclass so it can be a `jax.jit` static argument: all
frame geometry is compile-time constant, which keeps every shape in the traced
signal chain static (SURVEY.md §8 "Data-dependent control flow" risk).

All *derived* layout arrays (used-bin indices, pilot masks, known symbols) are
computed on the host with NumPy from the config and closed over as constants
by the jitted functions — they never become traced values.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np

__all__ = [
    "WIRE_FORMAT",
    "ModemConfig",
    "layout",
    "Layout",
    "GF3_STANDARD",
    "GF3_FAST",
    "GF3_TURBO",
    "GF3_HICAP",
    "GF3_ROBUST",
    "CONFIG1_LOOPBACK",
    "preset",
]


#: Wire-format version marker. Single source of truth for the fixture
#: manifest "format" field (tools/make_fixtures.py, tests/fixtures/) and the
#: version SPEC.md documents — bump it whenever an encode-side change breaks
#: decode compatibility with previously recorded audio.
#: v3: channel-bit block interleaver (config `interleave`).
WIRE_FORMAT = 3


@dataclass(frozen=True)
class ModemConfig:
    """Complete static description of the modem signal chain.

    Frozen + eq/hash by value → usable as a `static_argnums` jit argument and
    as an `lru_cache` key for derived layout tables.
    """

    # --- sampling / OFDM geometry (BASELINE.json:7-8: 44.1 kHz, 1024-pt FFT, CP 256)
    fs: int = 44100
    n_fft: int = 1024
    cp: int = 256

    # --- subcarrier allocation: used rfft bins are [bin_lo, bin_hi] inclusive,
    #     1 <= bin_lo <= bin_hi <= n_fft//2 - 1 (DC and Nyquist always zero;
    #     Hermitian symmetry is implicit in the rfft/irfft pair).
    #     n_used = 280 = 35·pilot_spacing → strided pilot layout (see
    #     `strided_pilots`): band ≈ 1.03–13.05 kHz at fs=44100/N=1024.
    bin_lo: int = 24
    bin_hi: int = 303

    # --- pilot layout: every `pilot_spacing`-th used bin (starting at
    #     `pilot_offset` within the used range) carries a known QPSK pilot.
    #     0 spacing disables pilots.
    pilot_spacing: int = 8
    pilot_offset: int = 0

    # --- constellation: bits per complex symbol (2=QPSK, 4=16QAM, 6=64QAM)
    bits_per_symbol: int = 2

    # --- frame schema (SURVEY.md Appendix "Frame")
    n_known_symbols: int = 4       # channel-estimation preamble OFDM symbols
    n_data_symbols: int = 16       # payload OFDM symbols per frame (static)
    use_schmidl_cox: bool = True   # include a repeated-half SC symbol after the chirp

    # --- chirp preamble (SURVEY.md Appendix "Chirp sync")
    chirp_f0: float = 1000.0
    chirp_f1: float = 10000.0
    chirp_duration: float = 0.25   # seconds
    chirp_fade: float = 0.005      # raised-cosine fade-in/out, seconds
    chirp_amplitude: float = 0.5

    # --- waveform scaling
    ofdm_amplitude: float = 0.18   # target RMS of each OFDM symbol's samples

    # --- channel-estimate denoising (SURVEY.md:132 "optional fine timing
    #     from estimated impulse response" family): project the LS Ĥ onto
    #     the subspace of ≤ est_taps time-domain taps (noise reduction
    #     ≈ 10·log10(n_used/taps) dB; measured ≥1 dB waterfall shift on the
    #     room-IR BER sweep). −1 = auto (cp//2); 0 (default) disables.
    #     Must be ≤ cp. The truncation biases Ĥ on rooms whose impulse
    #     response exceeds the taps — a clear win for the LDPC presets
    #     (they live at low SNR where estimator noise dominates), a loss
    #     for uncoded high-SNR decodes in long reverb, so the coded presets
    #     enable it and the base/loopback config leaves it off.
    chanest_taps: int = 0

    # --- FEC (SURVEY.md §3 "FEC codec"): 'none' or 'ldpc'
    fec: str = "none"
    ldpc_z: int = 64               # QC-LDPC lifting size (802.16e-style base matrix)
    ldpc_iters: int = 25           # min-sum BP iterations (fixed for static shapes)
    # code rate of the 24-block-column family: "1/2" | "2/3" | "3/4" | "5/6".
    # n = 24z at EVERY rate (codeword length, frame layout, and the fused
    # receive tail's (24, z, lanes) LDPC ingest are rate-invariant); only
    # k = (24 − m_b)·z changes — higher rates carry more payload per frame
    # at a higher required SNR (see docs/PERFORMANCE.md waterfalls).
    ldpc_rate: str = "1/2"

    # --- per-bin adaptive bit-loading (link adaptation, SPEC.md §5b): an
    #     optional per-DATA-BIN constellation table (entries 0/2/4/6 bits;
    #     length n_data_bins). None = uniform `bits_per_symbol` on every
    #     data bin. A table is agreed OUT-OF-BAND (like the preset itself)
    #     — typically computed from a probe decode's channel estimate by
    #     `gf3x.ops.adapt.bit_loading_from_probe` (`gf3x adapt` CLI) so
    #     notched/rolled-off bins carry fewer (or zero) bits and clean bins
    #     carry more. TX power of nulled bins is reallocated uniformly to
    #     the active data bins (total symbol power is loading-invariant).
    #     Static per config → every shape stays compile-time constant.
    bit_loading: "tuple[int, ...] | None" = None

    # --- channel-bit block interleaver (WIRE_FORMAT v3): scrambled coded
    #     bits are written into an (R × D) rectangle row-major and read
    #     column-major (R = bits per OFDM symbol, D = data symbols), so
    #     consecutive coded bits land on successive OFDM SYMBOLS at the
    #     same bin — a deep frequency notch then hits every codeword as
    #     short, well-separated bursts instead of wiping out one contiguous
    #     codeword region. Pure reshape/transpose (no TPU gathers).
    interleave: bool = True

    # --- PRBS seed for known symbols / pilots (class-standard constant)
    prbs_seed: int = 0x1D

    # ---------------------------------------------------------------- derived
    @property
    def est_taps(self) -> int:
        """Resolved channel-estimate denoising tap count (−1 → cp//2)."""
        return self.cp // 2 if self.chanest_taps < 0 else self.chanest_taps

    @property
    def n_bins(self) -> int:
        """Number of rfft bins (n_fft//2 + 1)."""
        return self.n_fft // 2 + 1

    @property
    def n_used(self) -> int:
        return self.bin_hi - self.bin_lo + 1

    @property
    def n_pilots(self) -> int:
        if self.pilot_spacing <= 0:
            return 0
        return len(range(self.pilot_offset, self.n_used, self.pilot_spacing))

    @property
    def strided_pilots(self) -> bool:
        """True when the pilot grid tiles the used band exactly: pilot/data
        separation is then a reshape + slice instead of a gather — on TPU,
        elementwise gathers lower catastrophically (SURVEY.md §8 "LDPC in
        XLA" risk; measured orders-of-magnitude slowdowns), so the standard
        presets keep this property."""
        return (
            self.pilot_spacing > 0
            and self.pilot_offset == 0
            and self.n_used % self.pilot_spacing == 0
        )

    @property
    def n_data_bins(self) -> int:
        return self.n_used - self.n_pilots

    @property
    def symbol_len(self) -> int:
        """Samples per OFDM symbol including cyclic prefix."""
        return self.n_fft + self.cp

    @property
    def chirp_len(self) -> int:
        return int(round(self.chirp_duration * self.fs))

    @property
    def sc_len(self) -> int:
        """Samples of the Schmidl–Cox symbol (one OFDM symbol) if enabled."""
        return self.symbol_len if self.use_schmidl_cox else 0

    @property
    def preamble_len(self) -> int:
        """Samples from frame start (chirp onset) to the first known symbol."""
        return self.chirp_len + self.sc_len

    @property
    def frame_len(self) -> int:
        """Total samples in one frame: chirp ∥ [SC] ∥ known ∥ data."""
        return self.preamble_len + (self.n_known_symbols + self.n_data_symbols) * self.symbol_len

    @property
    def n_active_bins(self) -> int:
        """Data bins that actually carry bits (= n_data_bins when uniform)."""
        if self.bit_loading is None:
            return self.n_data_bins
        return sum(1 for b in self.bit_loading if b > 0)

    @property
    def bits_per_ofdm_symbol(self) -> int:
        if self.bit_loading is not None:
            return sum(self.bit_loading)
        return self.n_data_bins * self.bits_per_symbol

    @property
    def raw_bits_per_frame(self) -> int:
        """Channel bits carried by the data symbols of one frame."""
        return self.n_data_symbols * self.bits_per_ofdm_symbol

    @property
    def ldpc_n(self) -> int:
        return 24 * self.ldpc_z

    @property
    def ldpc_k(self) -> int:
        from .codes import block_rows
        return (24 - block_rows(self.ldpc_rate)) * self.ldpc_z

    @property
    def n_codewords(self) -> int:
        """LDPC codewords per frame (fec='ldpc'); raw bits beyond them are padding."""
        if self.fec != "ldpc":
            return 0
        return self.raw_bits_per_frame // self.ldpc_n

    @property
    def payload_bits_per_frame(self) -> int:
        """Information bits per frame (pre-header)."""
        if self.fec == "ldpc":
            return self.n_codewords * self.ldpc_k
        return self.raw_bits_per_frame

    @property
    def ofdm_scale(self) -> float:
        """Time-domain scale applied after irfft so symbol RMS == ofdm_amplitude.

        With unit-power constellation points on `n_used` bins of an rfft
        spectrum, `x = irfft(X)` has Var(x) = 2·n_used / n_fft², so the scale
        is `ofdm_amplitude · n_fft / sqrt(2·n_used)` (SURVEY.md Appendix,
        OFDM symbol normalization).
        """
        return self.ofdm_amplitude * self.n_fft / float(np.sqrt(2.0 * self.n_used))

    def validate(self) -> "ModemConfig":
        assert self.n_fft > 0 and (self.n_fft & (self.n_fft - 1)) == 0, "n_fft must be a power of 2"
        assert 0 < self.cp < self.n_fft
        assert 1 <= self.bin_lo <= self.bin_hi <= self.n_fft // 2 - 1
        assert self.bits_per_symbol in (2, 4, 6)
        assert self.est_taps <= self.cp, "chanest_taps must be ≤ cp (or −1 = auto)"
        if self.bit_loading is not None:
            assert isinstance(self.bit_loading, tuple), (
                "bit_loading must be a tuple (hashable jit-static config)")
            assert len(self.bit_loading) == self.n_data_bins, (
                f"bit_loading has {len(self.bit_loading)} entries; "
                f"config has {self.n_data_bins} data bins")
            assert all(b in (0, 2, 4, 6) for b in self.bit_loading), (
                "bit_loading entries must be 0, 2, 4, or 6 bits")
            assert self.bits_per_ofdm_symbol > 0, (
                "bit_loading nulls every data bin")
        assert self.fec in ("none", "ldpc")
        if self.fec == "ldpc":
            from .codes import RATES
            assert self.ldpc_rate in RATES, (
                f"ldpc_rate {self.ldpc_rate!r} not in {RATES}")
            assert self.n_codewords >= 1, (
                "frame too small for one LDPC codeword: "
                f"{self.raw_bits_per_frame} raw bits < n={self.ldpc_n}"
            )
        if self.use_schmidl_cox:
            assert self.n_fft % 2 == 0
        return self

    def replace(self, **kw) -> "ModemConfig":
        return dataclasses.replace(self, **kw).validate()


# ============================================================ derived layout

@dataclass(frozen=True)
class Layout:
    """Host-side derived tables (NumPy) for a config. Closed over by jitted fns."""

    used_bins: np.ndarray        # (n_used,) int32 — rfft bin index of each used bin
    pilot_pos: np.ndarray        # (n_pilots,) int32 — positions *within* used range
    data_pos: np.ndarray         # (n_data_bins,) int32 — positions within used range
    pilot_vals: np.ndarray       # (n_pilots,) complex64 — unit-power QPSK pilots
    known_syms: np.ndarray       # (n_known_symbols, n_used) complex64 — PRBS QPSK
    sc_sym: np.ndarray           # (n_used,) complex64 — SC symbol bins (odd bins 0)
    scramble: np.ndarray         # (raw_bits_per_frame,) uint8 — channel-bit
                                 # scrambler: keeps padded/constant payloads
                                 # noise-like so no data symbol degenerates
                                 # into an impulse (PAPR control)


def _prbs_bits(n: int, seed: int) -> np.ndarray:
    """Deterministic PRBS via a 16-bit Fibonacci LFSR (taps 16,15,13,4).

    Implementation-independent (no RNG library semantics) so the golden NumPy
    model and any future port produce identical class-standard sequences.
    """
    state = seed & 0xFFFF
    if state == 0:
        state = 1
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        bit = ((state >> 0) ^ (state >> 2) ^ (state >> 3) ^ (state >> 5)) & 1
        state = (state >> 1) | (bit << 15)
        out[i] = state & 1
    return out


def _qpsk_from_bits(bits: np.ndarray) -> np.ndarray:
    """Gray-coded unit-power QPSK: (b0,b1) → ((1−2b0) + j(1−2b1))/√2."""
    b = bits.reshape(-1, 2).astype(np.float64)
    return ((1 - 2 * b[:, 0]) + 1j * (1 - 2 * b[:, 1])) / np.sqrt(2.0)


@functools.lru_cache(maxsize=None)
def layout(cfg: ModemConfig) -> Layout:
    """Compute the static bin/pilot/known-symbol tables for `cfg`."""
    cfg.validate()
    used = np.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=np.int32)
    if cfg.pilot_spacing > 0:
        ppos = np.arange(cfg.pilot_offset, cfg.n_used, cfg.pilot_spacing, dtype=np.int32)
    else:
        ppos = np.zeros((0,), dtype=np.int32)
    mask = np.ones(cfg.n_used, dtype=bool)
    mask[ppos] = False
    dpos = np.nonzero(mask)[0].astype(np.int32)

    # pilots, known symbols, SC symbol, and the channel-bit scrambler all
    # come from one continuous PRBS stream (class standard)
    n_pilot_bits = 2 * len(ppos)
    n_known_bits = 2 * cfg.n_known_symbols * cfg.n_used
    n_sc_bits = 2 * cfg.n_used
    bits = _prbs_bits(
        n_pilot_bits + n_known_bits + n_sc_bits + cfg.raw_bits_per_frame,
        cfg.prbs_seed,
    )
    pvals = _qpsk_from_bits(bits[:n_pilot_bits]).astype(np.complex64)
    kvals = (
        _qpsk_from_bits(bits[n_pilot_bits:n_pilot_bits + n_known_bits])
        .reshape(cfg.n_known_symbols, cfg.n_used)
        .astype(np.complex64)
    )

    # Schmidl–Cox symbol: energy only on *even* rfft bins → two identical
    # halves in the time domain (SURVEY.md Appendix "Schmidl–Cox"). Built on
    # the used-bin grid; odd used bins zeroed, even bins get √2-boosted QPSK
    # so symbol power matches a data symbol.
    off = n_pilot_bits + n_known_bits
    scb = _qpsk_from_bits(bits[off: off + n_sc_bits]).astype(np.complex64)
    even = (used % 2) == 0
    sc = np.where(even, scb * np.sqrt(2.0), 0.0).astype(np.complex64)

    return Layout(
        used_bins=used,
        pilot_pos=ppos,
        data_pos=dpos,
        pilot_vals=pvals,
        known_syms=kvals,
        sc_sym=sc,
        scramble=bits[off + n_sc_bits:].astype(np.uint8),
    )


# ================================================================== presets

# Driver benchmark config 1 (BASELINE.json:7): loopback QPSK-OFDM over the
# ideal channel, 1024-pt FFT, CP 256 — uncoded.
CONFIG1_LOOPBACK = ModemConfig(fec="none").validate()

# The full GF3 standard frame (BASELINE.json:10): chirp + SC + known-symbol
# preamble, pilot-bearing data symbols, LDPC-coded payload. n_data_symbols
# sized so the frame carries 4 codewords of the (2304,1152) z=96 code:
# 576 payload bytes per ~0.98 s frame (~4.7 kbit/s over the air).
GF3_STANDARD = ModemConfig(
    fec="ldpc",
    ldpc_z=96,
    n_data_symbols=20,
    chanest_taps=-1,               # Ĥ denoising: ~3 dB estimator-noise cut
).validate()

# Higher-rate variant: 16-QAM doubles the bit rate at ~6 dB more required
# SNR; same LDPC code, 8 codewords per frame (1152 B / 0.98 s ≈ 9.4 kbit/s).
GF3_FAST = GF3_STANDARD.replace(bits_per_symbol=4)

# Maximum-rate variant: coded 64-QAM (first-class per VERDICT r1 item 7) —
# 12 codewords / 1728 B per frame ≈ 14.2 kbit/s, needs ~6 dB more SNR than
# gf3-fast (clean rooms, good speakers).
GF3_TURBO = GF3_STANDARD.replace(bits_per_symbol=6)

# High-capacity variant: 16-QAM with the rate-3/4 member of the code family —
# 50 % more payload than gf3-fast from the same air time (1728 B / 0.98 s ≈
# 14.1 kbit/s) with a smaller SNR step than jumping to 64-QAM; for good
# rooms where gf3-fast converges in a few LDPC iterations.
GF3_HICAP = GF3_STANDARD.replace(bits_per_symbol=4, ldpc_rate="3/4")

# Robustness-first variant: denser pilots (spacing 4), longer known preamble,
# fewer data symbols — for harsh rooms and cheap speakers.
GF3_ROBUST = ModemConfig(
    fec="ldpc",
    ldpc_z=96,
    pilot_spacing=4,
    n_known_symbols=8,
    n_data_symbols=12,
    bin_lo=24,
    bin_hi=303,
    chanest_taps=-1,
).validate()

_PRESETS = {
    "config1": CONFIG1_LOOPBACK,
    "loopback": CONFIG1_LOOPBACK,
    "gf3": GF3_STANDARD,
    "gf3-standard": GF3_STANDARD,
    "gf3-fast": GF3_FAST,
    "gf3-turbo": GF3_TURBO,
    "gf3-hicap": GF3_HICAP,
    "gf3-robust": GF3_ROBUST,
}


def preset(name: str) -> ModemConfig:
    try:
        return _PRESETS[name.lower()]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; have {sorted(_PRESETS)}") from None
