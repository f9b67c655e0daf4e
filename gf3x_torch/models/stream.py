"""Multi-frame file transfer over one recording (counterpart of
gf3x/models/stream.py): the transmit side (`frame_capacity`, `encode_file`,
`encode_frames`), frame detection, the batched decode of every detected
frame, reassembly by header seq/total, HARQ chase combining and the
chunked `StreamingReceiver`.

The chirp matched filter runs on the modem's device. Up to 1 000 000
samples the peaks are picked on the host (`find_frames`); longer
recordings keep the O(T) work on the device and fetch one candidate per
half-frame segment (`find_frames_device`), with overlap-save correlations
above 8 000 000 samples so that the FFT workspace stays O(chunk). Window
slicing runs on the host with NumPy, and the windows decode in one batch
through `Modem.demodulate_prewindowed` (no cut kernel: the windows are
already cut)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..ops.sfo import auto_retry_needed, prefer_retry
from ..ops.sync import matched_filter, streaming_matched_filter
from ..utils.bits import HEADER_OVERHEAD
from .modem import DecodeResult, Modem

__all__ = ["encode_file", "encode_frames", "frame_capacity", "find_frames",
           "find_frames_device", "decode_stream", "decode_stream_windows",
           "merge_streams", "chase_combine", "StreamResult",
           "StreamingReceiver"]

#: longest recording `decode_stream` scans on the host; longer ones take
#: the per-segment device scan (`find_frames_device`)
MAX_HOST_SCAN = 1_000_000
#: above this length the device scan's correlations run overlap-save in
#: chunks of OVERLAP_SAVE_CHUNK samples (O(chunk) FFT workspace)
MAX_WHOLE_FFT = 8_000_000
OVERLAP_SAVE_CHUNK = 1 << 17


def chase_combine(modem: Modem, receptions, sfo: str = "off"
                  ) -> DecodeResult:
    """HARQ chase combining: soft-combine repeated receptions of the same
    logical frame (a CRC-failed original and a CRC-failed retransmission)
    into one decode. receptions: iterable of (recording, chirp onset).
    Each reception's descrambled coded-stream LLRs are 1/σ̂²-scaled by the
    demapper, so their plain sum is maximum-ratio combining; the sum runs
    the FEC decode and header parse (`Modem.decode_stream_llr`).

    sfo: 'off' | 'on' — 'on' estimates one clock offset jointly over the
    receptions (`Modem.joint_clock_offset`) and demodulates every copy
    through the δ̂-warped DFT; if that combination fails CRC, the
    uncorrected sum (δ = 0) is tried as well."""
    receptions = list(receptions)
    if not receptions:
        raise ValueError("chase_combine needs at least one reception")

    def combined(delta):
        total = None
        for rx, start in receptions:
            llr = modem.coded_llrs(np.asarray(rx), int(start), delta=delta)
            total = llr if total is None else total + llr
        return modem.decode_stream_llr(total)

    if sfo == "on":
        res = combined(modem.joint_clock_offset(receptions))
        if res.crc_ok:
            return res
        plain = combined(0.0)      # a δ = 0 warp is the plain demod
        return plain if plain.crc_ok else res
    return combined(None)


def frame_capacity(modem: Modem, filename: str = "") -> int:
    """Payload bytes one frame can carry after the header."""
    cap = (modem.cfg.payload_bits_per_frame // 8 - HEADER_OVERHEAD
           - len(filename.encode("utf-8")))
    if cap <= 0:
        raise ValueError("frame too small for the header alone")
    return cap


def _chunks(modem: Modem, data: bytes, filename: str) -> list[bytes]:
    cap = frame_capacity(modem, filename)
    return [data[i: i + cap] for i in range(0, max(len(data), 1), cap)]


def _with_gaps(modem: Modem, wavs: np.ndarray, gap_s: float) -> np.ndarray:
    """Frames (n, frame_len) → one waveform with `gap_s` of silence
    between consecutive frames."""
    gap = np.zeros(int(round(gap_s * modem.cfg.fs)), dtype=np.float32)
    parts: list[np.ndarray] = []
    for i, w in enumerate(wavs):
        if i:
            parts.append(gap)
        parts.append(w)
    return np.concatenate(parts)


def encode_file(modem: Modem, data: bytes, filename: str = "",
                gap_s: float = 0.05) -> np.ndarray:
    """Bytes of any size → one waveform of ⌈len/capacity⌉ frames (header
    seq/total set) with `gap_s` seconds of silence between them."""
    chunks = _chunks(modem, data, filename)
    total = len(chunks)
    if total > 0xFFFF:
        raise ValueError(f"file needs {total} frames (> 65535)")
    wavs = modem.encode_batch(chunks, filenames=[filename] * total,
                              seqs=list(range(total)), total=total)
    return _with_gaps(modem, wavs, gap_s)


def encode_frames(modem: Modem, data: bytes, seqs: list[int],
                  filename: str = "", gap_s: float = 0.05) -> np.ndarray:
    """Re-encode only the frames `seqs` of a transfer, in that order
    (selective retransmission of `StreamResult.missing`)."""
    chunks = _chunks(modem, data, filename)
    total = len(chunks)
    bad = [s for s in seqs if not 0 <= s < total]
    if bad:
        raise ValueError(f"seqs {bad} out of range for a {total}-frame "
                         "transfer")
    wavs = modem.encode_batch([chunks[s] for s in seqs],
                              filenames=[filename] * len(seqs),
                              seqs=list(seqs), total=total)
    return _with_gaps(modem, wavs, gap_s)


@dataclass
class StreamResult:
    payload: Optional[bytes]          # reassembled bytes (None if incomplete)
    filename: str
    complete: bool
    frames: list[DecodeResult] = field(default_factory=list)
    starts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    missing: list[int] = field(default_factory=list)


def merge_streams(*results: StreamResult) -> StreamResult:
    """Combine partial receptions (original + retransmissions) of one
    transfer into a single result."""
    frames = [r for res in results for r in res.frames]
    starts = (np.concatenate([res.starts for res in results]) if results
              else np.zeros(0, np.int64))
    good = [r for r in frames if r.crc_ok]
    if not good:
        return StreamResult(payload=None, filename="", complete=False,
                            frames=frames, starts=starts)
    total = max(r.total for r in good)
    by_seq: dict[int, DecodeResult] = {}
    for r in good:
        by_seq.setdefault(r.seq, r)
    missing = [s for s in range(total) if s not in by_seq]
    complete = not missing
    payload = (b"".join(by_seq[s].payload for s in range(total)) if complete
               else None)
    return StreamResult(payload=payload, filename=good[0].filename,
                        complete=complete, frames=frames, starts=starts,
                        missing=missing)


def find_frames(modem: Modem, rx: np.ndarray,
                max_frames: Optional[int] = None,
                threshold: float = 0.4) -> tuple[np.ndarray, np.ndarray]:
    """Every frame onset in a recording → (starts, ncc_metrics). The FFT
    matched filter runs on the modem's device over the whole recording;
    peaks are picked on the host (greedy argmax with half-frame exclusion
    and first-arrival refinement) and scored by normalized
    cross-correlation |m[n]| / (‖chirp‖·‖rx[n:n+L]‖), ≈ 1 at a chirp and
    ≈ 1/√L on OFDM data, so `threshold` separates frames from self-noise."""
    cfg = modem.cfg
    rx32 = np.asarray(rx, dtype=np.float32)
    chirp = modem.chirp.cpu().numpy()
    x = torch.as_tensor(rx32, device=modem.device)
    mabs = np.abs(matched_filter(x, chirp).cpu().numpy())
    L = cfg.chirp_len
    ce = float(np.sum(chirp ** 2))
    cs = np.concatenate([[0.0], np.cumsum(rx32.astype(np.float64) ** 2)])
    local = (cs[np.minimum(np.arange(len(rx32)) + L, len(rx32))]
             - cs[: len(rx32)])
    # floor the window energy at −40 dB of the loudest window: in silence
    # both |m| and the energy are ≈ 0 and their ratio is roundoff noise
    local = np.maximum(local, np.max(local) * 1e-4 + 1e-20)
    ncc = mabs / (np.sqrt(local * ce) + 1e-20)
    work = ncc.copy()
    min_sep = cfg.frame_len // 2
    starts, metrics = [], []
    limit = (max_frames if max_frames is not None
             else len(rx32) // cfg.frame_len + 1)
    for _ in range(limit):
        p = int(np.argmax(work))
        v = float(work[p])
        if v < threshold:
            break
        lo = max(0, p - cfg.cp)
        win = mabs[lo: p + 1]
        starts.append(lo + int(np.argmax(win >= 0.5 * mabs[p])))
        metrics.append(v)
        work[max(0, p - min_sep): p + min_sep] = 0.0
    order = np.argsort(starts)
    return (np.asarray(starts, dtype=np.int64)[order],
            np.asarray(metrics, dtype=np.float64)[order])


@torch.no_grad()
def _frame_scan(modem: Modem, rx32: np.ndarray, seg_len: int,
                chunk: Optional[int]):
    """One pass over the recording on the modem's device → per-segment
    sync candidates (n_seg,) each: the segment's best NCC, its
    first-arrival-refined onset and its raw argmax (gf3x's
    `_frame_scan_jit`). Only these three arrays reach the host."""
    cfg = modem.cfg
    chirp = modem.chirp.cpu().numpy()
    ce = float(np.sum(chirp ** 2))
    W = cfg.cp + 1
    x = torch.as_tensor(rx32, device=modem.device)
    T = x.shape[-1]
    n_seg = -(-T // seg_len)
    pad = n_seg * seg_len - T
    if chunk:
        def mf(a, h):
            return streaming_matched_filter(a, h, chunk)
    else:
        mf = matched_filter
    mabs = torch.abs(mf(x, chirp))
    # window energy: the correlation of x² with a ones kernel, the matched
    # filter's own machinery; a float32 cumsum difference would cancel
    # catastrophically once the running sum holds a long recording's energy
    local = torch.clamp(mf(x * x, np.ones(cfg.chirp_len)), min=0.0)
    local = torch.maximum(local, torch.amax(local) * 1e-4 + 1e-20)
    ncc = mabs / (torch.sqrt(local * ce) + 1e-20)
    nccp = torch.nn.functional.pad(ncc, (0, pad)).reshape(n_seg, seg_len)
    mpad = torch.nn.functional.pad(mabs, (0, pad))
    seg_arg = torch.argmax(nccp, dim=-1)
    seg_val = torch.gather(nccp, 1, seg_arg[:, None])[:, 0]
    gpos = seg_arg + torch.arange(n_seg, device=x.device) * seg_len
    # first arrival in the cp+1 samples up to each peak; the window is read
    # from a start clamped into the array, as jax's dynamic_slice does,
    # while the onset adds to the unclamped base (gf3x's arithmetic)
    base = torch.clamp(gpos - cfg.cp, min=0)
    lo = torch.clamp(base, max=max(mpad.shape[-1] - W, 0))
    win = mpad[lo[:, None] + torch.arange(W, device=x.device)]
    hit = (win >= 0.5 * mpad[gpos][:, None]).to(torch.int32)
    firsts = base + torch.argmax(hit, dim=-1)
    return (seg_val.cpu().numpy(), firsts.cpu().numpy(),
            gpos.cpu().numpy())


def find_frames_device(modem: Modem, rx: np.ndarray, threshold: float = 0.4,
                       streaming_chunk: Optional[int] = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """`find_frames` for long recordings: the O(T) correlation, energy and
    per-segment argmax stay on the device (`_frame_scan`, half-frame
    segments), and the host clusters the candidates greedily — above
    `threshold`, strongest first, none within half a frame of an accepted
    one. `streaming_chunk` runs the correlations overlap-save. Returns
    (starts, ncc_metrics)."""
    cfg = modem.cfg
    rx32 = np.asarray(rx, dtype=np.float32)
    if len(rx32) < cfg.frame_len:
        return np.zeros(0, np.int64), np.zeros(0)
    seg_val, firsts, gpos = _frame_scan(modem, rx32,
                                        max(cfg.frame_len // 2, 1),
                                        streaming_chunk)
    min_sep = cfg.frame_len // 2
    starts, metrics, taken = [], [], []
    for s in np.argsort(-seg_val):
        if seg_val[s] < threshold:
            break
        p = int(gpos[s])
        if any(abs(p - t) < min_sep for t in taken):
            continue
        taken.append(p)
        starts.append(int(firsts[s]))
        metrics.append(float(seg_val[s]))
    o = np.argsort(starts)
    return (np.asarray(starts, dtype=np.int64)[o],
            np.asarray(metrics, dtype=np.float64)[o])


def decode_stream_windows(modem: Modem, windows: np.ndarray,
                          sfo: str = "auto") -> list[DecodeResult]:
    """Decode already-cut frame windows (B, frame_len) in one batch, with
    the sfo='auto' retry policy: only the rows that trigger it decode again
    through the clock-offset loop, padded to a power-of-two count by
    repeating the first such row (gf3x pads so that its compiled programs
    stay few; the port pads too because the loop's δ̂ is a median over the
    batch, and the same rows give the same δ̂)."""

    def run(wins: np.ndarray, correct: bool) -> list[DecodeResult]:
        x = torch.as_tensor(np.asarray(wins, dtype=np.float32),
                            device=modem.device)
        return modem._host_results(
            *modem.demodulate_prewindowed(x, sfo_correct=correct))

    results = run(windows, sfo == "on")
    if sfo == "auto" and modem.cfg.use_schmidl_cox:
        bad = [i for i, r in enumerate(results)
               if auto_retry_needed(r.crc_ok, r.diag.clock_ppm)]
        if bad:
            nb = 1 << (len(bad) - 1).bit_length()
            idx = bad + [bad[0]] * (nb - len(bad))
            retry = run(np.asarray(windows)[idx], True)
            for j, i in enumerate(bad):
                if prefer_retry(results[i].crc_ok, retry[j].crc_ok):
                    results[i] = retry[j]
    return results


def decode_stream(modem: Modem, rx: np.ndarray, threshold: float = 0.4,
                  sfo: str = "auto") -> StreamResult:
    """A recording with any number of frames → reassembled file bytes.
    Frames are found by `find_frames` (or, above `MAX_HOST_SCAN` samples,
    `find_frames_device`, overlap-save above `MAX_WHOLE_FFT`), cut on the
    host at their onsets and decoded in one batch (`decode_stream_windows`);
    reassembly needs every seq 0..total−1 with CRC ok. sfo: 'off' | 'auto' | 'on', as in
    `Modem.decode`, one shared clock pair per recording."""
    cfg = modem.cfg
    rx32 = np.asarray(rx, dtype=np.float32)
    if rx32.size > MAX_HOST_SCAN:
        chunk = OVERLAP_SAVE_CHUNK if rx32.size > MAX_WHOLE_FFT else None
        starts, _ = find_frames_device(modem, rx32, threshold=threshold,
                                       streaming_chunk=chunk)
    else:
        starts, _ = find_frames(modem, rx32, threshold=threshold)
    if starts.size == 0:
        return StreamResult(payload=None, filename="", complete=False)
    rx_pad = np.concatenate([rx32, np.zeros(cfg.frame_len, np.float32)])
    windows = np.stack([rx_pad[s: s + cfg.frame_len] for s in starts])
    results = decode_stream_windows(modem, windows, sfo)
    return merge_streams(StreamResult(payload=None, filename="",
                                      complete=False, frames=results,
                                      starts=starts))


class StreamingReceiver:
    """Stateful chunked receiver: `feed()` audio as it arrives; frames
    decode as soon as their samples are complete, and the carried state
    stays O(frame_len) whatever the stream's length.

    >>> rcv = StreamingReceiver(modem)
    >>> for chunk in audio_source:          # any chunk sizes
    ...     for res in rcv.feed(chunk):     # DecodeResults as they complete
    ...         print(res.seq, res.crc_ok)
    >>> final = rcv.result()                # merged StreamResult

    The detection buffer is zero-padded to a multiple of `_BUCKET` samples,
    as gf3x pads it (there for a few compiled shapes; kept so both detect
    on the same buffer); onsets are tracked in absolute stream position so
    overlapping detection windows never decode a frame twice."""

    _BUCKET = 8192

    def __init__(self, modem: Modem, threshold: float = 0.4,
                 sfo: str = "auto"):
        self.modem = modem
        self.threshold = threshold
        self.sfo = sfo
        self._buf = np.zeros(0, dtype=np.float32)
        self._pos = 0                       # absolute index of _buf[0]
        self._frames: list[DecodeResult] = []
        self._taken: list[int] = []         # absolute onsets already decoded

    def feed(self, chunk: np.ndarray) -> list[DecodeResult]:
        """Append samples; return DecodeResults for frames they complete."""
        cfg = self.modem.cfg
        self._buf = np.concatenate(
            [self._buf, np.asarray(chunk, dtype=np.float32).ravel()])
        pad = (-len(self._buf)) % self._BUCKET
        det = np.pad(self._buf, (0, pad)) if pad else self._buf
        starts, _ = find_frames(self.modem, det, threshold=self.threshold)
        min_sep = cfg.frame_len // 2
        fresh = [
            int(s) for s in starts
            if s + cfg.frame_len <= len(self._buf)             # fully arrived
            and all(abs(s + self._pos - t) >= min_sep for t in self._taken)
        ]
        out: list[DecodeResult] = []
        if fresh:
            windows = np.stack(
                [self._buf[s: s + cfg.frame_len] for s in fresh])
            res = decode_stream_windows(self.modem, windows, self.sfo)
            for s, r in zip(fresh, res):
                self._taken.append(s + self._pos)
                out.append(r)
            self._frames.extend(out)
        # keep only what a future frame can still need: a chirp whose frame
        # is incomplete begins at most frame_len − 1 samples before the end
        keep = min(len(self._buf), cfg.frame_len + cfg.chirp_len)
        drop = len(self._buf) - keep
        if drop > 0:
            self._buf = self._buf[drop:]
            self._pos += drop
        return out

    def result(self) -> StreamResult:
        """Merged view of everything decoded so far."""
        starts = np.asarray(sorted(self._taken), dtype=np.int64)
        return merge_streams(StreamResult(
            payload=None, filename="", complete=False,
            frames=list(self._frames), starts=starts))
