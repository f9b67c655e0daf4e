"""Multi-frame reception over one recording (counterpart of
gf3x/models/stream.py's receive side): frame detection, the batched decode
of every detected frame, reassembly by header seq/total, and the chunked
`StreamingReceiver`.

The chirp matched filter runs on the modem's device; peak picking and
window slicing run on the host with NumPy, and the windows decode in one
batch through `Modem.demodulate_prewindowed` (no cut kernel: the windows
are already cut). Recordings above 1 000 000 samples take gf3x's on-device
segment scan (`find_frames_device`), which is not ported yet (ROADMAP
queue 1, item 8)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..ops.sfo import auto_retry_needed, prefer_retry
from ..ops.sync import matched_filter
from .modem import DecodeResult, Modem

__all__ = ["find_frames", "decode_stream", "decode_stream_windows",
           "merge_streams", "StreamResult", "StreamingReceiver"]

#: longest recording `decode_stream` takes (gf3x scans longer ones on the
#: device, segment by segment)
MAX_HOST_SCAN = 1_000_000


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
    Frames are found by `find_frames`, cut on the host at their onsets and
    decoded in one batch (`decode_stream_windows`); reassembly needs every
    seq 0..total−1 with CRC ok. sfo: 'off' | 'auto' | 'on', as in
    `Modem.decode`, one shared clock pair per recording."""
    cfg = modem.cfg
    rx32 = np.asarray(rx, dtype=np.float32)
    if rx32.size > MAX_HOST_SCAN:
        raise NotImplementedError(
            f"a recording of {rx32.size} samples needs the on-device frame "
            "scan (find_frames_device), which is not ported to gf3x_torch "
            "yet (ROADMAP queue 1, item 8)")
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
