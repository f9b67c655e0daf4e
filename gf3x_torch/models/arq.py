"""Selective-repeat ARQ with HARQ chase combining: the recovery state
machines of a file transfer over the modem (CRC + header seq/total +
selective retransmission).

Copied from gf3x/models/arq.py (host-side, no jax) onto the port's stream
module: `ArqReceiver` keeps every CRC-failed reception and chase-combines
repeated copies per seq (`chase_combine`), so a damaged retransmission can
still complete the transfer; `ArqSender` answers NACKs with exactly the
requested frames. The feedback channel is the caller's (any byte pipe,
the modem itself included).

Seq attribution for CRC-failed receptions (whose headers are unreadable)
is positional: an initial transmission carries seqs 0..n-1 in order, a
retransmission carries the NACKed list in order — the transmit-order
contract of `encode_file`/`encode_frames`. Sync-detected starts map to
those positions sorted.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .modem import Modem
from .stream import (StreamResult, chase_combine, decode_stream, encode_file,
                     encode_frames, frame_capacity, merge_streams)

__all__ = ["ArqSender", "ArqReceiver", "encode_nack", "decode_nack",
           "attribute_positions"]


def attribute_positions(starts, anchors, stride0: float) -> list:
    """Transmit-position attribution of sync-detected frame starts.

    starts: detection onsets (sorted ascending, samples); anchors:
    [(detection index, transmit position), ...] from CRC-ok headers;
    stride0: the protocol's nominal frame spacing (frame_len + gap).
    Returns one transmit position per detection.

    With ≥2 anchors the stride is MEASURED as the median over all anchor
    pairs of Δstart/Δposition — robust on two axes the nominal stride is
    not: (a) sampling-clock offset scales the on-air stride by (1+δ)
    (±800 ppm drifts the nominal rule ~25 samples/frame — harmless per
    round() but measured exactly here for free), and (b) one mis-refined
    anchor start (first-arrival latching a reflection sits up to −cp
    early, ops/sync.py `_first_arrival`) skews a first-to-last two-point
    fit by err/Δp for EVERY attribution, which flips round() on transfers
    longer than ~stride/(2·err) frames; the pairwise median tolerates any
    minority of bad anchors. The base offset is likewise the median over
    anchors of (start − position·stride). The measured stride is accepted
    only inside ±2 % of the nominal — an order of magnitude beyond the
    physical budget (±1200 ppm SFO plus ≤cp of start-refinement error per
    pair); outside that window the anchors themselves are corrupt (frames
    cannot be spaced closer than frame_len, and arbitrarily large medians
    collapse every attribution onto a few positions), so the nominal
    stride wins. Pair formation caps the anchors at 64 evenly spaced
    across the round: the pairwise count is O(A²) and a large transfer
    (~18k CRC-ok frames) would otherwise build ~1.6e8 pairs for a median
    that 64 well-spread anchors already pin."""
    n = len(starts)
    if not anchors:
        return list(range(n))
    stride = stride0
    est_anchors = anchors
    if len(est_anchors) > 64:
        idx = np.linspace(0, len(est_anchors) - 1, 64).round().astype(int)
        est_anchors = [est_anchors[i] for i in idx]
    ests = [
        (int(starts[ib]) - int(starts[ia])) / (pb - pa)
        for k, (ia, pa) in enumerate(est_anchors)
        for ib, pb in est_anchors[k + 1:]
        if pb != pa
    ]
    if ests:
        med = float(np.median(ests))
        if abs(med - stride0) <= 0.02 * stride0:
            stride = med
    if len(anchors) == 2 and anchors[0][1] != anchors[1][1]:
        # two disagreeing anchors: a median base is their midpoint, which
        # puts every (start − base)/stride on a half-integer and leaves the
        # attribution to banker's rounding — anchor the base on the FIRST
        # anchor instead (deterministic tie-break; matches the pre-median
        # behavior that the two-anchor tests pinned)
        i0, p0 = anchors[0]
        base = float(int(starts[i0]) - p0 * stride)
    else:
        base = float(np.median([int(starts[i]) - p * stride
                                for i, p in anchors]))
    return [round((int(starts[j]) - base) / stride) for j in range(n)]


def encode_nack(missing, filename: str = "") -> bytes:
    """Serialize a NACK for any feedback pipe. `missing` is the seq list,
    or the string "all" when the receiver decoded nothing and cannot know
    the frame count (`ArqReceiver.nack`)."""
    return json.dumps({"nack": missing, "file": filename}).encode()


def decode_nack(payload: bytes):
    doc = json.loads(payload)
    return doc["nack"], doc.get("file", "")


@dataclass
class ArqSender:
    """Transmit side: the initial transmission, then NACK-driven rounds."""

    modem: Modem
    payload: bytes
    filename: str = ""
    gap_s: float = 0.05

    @property
    def n_frames(self) -> int:
        return max(1, -(-len(self.payload)
                        // frame_capacity(self.modem, self.filename)))

    def initial(self) -> np.ndarray:
        return encode_file(self.modem, self.payload, self.filename,
                           gap_s=self.gap_s)

    def retransmit(self, nack) -> np.ndarray:
        """Waveform answering a NACK ("all" or a seq list, `decode_nack`).
        An empty NACK (the transfer completed) yields an empty waveform —
        nothing to send — rather than an opaque concatenate error."""
        seqs = list(range(self.n_frames)) if nack == "all" else list(nack)
        if not seqs:
            return np.zeros(0, dtype=np.float32)
        return encode_frames(self.modem, self.payload, seqs, self.filename,
                             gap_s=self.gap_s)


@dataclass
class ArqReceiver:
    """Receive side: feed each round's recording; failed receptions are
    kept and combined across rounds."""

    modem: Modem
    sfo: str = "auto"
    gap_s: float = 0.05            # the sender's inter-frame gap (protocol
                                   # constant; position stride = frame+gap)
    result: StreamResult = field(
        default_factory=lambda: StreamResult(payload=None, filename="",
                                             complete=False))
    # seq → [(frame window, start-within-window), ...] for CRC-FAILED
    # receptions only (decoded frames need no soft copies; windows bound
    # memory to O(missing frames), not O(session recordings))
    _receptions: dict = field(default_factory=dict)
    # seq → reception count at the last combine attempt (a failed
    # combination is deterministic: never re-run it on identical inputs)
    _attempted: dict = field(default_factory=dict)

    def feed(self, recording: np.ndarray,
             nacked: Optional[list] = None) -> StreamResult:
        """Process one round. `nacked`: the seq list this round retransmits
        (in order) per the NACK contract — a seq list or "all"; None (or
        "all") means the round carries every frame in seq order."""
        rec = np.asarray(recording, dtype=np.float32)
        got = decode_stream(self.modem, rec, sfo=self.sfo)
        order = None if nacked is None or nacked == "all" else list(nacked)
        # transmit-POSITION attribution. Plain enumeration order breaks
        # the moment the sync misses a frame (a burst that ate its chirp):
        # every later frame would shift down one slot. Any CRC-ok frame is
        # an ANCHOR (its header seq pins its position); other detections
        # get position = anchor + round(Δstart / stride), stride = the
        # protocol's frame+gap spacing. No anchor → plain enumeration.
        cfg = self.modem.cfg
        stride = cfg.frame_len + int(round(self.gap_s * cfg.fs))
        n = got.starts.size
        anchors = []                 # (detection index, transmit position)
        for i, f in enumerate(got.frames):
            if f.crc_ok:
                if order is not None:
                    if f.seq not in order:
                        # a decodable frame from OUTSIDE this round (live-
                        # capture overlap, stale transmission): its seq is
                        # meaningless as a round position — anchoring on it
                        # would corrupt the stride and every attribution
                        continue
                    ap = order.index(f.seq)
                else:
                    ap = f.seq
                anchors.append((i, ap))
        pos = attribute_positions(got.starts, anchors, stride)
        # total frame count, once any decoded frame has revealed it: bounds
        # "all"/initial rounds (order=None) so a spurious detection past
        # the last frame cannot create a phantom seq that leaks memory and
        # burns combine attempts forever
        known_total = max((f.total for f in (self.result.frames
                                             + list(got.frames))
                           if f.crc_ok), default=None)
        for i in range(n):
            p = pos[i]
            if p < 0 or (order is not None and p >= len(order)):
                continue            # outside this round's transmit order
            if order is None and known_total is not None and p >= known_total:
                continue
            seq = int(order[p] if order is not None else p)
            if got.frames[i].crc_ok:
                continue            # decoded: no soft copy needed
            # store only the frame window (start re-based to 0): all the
            # combiner reads is rec[start : start + frame_len]
            s0 = int(got.starts[i])
            win = np.zeros(cfg.frame_len, np.float32)
            seg = rec[s0: s0 + cfg.frame_len]
            win[: seg.size] = seg
            self._receptions.setdefault(seq, []).append((win, 0))
        self.result = merge_streams(self.result, got)
        self._try_combining()
        return self.result

    def _try_combining(self) -> None:
        """Chase-combine every still-missing seq with ≥2 stored
        receptions; accept a combination only when its CRC passes and its
        decoded seq matches the slot it was attributed to (a mis-sync or
        mis-attribution then cannot corrupt the transfer)."""
        # "still missing" must come from the stored receptions, not
        # result.missing: after a TOTAL-loss round merge_streams cannot
        # know the frame count and reports missing=[] with complete=False
        decoded = {f.seq for f in self.result.frames if f.crc_ok}
        known_total = max((f.total for f in self.result.frames if f.crc_ok),
                          default=None)
        for seq in sorted(self._receptions):
            if known_total is not None and seq >= known_total:
                del self._receptions[seq]          # phantom: past the end
                self._attempted.pop(seq, None)
                continue
            if seq in decoded:
                del self._receptions[seq]          # free the soft copies
                self._attempted.pop(seq, None)
                continue
            rcps = self._receptions[seq]
            if len(rcps) < 2 or self._attempted.get(seq) == len(rcps):
                continue                           # nothing new to try
            self._attempted[seq] = len(rcps)
            # full set first; then leave-one-out subsets, so ONE
            # mis-attributed copy (no-anchor rounds fall back to plain
            # enumeration) cannot permanently poison the seq
            subsets = [rcps] + ([list(rcps[:k]) + list(rcps[k + 1:])
                                 for k in range(len(rcps))]
                                if len(rcps) > 2 else [])
            res = None
            for sub in subsets:
                res = chase_combine(self.modem, sub)
                if not res.crc_ok and self.sfo != "off":
                    res = chase_combine(self.modem, sub, sfo="on")
                if res.crc_ok:
                    break
            if res is not None and res.crc_ok and res.seq == seq:
                single = StreamResult(
                    payload=res.payload, filename=res.filename,
                    complete=False, frames=[res],
                    starts=np.asarray([0], dtype=np.int64))
                self.result = merge_streams(self.result, single)
                del self._receptions[seq]
                self._attempted.pop(seq, None)

    def nack(self):
        """What to send back: [] when complete, the missing seq list, or
        "all" when nothing decoded yet (frame count unknown)."""
        if self.result.complete:
            return []
        if not any(f.crc_ok for f in self.result.frames):
            return "all"
        return self.result.missing
