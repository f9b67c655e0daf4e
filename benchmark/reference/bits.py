# Frozen copy of gf3x_torch/utils/bits.py (NumPy only) for the benchmark's reference, which
# imports nothing of the program. Do not edit: the benchmark's yardstick.
"""Bit layer: bytes↔bits packing and the payload header.

Reference layer L1 (SURVEY.md §2): bytes↔bits, payload header carrying
filename/length, padding. These run on the host (tiny, O(payload) work) —
the device path operates on the resulting bit arrays.

Header wire format (little-endian), GF3X v1:

    magic   2B  b"G3"
    version 1B  0x01
    length  4B  payload byte count (this frame's chunk)
    crc32   4B  zlib CRC-32 of the chunk bytes
    seq     2B  frame sequence number within the transfer (0-based)
    total   2B  total frames in the transfer (≥1)
    nameln  1B  filename length (0..255)
    name    nameln bytes (UTF-8)

The CRC lets the receiver validate recovery without the transmitter's bytes
(the genre's decode-parity check, BASELINE.json:5) and disambiguates
padding; seq/total let a multi-frame file transfer reassemble out of one
long recording (SURVEY.md §6.7 streaming decode).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

MAGIC = b"G3"
VERSION = 1
#: header bytes excluding the variable-length filename
HEADER_OVERHEAD = 16


def bytes_to_bits(data: bytes | np.ndarray) -> np.ndarray:
    """bytes → uint8 bit array, MSB-first within each byte."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    return np.unpackbits(arr)


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """uint8/bool bit array (MSB-first) → bytes; length truncated to whole bytes."""
    bits = np.asarray(bits).astype(np.uint8).ravel()
    bits = bits[: (len(bits) // 8) * 8]
    return np.packbits(bits).tobytes()


@dataclass
class FrameHeader:
    payload: bytes
    filename: str
    crc_ok: bool
    seq: int = 0
    total: int = 1


def pack_header(payload: bytes, filename: str = "", seq: int = 0, total: int = 1) -> bytes:
    """Prepend the GF3X v1 header to `payload` (one frame's chunk)."""
    name = filename.encode("utf-8")
    if len(name) > 255:
        raise ValueError("filename longer than 255 bytes")
    if not (0 <= seq < total <= 0xFFFF):
        raise ValueError(f"bad seq/total {seq}/{total}")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    hdr = (
        MAGIC
        + bytes([VERSION])
        + len(payload).to_bytes(4, "little")
        + crc.to_bytes(4, "little")
        + seq.to_bytes(2, "little")
        + total.to_bytes(2, "little")
        + bytes([len(name)])
        + name
    )
    return hdr + payload


def parse_header(stream: bytes) -> tuple[bytes, str, bool]:
    """Parse a decoded byte stream → (payload, filename, crc_ok).

    Compatibility wrapper over `parse_frame_header` for single-frame use.
    Raises ValueError if the magic/version is wrong or the declared length
    exceeds the stream (irrecoverable frame).
    """
    h = parse_frame_header(stream)
    return h.payload, h.filename, h.crc_ok


def safe_filename(name: str, default: str = "decoded.bin") -> str:
    """Sanitize an untrusted decoded filename to a bare basename.

    Frame headers arrive over the air: a hostile transmission could carry
    "../../.bashrc" or an absolute path, and `outdir / name` would escape
    (pathlib substitutes an absolute right operand wholesale). Strip every
    directory component (both separator conventions), reject empty/dot/NUL
    names, and fall back to `default`.
    """
    name = (name or "").replace("\\", "/").split("/")[-1].strip()
    # a Windows drive-relative name like "C:evil" has no separator but
    # still escapes `outdir / name` there — reject any colon
    if not name or name in (".", "..") or "\x00" in name or ":" in name:
        return default
    return name


def parse_frame_header(stream: bytes) -> FrameHeader:
    """Full parse including the multi-frame seq/total fields."""
    if len(stream) < HEADER_OVERHEAD or stream[:2] != MAGIC:
        raise ValueError("bad magic: not a GF3X frame")
    if stream[2] != VERSION:
        raise ValueError(f"unsupported header version {stream[2]}")
    length = int.from_bytes(stream[3:7], "little")
    crc = int.from_bytes(stream[7:11], "little")
    seq = int.from_bytes(stream[11:13], "little")
    total = int.from_bytes(stream[13:15], "little")
    nameln = stream[15]
    off = HEADER_OVERHEAD + nameln
    if off + length > len(stream):
        raise ValueError("declared payload length exceeds decoded stream")
    name = stream[HEADER_OVERHEAD:off].decode("utf-8", errors="replace")
    payload = stream[off:off + length]
    crc_ok = (zlib.crc32(payload) & 0xFFFFFFFF) == crc
    return FrameHeader(payload=payload, filename=name, crc_ok=crc_ok,
                       seq=seq, total=max(total, 1))
