"""The entries a traffic file can name: for each, the program's call that
the window times and the reference's route that judges its outputs. A new
route is one more line in each table."""

from __future__ import annotations

__all__ = ["PROGRAM", "REFERENCE"]

# modem, rx (B, T) on the device → (bits, DecodeDiag)
PROGRAM = {
    "demodulate": lambda modem, rx: modem.demodulate(rx),
    "demodulate_sfo": lambda modem, rx: modem.demodulate_sfo(rx),
}

# reference Receiver, the whole batch rx (B, T), the rows to judge → dict
REFERENCE = {
    "demodulate": lambda ref, rx, rows: ref.demodulate(rx[rows]),
    "demodulate_sfo": lambda ref, rx, rows: ref.demodulate_sfo(rx, rows),
}
