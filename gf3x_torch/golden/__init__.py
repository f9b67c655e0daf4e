# Copied from gf3x/golden/__init__.py.
from .modem import GoldenModem, GoldenDecodeResult

__all__ = ["GoldenModem", "GoldenDecodeResult"]
