from .modem import Modem, DecodeDiag, DecodeResult

__all__ = ["Modem", "DecodeDiag", "DecodeResult"]
