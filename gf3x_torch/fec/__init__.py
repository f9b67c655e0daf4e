"""FEC package: QC-LDPC code construction and the torch codec."""

from .ldpc import LdpcCode

__all__ = ["LdpcCode"]
