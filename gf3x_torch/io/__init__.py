from .audio import read_wav, write_wav

__all__ = ["read_wav", "write_wav"]
