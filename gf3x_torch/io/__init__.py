from .audio import have_live_audio, play, read_wav, record, write_wav

__all__ = ["read_wav", "write_wav", "play", "record", "have_live_audio"]
