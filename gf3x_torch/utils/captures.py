# Copied from gf3x/utils/captures.py, so that gf3x_torch never imports jax.
"""Frozen-capture manifest helpers (tests/fixtures/manifest.json): one place
turns a manifest entry into the decode config."""

from __future__ import annotations

from ..config import ModemConfig, preset

__all__ = ["capture_config"]


def capture_config(cap: dict) -> ModemConfig:
    """Manifest capture entry → the config its WAV must be decoded with."""
    cfg = preset(cap["preset"])
    if "bit_loading" in cap:
        cfg = cfg.replace(bit_loading=tuple(cap["bit_loading"]))
    return cfg
