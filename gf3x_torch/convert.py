"""Carry gf3x's static tables into a gf3x_torch `Modem`.

The modem holds no learned weights; its state is the set of tables both
implementations derive from the config (see `TABLES`). gf3x can export
them as NumPy arrays (for example `tests/test_torch_modem.py` does), and
`load_reference_tables` copies such arrays into the port's buffers, so a
port modem can be run on exactly the reference's tables."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["TABLES", "load_reference_tables"]

#: buffer name → where gf3x keeps the same table
TABLES = {
    "chirp": "gf3x.ops.chirp.make_chirp(cfg)",
    "known_syms": "gf3x.config.layout(cfg).known_syms",
    "pilot_vals": "gf3x.config.layout(cfg).pilot_vals",
    "sc_sym": "gf3x.config.layout(cfg).sc_sym",
    "scramble": "gf3x.config.layout(cfg).scramble",
    "denoise": "gf3x.ops.chanest.denoise_projection(cfg)",
    "isi_M": "gf3x.ops.chanest._isi_operator(cfg)[0]",
    "isi_q": "gf3x.ops.chanest._isi_operator(cfg)[1]",
    "ldpc_parity": "gf3x.fec.ldpc.LdpcCode.for_config(cfg).t.P",
    "fec_index": "gf3x.models.frame.interleave_bits(cfg, arange(raw_bits), "
                 "inverse=True)",
    "demap_used": "gf3x.config.layout(cfg).data_pos",
    "demap_bits": "gf3x.models.frame.loading_tables(cfg).groups: the bits "
                  "of each data bin's group, 0 when nulled "
                  "(cfg.bits_per_symbol everywhere when uniform)",
    "demap_off": "gf3x.models.frame.loading_tables(cfg): each data bin's "
                 "first bit in the group-sorted wire order of a symbol "
                 "(j·bits_per_symbol when uniform)",
}


def load_reference_tables(modem: torch.nn.Module,
                          tables: dict[str, np.ndarray]) -> None:
    """Copy `tables` (name → array, names from `TABLES`) into `modem`'s
    buffers in place, on the buffers' device and dtype. Raises on an
    unknown name, a table this config does not use, or a shape mismatch."""
    for name, arr in tables.items():
        if name not in TABLES:
            raise KeyError(f"unknown table {name!r}; have {sorted(TABLES)}")
        try:
            buf = modem.get_buffer(name)
        except AttributeError:
            raise KeyError(f"this modem's config uses no {name!r} table") \
                from None
        src = torch.as_tensor(np.asarray(arr))
        if tuple(src.shape) != tuple(buf.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(buf.shape)}")
        buf.copy_(src.to(buf.dtype))
    # the histogram's and the FEC gather's tables are derived from fec_index
    if "fec_index" in tables:
        modem._set_fec_tables()
