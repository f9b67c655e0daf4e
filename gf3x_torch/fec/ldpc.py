"""QC-LDPC codec on torch tensors (counterpart of gf3x/fec/ldpc.py):
systematic encode through the GF(2) parity projector, and layered
normalised min-sum decode (kernel 3 on the card, its plain version on the
CPU — `ops.kernels.ldpc_bp`)."""

from __future__ import annotations

import functools

import torch

from ..ops.kernels import ldpc_bp
from .codes import N_BLOCK_COLS, block_rows, gf2_solve_parity

__all__ = ["LdpcCode"]


class LdpcCode:
    """QC-LDPC over the 24-block-column 802.16e-style family: n = 24z at
    every rate, k = (24 − m_b)·z (rate ∈ `codes.RATES`)."""

    def __init__(self, z: int, rate: str = "1/2"):
        self.z = z
        self.rate = rate
        self.mb = block_rows(rate)
        self.n = N_BLOCK_COLS * z
        self.m = self.mb * z
        self.k = self.n - self.m
        self.P = gf2_solve_parity(z, rate)          # (m, k) uint8

    @classmethod
    @functools.lru_cache(maxsize=None)
    def _cached(cls, z: int, rate: str) -> "LdpcCode":
        return cls(z, rate)

    @classmethod
    def for_config(cls, cfg) -> "LdpcCode":
        return cls._cached(cfg.ldpc_z, getattr(cfg, "ldpc_rate", "1/2"))

    def encode(self, u: torch.Tensor, P: torch.Tensor | None = None
               ) -> torch.Tensor:
        """(..., k) uint8 info bits → (..., n) uint8 codeword [u | P·u mod 2].
        The product runs in full float32 (exact: row sums ≤ k ≪ 2²⁴; the
        package turns TF32 off). `P` is the (m, k) uint8 projector, the
        code's own when None."""
        if P is None:
            P = torch.as_tensor(self.P)
        Pt = P.to(u.device, torch.float32).T
        p = torch.remainder(torch.matmul(u.to(torch.float32), Pt), 2.0)
        return torch.cat([u.to(torch.uint8), p.to(torch.uint8)], dim=-1)

    def decode(self, llr: torch.Tensor, iters: int):
        """(..., n) f32 LLRs (positive ⇒ bit 0) → (info bits (..., k) uint8,
        passes (...,) int32 — sweeps each codeword ran —, unsat (...,) bool
        — its final hard decisions still violate a parity check)."""
        lead = llr.shape[:-1]
        lam = llr.reshape(-1, self.n).to(torch.float32).contiguous()
        tot, unsat, passes = self.decode_totals(lam, iters)
        bits = (tot[:, : self.k] < 0).to(torch.uint8)
        return (bits.reshape(*lead, self.k), passes.reshape(lead),
                unsat.reshape(lead))

    def decode_totals(self, lam: torch.Tensor, iters: int):
        """lam (L, n) f32 → (totals (L, n), unsat (L,) bool, passes (L,)
        int32) through `ops.kernels.ldpc_bp.minsum_totals`."""
        return ldpc_bp.minsum_totals(lam, self.z, self.rate, iters)
