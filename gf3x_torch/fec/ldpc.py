"""QC-LDPC codec (counterpart of gf3x/fec/ldpc.py): systematic encode
through the GF(2) parity projector and layered normalised min-sum decode
on torch tensors (kernel 3 on the card, its plain version on the CPU —
`ops.kernels.ldpc_bp`), and gf3x's host NumPy surface, `check` and the
float64 `decode_diag` the golden model decodes with."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.kernels import ldpc_bp
from .codes import N_BLOCK_COLS, _dense_H, block_rows, gf2_solve_parity

_ALPHA = 0.8  # min-sum normalization factor


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

    # ------------------------------------------------------------ host numpy
    def check(self, c: np.ndarray) -> np.ndarray:
        """Syndrome weight per codeword (0 ⇒ valid)."""
        H = _dense_H(self.z, self.rate)
        return ((c.astype(np.int64) @ H.T.astype(np.int64)) & 1).sum(axis=-1)

    def decode_diag(self, llr: np.ndarray, iters: int = 25,
                    early_exit: bool = True):
        """NumPy float64 normalized min-sum, the golden model's decoder
        (gf3x's `decode_diag`). llr: (..., n), positive ⇒ bit 0. Returns
        (info bits (..., k), passes run (int, batch-wide), unsat (...,)
        bool — True where the final hard decisions still violate a parity
        check). With `early_exit`, codewords whose totals satisfy every
        check freeze before each pass, and the loop ends once all have."""
        lead = llr.shape[:-1]
        lam = llr.reshape(-1, self.n).astype(np.float64)
        total, it_run = self._np_minsum(lam, iters, early_exit)
        unsat = self.check((total < 0).astype(np.uint8)) > 0
        bits = (total < 0).astype(np.uint8)
        return (bits[..., : self.k].reshape(*lead, self.k), it_run,
                unsat.reshape(lead))

    def _np_unsat(self, totals: np.ndarray) -> np.ndarray:
        """totals: (B, 24, z) → (B,) bool, True where any parity check of
        the hard decisions is violated."""
        hard = totals < 0                                         # (B, 24, z)
        unsat = np.zeros(totals.shape[0], dtype=bool)
        for row in ldpc_bp.row_edges(self.z, self.rate):
            par = np.zeros((totals.shape[0], self.z), dtype=bool)
            for _, j, s in row:
                # check c of the block row touches var (c + s) mod z of col j
                par ^= np.roll(hard[:, j], -s, axis=-1)
            unsat |= par.any(axis=-1)
        return unsat

    def _np_minsum(self, lam: np.ndarray, iters: int,
                   early_exit: bool = True) -> tuple[np.ndarray, int]:
        """Layered (block-row-serial) normalized min-sum: each block row's
        check update reads the current variable totals and writes its
        message delta back into them at once; the layer order and the
        tie-breaking are those of every other backend, so decoded bits
        stay bit-identical."""
        rows = ldpc_bp.row_edges(self.z, self.rate)
        B = lam.shape[0]
        totals = lam.reshape(B, N_BLOCK_COLS, self.z).copy()
        c2v = [np.zeros((len(row), B, self.z)) for row in rows]

        it_run = 0
        frozen = np.zeros(B, dtype=bool)
        for _ in range(iters):
            if early_exit:
                frozen = ~self._np_unsat(totals)
                if frozen.all():
                    break
            upd = ~frozen
            for row, msg in zip(rows, c2v):
                d = len(row)
                # v2c in check order: roll(tot, −s) − c2v (current totals)
                v2c = np.stack(
                    [np.roll(totals[:, j], -s, axis=-1) - msg[e]
                     for e, (_, j, s) in enumerate(row)], axis=0)  # (d, B, z)
                mag = np.abs(v2c)
                sgn = np.where(v2c < 0, -1.0, 1.0)
                prod = np.prod(sgn, axis=0, keepdims=True)
                m1 = np.min(mag, axis=0, keepdims=True)
                am = np.argmin(mag, axis=0, keepdims=True)
                mask = np.arange(d)[:, None, None] == am
                m2 = np.min(np.where(mask, np.inf, mag), axis=0, keepdims=True)
                mins = np.where(mask, m2, m1)
                new = _ALPHA * (prod * sgn) * mins                 # (d, B, z)
                for e, (_, j, s) in enumerate(row):
                    delta = np.where(upd[:, None], new[e] - msg[e], 0.0)
                    totals[:, j] += np.roll(delta, s, axis=-1)
                    msg[e] = np.where(upd[:, None], new[e], msg[e])
            it_run += 1
        return totals.reshape(B, self.n), it_run
