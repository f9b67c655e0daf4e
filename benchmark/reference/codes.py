# Frozen copy of gf3x_torch/fec/codes.py (NumPy only) for the benchmark's reference, which
# imports nothing of the program. Do not edit: the benchmark's yardstick.
"""QC-LDPC code construction (reference FEC layer, SURVEY.md §3 "FEC codec").

The GF3 genre uses the course-provided C `ldpc` library with 802.16-style
rate-1/2 codes (SURVEY.md §3, Tier B). We construct the same family from
scratch: a 12×24 quasi-cyclic base matrix whose entries are circulant shifts
(−1 = zero block), lifted by a configurable factor z. Shifts scale as
⌊s·z/96⌋ from the z=96 mother matrix (the 802.16e rate-1/2 convention).

Only the *structure* matters for the rebuild: any full-rank dual-diagonal
QC matrix gives a valid systematic code, and all parity/consistency is
enforced by construction tests (H·cᵀ = 0), not by matching an external
artifact (the reference mount is empty — SURVEY.md §0).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["BASE_MATRIX_R12", "RATES", "base_matrix", "block_rows",
           "expand_shifts", "build_H_blocks", "gf2_solve_parity"]

# 802.16e-style rate-1/2 base model matrix (12 × 24), z0 = 96.
# Columns 0-11: information blocks; column 12: the weight-3 column h_b;
# columns 13-23: dual-diagonal parity structure.
BASE_MATRIX_R12 = np.array([
    [-1, 94, 73, -1, -1, -1, -1, -1, 55, 83, -1, -1,  7,  0, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [-1, 27, -1, -1, -1, 22, 79,  9, -1, -1, -1, 12, -1,  0,  0, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [-1, -1, -1, 24, 22, 81, -1, 33, -1, -1, -1,  0, -1, -1,  0,  0, -1, -1, -1, -1, -1, -1, -1, -1],
    [61, -1, 47, -1, -1, -1, -1, -1, 65, 25, -1, -1, -1, -1, -1,  0,  0, -1, -1, -1, -1, -1, -1, -1],
    [-1, -1, 39, -1, -1, -1, 84, -1, -1, 41, 72, -1, -1, -1, -1, -1,  0,  0, -1, -1, -1, -1, -1, -1],
    [-1, -1, -1, -1, 46, 40, -1, 82, -1, -1, -1, 79,  0, -1, -1, -1, -1,  0,  0, -1, -1, -1, -1, -1],
    [-1, -1, 95, 53, -1, -1, -1, -1, -1, 14, 18, -1, -1, -1, -1, -1, -1, -1,  0,  0, -1, -1, -1, -1],
    [-1, 11, 73, -1, -1, -1,  2, -1, -1, 47, -1, -1, -1, -1, -1, -1, -1, -1, -1,  0,  0, -1, -1, -1],
    [12, -1, -1, -1, 83, 24, -1, 43, -1, -1, -1, 51, -1, -1, -1, -1, -1, -1, -1, -1,  0,  0, -1, -1],
    [-1, -1, -1, -1, -1, 94, -1, 59, -1, -1, 70, 72, -1, -1, -1, -1, -1, -1, -1, -1, -1,  0,  0, -1],
    [-1, -1,  7, 65, -1, -1, -1, -1, 39, 49, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,  0,  0],
    [43, -1, -1, -1, -1, 66, -1, 41, -1, -1, -1, 26,  7, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,  0],
], dtype=np.int64)

N_BLOCK_ROWS, N_BLOCK_COLS = BASE_MATRIX_R12.shape  # 12, 24
Z0 = 96

# The 802.16e family keeps 24 block COLUMNS at every rate and varies the
# block-ROW count: n = 24z always, k = (24 − m_b)·z. That invariance is what
# makes multi-rate cheap on TPU — the frame's codeword geometry (and the
# fused receive tail's (24, z, lanes) LDPC ingest layout) never changes.
RATES = ("1/2", "2/3", "3/4", "5/6")
_RATE_BLOCK_ROWS = {"1/2": 12, "2/3": 8, "3/4": 6, "5/6": 4}


def block_rows(rate: str) -> int:
    """Parity block rows m_b of the 24-block-column base matrix."""
    return _RATE_BLOCK_ROWS[rate]


def _count_4cycles(B: np.ndarray, z: int) -> int:
    """Length-4 cycles of the z-lifted graph of base matrix B (−1 = empty).

    Two columns sharing block rows i1, i2 close a 4-cycle iff
    (s[i1,j1] − s[i1,j2] + s[i2,j2] − s[i2,j1]) ≡ 0 (mod z)."""
    m_b, n_b = B.shape
    s = ((B.astype(np.int64) * z) // Z0) if z != Z0 else B
    cnt = 0
    for j1 in range(n_b):
        for j2 in range(j1 + 1, n_b):
            rows = [i for i in range(m_b) if B[i, j1] >= 0 and B[i, j2] >= 0]
            for a in range(len(rows)):
                for b in range(a + 1, len(rows)):
                    i1, i2 = rows[a], rows[b]
                    if (s[i1, j1] - s[i1, j2] + s[i2, j2] - s[i2, j1]) % z == 0:
                        cnt += 1
    return cnt


@functools.lru_cache(maxsize=None)
def _design_base(m_b: int, tries: int = 200) -> np.ndarray:
    """Deterministic seeded design of an (m_b × 24) QC base matrix.

    The reference mount is empty (SURVEY.md §0), so the higher-rate members
    of the family are DESIGNED here rather than transcribed: same skeleton
    as the 802.16e convention — degree-3 information columns balanced over
    the block rows, a weight-3 column h_b with equal top/bottom shifts and
    a zero middle (which makes the parity part provably invertible: the
    GF(2) sum of all block rows collapses the staircase and leaves
    P^x+P^0+P^x = I), and a zero-shift dual-diagonal staircase. Among
    `tries` seeded draws the one minimizing lifted 4-cycles at z ∈ {96, 64}
    wins (ties → fewer at z=32); validity (full-rank parity part,
    H·cᵀ = 0) is enforced by `gf2_solve_parity` and the construction tests,
    not by matching an external artifact."""
    k_b = 24 - m_b
    best = None
    for seed in range(tries):
        rng = np.random.default_rng(0xC0DE + 131 * m_b + seed)
        B = np.full((m_b, 24), -1, dtype=np.int64)
        deg = np.zeros(m_b, dtype=np.int64)
        for c in range(k_b):
            order = rng.permutation(m_b)
            rows = order[np.argsort(deg[order], kind="stable")][:3]
            for i in rows:
                B[i, c] = int(rng.integers(0, Z0))
                deg[i] += 1
        x = int(rng.integers(1, Z0))
        B[0, k_b] = x
        B[m_b // 2, k_b] = 0
        B[m_b - 1, k_b] = x
        for i in range(m_b - 1):
            B[i, k_b + 1 + i] = 0
            B[i + 1, k_b + 1 + i] = 0
        score = (_count_4cycles(B, 96), _count_4cycles(B, 64),
                 _count_4cycles(B, 32))
        if best is None or score < best[0]:
            best = (score, B)
    return best[1]


@functools.lru_cache(maxsize=None)
def base_matrix(rate: str) -> np.ndarray:
    """The (m_b × 24) base model matrix for `rate` ∈ RATES (shifts at z₀=96)."""
    if rate == "1/2":
        return BASE_MATRIX_R12
    if rate not in _RATE_BLOCK_ROWS:
        raise ValueError(f"unknown LDPC rate {rate!r}; one of {RATES}")
    return _design_base(_RATE_BLOCK_ROWS[rate])


def expand_shifts(z: int, rate: str = "1/2") -> np.ndarray:
    """Scale the mother-matrix shifts to lifting factor z: ⌊s·z/96⌋."""
    B = base_matrix(rate).copy()
    pos = B >= 0
    B[pos] = (B[pos] * z) // Z0
    return B


def build_H_blocks(z: int, rate: str = "1/2"):
    """Edge list of the lifted H: [(block_row, block_col, shift)], row-major.

    Each entry is a z×z circulant P^s: check c of block row i connects to
    variable (c + s) mod z of block col j.
    """
    B = expand_shifts(z, rate)
    edges = [
        (i, j, int(B[i, j]))
        for i in range(B.shape[0])
        for j in range(N_BLOCK_COLS)
        if B[i, j] >= 0
    ]
    return edges


def _dense_H(z: int, rate: str = "1/2") -> np.ndarray:
    """Dense (m_b·z × 24z) binary H — host-side only (construction + tests)."""
    m_b = block_rows(rate)
    m, n = m_b * z, N_BLOCK_COLS * z
    H = np.zeros((m, n), dtype=np.uint8)
    for (i, j, s) in build_H_blocks(z, rate):
        rows = np.arange(z)
        H[i * z + rows, j * z + (rows + s) % z] = 1
    return H


@functools.lru_cache(maxsize=None)
def gf2_solve_parity(z: int, rate: str = "1/2") -> np.ndarray:
    """Parity projector P (m × k) over GF(2): for info bits u, the parity
    bits are p = P·u (mod 2), giving codeword c = [u, p] with H·cᵀ = 0.

    Computed once per z on the host by bit-packed Gaussian elimination of
    B·X = A where H = [A | B]. This dense projector turns the *device*
    encoder into a single (batch × k)·(k × m) matmul on the MXU — the
    TPU-native replacement for the reference's C back-substitution encoder
    (SURVEY.md §3.1 rebuild consequence).
    """
    H = _dense_H(z, rate)
    m = block_rows(rate) * z
    k = N_BLOCK_COLS * z - m
    A = H[:, :k]
    B = H[:, k:]

    # bit-pack rows of the augmented [B | A] into uint64 words (solve B X = A)
    words = (m + k + 63) // 64
    aug = np.zeros((m, words), dtype=np.uint64)
    cols = np.concatenate([B, A], axis=1)
    idx = np.nonzero(cols)
    np.bitwise_or.at(aug, (idx[0], idx[1] // 64), np.uint64(1) << (idx[1] % 64).astype(np.uint64))

    # Gaussian elimination to reduced row echelon over the first m columns
    pivot_of_col = np.full(m, -1, dtype=np.int64)
    r = 0
    for c in range(m):
        w, b = c // 64, np.uint64(1) << np.uint64(c % 64)
        rows = np.nonzero(aug[r:, w] & b)[0]
        if rows.size == 0:
            continue
        pr = r + int(rows[0])
        if pr != r:
            aug[[r, pr]] = aug[[pr, r]]
        elim = np.nonzero(aug[:, w] & b)[0]
        elim = elim[elim != r]
        aug[elim] ^= aug[r]
        pivot_of_col[c] = r
        r += 1
        if r == m:
            break
    if np.any(pivot_of_col < 0):
        raise ValueError(f"parity part of H is singular for z={z}")

    # unpack: after RREF the row pivoting on column c holds row c of X = B⁻¹A
    # in its trailing k columns (bits m .. m+k−1)
    P = np.zeros((m, k), dtype=np.uint8)
    bitpos = m + np.arange(k)
    for c in range(m):
        row = aug[pivot_of_col[c]]
        P[c] = (row[bitpos // 64] >> (bitpos % 64).astype(np.uint64)).astype(np.uint8) & 1
    return P
