"""Sparse matrix containers and conversions.

The framework keeps host-side sparse matrices in a light COO container
(``SparseMatrix``) backed by numpy; everything device-side uses the packed
formats produced by :mod:`repro_torch.core.hflex`. scipy is available but we keep
the container dependency-free so the serving path can run without it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "SparseMatrix",
    "from_dense",
    "to_dense",
    "random_sparse",
    "power_law_sparse",
    "banded_sparse",
    "mesh_2d_sparse",
    "spmm_reference",
]


@dataclasses.dataclass(frozen=True)
class SparseMatrix:
    """COO sparse matrix, canonically sorted by (col, row) — column-major.

    Column-major order matches the paper's processing order (Section 3.2
    iterates the column vectors u_l of each window), which the scheduler
    and partitioner rely on.
    """

    shape: Tuple[int, int]
    row: np.ndarray  # int32 (nnz,)
    col: np.ndarray  # int32 (nnz,)
    val: np.ndarray  # float32 (nnz,)

    def __post_init__(self):
        if self.row.shape != self.col.shape or self.row.shape != self.val.shape:
            raise ValueError("row/col/val must have identical shapes")
        if self.row.ndim != 1:
            raise ValueError("COO arrays must be 1-D")

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    @property
    def density(self) -> float:
        m, k = self.shape
        return self.nnz / float(max(m * k, 1))

    def is_column_major(self) -> bool:
        """O(nnz) check that the triples are already (col, row)-sorted —
        lets packers skip the lexsort on the (common) pre-sorted path."""
        if self.nnz <= 1:
            return True
        dc = np.diff(self.col)
        if np.any(dc < 0):
            return False
        return bool(np.all((dc > 0) | (np.diff(self.row) >= 0)))

    def sorted_column_major(self) -> "SparseMatrix":
        if self.is_column_major():
            return self
        order = np.lexsort((self.row, self.col))
        return SparseMatrix(self.shape, self.row[order], self.col[order], self.val[order])

    def sorted_row_major(self) -> "SparseMatrix":
        order = np.lexsort((self.col, self.row))
        return SparseMatrix(self.shape, self.row[order], self.col[order], self.val[order])

    def validate(self) -> None:
        m, k = self.shape
        if self.nnz:
            if self.row.min() < 0 or self.row.max() >= m:
                raise ValueError("row index out of range")
            if self.col.min() < 0 or self.col.max() >= k:
                raise ValueError("col index out of range")

    def problem_size_flop(self, n: int) -> int:
        """FLOP count of C = alpha*A@B + beta*C, the paper's problem size."""
        m, _ = self.shape
        # 2 flops per nnz per output column (mul+add), plus the epilogue
        # alpha*X + beta*C = 3 flops per C element (2 mul + 1 add).
        return 2 * self.nnz * n + 3 * m * n

    def memory_traffic_bytes(self, n: int) -> int:
        """Off-chip bytes for one SpMM per the paper's Fig. 9 definition:
        4*(NNZ + N*(2M + K))."""
        m, k = self.shape
        return 4 * (self.nnz + n * (2 * m + k))


def from_dense(a: np.ndarray) -> SparseMatrix:
    r, c = np.nonzero(a)
    sm = SparseMatrix(
        (a.shape[0], a.shape[1]),
        r.astype(np.int32),
        c.astype(np.int32),
        a[r, c].astype(np.float32),
    )
    return sm.sorted_column_major()


def to_dense(a: SparseMatrix) -> np.ndarray:
    out = np.zeros(a.shape, np.float32)
    # np.add.at handles duplicate coordinates by accumulation, matching SpMM.
    np.add.at(out, (a.row, a.col), a.val)
    return out


def random_sparse(
    m: int,
    k: int,
    density: float,
    seed: int = 0,
    dtype=np.float32,
) -> SparseMatrix:
    """Uniform random sparse matrix (iid Bernoulli placement)."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(round(m * k * density)))
    nnz = min(nnz, m * k)
    flat = rng.choice(m * k, size=nnz, replace=False)
    row = (flat // k).astype(np.int32)
    col = (flat % k).astype(np.int32)
    val = rng.standard_normal(nnz)
    # Avoid exact zeros so nnz is stable under round-trips; keep the
    # requested dtype (it used to be silently discarded here).
    val = np.where(np.abs(val) < 1e-6, 1e-3, val).astype(dtype)
    return SparseMatrix((m, k), row, col, val).sorted_column_major()


def power_law_sparse(m: int, k: int, avg_nnz_per_row: float, seed: int = 0) -> SparseMatrix:
    """Power-law (graph-like) sparse matrix: mimics SNAP social networks.

    Row degrees follow a Zipf-like distribution — the adversarial case for
    row-based parallelization that motivates the paper (Fig. 1).
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, m + 1, dtype=np.float64)
    weights = ranks ** -1.1
    weights /= weights.sum()
    total = max(1, int(round(avg_nnz_per_row * m)))
    degrees = rng.multinomial(total, weights)
    rows = np.repeat(np.arange(m, dtype=np.int64), degrees)
    # Column targets also preferential (hubs attract edges).
    cweights = (np.arange(1, k + 1, dtype=np.float64) ** -1.05)
    cweights /= cweights.sum()
    cols = rng.choice(k, size=rows.shape[0], p=cweights)
    # Dedup (row, col) pairs.
    keys = rows * k + cols
    keys = np.unique(keys)
    row = (keys // k).astype(np.int32)
    col = (keys % k).astype(np.int32)
    val = rng.standard_normal(row.shape[0]).astype(np.float32)
    val = np.where(np.abs(val) < 1e-6, np.float32(1e-3), val).astype(np.float32)
    return SparseMatrix((m, k), row, col, val).sorted_column_major()


def banded_sparse(m: int, k: int, bandwidth: int, seed: int = 0) -> SparseMatrix:
    """Banded matrix: mimics SuiteSparse PDE/stencil matrices (e.g. crystm03)."""
    rng = np.random.default_rng(seed)
    rows = []
    cols = []
    for off in range(-bandwidth, bandwidth + 1):
        r = np.arange(max(0, -off), min(m, k - off), dtype=np.int32)
        rows.append(r)
        cols.append(r + off)
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    val = rng.standard_normal(row.shape[0]).astype(np.float32)
    val = np.where(np.abs(val) < 1e-6, np.float32(1e-3), val).astype(np.float32)
    return SparseMatrix((m, k), row, col, val).sorted_column_major()


def mesh_2d_sparse(side: int, seed: int = 0) -> SparseMatrix:
    """5-point stencil on a side×side grid (FEM-like)."""
    n = side * side
    idx = np.arange(n, dtype=np.int32)
    r = idx // side
    c = idx % side
    rows, cols = [idx], [idx]
    for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        ok = (r + dr >= 0) & (r + dr < side) & (c + dc >= 0) & (c + dc < side)
        rows.append(idx[ok])
        cols.append(((r + dr) * side + (c + dc))[ok].astype(np.int32))
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    rng = np.random.default_rng(seed)
    val = rng.standard_normal(row.shape[0]).astype(np.float32)
    val = np.where(np.abs(val) < 1e-6, np.float32(1e-3), val).astype(np.float32)
    return SparseMatrix((n, n), row, col, val).sorted_column_major()


def spmm_reference(
    a: SparseMatrix,
    b: np.ndarray,
    c: np.ndarray,
    alpha: float = 1.0,
    beta: float = 0.0,
) -> np.ndarray:
    """Numpy oracle for C = alpha*A@B + beta*C (float64 accumulate)."""
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"B rows {b.shape[0]} != A cols {k}")
    acc = np.zeros((m, b.shape[1]), np.float64)
    contrib = a.val[:, None].astype(np.float64) * b[a.col].astype(np.float64)
    np.add.at(acc, a.row, contrib)
    return (alpha * acc + beta * c.astype(np.float64)).astype(np.float32)
