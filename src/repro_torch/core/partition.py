"""Matrix partitioning per the paper's Equations 2-4.

The three matrices are partitioned as:

* Eq. 2 — B columns into ``N/N0`` tiles of width N0 (outer i loop).
* Eq. 3 — the K dimension into ``K/K0`` *windows* of depth K0 (j loop);
  each window of B is streamed on-chip and each A row segment of length K0
  is processed against it.
* Eq. 4 — the rows of each A window into P bins by ``row mod P`` (parallel
  PEs). Each bin's rows are disjoint, so PE accumulation never conflicts
  across PEs.

In the kernels the role of P row-interleaving is played by TM-row blocking
(one M-block per CUDA block); both are exposed here. Indices in
every partition are *compressed* (paper Fig. 3): the local column is
``col % K0`` and the local row is ``row // P`` (mod-interleave) or
``row % TM`` (block partition).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from .sparse import SparseMatrix

__all__ = [
    "SextansParams",
    "WindowPartition",
    "partition_windows",
    "bin_rows_mod",
    "block_rows",
    "cdiv",
]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class SextansParams:
    """Hardware-shape parameters of the accelerator (paper defaults)."""

    N0: int = 8        # PU lanes / B tile width
    K0: int = 4096     # window size (B depth streamed on-chip)
    P: int = 64        # parallel PEs (8 PEGs x 8 PEs)
    D: int = 10        # RAW dependency distance of the FP accumulator
    F_B: int = 4       # BRAM partition factor for streaming B
    F_C: int = 16      # CompC parallel factor
    freq_hz: float = 189e6        # Sextans prototype frequency
    hbm_bw_Bps: float = 460e9     # U280 HBM bandwidth

    def num_windows(self, k: int) -> int:
        return cdiv(k, self.K0)

    def num_col_tiles(self, n: int) -> int:
        return cdiv(n, self.N0)


@dataclasses.dataclass(frozen=True)
class WindowPartition:
    """Non-zeros of one A_j window (Eq. 3), column-major, local columns."""

    j: int                 # window index
    row: np.ndarray        # global row index (int32)
    col: np.ndarray        # local column index within window (int32)
    val: np.ndarray        # float32

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])


def partition_windows(a: SparseMatrix, k0: int) -> List[WindowPartition]:
    """Split A into K/K0 windows (Eq. 3). Returns all windows, including
    empty ones, so window index == position."""
    a = a.sorted_column_major()
    _, k = a.shape
    nwin = cdiv(k, k0)
    win_of = a.col // k0
    # column-major sorted => windows are contiguous runs
    boundaries = np.searchsorted(win_of, np.arange(nwin + 1))
    out: List[WindowPartition] = []
    for j in range(nwin):
        lo, hi = int(boundaries[j]), int(boundaries[j + 1])
        out.append(
            WindowPartition(
                j=j,
                row=a.row[lo:hi],
                col=(a.col[lo:hi] - j * k0).astype(np.int32),
                val=a.val[lo:hi],
            )
        )
    return out


def bin_rows_mod(w: WindowPartition, p: int) -> Dict[int, WindowPartition]:
    """Eq. 4: split a window's non-zeros into P bins by ``row mod P``.

    Local row index is compressed to ``row // P`` (paper Fig. 3: original
    row interleaved mod P). Bins keep column-major order.
    """
    out: Dict[int, WindowPartition] = {}
    bins = w.row % p
    for pe in range(p):
        mask = bins == pe
        out[pe] = WindowPartition(
            j=w.j,
            row=(w.row[mask] // p).astype(np.int32),
            col=w.col[mask],
            val=w.val[mask],
        )
    return out


def block_rows(w: WindowPartition, tm: int, m: int) -> Dict[int, WindowPartition]:
    """Kernel-side row partition: contiguous TM-row blocks (local row = row % TM).

    This is the M-block analogue of Eq. 4 used by the SpMM kernels; the
    statistical load-balance role of mod-interleaving is recovered by the
    scheduler's densification statistics (see hflex.pack_blocks).
    """
    out: Dict[int, WindowPartition] = {}
    nblocks = cdiv(m, tm)
    blk = w.row // tm
    for b in range(nblocks):
        mask = blk == b
        out[b] = WindowPartition(
            j=w.j,
            row=(w.row[mask] - b * tm).astype(np.int32),
            col=w.col[mask],
            val=w.val[mask],
        )
    return out


def load_imbalance(counts: np.ndarray) -> float:
    """max/mean load ratio across bins — 1.0 is perfectly balanced."""
    c = np.asarray(counts, np.float64)
    if c.size == 0 or c.mean() == 0:
        return 1.0
    return float(c.max() / c.mean())
