"""Synthetic sparse-matrix suite matched to the paper's Table 2 ranges.

SNAP / SuiteSparse are not available offline; this suite reproduces the
*distributional* properties the paper evaluates over — row/col counts from
tens to hundreds of thousands, NNZ 10..3.7e7 (scaled by ``budget``),
densities 6e-6..0.4 — across the three structural families the evaluated
collections contain: power-law graphs (SNAP), banded/FEM (SuiteSparse
crystm/ct20stif-like), and uniform random.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.core.sparse import (
    SparseMatrix, banded_sparse, mesh_2d_sparse, power_law_sparse, random_sparse,
)

__all__ = [
    "suite", "paper_n_values", "SuiteEntry",
    "DLMC_SPARSITIES", "DlmcEntry", "magnitude_pruned", "banded_pruned",
    "block_random_pruned", "dlmc_suite",
]

PAPER_N_VALUES = (8, 16, 32, 64, 128, 256, 512)

# DLMC-style (Deep Learning Matrix Collection) sparsity grid: the levels
# the pruned-transformer collection is published at.
DLMC_SPARSITIES = (0.70, 0.80, 0.90, 0.95, 0.98)


@dataclasses.dataclass
class SuiteEntry:
    name: str
    family: str
    matrix: SparseMatrix


def paper_n_values(budget: str = "small") -> Tuple[int, ...]:
    return PAPER_N_VALUES if budget == "full" else (8, 64, 512)


# ---------------------------------------------------------------------------
# DLMC-style pruned-weight patterns (block-structured, BSR-exact)
# ---------------------------------------------------------------------------
#
# Dense (d_in, d_out) float32 weights whose zero structure is aligned to a
# (bi, bo) block grid, so ``from_dense(w.T, format=Format.BSR, block=...)``
# packs them with zero fill-in.  Three families mirror how real pruned
# transformer weights look: magnitude pruning (unstructured block scores),
# banded (locality-biased), and uniform block-random.  All are seeded and
# keep EXACTLY ``round((1 - sparsity) * n_blocks)`` blocks (min 1), so
# same-(shape, sparsity) members share a kept-block count and stack into
# the grouped BSR lane without ragged padding.


@dataclasses.dataclass
class DlmcEntry:
    name: str
    pattern: str                     # magnitude | banded | block_random
    sparsity: float
    weight: np.ndarray               # dense (d_in, d_out) float32


def _block_weight(d_in: int, d_out: int, block: Tuple[int, int], seed: int,
                  scores: np.ndarray, keep_n: int) -> np.ndarray:
    """Gaussian weight masked to the ``keep_n`` top-score blocks (exact
    count: flat argsort, no threshold ties)."""
    bi, bo = block
    if d_in % bi or d_out % bo:
        raise ValueError("d_in/d_out must be multiples of the block tile")
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    w /= np.float32(np.sqrt(d_in))
    mask = np.zeros(scores.size, bool)
    mask[np.argsort(scores.reshape(-1), kind="stable")[-keep_n:]] = True
    mask = mask.reshape(scores.shape)
    return (w.reshape(d_in // bi, bi, d_out // bo, bo)
            * mask[:, None, :, None]).reshape(d_in, d_out)


def _keep_n(d_in: int, d_out: int, block: Tuple[int, int],
            sparsity: float) -> int:
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
    n_blocks = (d_in // block[0]) * (d_out // block[1])
    return max(1, int(round((1.0 - sparsity) * n_blocks)))


def magnitude_pruned(d_in: int, d_out: int, sparsity: float,
                     block: Tuple[int, int] = (16, 16),
                     seed: int = 0) -> np.ndarray:
    """Magnitude pruning: keep the top-``1 - sparsity`` fraction of blocks
    by L2 norm of an i.i.d. gaussian weight (the DLMC transformer recipe,
    block-granular)."""
    bi, bo = block
    # score with the weight's own block norms (same seed as _block_weight's
    # draw), so the mask is magnitude-coupled like real magnitude pruning
    w = np.random.default_rng(seed).standard_normal((d_in, d_out))
    scores = np.linalg.norm(
        w.reshape(d_in // bi, bi, d_out // bo, bo), axis=(1, 3))
    return _block_weight(d_in, d_out, block, seed, scores,
                         _keep_n(d_in, d_out, block, sparsity))


def banded_pruned(d_in: int, d_out: int, sparsity: float,
                  block: Tuple[int, int] = (16, 16),
                  seed: int = 0) -> np.ndarray:
    """Banded pattern: kept blocks concentrate around the (rescaled)
    diagonal — the locality structure of banded/FEM-like pruned layers.
    Scored by negative distance to the diagonal with a small seeded jitter
    to break ties inside a band."""
    bi, bo = block
    nr, nc = d_in // bi, d_out // bo
    r = np.arange(nr, dtype=np.float64)[:, None] / max(nr - 1, 1)
    c = np.arange(nc, dtype=np.float64)[None, :] / max(nc - 1, 1)
    rng = np.random.default_rng(seed + 1)
    scores = -np.abs(r - c) + rng.uniform(0, 1e-6, size=(nr, nc))
    return _block_weight(d_in, d_out, block, seed, scores,
                         _keep_n(d_in, d_out, block, sparsity))


def block_random_pruned(d_in: int, d_out: int, sparsity: float,
                        block: Tuple[int, int] = (16, 16),
                        seed: int = 0) -> np.ndarray:
    """Uniform block-random pattern: every block equally likely to
    survive (the DLMC 'random' baseline)."""
    bi, bo = block
    rng = np.random.default_rng(seed + 2)
    scores = rng.uniform(size=(d_in // bi, d_out // bo))
    return _block_weight(d_in, d_out, block, seed, scores,
                         _keep_n(d_in, d_out, block, sparsity))


_DLMC_PATTERNS = {
    "magnitude": magnitude_pruned,
    "banded": banded_pruned,
    "block_random": block_random_pruned,
}


def dlmc_suite(d_in: int, d_out: int, block: Tuple[int, int] = (16, 16),
               sparsities: Tuple[float, ...] = DLMC_SPARSITIES,
               seed: int = 0) -> List[DlmcEntry]:
    """The DLMC-style grid: every pattern family at every sparsity level,
    seeded per cell (pattern i, sparsity j -> seed + 100*i + j)."""
    out: List[DlmcEntry] = []
    for i, (pname, fn) in enumerate(sorted(_DLMC_PATTERNS.items())):
        for j, s in enumerate(sparsities):
            out.append(DlmcEntry(
                name=f"dlmc_{pname}_{int(round(s * 100))}",
                pattern=pname, sparsity=float(s),
                weight=fn(d_in, d_out, s, block=block,
                          seed=seed + 100 * i + j)))
    return out


def suite(budget: str = "small", seed: int = 0) -> List[SuiteEntry]:
    """Matrix suite. budget='small' keeps CPU runtime sane (~1e5 max rows);
    'full' stretches toward the paper's 5e5 rows / 3.7e7 nnz."""
    scale = 1.0 if budget == "full" else 0.12
    out: List[SuiteEntry] = []

    def s(x: int) -> int:
        return max(5, int(x * scale))

    # SNAP-like power-law graphs
    for i, (nodes, deg) in enumerate([
            (1_005, 20), (8_000, 6), (36_000, 8), (120_000, 5), (456_000, 4)]):
        m = s(nodes)
        out.append(SuiteEntry(f"snap_pl_{nodes}", "power_law",
                              power_law_sparse(m, m, deg, seed=seed + i)))

    # SuiteSparse-like banded / FEM
    for i, (n, bw) in enumerate([(24_696, 12), (3_000, 40), (60_000, 6)]):
        m = s(n)
        out.append(SuiteEntry(f"ss_band_{n}", "banded",
                              banded_sparse(m, m, bw, seed=seed + 10 + i)))
    side = max(10, int(220 * scale ** 0.5))
    out.append(SuiteEntry("ss_mesh2d", "mesh", mesh_2d_sparse(side, seed=seed)))

    # uniform random across the density range
    for i, (m, k, dens) in enumerate([
            (5, 5, 0.4), (1_000, 1_000, 0.02), (30_000, 30_000, 1e-4),
            (100_000, 50_000, 6e-6)]):
        mm, kk = s(m), s(k)
        d = min(dens, 0.4)
        out.append(SuiteEntry(f"rand_{m}x{k}", "random",
                              random_sparse(mm, kk, d, seed=seed + 20 + i)))
    return out
