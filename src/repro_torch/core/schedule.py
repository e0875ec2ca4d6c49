"""PE-aware out-of-order non-zero scheduling (paper Section 3.3).

The FPGA floating-point accumulator has a read-after-write (RAW) latency of
D cycles (7-10 on a U280). If two non-zeros with the same row index are
issued within D cycles, the HLS pipeline must stall (II > 1). The paper's
scheduler reorders the column-major non-zero stream of each A_pj submatrix
so that same-row non-zeros are >= D cycles apart, filling freed slots with
independent non-zeros (Tomasulo-style out-of-order issue, done once at
preprocessing time on the host).

Two schedulers produce legal II=1 streams, selected by ``mode=``:

* ``mode="greedy"`` — the paper's exact greedy (matches the worked example
  in Fig. 5): walk the non-zeros in column-major order; place each at the
  earliest free cycle c such that c >= last_cycle[row] + D; slots skipped
  while honoring the constraint become *bubbles* available to later
  independent non-zeros.  A pure-Python per-non-zero loop — the fidelity
  reference (the performance model charges exactly these cycles) and the
  only mode honoring ``window``.

* ``mode="vectorized"`` — the production preprocessing path: a NumPy
  occurrence-level scheduler.  Elements are grouped by their occurrence
  index within their row (level k = every row's (k+1)-th non-zero); levels
  are laid out back to back, each padded to at least D slots, and within
  every level rows are ordered by (total count desc, row id).  Because the
  rows present in level k+1 are exactly the rows with count > k+1 — a
  prefix of level k under that ordering — a row occupies the *same* rank in
  consecutive levels, so the spacing between its occurrences is the level
  length >= D: the schedule is II=1 legal by construction.  Cycle count is
  provably <= 2x the exact greedy (greedy >= max(nnz, (Kmax-1)*D + 1);
  levels cost sum(max(n_k, D)) <= nnz + (Kmax-1)*D), and in practice lands
  within a few percent on matrix workloads.  No per-element Python work:
  one or two lexsorts plus bincounts, ~two orders of magnitude faster.

``mode="auto"`` (the default) resolves to the vectorized scheduler unless a
reorder ``window`` is requested (a greedy-only notion).

The result is:
* a schedule: slot -> nnz index (or BUBBLE);
* II=1 execution: the pipeline consumes one slot per cycle, never stalls;
* cycle count = #slots; efficiency = nnz / #slots.

The GPU kernels add in a fixed order and have no RAW hazard to hide, but
the same pass is reused as *densification*: it bounds the padding of the
packed chunk slabs consumed by the SpMM kernels, and it drives the
cycle-accurate performance model that reproduces the paper's Table 1 (the
model pins ``mode="greedy"`` — it charges the FPGA's actual scheduler).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "BUBBLE",
    "Schedule",
    "schedule_nonzeros",
    "schedule_stats",
    "inorder_cycles",
    "verify_schedule",
    "min_dependency_distance",
]

BUBBLE = -1

#: Fixed regression bound of the vectorized scheduler vs the exact greedy:
#: cycles_vectorized <= VECTORIZED_CYCLE_BOUND * cycles_greedy (see the
#: module docstring for the proof sketch; asserted by tests).
VECTORIZED_CYCLE_BOUND = 2.0


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Result of scheduling one non-zero stream."""

    slots: np.ndarray          # int64 (cycles,): nnz index or BUBBLE
    cycles: int                # total cycle count (== len(slots))
    nnz: int
    d: int

    @property
    def bubbles(self) -> int:
        return self.cycles - self.nnz

    @property
    def efficiency(self) -> float:
        return self.nnz / self.cycles if self.cycles else 1.0


def schedule_nonzeros(
    rows: np.ndarray,
    d: int,
    window: Optional[int] = None,
    mode: str = "auto",
) -> Schedule:
    """Schedule a non-zero stream given per-element row indices.

    Parameters
    ----------
    rows : (nnz,) int array — destination row of each non-zero, in the
        desired issue order (column-major per the paper).
    d : RAW dependency distance of the target pipeline (>= 1). d=1 means
        no hazard (every cycle may issue any row).
    window : optional reorder window limiting how far forward an element
        may be pulled (paper: "within a scheduling window"). ``None`` is
        unbounded (the paper's aggressive bubble elimination). Only the
        greedy scheduler models a window.
    mode : "auto" | "vectorized" | "greedy".  "auto" picks the vectorized
        scheduler unless ``window`` is set.  "greedy" is the paper's exact
        algorithm (the reference implementation); "vectorized" is the fast
        NumPy level scheduler (raises if a window is requested).

    Returns a :class:`Schedule`. The schedule is a permutation of the input
    with bubbles: every nnz index appears exactly once.
    """
    rows = np.asarray(rows)
    n = int(rows.shape[0])
    if d < 1:
        raise ValueError("dependency distance must be >= 1")
    if mode not in ("auto", "vectorized", "greedy"):
        raise ValueError(f"unknown scheduler mode {mode!r}")
    if mode == "vectorized" and window is not None:
        raise ValueError("reorder window is only supported by mode='greedy'")
    if n == 0:
        return Schedule(np.empty((0,), np.int64), 0, 0, d)
    if mode == "greedy" or (mode == "auto" and window is not None):
        return _schedule_greedy(rows, d, window)
    return _schedule_vectorized(rows, d)


def _schedule_greedy(rows: np.ndarray, d: int, window: Optional[int]) -> Schedule:
    """Exact greedy (paper Fig. 5): per-element earliest-fit with gap fill."""
    n = int(rows.shape[0])
    last_cycle: dict = {}          # row -> last scheduled cycle
    gaps: list = []                # sorted list of bubble slots < tail
    tail = 0                       # next never-used slot
    placed = np.empty(n, np.int64) # nnz index -> slot

    for i in range(n):
        r = int(rows[i])
        earliest = 0
        if r in last_cycle:
            earliest = last_cycle[r] + d
        if window is not None:
            # May not be pulled earlier than (issue position - window).
            earliest = max(earliest, tail - window - len(gaps))
        # Try to fill the smallest gap >= earliest.
        slot = -1
        if gaps:
            gi = bisect.bisect_left(gaps, earliest)
            if gi < len(gaps):
                slot = gaps.pop(gi)
        if slot < 0:
            slot = max(tail, earliest)
            for g in range(tail, slot):
                bisect.insort(gaps, g)
            tail = slot + 1
        placed[i] = slot
        last_cycle[r] = slot

    cycles = int(tail)
    slots = np.full(cycles, BUBBLE, np.int64)
    slots[placed] = np.arange(n, dtype=np.int64)
    return Schedule(slots=slots, cycles=cycles, nnz=n, d=d)


def _occurrence_and_count(rows: np.ndarray):
    """Per-element occurrence index within its row (in stream order) and the
    row's total count — the two per-element quantities the level scheduler
    sorts by.  One stable argsort; no Python per-element work."""
    n = rows.shape[0]
    order = np.argsort(rows, kind="stable")
    srt = rows[order]
    start = np.searchsorted(srt, srt, side="left")
    stop = np.searchsorted(srt, srt, side="right")
    occ = np.empty(n, np.int64)
    occ[order] = np.arange(n, dtype=np.int64) - start
    cnt = np.empty(n, np.int64)
    cnt[order] = stop - start
    return occ, cnt


def _schedule_vectorized(rows: np.ndarray, d: int) -> Schedule:
    """Occurrence-level scheduler (see module docstring for the legality
    proof).  Levels are padded to >= d slots except the last."""
    n = int(rows.shape[0])
    occ, cnt = _occurrence_and_count(rows)
    # Level layout: primary occurrence level, then count desc, then row id.
    # The (count desc, row) key keeps every surviving row at the same rank
    # in consecutive levels => spacing == level length >= d.
    order = np.lexsort((rows, -cnt, occ))
    occ_s = occ[order]                       # ascending
    kmax = int(occ_s[-1]) + 1
    n_k = np.bincount(occ_s, minlength=kmax)          # level populations
    lengths = np.maximum(n_k, d)
    lengths[-1] = n_k[-1]                             # last level: no pad
    offsets = np.zeros(kmax, np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    rank = np.arange(n, dtype=np.int64) - np.searchsorted(occ_s, occ_s, "left")
    slot = offsets[occ_s] + rank
    cycles = int(offsets[-1] + n_k[-1])
    slots = np.full(cycles, BUBBLE, np.int64)
    slots[slot] = order
    return Schedule(slots=slots, cycles=cycles, nnz=n, d=d)


def verify_schedule(sched: Schedule, rows: np.ndarray) -> None:
    """Raise if the schedule violates II=1 legality:
    (1) permutation of all nnz, (2) same-row spacing >= D. Vectorized."""
    rows = np.asarray(rows)
    idx = sched.slots[sched.slots != BUBBLE]
    if idx.size != sched.nnz or not np.array_equal(
            np.sort(idx), np.arange(sched.nnz, dtype=idx.dtype)):
        raise AssertionError("schedule is not a permutation of the input")
    if sched.nnz == 0:
        return
    cyc = np.nonzero(sched.slots != BUBBLE)[0]
    r = rows[idx]
    order = np.lexsort((cyc, r))
    rs, cs = r[order], cyc[order]
    same = rs[1:] == rs[:-1]
    gap = np.diff(cs)
    bad = same & (gap < sched.d)
    if np.any(bad):
        i = int(np.nonzero(bad)[0][0])
        raise AssertionError(
            f"RAW violation: row {rs[i]} at cycles {cs[i]} and {cs[i + 1]} "
            f"(D={sched.d})"
        )


def min_dependency_distance(sched: Schedule, rows: np.ndarray
                            ) -> "int | None":
    """Smallest cycle gap between two placements of the same row — the
    tightest RAW dependency the accumulator pipeline must absorb.

    II=1 legality (paper Sec. 3.3) is exactly ``min_dependency_distance
    >= sched.d``; returns ``None`` when no row appears twice (every
    distance is legal).  This is the quantity ``verify_schedule`` bounds
    and a validator of packed artifacts reports on arbitrary schedules,
    including hand-built or corrupted ones."""
    rows = np.asarray(rows)
    idx = sched.slots[sched.slots != BUBBLE]
    if idx.size == 0:
        return None
    cyc = np.nonzero(sched.slots != BUBBLE)[0]
    r = rows[idx]
    order = np.lexsort((cyc, r))
    rs, cs = r[order], cyc[order]
    same = rs[1:] == rs[:-1]
    if not same.any():
        return None
    return int(np.diff(cs)[same].min())


def split_hub_rows(rows: np.ndarray, threshold: int) -> np.ndarray:
    """Beyond-paper: split rows with > threshold occurrences into virtual
    sub-rows (occurrence // threshold), giving the scheduler independent
    accumulator slots to interleave.

    The paper's OoO scheduling cannot hide a hub row whose window-local
    degree × D exceeds a PE's remaining work (each of its non-zeros must
    stay D cycles from the previous one). Virtual sub-rows break that
    chain; hardware-wise each sub-row is an extra scratchpad slot merged
    during the CompC pass (a handful of adds per split row — negligible
    next to the saved pipeline stalls)."""
    rows = np.asarray(rows)
    n = rows.shape[0]
    if n == 0 or threshold <= 0:
        return rows
    occ, _ = _occurrence_and_count(rows)
    stride = int(rows.max()) + 1
    return rows + (occ // threshold) * stride


def inorder_cycles(rows: np.ndarray, d: int, mode: str = "auto") -> int:
    """Cycle count of *in-order* issue with stall-on-hazard (the paper's
    baseline comparison: HLS schedules II=D on conflicting pairs).

    ``mode="auto"`` uses the vectorized evaluator (exact): run-structured
    streams (all of a row's non-zeros adjacent — the CSR row-order baseline)
    have a closed form; general streams are solved by fixpoint iteration on
    the max-plus recurrence ``c[i] = max(c[i-1]+1, c[prev(i)]+d)`` with a
    per-row prefix-max propagation step, falling back to the exact scalar
    loop (``mode="scalar"``) in the rare non-convergent case."""
    rows = np.asarray(rows)
    n = int(rows.shape[0])
    if n == 0:
        return 0
    if d <= 1:
        return n
    if mode == "scalar":
        return _inorder_cycles_scalar(rows, d)

    order = np.argsort(rows, kind="stable")
    srt = rows[order]
    same = srt[1:] == srt[:-1]                # adjacent (in row order) pairs

    # Run-structured (row-sorted) fast path: every stall is a consecutive
    # same-row pair in stream order, each costing d instead of 1.
    if not same.any() or np.all(~same | (order[1:] == order[:-1] + 1)):
        stream_same = int(np.count_nonzero(rows[1:] == rows[:-1]))
        return n + (d - 1) * stream_same

    # General case: least-fixpoint of the stall recurrence.  s[i] is the
    # cumulative stall (c[i] = i + s[i], non-decreasing).  Each round
    # propagates whole-row chains: cand[j] = max_{t<j, same row}
    # (s[t] + q[t] + (j-t)*d) - q[j], a segmented prefix max.
    pos = order.astype(np.int64)              # stream position, row-sorted
    occ_s = np.arange(n, dtype=np.int64) - np.searchsorted(srt, srt, "left")
    # Dense per-row segment rank for the prefix-max reset trick.
    seg = np.concatenate(([0], np.cumsum(~same))).astype(np.int64)
    big = np.int64(4) * (np.int64(n) + 1) * (np.int64(d) + 1)

    s = np.zeros(n, np.int64)
    for _ in range(64):
        v = s[pos] + pos - occ_s * d
        m = np.maximum.accumulate(v + seg * big) - seg * big  # per-row cummax
        cand_s = np.full(n, np.iinfo(np.int64).min, np.int64)
        cand_s[1:][same] = (m[:-1][same] + occ_s[1:][same] * d
                            - pos[1:][same])
        cand = np.empty(n, np.int64)
        cand[pos] = cand_s
        s2 = np.maximum.accumulate(np.maximum(s, cand))
        if np.array_equal(s2, s):
            return int(n + s[-1])
        s = s2
    return _inorder_cycles_scalar(rows, d)


def _inorder_cycles_scalar(rows: np.ndarray, d: int) -> int:
    """Exact scalar reference for :func:`inorder_cycles` (and its fallback)."""
    cycle = 0
    last: dict = {}
    for r in np.asarray(rows).tolist():
        if r in last:
            cycle = max(cycle, last[r] + d)
        last[r] = cycle
        cycle += 1
    return cycle


def schedule_stats(
    rows: np.ndarray,
    d: int,
    window: Optional[int] = None,
    mode: str = "auto",
) -> dict:
    """Convenience: schedule + summary numbers used by benchmarks."""
    s = schedule_nonzeros(rows, d, window, mode=mode)
    io = inorder_cycles(rows, d)
    return {
        "nnz": s.nnz,
        "cycles_ooo": s.cycles,
        "cycles_inorder": io,
        "bubbles": s.bubbles,
        "efficiency": s.efficiency,
        "speedup_vs_inorder": io / s.cycles if s.cycles else 1.0,
    }
