"""Taken from ``masa_tpu/core/pruning.py`` (the JAX reference).

Block pruning (SW only): per-strip contiguous chunk window.

Re-derivation of the reference's block-pruning family
(pruning/AbstractBlockPruning.cpp:70-111 bound;
BlockPruningDiagonal.cpp:109-152 contiguous window) for the strip/chunk
decomposition:

Everything entering strip s+1 passes through strip s's bus, so the exact
per-chunk upper bound on any score reaching chunk g is

    value[g] = max(busmax[g], value[g-1] + C*match)

(the second term is the best-case diagonal gain while crossing a chunk
within the strip).  Chunk g of the next strip is prunable when

    value[g] + min(m - rows_done, n - g*C) * match <= best

Pruned chunks are skipped and their bus is written as -INF — the
clearPrunedBlocks semantics (AbstractDiagonalAligner.cpp:491-501,
CUDAligner.cu:949-960)."""

from __future__ import annotations

import numpy as np

from masa_tpu_torch.types import INF, Recurrence, ScoreParams

NEG = -INF


def chunk_maxima(bus_h: np.ndarray, ng: int, chunk: int) -> np.ndarray:
    """Per-chunk max of a logical bus padded to ng*chunk."""
    return np.asarray(bus_h[: ng * chunk]).reshape(ng, chunk).max(axis=1)


def pruning_window(
    busmax: np.ndarray,
    best: int,
    rows_done: int,
    m: int,
    n: int,
    chunk: int,
    params: ScoreParams,
    border_max: int = 0,
    fresh_starts: bool = True,
) -> tuple[int, int]:
    """The [wL, wR) chunk window of the next strip that can still beat
    `best`.  border_max is the maximum left-border (init column) value;
    fresh_starts floors every chunk's entering value at 0 (SW alignments
    may begin anywhere)."""
    ng = len(busmax)
    value = np.empty(ng, np.int64)
    v = max(int(busmax[0]), border_max)
    value[0] = v
    gain_cross = chunk * params.match
    for g in range(1, ng):
        v = max(int(busmax[g]), v + gain_cross)
        value[g] = v
    if fresh_starts:
        np.maximum(value, 0, out=value)
    cols_left = np.maximum(n - np.arange(ng, dtype=np.int64) * chunk, 0)
    rows_left = max(m - rows_done, 0)
    gain = np.minimum(rows_left, cols_left) * params.match
    keep = value + gain > best
    if not keep.any():
        return 0, 0
    idx = np.nonzero(keep)[0]
    return int(idx[0]), int(idx[-1]) + 1


class BlockPruningGeneric:
    """Per-block prunable flags for arbitrary block schedules.

    The generic sibling of the strip/chunk window above — the analogue of
    BlockPruningGeneric/GenericN2 (pruning/BlockPruningGeneric.cpp:39-95,
    BlockPruningGenericN2.cpp:37-85), used by block-scheduled aligners
    where blocks are visited in any dependency-respecting order, so a
    contiguous window cannot represent the pruned set.

    The bound is AbstractBlockPruning::isBlockPrunable
    (pruning/AbstractBlockPruning.cpp:70-111): a block starting at local
    offset (bi0, bj0) inside an (m, n)-cell partition is prunable when

        value + min(m - bi0, n - bj0) * match <= best

    where `value` is the maximum score entering the block (its top/left
    boundary maxima; floored at 0 for SW since an alignment may start
    fresh anywhere inside).  Only SW prunes — NW paths must reach the
    corner regardless of score (the reference's NW corrections make the
    bound so loose it never fires; we follow CUDAligner and prune SW
    only).
    """

    def __init__(self, m: int, n: int, params: ScoreParams,
                 recurrence: Recurrence = Recurrence.SMITH_WATERMAN,
                 best: int = 0):
        self.m = m
        self.n = n
        self.params = params
        self.enabled = recurrence == Recurrence.SMITH_WATERMAN
        self.best = best
        self.pruned_blocks = 0

    def update_best(self, score: int) -> None:
        if score > self.best:
            self.best = score

    def is_prunable(self, bi0: int, bj0: int, entering_max: int) -> bool:
        """entering_max: max H over the block's entering row/column
        boundary (callers pass -INF for cleared boundaries)."""
        if not self.enabled:
            return False
        value = max(int(entering_max), 0)
        gain = min(self.m - bi0, self.n - bj0) * self.params.match
        prunable = value + gain <= self.best
        if prunable:
            self.pruned_blocks += 1
        return prunable
