"""Taken from ``masa_tpu/core/block_aligner.py`` (the JAX reference).

Block-scheduled aligner + thread-safe aligner wrapper.

The reference keeps two scheduling families under the same IAligner
contract: the diagonal family (AbstractDiagonalAligner — our TPUAligner's
strip loop) and the block family (AbstractBlockAligner,
libmasa/aligners/AbstractBlockAligner.cpp:73-644), where a Grid cuts the
partition into blocks, blocks are visited in a dependency-respecting
schedule, each block is handed to a block processor
(processors/AbstractBlockProcessor.hpp), and inter-block dependencies
travel through shared row/column vectors (AbstractBlockAligner.cpp:536-568).

`BlockAligner` re-creates that family: row-major block schedule, the
NumPy row-sweep oracle as the block processor (the CPUBlockProcessor
analogue), per-block generic pruning (BlockPruningGenericN2 semantics),
special-row dispatch at block-row boundaries.  It exists for the same
reasons the reference's does — a second, independently-scheduled engine
under the identical manager contract (differential testing of the
TPU path) and a home for block-granular features.

`SafeAligner` is the AbstractAlignerSafe analogue
(libmasa/aligners/AbstractAlignerSafe.cpp:27-136): it serializes the
life-cycle and dispatch calls of a thread-unsafe aligner behind one lock
so multi-threaded callers can share it.
"""

from __future__ import annotations

import threading

import numpy as np

from masa_tpu_torch.core.aligner import Aligner
from masa_tpu_torch.core.capabilities import AlignerCapabilities
from masa_tpu_torch.core.grid import Grid
from masa_tpu_torch.core.pruning import BlockPruningGeneric
from masa_tpu_torch.ops import oracle
from masa_tpu_torch.types import INF, InitType, Partition, Recurrence

NEG = -INF


class BlockAligner(Aligner):
    """Grid/block-scheduled aligner (the AbstractBlockAligner family).

    Blocks run row-major (a valid dependency order: a block needs only its
    top and left neighbors).  Boundary vectors: `row_h/row_f` carry each
    block-column's bottom boundary downward; `col_h/col_e` carry the left
    boundary rightward within the current block row — the analogue of the
    reference's inter-block row/col vectors.
    """

    def __init__(self, block_height: int = 512, block_width: int = 512):
        super().__init__()
        self.block_height = block_height
        self.block_width = block_width

    def get_capabilities(self) -> AlignerCapabilities:
        caps = AlignerCapabilities()
        caps.maximum_seq0_len = 1 << 24
        caps.maximum_seq1_len = 1 << 24
        return caps

    def align_partition(self, partition: Partition) -> None:
        mgr = self.manager
        p = partition
        m, n = p.height, p.width
        params = mgr.params
        rec = mgr.recurrence
        sw = rec == Recurrence.SMITH_WATERMAN
        grid = Grid.with_block_size(
            Partition(0, 0, m, n), self.block_height, self.block_width
        )
        pruner = BlockPruningGeneric(
            m, n, params, rec,
            best=mgr.best_scores.best.score if (
                mgr.must_prune_blocks() and len(mgr.best_scores)) else 0,
        ) if mgr.must_prune_blocks() else None

        # Full top border (H, F) and left border (H, E), index 0 = corner.
        row_init = mgr.get_first_row_init_type()
        col_init = mgr.get_first_column_init_type()
        row_h, row_g = oracle._border(n + 1, row_init, params,
                                      mgr.receive_first_row())
        col_h, col_g = oracle._border(m + 1, col_init, params,
                                      mgr.receive_first_column())
        row_h = row_h.astype(np.int64).copy()
        # Synthesized borders carry -INF gap components (same convention
        # as oracle.dp_rows); CUSTOM borders carry the caller's data.
        row_f = (row_g.astype(np.int64).copy()
                 if row_init == InitType.CUSTOM
                 else np.full(n + 1, NEG, np.int64))
        col_h = col_h.astype(np.int64).copy()
        col_e = (col_g.astype(np.int64).copy()
                 if col_init == InitType.CUSTOM
                 else np.full(m + 1, NEG, np.int64))

        iv = mgr.get_special_row_interval()
        if iv:
            iv = max(((iv + self.block_height - 1) // self.block_height)
                     * self.block_height, self.block_height)

        sub0 = self._seq0[p.i0 : p.i1]
        sub1 = self._seq1[p.j0 : p.j1]

        best, best_i, best_j = NEG, 0, 0
        lastcol_h = np.full(m + 1, NEG, np.int64)
        lastcol_e = np.full(m + 1, NEG, np.int64)
        lastcol_h[0] = row_h[n]
        lastcol_e[0] = NEG

        for bi in range(grid.nbi):
            if not mgr.must_continue():
                break
            i0, i1 = grid.splits_i[bi], grid.splits_i[bi + 1]
            # left boundary of this block row (H, E) incl. corner at i0
            cur_col_h = col_h[i0 : i1 + 1].copy()
            cur_col_e = col_e[i0 : i1 + 1].copy()
            for bj in range(grid.nbj):
                j0, j1 = grid.splits_j[bj], grid.splits_j[bj + 1]
                bh, bw = i1 - i0, j1 - j0
                # Top border of this block.  row_h[j0] was already
                # overwritten by the left neighbor (its bottom row), so the
                # shared corner H(i0, j0) comes from the left boundary
                # vector's top element instead.
                top_h = np.concatenate((cur_col_h[:1], row_h[j0 + 1 : j1 + 1]))
                next_corner = row_h[j1]  # H(i0, j1): the next block's corner
                entering = max(int(top_h.max()), int(cur_col_h.max()))
                if pruner is not None and pruner.is_prunable(i0, j0, entering):
                    # clearPrunedBlocks semantics: boundaries become -INF
                    # (the entering corner of the right neighbor keeps its
                    # true value — it was computed by the row above).
                    row_h[j0 + 1 : j1 + 1] = NEG
                    row_f[j0 + 1 : j1 + 1] = NEG
                    cur_col_h = np.full(bh + 1, NEG, np.int64)
                    cur_col_e = np.full(bh + 1, NEG, np.int64)
                    cur_col_h[0] = next_corner
                    self.stats.pruned_cells += bh * bw
                    continue
                res = oracle.dp_rows(
                    sub0[i0:i1], sub1[j0:j1], params, rec,
                    InitType.CUSTOM, InitType.CUSTOM,
                    first_row=(top_h, row_f[j0 : j1 + 1]),
                    first_col=(cur_col_h, cur_col_e),
                )
                self.stats.cells += bh * bw
                if sw and res.best > best:
                    best, best_i, best_j = res.best, i0 + res.best_i, \
                        j0 + res.best_j
                    if pruner is not None:
                        pruner.update_best(best)
                # Propagate boundaries.  Index 0 of last_f/col_e is the
                # shared corner whose gap component belongs to the left/top
                # neighbor's output (dp_rows reports -INF there) — keep the
                # neighbor's value.
                row_h[j0 : j1 + 1] = res.last_h
                row_f[j0 + 1 : j1 + 1] = res.last_f[1:]
                cur_col_h = res.col_h
                cur_col_e = res.col_e  # index 0 (corner E) is never read
                if bj == grid.nbj - 1:
                    lastcol_h[i0 : i1 + 1] = res.col_h
                    lastcol_e[i0 + 1 : i1 + 1] = res.col_e[1:]
            if iv and (i1 % iv == 0) and i1 != m:
                mgr.dispatch_row(p.i0 + i1, row_h[1:], row_f[1:])

        self.stats.partitions += 1
        if not sw:
            best, best_i, best_j = int(row_h[n]), m, n
        mgr.dispatch_last_row(p.i1, row_h, row_f)
        if mgr.must_dispatch_last_column():
            mgr.dispatch_last_column(p.j1, lastcol_h, lastcol_e)
        if mgr.must_dispatch_scores():
            mgr.dispatch_score(p.i0 + best_i, p.j0 + best_j, best)


class SafeAligner(Aligner):
    """Lock-serialized delegating wrapper (AbstractAlignerSafe).

    Every contract call on the wrapped aligner runs under one re-entrant
    lock, so thread-unsafe extensions can be shared by multi-threaded
    callers (the reference adds an optional dispatcher-queue thread; a
    re-entrant lock gives the same serialization guarantee without the
    queue hop).
    """

    def __init__(self, inner: Aligner):
        super().__init__()
        self.inner = inner
        self._lock = threading.RLock()

    def get_capabilities(self) -> AlignerCapabilities:
        return self.inner.get_capabilities()

    def get_fork_weights(self, count: int) -> list[float]:
        return self.inner.get_fork_weights(count)

    def set_manager(self, manager) -> None:
        with self._lock:
            self.manager = manager
            self.inner.set_manager(manager)

    def initialize(self) -> None:
        with self._lock:
            self.inner.initialize()

    def finalize(self) -> None:
        with self._lock:
            self.inner.finalize()

    def set_sequences(self, seq0, seq1) -> None:
        with self._lock:
            self.inner.set_sequences(seq0, seq1)

    def unset_sequences(self) -> None:
        with self._lock:
            self.inner.unset_sequences()

    def align_partition(self, partition: Partition) -> None:
        with self._lock:
            self.inner.align_partition(partition)

    def match_last_column(self, rev_h, rev_g, fwd_h, fwd_g, goal: int):
        with self._lock:
            return self.inner.match_last_column(
                rev_h, rev_g, fwd_h, fwd_g, goal
            )

    @property
    def stats(self):
        return self.inner.stats

    @stats.setter
    def stats(self, v):  # base-class __init__ assigns; forward if possible
        if hasattr(self, "inner"):
            self.inner.stats = v

    def clear_statistics(self) -> None:
        with self._lock:
            self.inner.clear_statistics()
