"""Taken from ``masa_tpu/core/manager.py`` (the JAX reference).  It
differs where the reference reaches JAX: the border gap values come from
the port's ``stages/core``, the device goal match is the port's
``ops/wavefront.goal_match_device`` over tensors on the pass's device.

AlignerManager: the core side of the aligner contract (IManager,
libmasa/IManager.hpp:90-319; impl common/AlignerManager.cpp).

Per-partition configuration (recurrence, special-row cadence, border init
types, goal score, pruning) and the dispatch funnel the aligner feeds
(rows -> special-row store with border-gap synthesis, last row -> goal
matching, scores -> best-score tracking with goal stop, block maxima ->
blocks file).  This IS the production pipeline's dispatch path: the stage
machinery (stages/core.forward_pass, reverse_pass_and_match) constructs a
manager + aligner pair for every partition it computes, exactly as the
reference's stages drive AlignerManager::alignPartition
(stage1/sw_stage1.cpp:255, common/AlignerManager.cpp:91-168)."""

from __future__ import annotations

import numpy as np

from masa_tpu_torch.core.best_score import BestScoreList
from masa_tpu_torch.models.scoring import border_cells, match_column
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.types import (
    INF,
    Crosspoint,
    CrosspointType,
    InitType,
    MatchResult,
    MatchType,
    Partition,
    Recurrence,
    ScoreParams,
    StartType,
)
from masa_tpu_torch.utils import trace


class LazyFullRow:
    """A special row whose body is still a device snapshot (an
    ops/strips.RowPull), with the host border element already attached.
    full_rows() materializes the (n+1,) int64 arrays; packed() yields the
    disk-persistable packed form and anchors() its index, beside the
    border scalars (core/sra.write_row_packed)."""

    def __init__(self, pull, border_h: int, border_f: int):
        self.pull = pull
        self.border_h = int(border_h)
        self.border_f = int(border_f)

    @property
    def count(self) -> int:
        return self.pull.nj + 1

    def start(self):
        self.pull.start()
        return self

    def ready(self) -> bool:
        return self.pull.ready()

    def rows32(self) -> tuple[np.ndarray, np.ndarray]:
        """The (n+1,) H and F as int32, the width the strips compute in."""
        bh, bf = self.pull.rows()
        h = np.empty(self.count, np.int32)
        f = np.empty(self.count, np.int32)
        h[0], f[0] = self.border_h, self.border_f
        h[1:], f[1:] = bh, bf
        return h, f

    def full_rows(self) -> tuple[np.ndarray, np.ndarray]:
        h, f = self.rows32()
        return h.astype(np.int64), f.astype(np.int64)

    def packed(self):
        return self.pull.packed()

    def anchors(self, stride: int):
        return self.pull.anchors(stride)


class AlignerManager:
    def __init__(self, aligner, params: ScoreParams = ScoreParams()):
        self.aligner = aligner
        self.params = params
        aligner.set_manager(self)
        # per-partition configuration
        self.recurrence = Recurrence.SMITH_WATERMAN
        self.special_row_interval = 0
        self.block_pruning = False
        self.best_in = None  # a score reached above the partitions
        self.first_row_init = InitType.WITH_ZEROES
        self.first_col_init = InitType.WITH_ZEROES
        self._first_row = None
        self._first_col = None
        self.super_partition: Partition | None = None
        # execution hints (per-partition, like the reference's per-stage
        # manager configuration)
        self.track_best = True        # must_dispatch_scores
        self.want_all_scores = False  # per-strip/row score dispatch
        self.want_last_row = True
        self.last_column_wanted = False
        self.pad_rows = False
        # dispatch sinks
        self.special_rows = None      # SpecialRowStore protocol
        self.best_scores = BestScoreList()
        self.score_callback = None    # best_sink(i, j, score)
        self.blocks_sink = None       # blocks_sink(rows_done, maxima)
        self.best: tuple[int, int, int] = (-INF, 0, 0)
        self.goal_score: int | None = None
        self.goal_base_row = None     # (h, f) stored cut for goal matching
        # device twin of goal_base_row: (dev_h, dev_f, cj, W1) — the cut
        # stays on device and matching runs there (wf.goal_match_device)
        self.goal_base_dev = None
        self.special_dev_sink = None  # DevRowCache protocol (put_dev/
        #   attach_border): retains special-row bus snapshots on device
        self.lazy_special_rows = False  # deliver rows as LazyFullRow
        #   (no host transfer until the store asks) — stage 1 opt-in
        self.reverse_f0: int | None = None  # exact border gap at f[0] of
        #   the dispatched last row (reverse passes pin continuing gaps,
        #   stages.core._border_f_value semantics)
        self._goal_cell: Crosspoint | None = None
        self.last_match_result = None
        self._stopped = False
        self.last_row = None
        self.last_column = None
        self._col_h_cache = None
        self._col_f_syn = None

    # --- configuration (the IManager getters) -------------------------

    def set_recurrence_type(self, rec: Recurrence) -> None:
        self.recurrence = rec

    def set_special_row_interval(self, iv: int) -> None:
        self.special_row_interval = iv

    def set_block_pruning(self, on: bool, best_in: int | None = None) -> None:
        """``best_in``: a score reached above the partitions (a resumed
        stage 1's best), the least best that pruning starts from."""
        self.block_pruning = on and self.aligner.get_capabilities(
        ).block_pruning
        self.best_in = best_in

    def set_special_rows_store(self, store) -> None:
        self.special_rows = store

    def set_first_row(self, init: InitType, data=None) -> None:
        self.first_row_init = init
        self._first_row = data

    def set_first_column(self, init: InitType, data=None) -> None:
        self.first_col_init = init
        self._first_col = data
        self._col_h_cache = None
        self._col_f_syn = None

    def set_goal_score(self, score: int, base_row=None) -> None:
        """Stop when `score` is matched — against the stored cut row (the
        stage-2 matching) or anywhere (best score hit)."""
        self.goal_score = score
        self.goal_base_row = base_row
        self._goal_cell = None

    def get_special_row_interval(self) -> int:
        return self.special_row_interval

    def get_first_row_init_type(self) -> InitType:
        return self.first_row_init

    def get_first_column_init_type(self) -> InitType:
        return self.first_col_init

    def get_super_partition(self) -> Partition:
        return self.super_partition

    def receive_first_row(self):
        return self._first_row

    def receive_first_column(self):
        return self._first_col

    # --- must* predicates (IManager.hpp:278-313) -----------------------

    def must_continue(self) -> bool:
        return not self._stopped

    def must_dispatch_scores(self) -> bool:
        return self.track_best

    def must_dispatch_last_row(self) -> bool:
        return self.want_last_row

    def must_dispatch_last_column(self) -> bool:
        return self.last_column_wanted

    def must_prune_blocks(self) -> bool:
        return self.block_pruning

    def must_dispatch_row_bests(self) -> bool:
        """Whether each special row goes with the best of the rows down
        to it: where the store keeps them (``put_best``, a resumable
        stage 1's) and scores are tracked."""
        return self.track_best and hasattr(self.special_rows, "put_best")

    # --- border synthesis ----------------------------------------------

    def _col_borders(self, height: int):
        """Column-border H values rows 0..height and the synthesized
        fresh-gap F along that border (stages.core.border_gap_values:
        F(r) = max_{r0<r}(H(r0) - open - (r-r0)*ext))."""
        if self._col_h_cache is None or len(self._col_h_cache) <= height:
            from masa_tpu_torch.stages.core import border_gap_values

            if self.first_col_init == InitType.CUSTOM:
                col_h = np.asarray(self._first_col[0], np.int64)
            else:
                col_h, _ = border_cells(height + 1, self.first_col_init,
                                        self.params)
                col_h = col_h.astype(np.int64)
            self._col_h_cache = col_h
            self._col_f_syn = border_gap_values(col_h, self.params)
        return self._col_h_cache, self._col_f_syn

    def _col_border(self, row: int):
        """Border values at ABSOLUTE row index (dispatches carry absolute
        rows; the border arrays are partition-local).  They are computed
        once for the partition's whole height (a row's values depend on
        the rows above it alone), not again for each deeper row, which
        cost O(m) a special row."""
        sup = self.super_partition
        r = row - (sup.i0 if sup else 0)
        h, f = self._col_borders(max(r, sup.height if sup else 0, 1))
        return int(h[r]), int(f[r])

    # --- dispatch funnel (AlignerManager.cpp:334-450) ------------------

    def dispatch_row(self, row: int, bus_h, bus_f) -> None:
        n = len(bus_h)
        h_full = np.empty(n + 1, np.int64)
        f_full = np.empty(n + 1, np.int64)
        ch, cf = self._col_border(row)
        h_full[0] = ch
        f_full[0] = cf
        h_full[1:] = bus_h
        f_full[1:] = bus_f
        if self.special_dev_sink is not None:
            self.special_dev_sink.attach_border(row, ch, cf)
        if self.special_rows is not None:
            self.special_rows.put(row, h_full, f_full)
        if self.goal_base_row is not None:
            self._match_goal(row, h_full, f_full)

    def dispatch_row_best(self, row: int, i: int, j: int, score: int) -> None:
        """The best (score at (i, j)) of the rows down to special row
        ``row``, handed to the store before that row."""
        self.special_rows.put_best(row, i, j, score)

    def dispatch_row_lazy(self, row: int, pull) -> None:
        """Lazy special-row delivery (ops/strips.RowPull): the border
        attaches immediately (host scalars), the O(n) row body stays on
        device until the store decides it needs host bytes.  Stores
        without put_lazy (and goal-matching passes) materialize at once
        — behaviorally identical to dispatch_row."""
        ch, cf = self._col_border(row)
        if self.special_dev_sink is not None:
            self.special_dev_sink.attach_border(row, ch, cf)
        lazy = LazyFullRow(pull, ch, cf)
        if self.goal_base_row is None and self.special_rows is not None \
                and hasattr(self.special_rows, "put_lazy"):
            self.special_rows.put_lazy(row, lazy)
            return
        h_full, f_full = lazy.full_rows()
        if self.special_rows is not None:
            self.special_rows.put(row, h_full, f_full)
        if self.goal_base_row is not None:
            self._match_goal(row, h_full, f_full)

    def dispatch_row_dev(self, row: int, dev_h, dev_f) -> None:
        """Device snapshot of a special row (the bus the packed pull
        retains); the host border attaches when the decoded row arrives
        through dispatch_row."""
        if self.special_dev_sink is not None:
            self.special_dev_sink.put_dev(row, dev_h, dev_f)

    def dispatch_last_row_device(self, row: int, bus_h, bus_f) -> None:
        """The device twin of dispatch_last_row + _match_goal: match the
        reverse pass's last-row bus against the cut in goal_base_dev
        (wf.goal_match_device) where both lie, and pull only the
        three-value verdict."""
        if self.goal_base_dev is None:
            return
        dev_h, dev_f, cj, W1 = self.goal_base_dev
        rev0h, rev0f = self._col_border(row)
        if self.reverse_f0 is not None:
            rev0f = self.reverse_f0
        verdict = wf.goal_match_device(
            dev_h, dev_f, bus_h, bus_f, cj, self.goal_score, rev0h, rev0f,
            W1=W1, go=self.params.gap_open)
        with trace.span("wait"):
            status, k, score = verdict.tolist()
        if status == 4:
            mres = MatchResult(False, -1, 0, MatchType.ALIGNED)
        elif status in (0, 1):
            mres = MatchResult(True, k, score,
                               MatchType.ALIGNED if status == 0
                               else MatchType.GAPPED)
        else:
            mres = MatchResult(False, k, 0,
                               MatchType.ERROR_SUM_MATCH if status == 2
                               else MatchType.ERROR_SUM_GAP)
        self.last_match_result = mres
        if mres.found:
            t = (CrosspointType.MATCH if mres.type == MatchType.ALIGNED
                 else CrosspointType.GAP_2)
            self._goal_cell = Crosspoint(row, mres.k, int(mres.score), t)
            self._stopped = True

    def dispatch_last_row(self, row: int, last_h, last_f) -> None:
        h_full = np.asarray(last_h, np.int64)
        f_full = np.asarray(last_f, np.int64).copy()
        if self.reverse_f0 is not None:
            f_full[0] = self.reverse_f0
        else:
            f_full[0] = self._col_border(row)[1]
        self.last_row = (row, h_full, f_full)
        if self.goal_base_row is not None and self._goal_cell is None:
            self._match_goal(row, h_full, f_full)

    def dispatch_last_column(self, col: int, col_h, col_e) -> None:
        self.last_column = (col, np.asarray(col_h), np.asarray(col_e))

    def dispatch_score(self, i: int, j: int, score: int) -> None:
        self.best_scores.add(i, j, score)
        if self.score_callback is not None:
            self.score_callback(i, j, score)
        s, bi, bj = self.best
        if (score, -i, -j) > (s, -bi, -bj):   # engine tie-break
            self.best = (score, i, j)
        if self.goal_score is not None and score >= self.goal_score:
            self._stopped = True

    def dispatch_block_scores(self, rows_done: int, maxima) -> None:
        if self.blocks_sink is not None:
            self.blocks_sink(rows_done, maxima)

    def _match_goal(self, row: int, h_full, f_full) -> None:
        base_h, base_f = self.goal_base_row
        mres = match_column(
            h_full, f_full,
            np.asarray(base_h, np.int64), np.asarray(base_f, np.int64),
            self.goal_score, self.params.gap_open,
        )
        self.last_match_result = mres
        if mres.found:
            t = (CrosspointType.MATCH if mres.type == MatchType.ALIGNED
                 else CrosspointType.GAP_2)
            self._goal_cell = Crosspoint(row, mres.k, int(mres.score), t)
            self._stopped = True

    def get_next_crosspoint(self) -> Crosspoint | None:
        return self._goal_cell

    def is_found_crosspoint(self) -> bool:
        return self._goal_cell is not None

    # --- orchestration (AlignerManager::alignPartition) ----------------

    def align_partition(self, partition: Partition,
                        start_type: StartType = StartType.MATCH) -> None:
        """Configure pinned-state borders from the start type and run the
        aligner (AlignerManager.cpp:91-168)."""
        self._stopped = False
        if self.first_row_init != InitType.CUSTOM:
            self.first_row_init = (
                InitType.WITH_GAPS_OPENED
                if start_type == StartType.GAP_H
                else self.first_row_init
            )
        if self.first_col_init != InitType.CUSTOM:
            self.first_col_init = (
                InitType.WITH_GAPS_OPENED
                if start_type == StartType.GAP_V
                else self.first_col_init
            )
        if self.super_partition is None:
            self.super_partition = partition
        self.aligner.align_partition(partition)
