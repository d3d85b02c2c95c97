"""The aligner extension contract and its two implementations, for the
port (counterpart of masa_tpu/core/aligner.py).

  * CUDAAligner — the strip engine (the TPUAligner analogue): the Hopper
    kernel on a CUDA device, the plain PyTorch strips on the CPU.
  * CPUAligner — the NumPy oracle, the differential baseline.
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np
import torch

from masa_tpu_torch.core.capabilities import AlignerCapabilities
from masa_tpu_torch.models.scoring import match_column
from masa_tpu_torch.ops import oracle
from masa_tpu_torch.types import MatchResult, Partition, Recurrence
from masa_tpu_torch.ops import strips
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.utils import trace


@dataclasses.dataclass
class AlignerStats:
    cells: int = 0
    pruned_cells: int = 0
    partitions: int = 0


class Aligner(abc.ABC):
    """The IAligner life-cycle: initialize -> set_sequences ->
    align_partition* -> unset_sequences -> finalize."""

    def __init__(self):
        self.manager = None
        self.stats = AlignerStats()
        self._seq0 = None
        self._seq1 = None

    @abc.abstractmethod
    def get_capabilities(self) -> AlignerCapabilities: ...

    def set_manager(self, manager) -> None:
        self.manager = manager

    def get_fork_weights(self, count: int) -> list[float]:
        """Per-fork slab weights (IAligner::getForkWeights): the probed
        throughputs of the CUDA cards, cycled to ``count`` forks
        (cuda_util.cpp:191 getGPUWeights)."""
        from masa_tpu_torch.utils.devices import device_weights

        w = device_weights(probe=True)
        return [w[k % len(w)] for k in range(count)]

    def initialize(self) -> None:
        pass

    def finalize(self) -> None:
        pass

    def set_sequences(self, seq0: np.ndarray, seq1: np.ndarray) -> None:
        self._seq0 = np.asarray(seq0, np.uint8)
        self._seq1 = np.asarray(seq1, np.uint8)

    def unset_sequences(self) -> None:
        self._seq0 = self._seq1 = None

    @abc.abstractmethod
    def align_partition(self, partition: Partition) -> None:
        """Compute the partition, dispatching rows/columns/scores through
        the manager."""

    def match_last_column(self, rev_h, rev_g, fwd_h, fwd_g, goal: int
                          ) -> MatchResult:
        """The Myers-Miller matching fallback
        (AbstractAligner::matchLastColumn -> AlignerUtils::matchColumn)."""
        return match_column(rev_h, rev_g, fwd_h, fwd_g, goal,
                            self.manager.params.gap_open)

    def clear_statistics(self) -> None:
        self.stats = AlignerStats()


class CUDAAligner(Aligner):
    """The strip engine on ``device``.  Its device views of the sequences
    come from the device sequence cache (``wavefront.dev_seq``), so an
    array that is there already (stage 1's, the reverse march's flips of
    them) is not copied again; partitions and strips slice the views."""

    def __init__(self, cfg: wf.StripConfig, device):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self._dev0 = self._dev1 = None

    def get_capabilities(self) -> AlignerCapabilities:
        return AlignerCapabilities()  # block pruning included

    def set_sequences(self, seq0: np.ndarray, seq1: np.ndarray) -> None:
        super().set_sequences(seq0, seq1)
        self._dev0 = wf.dev_seq(self._seq0, self.device)
        self._dev1 = wf.dev_seq(self._seq1, self.device)

    def unset_sequences(self) -> None:
        super().unset_sequences()
        self._dev0 = self._dev1 = None

    def align_partition(self, partition: Partition) -> None:
        mgr = self.manager
        p = partition
        cfg = dataclasses.replace(
            self.cfg,
            recurrence=mgr.recurrence,
            track_best=mgr.must_dispatch_scores(),
            store_lastcol=mgr.must_dispatch_last_column(),
            match=mgr.params.match,
            mismatch=mgr.params.mismatch,
            gap_open=mgr.params.gap_open,
            gap_ext=mgr.params.gap_ext,
        )
        iv = mgr.get_special_row_interval()

        def on_row(r, bus_h, bus_f):
            mgr.dispatch_row(p.i0 + r, bus_h, bus_f)

        def stop(out, rows_done, strip_rows, col_off):
            with trace.span("wait"):
                got = out.best.tolist()
            s, bi, bj = (int(v) for v in got)
            mgr.dispatch_score(p.i0 + rows_done - strip_rows + bi + 1,
                               p.j0 + col_off + bj + 1, s)
            return not mgr.must_continue()

        on_best = None
        if iv and cfg.track_best and mgr.must_dispatch_row_bests():
            def on_best(r, i, j, score):
                mgr.dispatch_row_best(p.i0 + r, p.i0 + i, p.j0 + j, score)

        blocks = None
        if mgr.blocks_sink is not None:
            def blocks(rows_done, maxima):
                mgr.dispatch_block_scores(p.i0 + rows_done, maxima)

        # special rows kept where they were computed: copies to the row
        # cache, and the store's rows copied to the host on its demand
        on_row_dev = on_row_lazy = None
        if iv and mgr.special_dev_sink is not None:
            def on_row_dev(r, dev_h, dev_f):
                mgr.dispatch_row_dev(p.i0 + r, dev_h, dev_f)
        if iv and mgr.lazy_special_rows:
            def on_row_lazy(r, pull):
                mgr.dispatch_row_lazy(p.i0 + r, pull)
        # a cut on the device is matched there: the reverse pass's last
        # row stays on the device too, and three values come back
        dev_match = mgr.goal_base_dev is not None

        # per-strip score dispatch only when the manager wants every
        # candidate: a partition is one launch on the card, so there is no
        # later strip for a mid-flight goal stop to skip
        res = strips.run_partition(
            cfg, self._dev0[p.i0:p.i1], self._dev1[p.j0:p.j1], mgr.params,
            mgr.get_first_row_init_type(), mgr.get_first_column_init_type(),
            first_row=mgr.receive_first_row(),
            first_col=mgr.receive_first_column(),
            special_every=iv,
            on_special_row=on_row if iv else None,
            stop_check=(stop if cfg.track_best and mgr.want_all_scores
                        else None),
            prune=mgr.must_prune_blocks(),
            pad_rows=mgr.pad_rows,
            blocks_sink=blocks,
            want_last_row=mgr.must_dispatch_last_row() and not dev_match,
            best_in=mgr.best_in,
            on_special_row_dev=on_row_dev,
            on_special_row_lazy=on_row_lazy,
            on_special_best=on_best,
            want_dev_last=dev_match,
        )
        self.stats.cells += res.cells
        self.stats.pruned_cells += res.pruned_cells
        self.stats.partitions += 1
        if res.dev_last is not None:
            mgr.dispatch_last_row_device(p.i1, *res.dev_last)
        if res.last_h is not None:
            mgr.dispatch_last_row(p.i1, res.last_h, res.last_f)
        if cfg.store_lastcol:
            mgr.dispatch_last_column(p.j1, res.col_h, res.col_e)
        if cfg.track_best:
            mgr.dispatch_score(p.i0 + res.best_i, p.j0 + res.best_j,
                               res.best)


class CPUAligner(Aligner):
    """Scalar oracle extension — the differential baseline."""

    def get_capabilities(self) -> AlignerCapabilities:
        caps = AlignerCapabilities()
        caps.block_pruning = False
        caps.maximum_seq0_len = 1 << 20
        caps.maximum_seq1_len = 1 << 20
        return caps

    def align_partition(self, partition: Partition) -> None:
        mgr = self.manager
        p = partition
        sub0 = self._seq0[p.i0:p.i1]
        sub1 = self._seq1[p.j0:p.j1]
        iv = mgr.get_special_row_interval()
        rows = tuple(range(iv, p.height + 1, iv)) if iv else ()
        bests = {} if mgr.must_dispatch_row_bests() else None
        res = oracle.dp_rows(
            sub0, sub1, mgr.params, mgr.recurrence,
            mgr.get_first_row_init_type(), mgr.get_first_column_init_type(),
            first_row=mgr.receive_first_row(),
            first_col=mgr.receive_first_column(),
            special_rows=rows,
            row_bests=mgr.want_all_scores,
            special_best=bests,
        )
        self.stats.cells += p.height * p.width
        self.stats.partitions += 1
        for r in sorted(res.specials):
            h, f = res.specials[r]
            if bests and r in bests:
                b, bi, bj = bests[r]
                mgr.dispatch_row_best(p.i0 + r, p.i0 + bi, p.j0 + bj, b)
            mgr.dispatch_row(p.i0 + r, h[1:], f[1:])
        if mgr.must_dispatch_last_row():
            mgr.dispatch_last_row(p.i1, res.last_h, res.last_f)
        if mgr.must_dispatch_last_column():
            mgr.dispatch_last_column(p.j1, res.col_h, res.col_e)
        if mgr.must_dispatch_scores():
            if mgr.want_all_scores and res.row_best_val is not None:
                for i in range(p.height):
                    mgr.dispatch_score(p.i0 + i + 1,
                                       p.j0 + int(res.row_best_j[i]),
                                       int(res.row_best_val[i]))
            if mgr.recurrence == Recurrence.NEEDLEMAN_WUNSCH:
                # dp_rows' SW-style running best is wrong for NW values;
                # recompute densely (the reverse-pass start search)
                dres = oracle.dp_matrix(
                    sub0, sub1, mgr.params, mgr.recurrence,
                    mgr.get_first_row_init_type(),
                    mgr.get_first_column_init_type(),
                    first_row=mgr.receive_first_row(),
                    first_col=mgr.receive_first_column(),
                )
                b, bi, bj = dres.best()
                mgr.dispatch_score(p.i0 + bi, p.j0 + bj, b)
            else:
                mgr.dispatch_score(p.i0 + res.best_i, p.j0 + res.best_j,
                                   res.best)
