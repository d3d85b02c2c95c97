"""The port's BlockAligner / Grid / SafeAligner (masa_tpu_torch/core/
block_aligner.py, core/grid.py) against the port's oracle and against
masa_tpu's, on the CPU: the counterpart of tests/test_block_aligner.py.

Both run on the host in both packages (numpy and the oracle), so no device
enters.  Each case drives the same seeded inputs through masa_tpu's
aligner under masa_tpu's manager and through the port's under the port's,
and compares what reached the managers: the dispatched special rows, the
last row, the last column, the best and ``pruned_cells``.  Tolerance 0.
Values cross between the packages through ``masa_tpu_torch.convert``."""

import importlib
import threading

import numpy as np
import pytest

import masa_tpu
import masa_tpu_torch
from masa_tpu_torch import convert
from masa_tpu_torch.core.block_aligner import BlockAligner, SafeAligner
from masa_tpu_torch.core.grid import Grid, split_evenly
from masa_tpu_torch.core.manager import AlignerManager
from masa_tpu_torch.core.pruning import BlockPruningGeneric
from masa_tpu_torch.models.scoring import border_cells
from masa_tpu_torch.ops import oracle
from masa_tpu_torch.stages.core import SpecialRowStore, border_gap_values
from masa_tpu_torch.types import InitType, Partition, Recurrence, ScoreParams

BASES = np.frombuffer(b"ACGT", np.uint8)
BOTH = (masa_tpu, masa_tpu_torch)
SW, NW = Recurrence.SMITH_WATERMAN, Recurrence.NEEDLEMAN_WUNSCH


def mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def rand_seqs(m, n, seed):
    rng = np.random.default_rng(seed)
    return rng.choice(BASES, m).astype(np.uint8), rng.choice(
        BASES, n).astype(np.uint8)


def similar_seqs(m, seed, mut=0.1):
    rng = np.random.default_rng(seed)
    s0 = rng.choice(BASES, m).astype(np.uint8)
    s1 = s0.copy()
    idx = rng.random(m) < mut
    s1[idx] = rng.choice(BASES, int(idx.sum())).astype(np.uint8)
    return s0, s1


def drive(pkg, s0, s1, rec, part, block, row=(InitType.WITH_ZEROES, None),
          col=(InitType.WITH_ZEROES, None), interval=0, prune=False,
          safe=False):
    """One partition through ``pkg``'s BlockAligner under ``pkg``'s
    manager; what the manager received, as plain data.  ``rec``, ``row``,
    ``col`` and ``part`` are the port's values, named over to ``pkg``."""
    t, ba = mod(pkg, "types"), mod(pkg, "core.block_aligner")
    al = ba.BlockAligner(block_height=block[0], block_width=block[1])
    if safe:
        al = ba.SafeAligner(al)
    mgr = mod(pkg, "core.manager").AlignerManager(al, t.ScoreParams())
    mgr.set_recurrence_type(t.Recurrence[rec.name])
    mgr.set_first_row(t.InitType[row[0].name], row[1])
    mgr.set_first_column(t.InitType[col[0].name], col[1])
    mgr.last_column_wanted = True
    store = mod(pkg, "stages.core").SpecialRowStore()
    mgr.set_special_rows_store(store)
    mgr.set_special_row_interval(interval)
    mgr.set_block_pruning(prune)
    al.set_sequences(s0, s1)
    mgr.align_partition(t.Partition(*part))
    best = mgr.best_scores.best if len(mgr.best_scores) else None
    return {
        "rows": {r: [np.asarray(x).tolist() for x in store.get(r)]
                 for r in store.rows()},
        "last_row": [mgr.last_row[0]] + [np.asarray(x).tolist()
                                         for x in mgr.last_row[1:]],
        "last_column": [mgr.last_column[0]] + [
            np.asarray(x).tolist() for x in mgr.last_column[1:]],
        "best": None if best is None else (best.score, best.i, best.j),
        "cells": al.stats.cells, "pruned_cells": al.stats.pruned_cells,
        "partitions": al.stats.partitions,
    }


def both(*args, **kw):
    ref, got = (drive(pkg, *args, **kw) for pkg in BOTH)
    assert got == ref
    return got


def test_split_evenly():
    ref = mod(masa_tpu, "core.grid").split_evenly
    for total, count in ((10, 3), (2, 5), (0, 4), (7, 7), (100, 1)):
        assert split_evenly(total, count) == ref(total, count)
    sizes = np.diff(split_evenly(10, 3))
    assert sizes.sum() == 10 and sizes.max() - sizes.min() <= 1
    assert split_evenly(2, 5) == [0, 1, 2]  # count clamped to total


def test_grid_blocks_cover_partition():
    p = Partition(5, 7, 105, 260)
    g = Grid.with_block_size(p, 33, 77)
    seen = np.zeros((p.height, p.width), bool)
    for bi in range(g.nbi):
        for bj in range(g.nbj):
            b = g.block(bi, bj)
            assert b.i0 >= p.i0 and b.j1 <= p.j1
            seen[b.i0 - p.i0:b.i1 - p.i0, b.j0 - p.j0:b.j1 - p.j0] = True
    assert seen.all()
    bi, bj = g.block_of(40, 100)
    b = g.block(bi, bj)
    assert b.i0 <= 40 < b.i1 and b.j0 <= 100 < b.j1
    # the reference's lattice, block for block
    rt, rg = mod(masa_tpu, "types"), mod(masa_tpu, "core.grid")
    for make, args in (("with_block_size", (33, 77)),
                       ("with_block_count", (4, 3))):
        ours = getattr(Grid, make)(p, *args)
        ref = getattr(rg.Grid, make)(rt.Partition(5, 7, 105, 260), *args)
        assert (ours.splits_i, ours.splits_j) == (ref.splits_i, ref.splits_j)
        assert convert.to_plain(ours.block(1, 2)) == convert.to_plain(
            ref.block(1, 2))
        assert ours.block_of(77, 200) == ref.block_of(77, 200)


@pytest.mark.parametrize("rec", [SW, NW])
@pytest.mark.parametrize("inits", [
    (InitType.WITH_ZEROES, InitType.WITH_ZEROES),
    (InitType.WITH_GAPS, InitType.WITH_GAPS),
])
def test_block_aligner_matches_oracle(rec, inits):
    m, n = 233, 181
    s0, s1 = rand_seqs(m, n, 3)
    params = ScoreParams()
    ref = oracle.dp_matrix(s0, s1, params, rec, inits[0], inits[1])
    got = both(s0, s1, rec, (0, 0, m, n), (64, 48), row=(inits[0], None),
               col=(inits[1], None), interval=64)

    row, lh, lf = got["last_row"]
    assert row == m
    np.testing.assert_array_equal(lh, ref.h[-1])
    # element 0 carries the manager's synthesized border gap, not the
    # dense matrix's -INF placeholder
    np.testing.assert_array_equal(lf[1:], ref.f[-1][1:])
    col, ch, ce = got["last_column"]
    assert col == n
    np.testing.assert_array_equal(ch, ref.h[:, -1])
    # E of the last column: row 0's E is unrepresentable (-INF convention)
    np.testing.assert_array_equal(ce[1:], ref.e[1:, -1])
    if rec == SW:
        assert got["best"] == ref.best()
    # special rows at block-row boundaries
    col_h, _ = border_cells(m + 1, inits[1], params)
    syn = border_gap_values(col_h.astype(np.int64), params)
    assert len(got["rows"]) >= 2
    for r, (h, f) in got["rows"].items():
        np.testing.assert_array_equal(h, ref.h[r])
        np.testing.assert_array_equal(f[1:], ref.f[r][1:])
        assert f[0] == syn[r]


def test_block_aligner_custom_borders_match_oracle():
    """A sub-rectangle computed with CUSTOM borders must equal the dense
    matrix's interior values (the stage-3 partition contract)."""
    m, n = 160, 140
    s0, s1 = similar_seqs(m, 11)[0], similar_seqs(n, 12)[0]
    ref = oracle.dp_matrix(s0, s1, ScoreParams(), NW, InitType.WITH_GAPS,
                           InitType.WITH_GAPS)
    i0, j0 = 40, 30
    got = both(s0, s1, NW, (i0, j0, m, n), (37, 29),
               row=(InitType.CUSTOM, (ref.h[i0, j0:], ref.f[i0, j0:])),
               col=(InitType.CUSTOM, (ref.h[i0:, j0], ref.e[i0:, j0])))
    _, lh, lf = got["last_row"]
    np.testing.assert_array_equal(lh, ref.h[-1, j0:])
    # element 0 is the border column's F, which a partition cannot know:
    # passed through by convention
    np.testing.assert_array_equal(lf[1:], ref.f[-1, j0 + 1:])


def test_block_pruning_generic_keeps_best_score():
    """Pruning may skip cells but must preserve the best score/location
    for similar sequences (where the best is found early)."""
    m = 700
    s0, s1 = similar_seqs(m, 5, mut=0.05)
    ref = oracle.dp_rows(s0, s1, ScoreParams(), SW)
    got = both(s0, s1, SW, (0, 0, m, m), (96, 96), prune=True)
    assert got["best"] == (ref.best, ref.best_i, ref.best_j)
    assert got["pruned_cells"] > 0
    assert got["cells"] + got["pruned_cells"] == m * m


def test_block_pruning_generic_bound():
    pr = BlockPruningGeneric(1000, 1000, ScoreParams(), best=100)
    # 50 rows x 1000 cols left, entering 40 -> 40 + 50 <= 100: prunable
    assert pr.is_prunable(950, 0, 40)
    # entering 60 -> 60 + 50 > 100: not prunable
    assert not pr.is_prunable(950, 0, 60)
    # NW never prunes
    pr_nw = BlockPruningGeneric(1000, 1000, ScoreParams(), NW, best=10**6)
    assert not pr_nw.is_prunable(999, 999, -10**9)


def test_safe_aligner_serializes_threads():
    m, n = 120, 130
    s0, s1 = rand_seqs(m, n, 8)
    params = ScoreParams()
    ref = oracle.dp_matrix(s0, s1, params)
    results = []

    def run():
        al = SafeAligner(BlockAligner(block_height=40, block_width=50))
        mgr = AlignerManager(al, params)
        al.set_sequences(s0, s1)
        mgr.align_partition(Partition(0, 0, m, n))
        results.append(mgr.best_scores.best.score)

    ts = [threading.Thread(target=run) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert results == [ref.best()[0]] * 4
    # the wrapper forwards the whole contract: the reference's, too
    got = both(s0, s1, SW, (0, 0, m, n), (40, 50), safe=True)
    assert got["best"] == ref.best()
