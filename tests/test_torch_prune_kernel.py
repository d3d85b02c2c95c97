"""Block pruning inside a launch (the strip kernel's PRUNE instances),
through its plain twin ``wavefront.strip_plain_pruned``, on the CPU.

On the card one launch covers a whole stage-1 partition, so the strip
kernel prunes inside it: each sub-strip skips the prefix of its 512-column
chunks that masa_tpu's bound (``masa_tpu.core.pruning.pruning_window``)
says cannot beat ``B_g``, the best of the sub-strips at least ``blocks``
above it.  The twin computes the same outputs and record as the kernel;
here it is held against masa_tpu at 2^10-2^13 homologs (8% substitutions),
64-512-row sub-strips and 1-4 blocks: the best and its endpoint equal
masa_tpu's and its oracle's, each decision is masa_tpu's window for that
sub-strip's entering bus and ``B_g``, ``B_g`` never passes the best of the
rows above, ties go to the earlier row, NW and the last column never prune,
and a six-stage alignment through the rule gives masa_tpu's score with the
stage-5 invariant and the stage-6 re-score.  ``tests/test_torch_cuda.py``
holds the kernel against the twin on the card.  Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from masa_tpu.core import pruning as jpruning
from masa_tpu.core.job import Job as JJob
from masa_tpu.core.job import JobConfig as JJobConfig
from masa_tpu.ops import oracle
from masa_tpu.ops import wavefront as jwf
from masa_tpu.stages import core as jcore
from masa_tpu.stages import runner as jrunner
from masa_tpu.types import InitType, Recurrence, ScoreParams
from masa_tpu_torch import convert
from masa_tpu_torch.core.job import Job, JobConfig
from masa_tpu_torch.ops import kernels, strips
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import core, runner, stage6

P = ScoreParams()
Z = InitType.WITH_ZEROES
SW = Recurrence.SMITH_WATERMAN
C = wf.PRUNE_CHUNK
NEG = -wf.INF
KW = dict(match=P.match, mismatch=P.mismatch, gap_open=P.gap_open,
          gap_ext=P.gap_ext, sw=True, track_best=True)
port = convert.to_port


@pytest.fixture
def bench_pair(dna, homolog):
    """A bench.py-style homolog: 8% substitutions, rare short indels."""
    def make(n, seed):
        s0 = dna(n, seed=seed)
        return s0, homolog(s0, seed=seed + 1, sub_rate=0.08,
                           indel_rate=0.002)
    return make


def forward(s0, s1, prune, cfg, rec=SW, **kw):
    return core.forward_pass(s0, s1, port(P), port(rec), port(Z), port(Z),
                             prune=prune, backend="kernel", cfg=cfg,
                             device="cpu", **kw)


def strip_inputs(s0, s1, i0=0, col_off=0):
    """The launch of rows [i0, len(s0)) and columns [col_off, len(s1)) of
    the partition (s0, s1): its characters, the row above it from an
    unpruned sweep, and its left border (the zero border, or the -INF wall
    of a host window starting past column 0)."""
    t = torch.from_numpy
    a, b = t(s0.copy()), t(s1.copy())
    bus_h, bus_f = wf.init_bus(Z, len(s1), P.gap_open, P.gap_ext, "cpu")
    if i0:
        up = wf.strip_plain(a[:i0], b, bus_h, bus_f,
                            torch.zeros(i0, dtype=torch.int32),
                            torch.full((i0,), NEG, dtype=torch.int32), 0,
                            **KW)
        bus_h, bus_f = up.bus_h, up.bus_f
    h = len(s0) - i0
    if col_off:
        ch = ce = torch.full((h,), NEG, dtype=torch.int32)
        corner = NEG
    else:
        ch = torch.zeros(h, dtype=torch.int32)
        ce = torch.full((h,), NEG, dtype=torch.int32)
        corner = 0
    return (a[i0:], b[col_off:], bus_h[col_off:].contiguous(),
            bus_f[col_off:].contiguous(), ch, ce, corner)


@pytest.mark.parametrize("n,strip_rows,rows,blocks", [
    (1024, 1024, 64, 1), (2048, 2048, 128, 2), (4096, 1024, 256, 4),
    (4096, 4096, 512, 1), (8192, 8192, 256, 4)])
def test_best_and_endpoint_equal_masa_tpu(bench_pair, n, strip_rows, rows,
                                          blocks):
    """A partition through the in-launch rule (strips of ``strip_rows``,
    the host window between them): masa_tpu's best and endpoint, pruned or
    not, and its oracle's; cells and pruned cells add up to m n, and the
    rule prunes more than the window between strips alone."""
    s0, s1 = bench_pair(n, seed=n + rows)
    cfg = wf.StripConfig(rows=strip_rows)
    got = forward(s0, s1, True, dataclasses.replace(
        cfg, launch_prune=(rows, blocks)))
    host = forward(s0, s1, True, cfg)
    ref = jcore.forward_pass(s0, s1, P, SW, Z, Z, prune=True,
                             backend="kernel",
                             cfg=jwf.WavefrontConfig(alpha=4, rs=1, chunk=512))
    o = oracle.dp_rows(s0, s1)
    want = (o.best, o.best_i, o.best_j)
    assert (ref.best, ref.best_i, ref.best_j) == want
    assert (got.best, got.best_i, got.best_j) == want
    assert got.cells + got.pruned_cells == len(s0) * len(s1)
    assert got.pruned_cells > host.pruned_cells


def row_bests(args):
    """The unpruned sweep's best of each row: every row flushed."""
    out = wf.strip_plain(*args, **KW, flush_every=1)
    last = out.bus_h.max().view(1)
    if out.rows_h is None:
        return last.long()
    return torch.cat([out.rows_h.max(1).values, last]).long()


@pytest.mark.parametrize("i0,col_off,b_in", [(0, 0, 0), (512, 512, 300)])
@pytest.mark.parametrize("rows,blocks", [(64, 1), (128, 3), (256, 2)])
def test_each_decision_is_masa_tpus_window(bench_pair, i0, col_off, b_in,
                                           rows, blocks):
    """Every sub-strip's first column kept is masa_tpu's window for its
    entering bus (a row flushed at each sub-strip's end), its border and
    ``B_g``; ``B_g`` is ``max(best_in, best of sub-strips <= g - blocks)``
    and never passes the best of the unpruned rows above the sub-strip.
    The launch may sit below and right of the partition's corner, with a
    best handed in."""
    s0, s1 = bench_pair(2048 + i0, seed=31)
    m, n = len(s0), len(s1)
    args = strip_inputs(s0, s1, i0, col_off)
    h, nj = args[0].numel(), args[1].numel()
    lp = wf.LaunchPrune(m, n, i0, col_off, torch.tensor([b_in]))
    bus_h, _, best_v, _, _, _, rows_h, _, rec = wf.strip_plain_pruned(
        *args, lp, (rows, blocks), **KW, flush_every=rows)
    truth = row_bests(args)
    assert (rec.rows, rec.blocks) == (rows, blocks)
    assert tuple(rec.record.shape) == (-(-h // rows), 2)
    ng = -(-nj // C)
    for g, (lo, bg) in enumerate(rec.record.tolist()):
        top = g * rows
        bus = args[2] if g == 0 else rows_h[g - 1]
        padded = np.full(ng * C, NEG, np.int64)
        padded[:nj] = bus.numpy()
        border = max([args[6] if g == 0 else int(args[4][top - 1])]
                     + args[4][top:top + rows].tolist())
        wl, wr = jpruning.pruning_window(
            jpruning.chunk_maxima(padded, ng, C), bg, i0 + top, m, n, C, P,
            border_max=border)
        assert lo == (min(wl * C, nj) if wl < wr else nj), g
        done = (g - blocks + 1) * rows  # rows of sub-strips <= g - blocks
        assert bg == max([b_in] + best_v[:max(done, 0)].tolist()), g
        assert bg <= max([b_in] + truth[:top].tolist()), g
    assert int(rec.record[:, 0].sum()) > 0  # the rule fired
    assert int(best_v.max()) == int(truth.max())
    assert bool((bus_h <= wf.strip_plain(*args, **KW).bus_h).all())


def test_two_runs_write_the_same_rows_and_record(bench_pair):
    """The decisions are a function of the inputs and the geometry: two
    runs give the same outputs, flushed rows and record, byte for byte."""
    s0, s1 = bench_pair(2048, seed=41)
    args = strip_inputs(s0, s1)
    lp = wf.LaunchPrune(len(s0), len(s1), 0, 0, torch.tensor([0]))
    one, two = (wf.strip_plain_pruned(*args, lp, (64, 2), **KW,
                                      flush_every=100) for _ in range(2))
    for x, y in zip(one[:8], two[:8]):
        assert (x is None and y is None) or torch.equal(x, y)
    assert torch.equal(one[8].record, two[8].record)
    assert int(one[8].record[:, 0].sum()) > 0


@pytest.mark.parametrize("rows,blocks", [(64, 1), (64, 2), (128, 1)])
def test_ties_go_to_the_earlier_row(dna, rows, blocks):
    """One sequence twice against itself: the same best ends at rows L and
    2L, in two sub-strips.  The rule prunes the second copy (it can only
    tie) and the endpoint stays the first, as masa_tpu's and the oracle's."""
    x = dna(512, seed=51)
    s0, s1 = np.concatenate([x, x]), x.copy()
    cfg = wf.StripConfig(rows=len(s0), launch_prune=(rows, blocks))
    got = forward(s0, s1, True, cfg)
    o = oracle.dp_rows(s0, s1)
    ref = jcore.forward_pass(s0, s1, P, SW, Z, Z, prune=True,
                             backend="kernel",
                             cfg=jwf.WavefrontConfig(alpha=4, rs=1, chunk=512))
    assert (got.best, got.best_i, got.best_j) == (o.best, o.best_i, o.best_j)
    assert (ref.best, ref.best_i, ref.best_j) == (512, 512, 512)
    assert got.best_i == 512 and got.pruned_cells > 0


def test_nw_and_the_last_column_never_prune(bench_pair):
    """NW (pinned ends) and a launch that stores its last column take the
    host rule's exits: no pruning, the same results as unpruned.  Asked
    directly, the twin and the kernel's wrapper refuse (the wrapper before
    it looks at the device)."""
    s0, s1 = bench_pair(1024, seed=61)
    cfg = wf.StripConfig(rows=1024, launch_prune=(64, 1))
    nw = forward(s0, s1, True, cfg, rec=Recurrence.NEEDLEMAN_WUNSCH)
    nw_full = forward(s0, s1, False, cfg, rec=Recurrence.NEEDLEMAN_WUNSCH)
    assert nw.pruned_cells == 0
    np.testing.assert_array_equal(nw.last_h, nw_full.last_h)
    col = forward(s0, s1, True, cfg, want_lastcol=True)
    col_full = forward(s0, s1, False, cfg, want_lastcol=True)
    assert col.pruned_cells == 0
    np.testing.assert_array_equal(col.col_h, col_full.col_h)
    np.testing.assert_array_equal(col.last_h, col_full.last_h)

    args = strip_inputs(s0, s1)
    lp = wf.LaunchPrune(len(s0), len(s1), 0, 0, torch.tensor([0]))
    for bad in (dict(sw=False), dict(store_lastcol=True),
                dict(track_best=False)):
        kw = {**KW, **bad}
        with pytest.raises(ValueError, match="pruning"):
            wf.strip_plain_pruned(*args, lp, (64, 1), **kw)
        with pytest.raises(ValueError, match="pruning"):
            kernels.strip_cuda(*args, **kw, prune=lp)


def test_one_sub_strip_a_launch_adds_nothing_to_the_window(bench_pair):
    """With one sub-strip a launch the rule decides against the same best
    as the window between strips, which has already cut the launch to
    its first kept chunk: it skips nothing more, and the results are the
    window's alone (the CPU path's without ``launch_prune``)."""
    s0, s1 = bench_pair(2048, seed=71)
    plain = forward(s0, s1, True, wf.StripConfig(rows=512))
    launch = forward(s0, s1, True, wf.StripConfig(rows=512,
                                                  launch_prune=(512, 1)))
    assert plain.pruned_cells == launch.pruned_cells > 0
    assert (plain.best, plain.best_i, plain.best_j) == \
        (launch.best, launch.best_i, launch.best_j)


def test_a_best_from_above_prunes_more_and_keeps_the_result(bench_pair):
    """``best_in`` (a resumed stage 1's best, reached above the partition)
    raises every ``B_g`` to at least it: below the optimum it prunes more
    and leaves the best and its endpoint as they were; the CPU path
    without ``launch_prune`` ignores it, as masa_tpu has no such input."""
    s0, s1 = bench_pair(2048, seed=91)
    o = oracle.dp_rows(s0, s1)
    cfg = wf.StripConfig(rows=2048, launch_prune=(128, 2))
    plain = forward(s0, s1, True, cfg)
    floor = forward(s0, s1, True, cfg, best_in=o.best - 1)
    assert (floor.best, floor.best_i, floor.best_j) == \
        (o.best, o.best_i, o.best_j)
    assert floor.pruned_cells > plain.pruned_cells
    host = wf.StripConfig(rows=512)
    assert forward(s0, s1, True, host, best_in=o.best - 1).pruned_cells \
        == forward(s0, s1, True, host).pruned_cells


@pytest.mark.parametrize("rows,blocks,flush", [(64, 2, 32), (64, 3, 128),
                                               (128, 1, 128)])
def test_a_sampled_check_reproduces_the_launch(rows, blocks, flush):
    """``tools/strip_tune.check_pruned_span``, which holds the card's
    launches taller than the grid against the twin on sampled sub-strips,
    re-runs the twin a sub-strip at a time from the launch's own flushed
    rows and per-row bests: on the twin's own outputs every span passes,
    and one changed cell of the leaving bus's -INF prefix, of a per-row
    best or of a record's ``B_g`` fails it."""
    from masa_tpu_torch.tools import strip_tune

    nj = 2048
    h = 2 * nj + 3 * rows + 5
    args = strip_tune.pruned_inputs(3, h, nj, "cpu")
    lp = wf.LaunchPrune(h, nj, 0, 0, torch.tensor([0]))
    out = wf.strip_plain_pruned(*args, lp, (rows, blocks),
                                **strip_tune.PRUNE_KW, flush_every=flush)
    rec = out[8]
    n_sub = len(rec.record)
    firsts = strip_tune.check_pruned_span(args, out, lp, flush, 0, n_sub,
                                          strip_tune.PRUNE_KW)
    assert firsts == rec.record[:, 0].tolist()
    step = max(1, flush // rows)
    g = max(g for g in range(0, n_sub - step, step)
            if 0 < firsts[g + step - 1] < nj)
    span = (args, out, lp, flush, g, g + step, strip_tune.PRUNE_KW)
    assert strip_tune.check_pruned_span(*span) == firsts[g:g + step]
    leaving = ((g + step) * rows) // flush - 1
    for k, at in ((6, (leaving, 0)), (2, g * rows), (8, (g, 1))):
        bad = list(out)
        if k == 8:
            bad[8] = rec._replace(record=rec.record.clone())
            bad[8].record[at] += 1
        else:
            bad[k] = out[k].clone()
            bad[k][at] += 1
        with pytest.raises(AssertionError):
            strip_tune.check_pruned_span(*((args, bad) + span[2:]))
    with pytest.raises(ValueError, match="flushed"):
        strip_tune.check_pruned_span(args, out, lp, flush, g, g + step + 1
                                     if flush > rows else n_sub + 1,
                                     strip_tune.PRUNE_KW)


def quiet(*a, **k):
    pass


@pytest.mark.parametrize("crash", [False, True], ids=["whole", "resumed"])
def test_six_stages_through_the_rule(bench_pair, tmp_path, monkeypatch,
                                     crash):
    """A full alignment whose stage 1 prunes inside its launches (2048-row
    strips of 64-row sub-strips on 2 blocks): masa_tpu's score, stage 5
    verified, the stage-6 re-score equal, pruned cells in the statistics.
    Resumed after a crash two special rows in, the rule counts the rows
    from the resumed partition's top and still gives the same score."""
    s0, s1 = bench_pair(4096, seed=81)
    base = dict(ram_limit=0, disk_limit=1 << 20, backend="kernel")
    mine = Job(JobConfig(work_dir=str(tmp_path / "port"),
                         **convert.to_port(base)), device="cpu")
    ref = JJob(JJobConfig(work_dir=str(tmp_path / "ref"), **base))
    cfg = wf.StripConfig(rows=2048, launch_prune=(64, 2))
    msgs = []
    if crash:
        put = runner._OffsetStore.put
        calls = {"n": 0}

        def dying(self, r, h, f):
            calls["n"] += 1
            if calls["n"] > 2:
                raise KeyboardInterrupt("simulated crash")
            put(self, r, h, f)

        monkeypatch.setattr(runner._OffsetStore, "put", dying)
        with pytest.raises(KeyboardInterrupt):
            runner.stage1(mine, s0, s1, kernel_cfg=cfg, log=quiet)
        monkeypatch.setattr(runner._OffsetStore, "put", put)
        mine = Job(mine.cfg, device="cpu")
    aln = runner.align_job(mine, s0, s1, kernel_cfg=cfg, log=msgs.append)
    want = jrunner.align_job(ref, s0, s1, log=quiet)
    assert aln.raw_score == want.raw_score == oracle.dp_rows(s0, s1).best
    assert any(m.startswith(f"stage5: score={aln.raw_score} verified")
               for m in msgs)
    assert stage6.recheck(aln, s0, s1).score == aln.raw_score
    assert any(m.startswith("stage1: resuming") for m in msgs) == crash
    with open(mine.path("statistics_01.00")) as fh:
        pruned = int(fh.read().split("pruned_cells: ")[1].split()[0])
    assert pruned > 0


def test_the_record_counts_the_skipped_cells():
    """``PruneRecord.pruned_cells``: each sub-strip's first column kept
    times its height, the last sub-strip partial."""
    rec = wf.PruneRecord(torch.tensor([[0, 5], [512, 9], [1024, 9]],
                                      dtype=torch.int32), 64, 2)
    assert rec.pruned_cells(64 * 2 + 10) == 512 * 64 + 1024 * 10
    assert rec.pruned_cells(64 * 2 + 10, [0, 0, 7]) == 70


def test_the_chunk_mirrors_the_kernel():
    """The decisions' grain is one constant on both sides."""
    with open(kernels.SOURCES["strip"]) as fh:
        src = fh.read()
    assert f"constexpr int PCHUNK = {wf.PRUNE_CHUNK};" in src
    assert strips.PRUNE_CHUNK == wf.PRUNE_CHUNK
