"""Persistent stage functions of the port: the pipeline wired to the work
directory's artifacts with crash-safe resume (counterpart of
masa_tpu/stages/runner.py; the reference's stage{1..6}/sw_stage{1..6}.cpp
plus the executeTraceback sequencing of libmasa.cpp:644-655).

The artifacts have masa_tpu's formats (``Job``, status file, crosspoint files,
special rows area, statistics, CGFF, stage-6 renderings), byte for byte
where the special-row cadence is the same, so a work directory written by
one package resumes under the other.  The stages run the port's passes on
``job.device``.  Stage 1 keeps its special rows on the device for the same
call's stage 2 (``core.DevRowCache`` on ``job.runtime_dev_rows``) and, where
they fit, hands them to the store lazily: disk rows are copied to the host
beside the work and written in the area's codec, RAM rows stay on the
device until read.  A resumed call has no cache, and its stage 2 reads cut
windows from the disk rows.  Left out: masa_tpu's stage-1 rung planner;
the special-row interval is aligned to ``pipeline.FLUSH_GRAIN`` on every
device."""

from __future__ import annotations

import dataclasses
import functools
import os
import time

import numpy as np

from masa_tpu_torch.biology import alignment as balign
from masa_tpu_torch.biology.sequence import Sequence
from masa_tpu_torch.core.best_score import BestScoreList
from masa_tpu_torch.core.blocks_file import BlocksFile
from masa_tpu_torch.models.scoring import border_cells
from masa_tpu_torch.stages import stage6 as st6
from masa_tpu_torch.types import (
    INF,
    AlignmentStart,
    Crosspoint,
    CrosspointType,
    InitType,
    Recurrence,
)
from masa_tpu_torch.utils.memory import process_vm_size
from masa_tpu_torch.utils.timer import RecurrentTimer, Timer
from masa_tpu_torch.core.job import Job
from masa_tpu_torch.ops import myers_miller as mm
from masa_tpu_torch.stages import core, pipeline
from masa_tpu_torch.utils import trace

STAGE_1, STAGE_2, STAGE_3, STAGE_4, STAGE_5, STAGE_6 = range(1, 7)


class _NoTruncate:
    """Multi-alignment runs share the stage-1 rows; truncation is
    disabled so later ids can still match."""

    def __init__(self, part):
        self._part = part

    def __getattr__(self, name):
        return getattr(self._part, name)

    def truncate_above(self, i):
        pass


class _OffsetDevCache:
    """A DevRowCache rebasing partition-frame rows (a resumed stage 1
    computes rows r0..m as 0..m-r0) to absolute ones; stage 2's reads are
    absolute already."""

    def __init__(self, cache: core.DevRowCache, offset: int):
        self.cache = cache
        self.offset = offset

    def put_dev(self, r, dev_h, dev_f):
        self.cache.put_dev(self.offset + r, dev_h, dev_f)

    def attach_border(self, r, h0, f0):
        self.cache.attach_border(self.offset + r, h0, f0)

    def get(self, r):
        return self.cache.get(r)

    def truncate_above(self, i):
        self.cache.truncate_above(i)


class _OffsetStore:
    """Stage 1's row sink: translates partition-local row indices (a
    resumed stage 1 computes rows r0..m as 0..m-r0) to absolute ones,
    mirroring progress into the status file.  Stage 2 reads the partition
    itself.

    Each special row goes into the status file before the partition:
    its number, and the best of the rows down to it where the pass
    tracks its best (``put_best``, called before the row), merged with
    ``above``, the best a resumed stage 1 found there (the earlier of
    equal scores kept, as one pass keeps it).  So a stage 1 resumed at
    row r0 takes the rows above r0's best from the status file.
    masa_tpu writes the best only when stage 1 ends, and a resumed stage
    1 there forgets the rows above r0."""

    def __init__(self, part, offset: int, job: Job, above=None):
        self.part = part
        self.offset = offset
        self.job = job
        self.best = above

    def put_best(self, r, i, j, score):
        cand = (self.offset + i, j, score)
        if self.best is None or (score, -cand[0], -j) > (
                self.best[2], -self.best[0], -self.best[1]):
            self.best = cand

    def put(self, r, h, f):
        self._progress(r)
        self.part.put(self.offset + r, h, f)

    def put_lazy(self, r, lazy):
        self._progress(r)
        self.part.put_lazy(self.offset + r, lazy)

    def _progress(self, r):
        self.job.status.update(last_special_row=self.offset + r,
                               best=self.best)

    def finalize(self):
        self.part.finalize()


def _pcfg(job: Job, kernel_cfg=None) -> pipeline.PipelineConfig:
    return pipeline.PipelineConfig(
        params=job.cfg.params,
        alignment_start=job.cfg.alignment_start,
        alignment_end=job.cfg.alignment_end,
        backend=job.cfg.backend,
        kernel_cfg=kernel_cfg,
        max_cells_stage5=job.cfg.stage5_max_cells,
        device=job.device,
    )


def _load(cpf) -> tuple[list[Crosspoint], bool]:
    """A crosspoint file's crosspoints and whether it was completed (END);
    ([], False) when it is missing or unreadable."""
    if not os.path.exists(cpf.path):
        return [], False
    try:
        cps = cpf.load()
    except (OSError, ValueError):
        return [], False
    return cps, cpf.complete and bool(cps)


def _end_autosave(cpf) -> None:
    """Close a file's autosave handle without its END: the ascending
    save() that follows is its complete form."""
    if cpf._fh:
        cpf._fh.close()
        cpf._fh = None


def _stage(fn):
    """A stage function (the job first) run inside its stage's trace
    span on the job's device (``utils/trace.stage``)."""
    @functools.wraps(fn)
    def run(job, *args, **kw):
        with trace.stage(fn.__name__, job.device):
            return fn(job, *args, **kw)

    return run


@_stage
def stage1(job: Job, seq0: np.ndarray, seq1: np.ndarray,
           kernel_cfg=None, log=print) -> BestScoreList:
    """Forward pass over the whole matrix with persisted special rows;
    resumable from the last flushed row (sw_stage1.cpp:210-217)."""
    t0 = time.time()
    m, n = len(seq0), len(seq1)
    pcfg = _pcfg(job, kernel_cfg)
    ivs = job.calculate_flush_intervals(m, n, align_to=pipeline.FLUSH_GRAIN)
    cpf = job.crosspoints_file(STAGE_1, 0)

    if _load(cpf)[1]:
        best = BestScoreList(job.cfg.max_alignments)
        for aln_id in range(job.cfg.max_alignments):
            cps, complete = _load(job.crosspoints_file(STAGE_1, aln_id))
            if not complete:
                break
            best.add(cps[0].i, cps[0].j, cps[0].score)
        log("stage1: already executed (resume)")
        return best

    row_init, col_init = pipeline._mode_inits(pcfg.alignment_start)
    area = job.sra_area(STAGE_1, 0)
    part = area.open_partition(0, 0) or area.create_partition(
        0, 0, m, n, row_init=row_init, col_init=col_init)
    r0 = part.last_row() or 0
    rec = pipeline._recurrence(pcfg.alignment_start)
    end = pipeline._effective_end(pcfg)
    # the best of the rows down to r0 (written before each row)
    above = tuple(job.status.best) if r0 else None
    store = _OffsetStore(part, r0, job, above)
    want_lastcol = end in (AlignmentStart.SEQUENCE_1,
                           AlignmentStart.SEQUENCE_1_OR_2)
    first_row = first_col = None
    col_init_eff = col_init
    if r0:
        log(f"stage1: resuming from special row {r0}")
        first_row = part.get(r0)
        row_init = InitType.CUSTOM
        # the partition's recorded border type, not the resumed run's
        # flags (SpecialRowsPartition.cpp:129-175 of the reference)
        saved_col = (InitType(part.col_init)
                     if part.col_init is not None else col_init)
        # a zero border is offset-invariant and stays synthesized; any
        # other is sliced from row r0 down
        col_init_eff = saved_col
        if saved_col != InitType.WITH_ZEROES:
            ch, cg = border_cells(m + 1, saved_col, job.cfg.params)
            first_col = (ch[r0:], cg[r0:])
            col_init_eff = InitType.CUSTOM

    # pinned endpoints (NW/semi-global) may legitimately be negative: the
    # min-score admission filter applies to SW candidates only
    best = BestScoreList(job.cfg.max_alignments,
                         min_score=(0 if rec == Recurrence.SMITH_WATERMAN
                                    else -INF),
                         min_distance=job.cfg.best_score_distance)
    sink = None
    if job.cfg.max_alignments > 1 and rec == Recurrence.SMITH_WATERMAN:
        def sink(i, j, s):
            best.add(r0 + i, j, s)
    blocks = blocks_sink = None
    if job.cfg.dump_blocks:
        blocks = BlocksFile(job.path("blocks.00.bin"))

        def blocks_sink(rows_done, maxima):
            blocks.add_row(maxima)

    def tick():
        # the 2-s progress line (RecurrentTimer, sw_stage1.cpp:315,378),
        # read from the crash-safe status file
        r = max(job.status.last_special_row, 0)
        log(f"stage1: ... flushed row {r}/{m} "
            f"({100.0 * r / max(m, 1):.1f}%)")

    # the rows stay on the device for this call's stage 2 (one alignment:
    # the march truncates the cache); lazy delivery where the rows a RAM
    # store pins fit the cache's budget
    lazy_rows = False
    if job.cfg.max_alignments == 1:
        cache = core.DevRowCache(core.row_cache_budget(job.device))
        job.runtime_dev_rows = _OffsetDevCache(cache, r0)
        pinned = min((m - r0) // max(ivs[0], 1) * 8 * n, job.cfg.ram_limit)
        lazy_rows = core.lazy_rows_fit(pinned, cache.budget, job.device)

    timer = Timer()
    timer.create_event("compute")
    ticker = RecurrentTimer(2.0, tick)
    ticker.start()
    try:
        res = core.forward_pass(
            seq0[r0:], seq1, job.cfg.params, rec, row_init, col_init_eff,
            first_row=first_row, first_col=first_col,
            special_every=ivs[0], store=store,
            backend=job.cfg.backend, cfg=kernel_cfg,
            prune=job.cfg.block_pruning,
            # endpoint selection from the last row/column needs them
            pad_rows=(rec == Recurrence.SMITH_WATERMAN
                      and end == AlignmentStart.ANYWHERE),
            best_sink=sink, blocks_sink=blocks_sink,
            want_lastcol=want_lastcol,
            nw_best=(end == AlignmentStart.ANYWHERE
                     and rec == Recurrence.NEEDLEMAN_WUNSCH),
            device=job.device,
            # a resumed run's best, reached in the rows above r0
            best_in=above[2] if r0 else None,
            dev_cache=job.runtime_dev_rows, lazy_rows=lazy_rows,
        )
    finally:
        ticker.stop()
    timer.event_record("compute")
    if blocks is not None:
        blocks.save()
        log(f"stage1: wrote {blocks.path}")
    with job.stats_file(STAGE_1, 0) as fh:
        timer.print_statistics(fh, cells=res.cells)
        fh.write(f"  pruned_cells: {res.pruned_cells}\n")
        fh.write(f"  flush_interval: {ivs[0]}\n")
        for k, v in part.usage().items():
            fh.write(f"  {k}: {v}\n")
        if job.runtime_dev_rows is not None:
            cache = job.runtime_dev_rows.cache
            fh.write(f"  lazy_rows: {int(lazy_rows)}\n"
                     f"  dev_rows: {len(cache)}\n"
                     f"  dev_row_bytes: {cache.nbytes}\n"
                     f"  dev_row_budget: {cache.budget}\n")

    if rec == Recurrence.SMITH_WATERMAN and end == AlignmentStart.ANYWHERE:
        # the rows below r0 and those above it, the earlier of equal
        # scores first, as one pass would have kept it
        cands = [(r0 + res.best_i, res.best_j, res.best)]
        if r0:
            cands.append(above)
        for i, j, s in sorted(cands, key=lambda c: (-c[2], c[0], c[1])):
            best.add(i, j, s)
    else:
        ep = pipeline.select_endpoint(res, m - r0, n, end, rec)
        best.add(r0 + ep.i, ep.j, ep.score)
        if r0 + ep.i == m:
            part.put(m, res.last_h, res.last_f)

    # one endpoint crosspoint file per alignment id (crosspoint_01.II)
    for aln_id, s in enumerate(best):
        f = cpf if aln_id == 0 else job.crosspoints_file(STAGE_1, aln_id)
        f.set_autosave()
        f.write(Crosspoint(s.i, s.j, s.score, CrosspointType.MATCH))
        f.close()
    b = best.best
    job.status.update(stage=STAGE_1, best=(b.i, b.j, b.score))
    dt = time.time() - t0
    log(f"stage1: best={b.score} at ({b.i},{b.j})  "
        f"{res.cells/1e6:.1f} Mcells in {dt:.2f}s "
        f"({res.cells/dt/1e9:.2f} GCUPS)"
        + (f"  pruned={res.pruned_cells/1e6:.1f} Mcells "
           f"({100.0 * res.pruned_cells / max(res.cells + res.pruned_cells, 1):.1f}%)"
           if res.pruned_cells else ""))
    return best


@_stage
def stage2(job: Job, seq0: np.ndarray, seq1: np.ndarray, aln_id: int = 0,
           kernel_cfg=None, log=print) -> list[Crosspoint]:
    """Reverse goal-score marching at the stage-1 special rows
    (sw_stage2.cpp:237).

    Crosspoints are autosaved as the march proceeds and the stage-1 rows
    are truncated behind each one, so a crash mid-stage resumes from the
    deepest crosspoint found.  A partial (END-less) file holds the chain
    in found order (endpoint first); the completed file is ascending."""
    t0 = time.time()
    pcfg = _pcfg(job, kernel_cfg)
    out_cpf = job.crosspoints_file(STAGE_2, aln_id)
    prior, complete = _load(out_cpf)  # descending (found order) if partial
    if complete:
        log("stage2: already executed (resume)")
        return prior

    endpoint = job.crosspoints_file(STAGE_1, aln_id).load()[0]
    part = job.sra_area(STAGE_1, 0).open_partition(endpoint.i, endpoint.j)
    if part is None:
        raise RuntimeError("stage2: no stage-1 special rows area")
    if job.cfg.max_alignments > 1:
        part = _NoTruncate(part)
    if prior and tuple(prior[0]) != tuple(endpoint):
        prior = []  # a stale partial from another endpoint
    march_from = prior[-1] if prior else endpoint
    if prior:
        log(f"stage2: resuming mid-stage from crosspoint "
            f"({march_from.i},{march_from.j})")
        part.truncate_above(march_from.i)

    out_cpf.crosspoints = []
    out_cpf.set_autosave()
    for c in prior or [endpoint]:
        out_cpf.write(c)

    row_init, col_init = pipeline._mode_inits(pcfg.alignment_start)
    stats = core.MarchStats()
    cps = core.reverse_march(
        seq0, seq1, job.cfg.params, march_from, part,
        row_init, col_init, pcfg.alignment_start,
        backend=job.cfg.backend, cfg=kernel_cfg,
        on_crosspoint=out_cpf.write, device=job.device,
        # the rows this call's stage 1 kept on the device, if it ran
        dev_cache=job.runtime_dev_rows, stats=stats,
    )
    # once a march, so that no segment counts twice
    trace.count("hops.segments", stats.segments)
    job.runtime_dev_rows = None  # the rows' device memory goes back
    _end_autosave(out_cpf)
    # the full ascending chain: the fresh march + the resumed prefix
    cps = cps + list(reversed(prior))[1:]
    out_cpf.crosspoints = cps
    out_cpf.save()
    job.status.update(stage=STAGE_2)
    with job.stats_file(STAGE_2, aln_id) as fh:
        fh.write(f"  crosspoints: {len(cps)}\n")
        fh.write(f"  total_ms: {(time.time()-t0)*1000:.3f}\n")
        for k, v in dataclasses.asdict(stats).items():
            fh.write(f"  {k}: {v}\n")
    log(f"stage2: {len(cps)} crosspoints in {time.time()-t0:.2f}s "
        f"({stats.text()})")
    return cps


def stage3_max_cells(job: Job) -> int | None:
    """How far stage 3 densifies: not at all (1 << 62) when stage 4 runs
    the batched engine on a CUDA device, which takes the stage-2 bands
    whole; to 32768^2 cells for the native ladder; else to stage
    5's own limit (None)."""
    engine = mm.stage4_engine(job.device,
                              mm.SplitStrategy[job.cfg.stage4_strategy])
    return {"batched": 1 << 62, "native": 1 << 30}.get(engine)


@_stage
def stage3(job: Job, seq0: np.ndarray, seq1: np.ndarray, aln_id: int = 0,
           kernel_cfg=None, log=print) -> list[Crosspoint]:
    """Recursive densification inside partitions (sw_stage3.cpp:264);
    a crash mid-stage resumes after the autosaved ascending prefix."""
    t0 = time.time()
    pcfg = _pcfg(job, kernel_cfg)
    out_cpf = job.crosspoints_file(STAGE_3, aln_id)
    prior, complete = _load(out_cpf)  # an ascending prefix if partial
    if complete:
        log("stage3: already executed (resume)")
        return prior

    cps = job.crosspoints_file(STAGE_2, aln_id).load()
    if prior and tuple(prior[0]) != tuple(cps[0]):
        prior = []  # a stale partial from another chain
    work = cps
    if prior:
        last = prior[-1]
        work = [last] + [c for c in cps if (c.i, c.j) > (last.i, last.j)]
        log(f"stage3: resuming mid-stage from ({last.i},{last.j})")
    out_cpf.crosspoints = []
    out_cpf.set_autosave()
    for c in prior or cps[:1]:
        out_cpf.write(c)
    densified = pipeline.stage3_densify(
        seq0, seq1, pcfg, work, max_cells=stage3_max_cells(job),
        on_crosspoint=out_cpf.write)
    _end_autosave(out_cpf)
    cps = prior + densified[1:] if prior else densified
    out_cpf.crosspoints = cps
    out_cpf.save()
    job.status.update(stage=STAGE_3)
    with job.stats_file(STAGE_3, aln_id) as fh:
        fh.write(f"  crosspoints: {len(cps)}\n")
        fh.write(f"  total_ms: {(time.time()-t0)*1000:.3f}\n")
        fh.write(f"  vm_size_mb: {process_vm_size() >> 20}\n")
    log(f"stage3: {len(cps)} crosspoints in {time.time()-t0:.2f}s")
    return cps


@_stage
def stage4(job: Job, seq0: np.ndarray, seq1: np.ndarray, aln_id: int = 0,
           strategy=None, log=print) -> list[Crosspoint]:
    """Myers-Miller mid-splitting until <= maximum-partition
    (sw_stage4.cpp:883)."""
    t0 = time.time()
    if strategy is None:
        strategy = mm.SplitStrategy[job.cfg.stage4_strategy]
    out_cpf = job.crosspoints_file(STAGE_4, aln_id)
    done, complete = _load(out_cpf)
    if complete:
        log("stage4: already executed (resume)")
        return done

    cps = job.crosspoints_file(STAGE_3, aln_id).load()
    mps = job.cfg.stage4_max_partition
    if mps:
        cps = mm.stage4_reduce(
            seq0, seq1, cps, job.cfg.params, mps, strategy, log=log,
            stage5_max_cells=job.cfg.stage5_max_cells, device=job.device)
    out_cpf.crosspoints = cps
    out_cpf.save()
    job.status.update(stage=STAGE_4)
    with job.stats_file(STAGE_4, aln_id) as fh:
        fh.write(f"  crosspoints: {len(cps)}\n")
        fh.write(f"  total_ms: {(time.time()-t0)*1000:.3f}\n")
    log(f"stage4: {len(cps)} crosspoints in {time.time()-t0:.2f}s")
    return cps


@_stage
def stage5(job: Job, seq0: np.ndarray, seq1: np.ndarray,
           sequences: list[Sequence] | None = None, aln_id: int = 0,
           log=print) -> balign.Alignment:
    """Exact traceback per partition + score invariant; writes the CGFF
    binary (sw_stage5.cpp:322,464)."""
    t0 = time.time()
    src = STAGE_4 if job.cfg.stage4_max_partition else STAGE_3
    cps = job.crosspoints_file(src, aln_id).load()
    aln = pipeline.stage5_emit(seq0, seq1, _pcfg(job), cps, sequences)
    balign.write_cgff(job.path(f"alignment.{aln_id:02d}.cgff"), aln)
    job.status.update(stage=STAGE_5)
    log(f"stage5: score={aln.raw_score} verified in {time.time()-t0:.2f}s")
    return aln


@_stage
def stage6(job: Job, seq0: np.ndarray, seq1: np.ndarray,
           aln: balign.Alignment, aln_id: int = 0, fmt: str = "text",
           log=print) -> str:
    """Render via the format registry + independent re-check
    (sw_stage6.cpp:992, stage6_formats[] :50-57)."""
    st6.recheck(aln, seq0, seq1, job.cfg.params)
    blocks = None
    bpath = job.path("blocks.00.bin")
    if os.path.exists(bpath):
        blocks = BlocksFile.load(bpath)
    render = st6.FORMATS.get(fmt, st6.FORMATS["text"])
    out, ext = render(aln, seq0, seq1, blocks=blocks)
    path = job.path(f"alignment.{aln_id:02d}.{ext}")
    with open(path, "w") as f:
        f.write(out)
    job.status.update(stage=STAGE_6)
    log(f"stage6: wrote {path}")
    return out


def execute_traceback(job: Job, seq0, seq1, sequences=None,
                      kernel_cfg=None, fmt: str = "text", log=print
                      ) -> balign.Alignment:
    """Stages 2..6 for each best-score alignment id
    (executeTraceback, libmasa.cpp:644-655)."""
    first = None
    for aln_id in range(job.cfg.max_alignments):
        if aln_id and not os.path.exists(
                job.crosspoints_file(STAGE_1, aln_id).path):
            break
        stage2(job, seq0, seq1, aln_id, kernel_cfg, log)
        stage3(job, seq0, seq1, aln_id, kernel_cfg, log)
        stage4(job, seq0, seq1, aln_id, log=log)
        aln = stage5(job, seq0, seq1, sequences, aln_id, log)
        stage6(job, seq0, seq1, aln, aln_id, fmt, log)
        if first is None:
            first = aln
    return first


def align_job(job: Job, seq0, seq1, sequences=None, kernel_cfg=None,
              fmt: str = "text", log=print) -> balign.Alignment:
    """The full run: stage 1 + traceback (libmasa_entry_point sequencing,
    libmasa.cpp:1351-1385)."""
    stage1(job, seq0, seq1, kernel_cfg, log)
    return execute_traceback(job, seq0, seq1, sequences, kernel_cfg, fmt,
                             log)


def finish_alignment(job: Job, seq0, seq1, aln: balign.Alignment,
                     cps=None, aln_id: int = 0, fmt: str = "text",
                     log=print, elapsed: dict | None = None
                     ) -> balign.Alignment:
    """Write the standard work-dir artifact set for an alignment produced
    outside the persistent stage functions: the CGFF binary, the stage-6
    rendering with its independent re-check, crosspoint files and
    per-stage statistics, as the monolithic path leaves them
    (libmasa.cpp:1351-1394)."""
    balign.write_cgff(job.path(f"alignment.{aln_id:02d}.cgff"), aln)
    if cps:
        f = job.crosspoints_file(STAGE_4, aln_id)
        f.crosspoints = list(cps)
        f.save()
    for stage, key in ((STAGE_1, "stage1"), (STAGE_2, "stage2"),
                       (STAGE_3, "stage3"), (STAGE_4, "stage4"),
                       (STAGE_5, "stage5")):
        with job.stats_file(stage, aln_id) as fh:
            if elapsed and key in elapsed:
                fh.write(f"  total_ms: {elapsed[key] * 1000:.3f}\n")
    job.status.update(stage=STAGE_5,
                      best=(aln.end[0], aln.end[1], aln.raw_score))
    stage6(job, seq0, seq1, aln, aln_id, fmt, log)
    return aln
