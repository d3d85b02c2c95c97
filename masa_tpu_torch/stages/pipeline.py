"""End-to-end alignment pipeline of the port: the six stages as a library
(counterpart of masa_tpu/stages/pipeline.py).

    stage 1  forward pass: special rows, best score (the strip kernel)
    stage 2  reverse goal-score march at special rows (the strip kernel)
    stage 3  recursive densification inside partitions (the strip kernel)
    stage 4  Myers-Miller splitting (the batched strip kernel on a GPU,
             down to isqrt(max_cells_stage5); the native host ladder,
             ``native/masanative.cpp``, on the CPU)
    stage 5  exact constrained DP + traceback per partition (host)
    stage 6  the independent re-score of the stage-5 statistics
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from masa_tpu_torch.biology.alignment import (
    ALIGNMENT_METHOD_GLOBAL,
    ALIGNMENT_METHOD_LOCAL,
    Alignment,
)
from masa_tpu_torch.biology.sequence import Sequence
from masa_tpu_torch.ops import smallsw
from masa_tpu_torch.types import (
    AlignmentStart,
    Crosspoint,
    CrosspointType,
    InitType,
    Recurrence,
    ScoreParams,
)
from masa_tpu_torch.ops import myers_miller as mm
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import core
from masa_tpu_torch.utils import trace
from masa_tpu_torch.utils.devices import resolve_device


@dataclasses.dataclass
class PipelineConfig:
    params: ScoreParams = dataclasses.field(default_factory=ScoreParams)
    alignment_start: AlignmentStart = AlignmentStart.ANYWHERE
    # None mirrors alignment_start (local start -> end anywhere, pinned
    # start -> corner)
    alignment_end: AlignmentStart | None = None
    flush_interval: int = 0          # 0 = auto
    max_cells_stage5: int = 1 << 18  # partitions at most this many cells
    max_partition: int = 16          # stage-4 ladder target (0 = skip)
    backend: str = "auto"
    kernel_cfg: wf.StripConfig | None = None
    min_dist: int = 1
    device: str = "cuda"


def _mode_inits(start: AlignmentStart) -> tuple[InitType, InitType]:
    """Matrix border inits per alignment-start mode."""
    if start == AlignmentStart.ANYWHERE:
        return InitType.WITH_ZEROES, InitType.WITH_ZEROES
    if start == AlignmentStart.SEQUENCE_1:
        return InitType.WITH_GAPS, InitType.WITH_ZEROES
    if start == AlignmentStart.SEQUENCE_2:
        return InitType.WITH_ZEROES, InitType.WITH_GAPS
    if start == AlignmentStart.SEQUENCE_1_OR_2:
        return InitType.WITH_ZEROES, InitType.WITH_ZEROES
    return InitType.WITH_GAPS, InitType.WITH_GAPS


def _recurrence(start: AlignmentStart) -> Recurrence:
    return (Recurrence.SMITH_WATERMAN if start == AlignmentStart.ANYWHERE
            else Recurrence.NEEDLEMAN_WUNSCH)


def _effective_end(pcfg) -> AlignmentStart:
    if pcfg.alignment_end is not None:
        return pcfg.alignment_end
    if pcfg.alignment_start == AlignmentStart.ANYWHERE:
        return AlignmentStart.ANYWHERE
    return AlignmentStart.SEQUENCE_1_AND_2


def select_endpoint(res, m: int, n: int, end: AlignmentStart,
                    rec: Recurrence) -> Crosspoint:
    """Endpoint per --alignment-end: ANYWHERE = global max; SEQUENCE_1 =
    last column; SEQUENCE_2 = last row; SEQUENCE_1_OR_2 = the better of
    those; SEQUENCE_1_AND_2 = the corner."""
    if end == AlignmentStart.ANYWHERE:
        return Crosspoint(res.best_i, res.best_j, res.best,
                          CrosspointType.MATCH)
    if end == AlignmentStart.SEQUENCE_1_AND_2:
        return Crosspoint(m, n, int(res.last_h[n]), CrosspointType.MATCH)
    cands = []
    if end in (AlignmentStart.SEQUENCE_2, AlignmentStart.SEQUENCE_1_OR_2):
        lh = np.asarray(res.last_h, np.int64)
        j = int(np.argmax(lh))
        cands.append(Crosspoint(m, j, int(lh[j]), CrosspointType.MATCH))
    if end in (AlignmentStart.SEQUENCE_1, AlignmentStart.SEQUENCE_1_OR_2):
        ch = np.asarray(res.col_h, np.int64)
        i = int(np.argmax(ch))
        cands.append(Crosspoint(i, n, int(ch[i]), CrosspointType.MATCH))
    return max(cands, key=lambda c: (c.score, -c.i, -c.j))


# The automatic special-row interval is a multiple of this: masa_tpu's CPU
# strip height, so both packages pick the same rows on the CPU.
FLUSH_GRAIN = 512


def auto_flush_interval(m: int, n: int, limit_bytes: int = 1 << 30) -> int:
    """Special-row interval (Job::calculateFlushIntervals): m*n*8/limit + 1
    rows, rounded up to FLUSH_GRAIN."""
    iv = m * n * 8 // limit_bytes + 1
    return max(-(-iv // FLUSH_GRAIN) * FLUSH_GRAIN, FLUSH_GRAIN)


def stage1_pass(
    seq0: np.ndarray,
    seq1: np.ndarray,
    pcfg: PipelineConfig,
    store: core.SpecialRowStore | None = None,
) -> tuple[core.FwdResult, Crosspoint]:
    """Stage 1: full forward pass.  Returns the pass result and the
    alignment endpoint crosspoint.  The special rows stay on the device
    for stage 2 (``res.dev_cache``) and, where they fit its budget, reach
    the store lazily: a RAM row that stage 2 matches on the device never
    crosses to the host."""
    m, n = len(seq0), len(seq1)
    row_init, col_init = _mode_inits(pcfg.alignment_start)
    rec = _recurrence(pcfg.alignment_start)
    end = _effective_end(pcfg)
    iv = pcfg.flush_interval or auto_flush_interval(m, n)
    cache = core.DevRowCache(core.row_cache_budget(pcfg.device))
    res = core.forward_pass(
        seq0, seq1, pcfg.params, rec, row_init, col_init,
        special_every=iv, store=store, backend=pcfg.backend,
        cfg=pcfg.kernel_cfg,
        want_lastcol=end in (AlignmentStart.SEQUENCE_1,
                             AlignmentStart.SEQUENCE_1_OR_2),
        nw_best=(end == AlignmentStart.ANYWHERE
                 and rec == Recurrence.NEEDLEMAN_WUNSCH),
        device=pcfg.device, dev_cache=cache,
        lazy_rows=core.lazy_rows_fit(m // iv * 8 * n, cache.budget,
                                     pcfg.device),
    )
    endpoint = select_endpoint(res, m, n, end, rec)
    if endpoint.i == m:
        # the last row is itself a final special row for stage 2
        res.specials.put(m, res.last_h, res.last_f)
    return res, endpoint


def stage2_march(
    seq0: np.ndarray,
    seq1: np.ndarray,
    pcfg: PipelineConfig,
    endpoint: Crosspoint,
    specials: core.SpecialRowStore,
    dev_cache: core.DevRowCache | None = None,
    stats: core.MarchStats | None = None,
    chain: bool | None = None,
) -> list[Crosspoint]:
    """Stage 2: the reverse march over stage 1's rows (``dev_cache``:
    the rows stage 1 kept on the device; ``chain``: see
    ``core.reverse_march``)."""
    row_init, col_init = _mode_inits(pcfg.alignment_start)
    return core.reverse_march(
        seq0, seq1, pcfg.params, endpoint, specials,
        row_init, col_init, pcfg.alignment_start,
        min_dist=pcfg.min_dist, backend=pcfg.backend,
        cfg=pcfg.kernel_cfg, device=pcfg.device, dev_cache=dev_cache,
        stats=stats, chain=chain,
    )


def stage3_densify(
    seq0: np.ndarray,
    seq1: np.ndarray,
    pcfg: PipelineConfig,
    cps: list[Crosspoint],
    max_cells: int | None = None,
    on_crosspoint=None,
) -> list[Crosspoint]:
    """Stage 3: recursively densify crosspoints until every partition fits
    `max_cells`.  ``on_crosspoint`` fires for every definitive crosspoint
    as each input pair's segment completes (ascending path order,
    excluding cps[0])."""
    max_cells = max_cells or pcfg.max_cells_stage5
    out = [cps[0]]
    for c0, c1 in zip(cps, cps[1:]):
        seg = _densify_segment(seq0, seq1, pcfg, c0, c1, max_cells, 0)
        if on_crosspoint:
            for c in seg:
                on_crosspoint(c)
        out.extend(seg)
    return out


def _densify_segment(seq0, seq1, pcfg, c0, c1, max_cells, depth):
    """Crosspoints strictly inside (c0, c1], ascending."""
    h = c1.i - c0.i
    w = c1.j - c0.j
    if h * w <= max_cells or depth > 30:
        return [c1]
    if w > h:
        # transpose the subproblem so rows are the long axis
        t = _densify_segment(seq1, seq0, pcfg, c0.transposed(),
                             c1.transposed(), max_cells, depth + 1)
        return [c.transposed() for c in t]

    sub0 = np.ascontiguousarray(seq0[c0.i:c1.i])
    sub1 = np.ascontiguousarray(seq1[c0.j:c1.j])
    row_init, col_init = core.init_types_for(c0.type)
    store = core.SpecialRowStore()
    # >= 4 bands per level; the strips flush rows at any cadence
    core.forward_pass(
        sub0, sub1, pcfg.params, Recurrence.NEEDLEMAN_WUNSCH,
        row_init, col_init, special_every=max(h // 8, 1), store=store,
        backend="auto", cfg=pcfg.kernel_cfg, track_best=False,
        pad_rows=True, device=pcfg.device,
    )
    local_end = Crosspoint(h, w, c1.score - c0.score, c1.type)
    local_cps = core.reverse_march(
        sub0, sub1, pcfg.params, local_end, store,
        row_init, col_init, AlignmentStart.SEQUENCE_1_AND_2,
        min_dist=pcfg.min_dist, backend="auto", cfg=pcfg.kernel_cfg,
        fix_origin=False, device=pcfg.device,
    )
    # translate to global, drop a leading local origin duplicate
    glob = [Crosspoint(c0.i + c.i, c0.j + c.j, c0.score + c.score, c.type)
            for c in local_cps if c.i or c.j]
    if not glob or glob[-1].i != c1.i or glob[-1].j != c1.j:
        raise RuntimeError("densify lost the segment endpoint")
    out = []
    prev = c0
    for c in glob:
        out.extend(_densify_segment(seq0, seq1, pcfg, prev, c, max_cells,
                                    depth + 1))
        prev = c
    return out


def stage5_emit(
    seq0: np.ndarray,
    seq1: np.ndarray,
    pcfg: PipelineConfig,
    cps: list[Crosspoint],
    sequences: list[Sequence] | None = None,
) -> Alignment:
    """Stage 5: exact traceback of every partition, with the score
    invariant re-check, then the independent re-score of the collected
    statistics (stage 6)."""
    p = pcfg.params
    aln = Alignment(
        sequences=sequences or [],
        method=(ALIGNMENT_METHOD_LOCAL
                if pcfg.alignment_start == AlignmentStart.ANYWHERE
                else ALIGNMENT_METHOD_GLOBAL),
        match=p.match, mismatch=p.mismatch,
        gap_open=p.gap_open, gap_ext=p.gap_ext,
    )
    start, end = cps[0], cps[-1]
    aln.start = [start.i + 1, start.j + 1]
    aln.end = [end.i, end.j]
    total = 0
    for c0, c1 in zip(cps, cps[1:]):
        trace.count("partitions")
        sub0 = np.ascontiguousarray(seq0[c0.i:c1.i])
        sub1 = np.ascontiguousarray(seq1[c0.j:c1.j])
        seg = smallsw.traceback_segment(sub0, sub1, c0.i, c0.j, c0.type,
                                        c1.type, p, aln)
        expect = c1.score - c0.score
        if seg != expect:
            raise RuntimeError(
                f"stage5 invariant failed: partition {c0}->{c1} scored "
                f"{seg}, crosspoints say {expect}")
        total += seg
    aln.raw_score = total
    stat_score = (aln.matches * p.match + aln.mismatches * p.mismatch
                  - aln.gap_opens * p.gap_open
                  - aln.gap_extensions * p.gap_ext)
    if stat_score != total:
        raise RuntimeError(f"stage5 statistics mismatch: ops say "
                           f"{stat_score}, DP says {total}")
    if not aln.check_consistency():
        raise RuntimeError("stage5 gap lists are inconsistent")
    return aln


def align_pair(
    seq0: np.ndarray,
    seq1: np.ndarray,
    pcfg: PipelineConfig | None = None,
    sequences: list[Sequence] | None = None,
    on_stage=None,
    stats: core.MarchStats | None = None,
) -> Alignment:
    """The full pipeline on raw encoded sequences.  ``on_stage(name,
    seconds, result)``, when given, is called as each stage ends, with its
    host-clock time up to a device sync; ``stats`` counts stage 2's
    matches and window reads."""
    pcfg = pcfg or PipelineConfig()
    run = trace.stage_runner(resolve_device(pcfg.device), on_stage)
    res, endpoint = run("stage1", stage1_pass, seq0, seq1, pcfg)
    cps = run("stage2", stage2_march, seq0, seq1, pcfg, endpoint,
              res.specials, res.dev_cache, stats)
    res = None  # the rows' device memory goes back
    cps = run("stage3", stage3_densify, seq0, seq1, pcfg, cps)
    if pcfg.max_partition:
        reduce = functools.partial(mm.stage4_reduce,
                                   stage5_max_cells=pcfg.max_cells_stage5,
                                   device=pcfg.device)
        cps = run("stage4", reduce, seq0, seq1, cps, pcfg.params,
                  pcfg.max_partition)
    return run("stage5", stage5_emit, seq0, seq1, pcfg, cps, sequences)
