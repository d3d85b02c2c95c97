"""Column-split stage 1 and its traceback, for the port: masa_tpu's
``--split W1,..,Wn`` and ``--fork`` modes and the split of oversize inputs
(counterpart of masa_tpu/parallel/split.py; the reference's
libmasa.cpp:497-757).

Sequence #1 is cut into weighted vertical slabs.  Each slab runs stage 1
over every row, reading its left border from the slab before it and
writing its last column to the slab after it through a cells URL
(masa_tpu's ``io/cells``: ``file://`` between serial slabs, ``socket://``
between threads or processes).  The traceback marches right to left, slab
by slab, matching at each slab's special rows and, where the path leaves a
slab, against the border column the slab read.  The cell streams, the
crosspoints and the special rows are masa_tpu's formats.

On a CUDA device one launch of the strip kernel covers a slab's rows
(``strips.strip_height``), so a slab reads its whole border before it
starts: slabs on one card run one after another.  The split serves
oversize inputs and many devices, not speed on one card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from masa_tpu_torch.io import cells as cio
from masa_tpu_torch.models.scoring import border_cells, match_column
from masa_tpu_torch.types import (
    INF,
    Crosspoint,
    CrosspointType,
    InitType,
    MatchType,
    Recurrence,
    ScoreParams,
)
from masa_tpu_torch.ops import myers_miller as mm
from masa_tpu_torch.ops import strips
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import core, pipeline, stage6
from masa_tpu_torch.utils import trace
from masa_tpu_torch.utils.devices import resolve_device

NEG = -INF


def split_points(n: int, weights: list[float]) -> list[int]:
    """Column boundaries for weighted slabs (split_sequences,
    libmasa.cpp:497-535)."""
    total = sum(weights)
    pts = [0]
    acc = 0.0
    for w in weights[:-1]:
        acc += w
        pts.append(int(round(n * acc / total)))
    pts.append(n)
    return pts


def auto_urls(work_dir: str, nparts: int, use_sockets: bool = False,
              base_port: int = 7000) -> list[str]:
    """Border stream URLs between parts k and k+1: STEP files, or
    localhost sockets from ``base_port`` up (libmasa.cpp:516-527,
    585-595)."""
    if use_sockets:
        return [f"socket://127.0.0.1:{base_port + k}"
                for k in range(nparts - 1)]
    return [f"file://{work_dir}/STEP-{k:02d}.tmp"
            for k in range(nparts - 1)]


def _best_part(parts) -> int:
    """The slab owning the global endpoint, with the engine tie-break
    (max score, then smallest i, then smallest j), so a cross-slab tie
    picks the monolithic pipeline's endpoint."""
    return max(range(len(parts)),
               key=lambda k: (parts[k].best, -parts[k].best_i,
                              -parts[k].best_j))


def slab_interval(m: int, width: int, device, cfg: wf.StripConfig | None = None,
                  limit: int = 1 << 30) -> int:
    """Special-row interval of a slab whose rows stay in RAM (fork workers,
    oversize slabs).  On the CPU: the strip height (512 rows by default,
    masa_tpu's CPU strip, so both packages keep the same rows).  On a CUDA
    device, where one launch covers the slab and its height says nothing
    of the rows wanted: ``pipeline.auto_flush_interval`` under ``limit``
    bytes."""
    if torch.device(device).type == "cuda":
        return pipeline.auto_flush_interval(m, width, max(limit, 1))
    return (cfg or core.default_config(device)).rows


def densify_limit(max_partition: int, device) -> int | None:
    """How far stage 3 densifies a split traceback's chain: not at all
    (1 << 62) when stage 4 runs the batched engine (a CUDA device), which
    splits the stage-2 bands itself, as the runner does
    (``runner.stage3_max_cells``); else to stage 5's limit (None), as
    masa_tpu does."""
    if max_partition and mm.stage4_engine(
            device, mm.SplitStrategy.OPTIMIZED) == "batched":
        return 1 << 62
    return None


@dataclasses.dataclass
class PartResult:
    best: int
    best_i: int
    best_j: int
    last_h: np.ndarray  # (width,) the part's final-row H (cells only)
    last_f: np.ndarray
    cells: int
    specials: core.SpecialRowStore | None = None  # slab-local columns
    first_col: tuple | None = None      # the border (H, E) column read
    j0: int = 0
    j1: int = 0


class _CapturingReader(cio.CellsReader):
    """Keeps a border stream in RAM as it is read, so the traceback can
    match against it (the reference persists the loaded column through
    the SRA)."""

    def __init__(self, inner):
        self.inner = inner
        self.hs = []
        self.gs = []

    def read(self, n):
        h, g = self.inner.read(n)
        self.hs.append(np.asarray(h))
        self.gs.append(np.asarray(g))
        return h, g

    def h_at(self, r: int) -> int:
        """The border H at DP row r >= 1 (read already)."""
        k = r - 1
        for h in self.hs:
            if k < len(h):
                return int(h[k])
            k -= len(h)
        raise IndexError(f"border row {r} has not been read")

    def column(self, row0_h: int):
        h = np.concatenate([[row0_h]] + self.hs).astype(np.int64)
        g = np.concatenate([[NEG]] + self.gs).astype(np.int64)
        return h, g

    def close(self):
        self.inner.close()


def _boundary_crosspoint(cp: Crosspoint, r: int, rev_col, first_col,
                         goal: int, params: ScoreParams) -> Crosspoint:
    """Where the path leaves the slab through its left border between rows
    r and cp.i: the reverse pass's far column (reverse row p = cp.i - row)
    matched against the stored border column."""
    if first_col is None or rev_col is None:
        raise RuntimeError(f"Backtrace lost in slab at row {r}")
    hb = cp.i - r
    fwd_h = np.asarray(first_col[0], np.int64)[r:cp.i + 1][::-1]
    fwd_e = np.asarray(first_col[1], np.int64)[r:cp.i + 1][::-1]
    mres = match_column(np.asarray(rev_col[0], np.int64)[:hb + 1],
                        np.asarray(rev_col[1], np.int64)[:hb + 1],
                        fwd_h, fwd_e, goal, params.gap_open)
    if not mres.found:
        raise RuntimeError(
            f"Backtrace lost at slab boundary (rows {r}..{cp.i})")
    t = (CrosspointType.MATCH if mres.type == MatchType.ALIGNED
         else CrosspointType.GAP_1)
    return Crosspoint(cp.i - mres.k, 0, int(mres.score), t)


def march_slab(
    seq0: np.ndarray,
    slab: np.ndarray,
    params: ScoreParams,
    endpoint_local: Crosspoint,
    specials,
    first_col,
    sw_anywhere: bool,
    backend: str = "auto",
    cfg: wf.StripConfig | None = None,
    known: set | None = None,
    device="cuda",
) -> list[Crosspoint]:
    """Stage 2 confined to one slab: matches at the slab's special rows
    (slab-local columns) and, when the path leaves through the slab's left
    border, against the stored border column ``first_col`` ((m+1,) H and
    E, or None for the first slab).  Returns slab-local crosspoints
    ascending; the first sits on the border (j == 0) when the path goes on
    leftward.

    ``known`` (speculative traceback): stop at the first crosspoint found
    that is in the set; the caller splices the speculated chain there (the
    already-computed check of sw_stage2.cpp:151-182)."""
    n_loc = len(slab)
    cps = [endpoint_local]
    cp = endpoint_local
    rev_seqs = (np.ascontiguousarray(seq0[::-1]),
                np.ascontiguousarray(slab[::-1]))
    row0_h = border_cells(n_loc + 1, InitType.WITH_ZEROES,
                          params)[0].astype(np.int64)

    while True:
        if sw_anywhere and cp.score <= 0:
            break
        if cp.i == 0 or cp.j == 0:
            break
        r = specials.next_below(cp.i, 1)
        if r is None or r == 0:
            r = 0
            fh, ff = row0_h, np.full(n_loc + 1, NEG, np.int64)
        else:
            fh, ff = specials.get(r)
        goal_anywhere = sw_anywhere and core.goal_reachable(
            cp, r, params.match)
        goal = cp.score + (params.gap_open
                           if cp.type != CrosspointType.MATCH else 0)

        j_low = cp.j - core.initial_window(cp, r, backend)
        while True:
            at_edge = j_low <= 0
            rm = core.reverse_pass_and_match(
                seq0, slab, params, cp, r, fh, ff, max(j_low, 0),
                goal_anywhere, rev_seqs, backend=backend, cfg=cfg,
                want_rev_col=at_edge and first_col is not None,
                device=device)
            if rm.start_found:
                found = Crosspoint(*rm.start, 0, CrosspointType.MATCH)
                break
            if rm.crosspoint is not None:
                found = rm.crosspoint
                break
            if not at_edge:
                j_low = cp.j - 2 * (cp.j - j_low)
                continue
            # the full slab width found no match at row r: the path leaves
            # through the border column between r and cp.i
            found = _boundary_crosspoint(cp, r, rm.rev_col, first_col, goal,
                                         params)
            break

        cp = found
        cps.append(cp)
        if known and tuple(cp) in known:
            break
        specials.truncate_above(cp.i)
        if cp.j == 0:
            break
    return list(reversed(cps))


def _on(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint8)).to(dev)


def run_part_stage1(
    seq0: np.ndarray,
    seq1: np.ndarray,
    part: int,
    points: list[int],
    params: ScoreParams = ScoreParams(),
    cfg: wf.StripConfig | None = None,
    load_url: str | None = None,
    flush_url: str | None = None,
    buffered: bool = True,
    special_every: int = 0,
    device="cuda",
) -> PartResult:
    """Stage 1 over one vertical slab on ``device``: ``load_url`` gives the
    left border (part - 1's last column), ``flush_url`` receives this
    part's last column.  With ``special_every``, the slab's special rows
    (slab-local columns) and the border column it read are kept for the
    traceback."""
    m = len(seq0)
    j0, j1 = points[part], points[part + 1]
    slab = np.ascontiguousarray(seq1[j0:j1])
    dev = resolve_device(device)
    cfg = dataclasses.replace(
        cfg or core.default_config(dev),
        recurrence=Recurrence.SMITH_WATERMAN,
        track_best=True,
        store_lastcol=flush_url is not None,
        match=params.match, mismatch=params.mismatch,
        gap_open=params.gap_open, gap_ext=params.gap_ext,
    )

    reader = writer = capture = None
    if load_url:
        reader = cio.open_reader(load_url)
        if buffered:
            reader = cio.BufferedCellsReader(reader, chunk=cfg.rows,
                                             total=m)
        if special_every:
            reader = capture = _CapturingReader(reader)
    if flush_url:
        writer = cio.open_writer(flush_url)
        if buffered:
            writer = cio.BufferedCellsWriter(writer)
    store = core.SpecialRowStore() if special_every else None

    def on_special(r, bus_h, bus_f):
        h_full = np.empty(len(slab) + 1, np.int64)
        f_full = np.empty(len(slab) + 1, np.int64)
        # the border at row r itself: a launch flushes rows inside it, so
        # the last border cell read belongs to the launch's last row
        h_full[0] = capture.h_at(r) if capture else 0
        f_full[0] = NEG
        h_full[1:] = bus_h
        f_full[1:] = bus_f
        store.put(r, h_full, f_full)

    res = strips.run_partition(
        cfg, _on(seq0, dev), _on(slab, dev), params,
        InitType.WITH_ZEROES,
        InitType.CUSTOM if reader else InitType.WITH_ZEROES,
        special_every=special_every,
        on_special_row=on_special if special_every else None,
        first_col_reader=reader,
        lastcol_writer=writer,
    )
    if writer:
        writer.close()
    if reader:
        reader.close()
    return PartResult(
        best=res.best,
        best_i=res.best_i,
        best_j=j0 + res.best_j,
        last_h=res.last_h[1:],
        last_f=res.last_f[1:],
        cells=res.cells,
        specials=store,
        first_col=capture.column(0) if capture else None,
        j0=j0,
        j1=j1,
    )


def run_split_serial(
    seq0: np.ndarray,
    seq1: np.ndarray,
    nparts: int,
    work_dir: str,
    params: ScoreParams = ScoreParams(),
    cfg: wf.StripConfig | None = None,
    device="cuda",
) -> list[PartResult]:
    """All parts in sequence with file:// handoff: the reference's
    single-machine distributed test mode."""
    points = split_points(len(seq1), [1.0] * nparts)
    urls = auto_urls(work_dir, nparts)
    return [run_part_stage1(
        seq0, seq1, k, points, params, cfg,
        load_url=urls[k - 1] if k > 0 else None,
        flush_url=urls[k] if k < nparts - 1 else None,
        buffered=False, device=device,
    ) for k in range(nparts)]


def _global(local: list[Crosspoint], j0: int) -> list[Crosspoint]:
    return [Crosspoint(c.i, c.j + j0, c.score, c.type) for c in local]


def pipelined_traceback(
    seq0: np.ndarray,
    seq1: np.ndarray,
    parts: list[PartResult],
    params: ScoreParams = ScoreParams(),
    backend: str = "auto",
    cfg: wf.StripConfig | None = None,
    device="cuda",
) -> list[Crosspoint]:
    """Stage 2 across slabs, right to left (executeTracebackPipelined,
    libmasa.cpp:659-696): each part marches in its slab; where the path
    leaves a slab, the border crosspoint hands off to the left neighbour.
    Returns global crosspoints ascending."""
    return speculative_traceback(seq0, seq1, parts, params, backend, cfg,
                                 device, speculate=False)[0]


def speculate_slab(
    seq0: np.ndarray,
    slab: np.ndarray,
    params: ScoreParams,
    best: tuple[int, int, int],   # (i, j_global, score)
    j0: int,
    j1: int,
    specials,
    first_col,
    backend: str = "auto",
    cfg: wf.StripConfig | None = None,
    device="cuda",
):
    """A march from the slab's own best (the TPDS2016 prediction), on a
    copy of its special rows.  Returns the slab-local chain, or None when
    the best lies outside the slab or the march loses its way (never
    fatal: the confirming march runs the same slab)."""
    bi, bj, bs = best
    if bs <= 0 or not (j0 < bj <= j1):
        return None
    ep = Crosspoint(bi, bj - j0, bs, CrosspointType.MATCH)
    try:
        return march_slab(seq0, slab, params, ep, specials.copy(),
                          first_col, sw_anywhere=True, backend=backend,
                          cfg=cfg, device=device)
    except RuntimeError:
        return None


def splice_speculation(local: list, spec: list | None):
    """Splice the speculated prefix when the confirmed chain landed on a
    speculated crosspoint (the already-computed check,
    sw_stage2.cpp:151-182).  Returns (chain, reused_count)."""
    if not spec or not local:
        return local, 0
    keys = {tuple(c): i for i, c in enumerate(spec)}
    hit = keys.get(tuple(local[0]))
    if hit is None:
        return local, 0
    return spec[: hit + 1] + local[1:], hit + 1


def speculative_traceback(
    seq0: np.ndarray,
    seq1: np.ndarray,
    parts: list[PartResult],
    params: ScoreParams = ScoreParams(),
    backend: str = "auto",
    cfg: wf.StripConfig | None = None,
    device="cuda",
    speculate: bool = True,
):
    """Incremental speculative traceback (TPDS2016;
    executeTracebackPredicted, libmasa.cpp:698-757): every part left of
    the endpoint's marches from its own stage-1 best first; the confirming
    march from the true entry stops at the first speculated crosspoint it
    meets and splices the speculated chain.  ``speculate=False`` is the
    pipelined traceback.

    Returns (crosspoints, reused_count): reused_count is the number of
    crosspoints taken from speculation instead of recomputed."""
    best_k = _best_part(parts)
    slabs = [np.ascontiguousarray(seq1[p.j0:p.j1]) for p in parts]
    spec: dict[int, list] = {}
    for k in range(best_k if speculate else 0):
        p = parts[k]
        s = speculate_slab(seq0, slabs[k], params,
                           (p.best_i, p.best_j, p.best), p.j0, p.j1,
                           p.specials, p.first_col if k > 0 else None,
                           backend=backend, cfg=cfg, device=device)
        if s is not None:
            spec[k] = s

    p = parts[best_k]
    cp = Crosspoint(p.best_i, p.best_j, p.best, CrosspointType.MATCH)
    k = best_k
    all_cps: list = []
    reused = 0
    while True:
        part = parts[k]
        local = march_slab(
            seq0, slabs[k], params,
            Crosspoint(cp.i, cp.j - part.j0, cp.score, cp.type),
            part.specials, part.first_col if k > 0 else None,
            sw_anywhere=True, backend=backend, cfg=cfg,
            known={tuple(c) for c in spec[k]} if k in spec else None,
            device=device)
        local, r = splice_speculation(local, spec.get(k))
        reused += r
        glob = _global(local, part.j0)
        all_cps = glob[:-1] + all_cps if all_cps else glob
        first = glob[0]
        if first.j > part.j0 or k == 0 or first.score <= 0:
            break
        cp = first
        k -= 1
    return all_cps, reused


def run_split_threads(
    seq0: np.ndarray,
    seq1: np.ndarray,
    nparts: int,
    params: ScoreParams = ScoreParams(),
    cfg: wf.StripConfig | None = None,
    base_port: int = 7100,
    device="cuda",
) -> list[PartResult]:
    """All parts as concurrent threads of one process, wired by localhost
    sockets: the in-process harness of the socket cell streams.  One
    process per slab is ``parallel/fork.run_fork``."""
    import threading

    points = split_points(len(seq1), [1.0] * nparts)
    urls = auto_urls("", nparts, use_sockets=True, base_port=base_port)
    results: list = [None] * nparts
    errs: list = [None] * nparts

    def work(k):
        try:
            results[k] = run_part_stage1(
                seq0, seq1, k, points, params, cfg,
                load_url=urls[k - 1] if k > 0 else None,
                flush_url=urls[k] if k < nparts - 1 else None,
                device=device,
            )
        except Exception as e:  # re-raised below, in the caller's thread
            errs[k] = e

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(nparts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errs:
        if e:
            raise e
    return results


def align_oversize(
    seq0: np.ndarray,
    seq1: np.ndarray,
    max_width: int,
    work_dir: str,
    params: ScoreParams = ScoreParams(),
    cfg: wf.StripConfig | None = None,
    backend: str = "kernel",
    max_cells_stage5: int = 1 << 18,
    device="cuda",
    limit: int = 1 << 30,
    on_stage=None,
):
    """Full alignment when seq1 is wider than one run may be: chained
    column slabs of at most ``max_width`` with file:// border handoff (the
    reference's oversize-partition splitting, sw_stage1.cpp:362-375 +
    SpecialRowsArea::createSplittedPartitions), traced back with the
    pipelined slab march; special rows every ``slab_interval`` (``limit``
    bytes of them a slab on a CUDA device).  Stage 3 and 4 follow
    ``densify_limit``.  ``on_stage(name, seconds, result)``, when given,
    is called as each stage ends (as in ``pipeline.align_pair``).
    Returns (best, alignment)."""
    dev = resolve_device(device)
    run = trace.stage_runner(dev, on_stage)
    m = len(seq0)
    nparts = -(-len(seq1) // max_width)
    points = split_points(len(seq1), [1.0] * nparts)
    urls = auto_urls(work_dir, nparts)
    width = max(b - a for a, b in zip(points, points[1:]))
    iv = slab_interval(m, width, dev, cfg, limit)
    parts = run("stage1", lambda: [run_part_stage1(
        seq0, seq1, k, points, params, cfg,
        load_url=urls[k - 1] if k > 0 else None,
        flush_url=urls[k] if k < nparts - 1 else None,
        buffered=False, special_every=iv, device=dev,
    ) for k in range(nparts)])
    cps = run("stage2", pipelined_traceback, seq0, seq1, parts, params,
              backend=backend, cfg=cfg, device=dev)
    pcfg = pipeline.PipelineConfig(
        params=params, kernel_cfg=cfg, backend=backend,
        max_cells_stage5=max_cells_stage5, device=str(dev),
    )
    dense = densify_limit(pcfg.max_partition, dev)
    cps = run("stage3", pipeline.stage3_densify, seq0, seq1, pcfg, cps,
              max_cells=dense)
    if dense:
        cps = run("stage4", mm.stage4_reduce, seq0, seq1, cps, params,
                  pcfg.max_partition, stage5_max_cells=max_cells_stage5,
                  device=dev)
    aln = run("stage5", pipeline.stage5_emit, seq0, seq1, pcfg, cps)
    run("stage6", stage6.recheck, aln, seq0, seq1, params)
    return max(p.best for p in parts), aln
