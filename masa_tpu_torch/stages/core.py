"""Stage-agnostic traceback machinery for the port: forward passes with
special rows, reverse goal-score marching (stages 2 and 3), and the
crosspoint algebra.  Counterpart of masa_tpu/stages/core.py; the contracts
(crosspoint states, cut matching, border gap synthesis) are documented
there and are the same here.

What differs is how passes are dispatched.  Every pass builds a manager
and an aligner; ``backend="auto"`` picks the strip engine for every pass on
a CUDA device (a launch costs microseconds there), and keeps masa_tpu's
size gates to the NumPy oracle on the CPU.  The reverse march runs one
reverse pass per hop and matches the pulled last row on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from masa_tpu_torch.models.scoring import border_cells, match_column
from masa_tpu_torch.types import (
    INF,
    AlignmentStart,
    Crosspoint,
    CrosspointType,
    InitType,
    MatchType,
    Partition,
    Recurrence,
    ScoreParams,
)
from masa_tpu_torch.core.aligner import CPUAligner, CUDAAligner
from masa_tpu_torch.core.manager import AlignerManager
from masa_tpu_torch.ops import wavefront as wf

NEG = -INF


class SpecialRowStore:
    """RAM special-row store: row index -> ((n+1,) H, (n+1,) F) including
    the border element at k=0."""

    def __init__(self):
        self._rows: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def put(self, r: int, h: np.ndarray, f: np.ndarray) -> None:
        self._rows[r] = (np.asarray(h), np.asarray(f))

    def get(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        return self._rows[r]

    def rows(self) -> list[int]:
        return sorted(self._rows)

    def next_below(self, i: int, min_dist: int = 1) -> int | None:
        """Largest stored row r with r <= i - min_dist."""
        cand = [r for r in self._rows if r <= i - min_dist]
        return max(cand) if cand else None

    def truncate_above(self, i: int) -> None:
        """Drop rows above the found crosspoint."""
        for r in [r for r in self._rows if r > i]:
            del self._rows[r]

    def copy(self) -> "SpecialRowStore":
        """A store of the same rows (shared, never written), so truncating
        one store leaves the other whole."""
        out = SpecialRowStore()
        out._rows = dict(self._rows)
        return out

    def __len__(self):
        return len(self._rows)


def border_gap_values(h_border: np.ndarray, params: ScoreParams) -> np.ndarray:
    """Exact gap-state values along a border: out[k] =
    max_{k0<k}( h[k0] - open - (k-k0)*ext ), out[0] = -INF."""
    n = len(h_border)
    ext = params.gap_ext
    k = np.arange(n, dtype=np.int64)
    g = np.asarray(h_border, np.int64) + k * ext
    run = np.maximum.accumulate(g)
    out = np.empty(n, np.int64)
    out[0] = NEG
    out[1:] = run[:-1] - params.gap_open - k[1:] * ext
    return np.maximum(out, NEG)


def init_types_for(start_type: int) -> tuple[InitType, InitType]:
    """(row_init, col_init) pinning a partition's start state exactly."""
    if start_type == CrosspointType.GAP_1:
        return InitType.WITH_GAPS_OPENED, InitType.WITH_GAPS
    if start_type == CrosspointType.GAP_2:
        return InitType.WITH_GAPS, InitType.WITH_GAPS_OPENED
    return InitType.WITH_GAPS, InitType.WITH_GAPS


@dataclasses.dataclass
class FwdResult:
    last_h: np.ndarray   # (n+1,) with synthesized border gap at [0] in last_f
    last_f: np.ndarray
    best: int
    best_i: int
    best_j: int
    specials: SpecialRowStore
    cells: int
    col_h: np.ndarray | None = None  # (m+1,) last column H if requested
    col_e: np.ndarray | None = None
    pruned_cells: int = 0


def default_config(device) -> wf.StripConfig:
    """Strip height per launch.  On a GPU one launch covers up to 2^22 rows,
    which the kernel spreads over the card in sub-strips; on the CPU
    512-row strips mirror masa_tpu's CPU cadence."""
    if torch.device(device).type == "cuda":
        return wf.StripConfig(rows=1 << 22)
    return wf.StripConfig(rows=512)


def resolve_backend(backend: str, cells: int, gate: int, device) -> str:
    """"auto": the strip engine for every pass on a GPU; on the CPU the
    NumPy oracle below ``gate`` cells (masa_tpu's gates)."""
    if backend != "auto":
        return backend
    if torch.device(device).type == "cuda":
        return "kernel"
    return "numpy" if cells < gate else "kernel"


def make_aligner(backend: str, cfg: wf.StripConfig | None, device):
    """The oracle extension for the numpy backend, the strip engine
    otherwise."""
    if backend == "numpy":
        return CPUAligner()
    return CUDAAligner(cfg or default_config(device), device)


def forward_pass(
    seq0: np.ndarray,
    seq1: np.ndarray,
    params: ScoreParams,
    recurrence: Recurrence,
    row_init: InitType,
    col_init: InitType,
    first_row=None,
    first_col=None,
    special_every: int = 0,
    store: SpecialRowStore | None = None,
    backend: str = "auto",
    cfg: wf.StripConfig | None = None,
    track_best: bool = True,
    prune: bool = False,
    pad_rows: bool = False,
    best_sink=None,
    blocks_sink=None,
    want_last_row: bool = True,
    want_lastcol: bool = False,
    nw_best: bool = False,
    device="cuda",
    best_in: int | None = None,
) -> FwdResult:
    """Forward DP over a partition; persists special rows (with synthesized
    border gap values) into `store`, through a manager + aligner pair.
    ``prune`` enables block pruning where the aligner supports it (the
    strip engine, SW); ``best_sink(i, j, score)`` receives every candidate
    score (multi-alignment runs); ``blocks_sink(rows_done, maxima)`` the
    per-chunk bus maxima after each strip (--dump-blocks).  ``best_in`` is
    a score reached above the partition (a resumed stage 1's best): the
    pruning inside a launch starts from it."""
    m, n = len(seq0), len(seq1)
    store = store if store is not None else SpecialRowStore()
    backend = resolve_backend(backend, m * n, 4_000_000, device)
    aligner = make_aligner(backend, cfg, device)
    mgr = AlignerManager(aligner, params)
    mgr.set_recurrence_type(recurrence)
    mgr.set_first_row(row_init, first_row)
    mgr.set_first_column(col_init, first_col)
    mgr.set_special_rows_store(store)
    mgr.set_special_row_interval(special_every)
    mgr.set_block_pruning(prune, best_in)
    # NW best tracking is opt-in (nw_best): --alignment-end '*' selects the
    # endpoint as the global NW maximum
    mgr.track_best = track_best and (
        recurrence == Recurrence.SMITH_WATERMAN or nw_best)
    mgr.want_all_scores = best_sink is not None
    mgr.score_callback = best_sink
    mgr.pad_rows = pad_rows
    mgr.want_last_row = want_last_row and not pad_rows
    mgr.last_column_wanted = want_lastcol
    mgr.blocks_sink = blocks_sink
    aligner.set_sequences(seq0, seq1)
    mgr.align_partition(Partition(0, 0, m, n))

    if mgr.last_row is not None:
        _, lh, lf = mgr.last_row
    else:
        lh = lf = None
    best, best_i, best_j = mgr.best
    col_h = col_e = None
    if want_lastcol and mgr.last_column is not None:
        _, col_h, col_e = mgr.last_column
    return FwdResult(lh, lf, best, best_i, best_j, store,
                     aligner.stats.cells, col_h=col_h, col_e=col_e,
                     pruned_cells=aligner.stats.pruned_cells)


def goal_reachable(cp: Crosspoint, cut_row: int, match: int) -> bool:
    """Necessary condition for the SW alignment START to lie within the
    reverse window rows (cut_row, cp.i]: cp.score <= min(hb, cp.j) *
    match."""
    return cp.score <= min(cp.i - cut_row, cp.j) * match


def initial_window(cp: Crosspoint, cut_row: int, backend: str) -> int:
    """First reverse-window width for a hop of height hb = cp.i - cut_row
    (masa_tpu's policy, kept so crosspoints match it exactly: the matched
    column is typically ~hb left of cp.j, misses double and retry)."""
    hb = cp.i - cut_row
    if backend == "numpy" or (
        backend == "auto" and hb * min(cp.j, max(256, 2 * hb)) < 16_000_000
    ):
        floor = 256
    else:
        floor = 4096
    return min(cp.j, max(floor, 2 * hb))


@dataclasses.dataclass
class ReverseMatch:
    crosspoint: Crosspoint | None
    start_found: bool = False
    start: tuple[int, int] | None = None
    # (H, E) of the reverse pass along its far column, indexed by reverse
    # row p = cp.i - global_row; only when requested.
    rev_col: tuple | None = None


def _border_f_value(col_init: InitType, i: int, params: ScoreParams) -> int:
    """The true gap-state value straight along a synthesized border column
    (continuing pinned gap for GAPS_OPENED, freshly opened for GAPS)."""
    if col_init == InitType.WITH_GAPS_OPENED:
        return -i * params.gap_ext
    return -params.gap_open - i * params.gap_ext


def reverse_pass_and_match(
    seq0: np.ndarray,
    seq1: np.ndarray,
    params: ScoreParams,
    cp: Crosspoint,
    cut_row: int,
    fwd_h: np.ndarray,
    fwd_f: np.ndarray,
    j_low: int,
    goal_anywhere: bool,
    rev_seqs: tuple,
    backend: str = "auto",
    cfg: wf.StripConfig | None = None,
    want_rev_col: bool = False,
    free_col_start: bool = False,
    device="cuda",
) -> ReverseMatch:
    """One reverse partition: from crosspoint `cp` up to `cut_row`,
    columns [j_low, cp.j], matched against the stored forward cut
    fwd_h/fwd_f ((n+1,) arrays of `cut_row`).  Returns the next
    crosspoint, or a start-found result (SW), or crosspoint=None when the
    window was too small (caller widens j_low).

    ``rev_seqs = (seq0_reversed, seq1_reversed)``: the full reversed
    arrays, built once per march; the pass aligns an offset partition of
    them."""
    ci, cj, s, t = cp.i, cp.j, cp.score, cp.type
    hb = ci - cut_row
    assert hb >= 1
    if j_low > 0:
        # masa_tpu's power-of-two window widths, kept for equal results
        want = cj - j_low
        want = 1 << (want - 1).bit_length()
        j_low = max(cj - want, 0)
    width = cj - j_low
    goal = s + (params.gap_open if t != CrosspointType.MATCH else 0)

    # Reverse frame: row border = horizontal moves back from the
    # crosspoint; col border = vertical.  Pin the crosspoint state.
    row_init, col_init = init_types_for(t)
    backend = resolve_backend(backend, hb * max(width, 1), 16_000_000,
                              device)

    # Matching frame: index k runs j = cj - k for k in [0, width].
    fwd_cut_h = np.asarray(fwd_h, np.int64)[j_low:cj + 1][::-1]
    fwd_cut_f = np.asarray(fwd_f, np.int64)[j_low:cj + 1][::-1]
    if width == 0:
        # Degenerate window: only the straight-up border column exists.
        rev_h, _ = border_cells(hb + 1, col_init, params)
        rev_last_h = rev_h.astype(np.int64)[hb:hb + 1]
        rev_last_f = np.array([_border_f_value(col_init, hb, params)],
                              np.int64)
        best = NEG
        best_pq = (0, 0)
        rev_col = None
        mres = match_column(rev_last_h, rev_last_f, fwd_cut_h, fwd_cut_f,
                            goal, params.gap_open)
    else:
        aligner = make_aligner(backend, cfg, device)
        mgr = AlignerManager(aligner, params)
        mgr.set_recurrence_type(Recurrence.NEEDLEMAN_WUNSCH)
        mgr.set_first_row(row_init)
        mgr.set_first_column(col_init)
        mgr.track_best = goal_anywhere
        mgr.last_column_wanted = want_rev_col
        mgr.reverse_f0 = _border_f_value(col_init, hb, params)
        mgr.set_goal_score(goal, base_row=(fwd_cut_h, fwd_cut_f))
        part = Partition(len(seq0) - ci, len(seq1) - cj,
                         len(seq0) - cut_row, len(seq1) - j_low)
        aligner.set_sequences(*rev_seqs)
        mgr.align_partition(part)
        best = mgr.best[0]
        best_pq = (mgr.best[1] - part.i0, mgr.best[2] - part.j0)
        rev_col = None
        if want_rev_col and mgr.last_column is not None:
            rev_col = (mgr.last_column[1], mgr.last_column[2])
        mres = mgr.last_match_result

    # SW start detection: the pinned-state reverse matrix is bounded above
    # by the goal; best == goal locates the alignment start.
    if goal_anywhere and best == goal:
        p, q = best_pq
        return ReverseMatch(None, start_found=True, start=(ci - p, cj - q))

    if not mres.found:
        # Free-column-border start: the path may start mid-border at (i, 0)
        # between special rows; an exact goal hit in the reverse pass's
        # last column locates it.
        if j_low == 0 and rev_col is not None and free_col_start:
            rc = np.asarray(rev_col[0], np.int64)[:hb + 1]
            hits = np.nonzero(rc == goal)[0]
            if len(hits):
                return ReverseMatch(None, start_found=True,
                                    start=(ci - int(hits[0]), 0))
        if mres.type in (MatchType.ERROR_SUM_MATCH, MatchType.ERROR_SUM_GAP) \
                and j_low == 0 and not want_rev_col:
            raise RuntimeError(
                f"Backtrace lost at row {cut_row} (match overshoot "
                f"{mres.type})")
        return ReverseMatch(None, rev_col=rev_col)
    new_type = (CrosspointType.MATCH if mres.type == MatchType.ALIGNED
                else CrosspointType.GAP_2)
    return ReverseMatch(
        Crosspoint(cut_row, cj - mres.k, int(mres.score), new_type),
        rev_col=rev_col)


def reverse_march(
    seq0: np.ndarray,
    seq1: np.ndarray,
    params: ScoreParams,
    endpoint: Crosspoint,
    specials: SpecialRowStore,
    row_init: InitType,
    col_init: InitType,
    alignment_start: AlignmentStart,
    min_dist: int = 1,
    backend: str = "auto",
    cfg: wf.StripConfig | None = None,
    on_crosspoint=None,
    fix_origin: bool = True,
    device="cuda",
) -> list[Crosspoint]:
    """The stage-2 loop: march crosspoints from `endpoint` back toward the
    origin, matching at stored special rows (virtual row 0 included).

    ``specials`` is any row store with ``get``, ``next_below`` and
    ``truncate_above``: a SpecialRowStore, or a special-rows-area
    partition (``core/sra``), which the runner passes.  Returns
    crosspoints ordered from start to endpoint (ascending i).
    row_init/col_init describe the matrix borders, used for the final
    row-0 matching and origin fixups."""
    n = len(seq1)
    sw_anywhere = alignment_start == AlignmentStart.ANYWHERE
    cps: list[Crosspoint] = [endpoint]
    cp = endpoint
    rev_seqs = (np.ascontiguousarray(seq0[::-1]),
                np.ascontiguousarray(seq1[::-1]))
    row0_h = (border_cells(n + 1, row_init, params)[0]
              if row_init != InitType.CUSTOM else None)

    while True:
        if sw_anywhere and cp.score <= 0:
            break
        if cp.i == 0 or (cp.j == 0 and not sw_anywhere):
            break
        dist = min_dist
        while True:
            # row-widen loop: a full-width miss at a stored row skips that
            # row and rematches at the next one below; only a full-width
            # miss at virtual row 0 is a lost backtrace
            r = specials.next_below(cp.i, dist)
            if r is None or r == 0:
                r = 0
                fh = row0_h.astype(np.int64)
                ff = np.full(n + 1, NEG, np.int64)
            else:
                fh, ff = specials.get(r)
            goal_anywhere = (sw_anywhere
                             and goal_reachable(cp, r, params.match))
            # free column border: the path may start mid-border at (i, 0)
            free_col = (not sw_anywhere
                        and col_init == InitType.WITH_ZEROES)
            j_low = cp.j - initial_window(cp, r, backend)
            while True:
                rm = reverse_pass_and_match(
                    seq0, seq1, params, cp, r, fh, ff, max(j_low, 0),
                    goal_anywhere, backend=backend, cfg=cfg,
                    rev_seqs=rev_seqs, want_rev_col=free_col and j_low <= 0,
                    free_col_start=free_col, device=device)
                if rm.start_found:
                    si, sj = rm.start
                    cp = Crosspoint(si, sj, 0, CrosspointType.MATCH)
                    cps.append(cp)
                    if on_crosspoint:
                        on_crosspoint(cp)
                    return list(reversed(cps))
                if rm.crosspoint is not None or j_low <= 0:
                    break
                j_low = cp.j - 2 * (cp.j - j_low)
            if rm.crosspoint is not None:
                break
            if r == 0:
                raise RuntimeError(
                    f"Backtrace lost: no match at special row {r}")
            dist = cp.i - r + 1
        cp = rm.crosspoint
        cps.append(cp)
        if on_crosspoint:
            on_crosspoint(cp)
        specials.truncate_above(cp.i)

    # Origin fixup: a crosspoint resting on a gapped border extends to the
    # origin.
    first = cps[-1]
    gapped = (InitType.WITH_GAPS, InitType.WITH_GAPS_OPENED)
    if fix_origin and not sw_anywhere and (first.i > 0 or first.j > 0):
        if (first.i == 0 and row_init in gapped) or (
            first.j == 0 and col_init in gapped
        ):
            cps.append(Crosspoint(0, 0, 0, CrosspointType.MATCH))

    return list(reversed(cps))
