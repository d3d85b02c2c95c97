"""Stage-agnostic traceback machinery for the port: forward passes with
special rows, reverse goal-score marching (stages 2 and 3), and the
crosspoint algebra.  Counterpart of masa_tpu/stages/core.py; the contracts
(crosspoint states, cut matching, border gap synthesis) are documented
there and are the same here.

What differs is how passes are dispatched.  Every pass builds a manager
and an aligner; ``backend="auto"`` picks the strip engine for every pass on
a CUDA device (a launch costs microseconds there), and keeps masa_tpu's
size gates to the NumPy oracle on the CPU.

Stage 2 matches on the device where it can, as masa_tpu does: stage 1
keeps a copy of each special row where it was computed (``DevRowCache``,
its budget the card's own), and a hop whose cut is there matches the
reverse pass's last row against it in place and pulls three values
(``wavefront.goal_match_device``).  A hop whose row is not cached (a
resumed run, an evicted row) reads only the cut's column window from the
store and matches that on the device (``_fetch_window_cut``).

On a card the march's steady hops run chained, as masa_tpu's device march
runs them (``_run_hop_chain``, ``_run_arb_hop``): the march state stays on
the device between hops (``wavefront.hop_step``: one launch of the hop
kernel a hop, three for a hop taller than a cluster), a segment of up to
CHAIN_HOPS hops is issued with no read on the host and pulls its verdicts
once, and a hop that is not eligible or does not hit hands the march back
to the host path from that hop, so the crosspoints are those of the host
march byte for byte.
"""

from __future__ import annotations

import dataclasses
import functools

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
from masa_tpu_torch.ops import kernels, strips
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.utils import trace

NEG = -INF

# The row cache's budget on the CPU, where its rows are host memory.
CPU_ROW_CACHE_BYTES = 1 << 30
# Device memory a stage-1 launch needs beside the rows it keeps: its
# flushed rows (at most strips.FLUSH_ROWS_BYTES), its disk rows packed
# (strips.PACK_BYTES) and 64 MiB for the rest.  Measured on an H100
# (chip_smoke.py, the CLI on the 1M pair, before the rows were packed a
# launch at a time): the call's peak less its 127 kept rows was
# 1,111,567,840 bytes, the launch's 1,065,349,152 bytes of flushed rows
# and 46,218,688 more.
LAUNCH_MARGIN = strips.FLUSH_ROWS_BYTES + strips.PACK_BYTES + (64 << 20)


class SpecialRowStore:
    """RAM special-row store: row index -> ((n+1,) H, (n+1,) F) including
    the border element at k=0, or a manager.LazyFullRow whose body stays
    on its device until a read."""

    def __init__(self):
        self._rows: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def put(self, r: int, h: np.ndarray, f: np.ndarray) -> None:
        self._rows[r] = (np.asarray(h), np.asarray(f))

    def put_lazy(self, r: int, lazy) -> None:
        """A lazy row: a RAM store is no crash persistence, so a row that
        is never read never crosses to the host."""
        self._rows[r] = lazy

    def get(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        v = self._rows[r]
        if not isinstance(v, tuple):
            v = self._rows[r] = v.full_rows()
        return v

    def get_window(self, r: int, lo: int, hi: int
                   ) -> tuple[np.ndarray, np.ndarray]:
        h, f = self.get(r)
        return h[lo:hi], f[lo:hi]

    def finalize(self) -> None:
        pass

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


class DevRowCache:
    """Stage 1's special rows kept where they were computed, so that
    stage 2 matches each hop there (the port of
    ``masa_tpu.stages.core.DevRowCache``).  The store stays the
    authority (crash resume); this is an accelerator.

    ``budget_bytes`` bounds the rows' bytes (``row_cache_budget`` gives
    the rule for a device).  Eviction drops the smallest rows first:
    stage 2 consumes top-down, so the high rows are needed soonest.  Rows
    above a found crosspoint are dropped as the store drops them."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self._rows: dict[int, tuple] = {}     # r -> (dev_h, dev_f)
        self._borders: dict[int, tuple] = {}  # r -> (h0, f0)
        self.nbytes = 0

    @staticmethod
    def _size(dev_h) -> int:
        return 2 * dev_h.numel() * dev_h.element_size()

    def _drop(self, r: int) -> None:
        dev_h, _ = self._rows.pop(r)
        self._borders.pop(r, None)
        self.nbytes -= self._size(dev_h)

    def put_dev(self, r: int, dev_h, dev_f) -> None:
        if r in self._rows:
            return
        size = self._size(dev_h)
        while self.nbytes + size > self.budget and self._rows:
            self._drop(min(self._rows))
        if self.nbytes + size > self.budget:
            return
        self._rows[r] = (dev_h, dev_f)
        self.nbytes += size

    def attach_border(self, r: int, h0: int, f0: int) -> None:
        if r in self._rows:
            self._borders[r] = (int(h0), int(f0))

    def get(self, r: int):
        """(dev_h, dev_f, border_h0, border_f0) or None."""
        row = self._rows.get(r)
        border = self._borders.get(r)
        if row is None or border is None:
            return None
        return (*row, *border)

    def truncate_above(self, i: int) -> None:
        for r in [r for r in self._rows if r > i]:
            self._drop(r)

    def copy(self) -> "DevRowCache":
        """A cache of the same rows (shared, never written), so truncating
        one cache leaves the other whole."""
        out = DevRowCache(self.budget)
        out._rows, out._borders = dict(self._rows), dict(self._borders)
        out.nbytes = self.nbytes
        return out

    def __len__(self):
        return len(self._rows)


def row_cache_budget(device) -> int:
    """The row cache's budget on ``device``: on a card, half of the
    device memory free when it is asked (the rest is for the launches of
    every stage); on the CPU, CPU_ROW_CACHE_BYTES."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[0] // 2
    return CPU_ROW_CACHE_BYTES


def lazy_rows_fit(pinned_bytes: int, budget: int, device) -> bool:
    """Whether stage 1 may deliver its rows lazily: a lazy row pins its
    device copy until the store reads it, and the rows a RAM store keeps
    are never read, so their bytes (``pinned_bytes``) must fit the
    cache's budget with a stage-1 launch's own working memory beside
    them (LAUNCH_MARGIN on a card)."""
    margin = LAUNCH_MARGIN if torch.device(device).type == "cuda" else 0
    return pinned_bytes + margin <= budget


@dataclasses.dataclass
class MarchStats:
    """What a reverse march did: its passes matched where the rows lie
    (the chained hops among them) and on the host, the cut windows it read
    from the store with their int32 H and F bytes, the hops it handed on
    from chained segments (an endpoint hop is a segment of one), the
    segments and those that broke before their end, and the hops the
    segments issued on the device (those after a break, computed in vain,
    among them), of which ``issued_three`` as the three launches of a hop
    taller than a cluster (the route ``wavefront.hop_step`` took)."""
    dev_matches: int = 0
    host_matches: int = 0
    window_reads: int = 0
    window_bytes: int = 0
    chained: int = 0
    segments: int = 0
    chain_breaks: int = 0
    issued: int = 0
    issued_three: int = 0

    def text(self) -> str:
        return (f"matched on the device {self.dev_matches}, on the host "
                f"{self.host_matches}; window reads {self.window_reads} "
                f"({self.window_bytes} bytes); chained {self.chained} of "
                f"{self.issued} issued ({self.issued_three} in three "
                f"launches) in {self.segments} segments, "
                f"{self.chain_breaks} broken")


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
    dev_cache: DevRowCache | None = None


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
    dev_cache: DevRowCache | None = None,
    lazy_rows: bool = False,
) -> FwdResult:
    """Forward DP over a partition; persists special rows (with synthesized
    border gap values) into `store`, through a manager + aligner pair.
    ``prune`` enables block pruning where the aligner supports it (the
    strip engine, SW); ``best_sink(i, j, score)`` receives every candidate
    score (multi-alignment runs); ``blocks_sink(rows_done, maxima)`` the
    per-chunk bus maxima after each strip (--dump-blocks).  ``best_in`` is
    a score reached above the partition (a resumed stage 1's best): the
    pruning inside a launch starts from it.  ``dev_cache`` keeps a copy
    of each special row on the pass's device (the strip engine); with
    ``lazy_rows`` the store gets them as LazyFullRows too, and is
    finalized after the pass."""
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
    mgr.special_dev_sink = dev_cache
    mgr.lazy_special_rows = (lazy_rows and dev_cache is not None
                             and backend != "numpy")
    aligner.set_sequences(seq0, seq1)
    mgr.align_partition(Partition(0, 0, m, n))
    if mgr.lazy_special_rows:
        store.finalize()

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
                     pruned_cells=aligner.stats.pruned_cells,
                     dev_cache=dev_cache)


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
    dev_cut: tuple | None = None,
    fwd_rows_fn=None,
    dev_cut_off: int = 0,
    stats: MarchStats | None = None,
) -> ReverseMatch:
    """One reverse partition: from crosspoint `cp` up to `cut_row`,
    columns [j_low, cp.j], matched against the stored forward cut
    fwd_h/fwd_f ((n+1,) arrays of `cut_row`).  Returns the next
    crosspoint, or a start-found result (SW), or crosspoint=None when the
    window was too small (caller widens j_low).

    ``rev_seqs = (seq0_reversed, seq1_reversed)``: the full reversed
    arrays, built once per march; the pass aligns an offset partition of
    them.

    ``dev_cut = (dev_h, dev_f, border_h0, border_f0)``: the stored cut as
    tensors on the pass's device, a whole row from the row cache or a
    window read from the store, its element 0 at bus index
    ``dev_cut_off``.  Where it serves (the strip engine, a window clear of
    column 0) the match runs on the device and fwd_h/fwd_f may be None:
    ``fwd_rows_fn()`` loads the host row only if the host match is needed
    after all.  ``stats`` counts where the pass matched."""
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
    # the match on the device: not on the column-0 border, nor for the
    # oracle
    use_dev = (dev_cut is not None and width > 0 and j_low >= 1
               and backend != "numpy")
    if stats is not None:
        if use_dev:
            stats.dev_matches += 1
        else:
            stats.host_matches += 1

    # Matching frame: index k runs j = cj - k for k in [0, width].
    fwd_cut_h = fwd_cut_f = None
    if not use_dev:
        if fwd_h is None:
            fwd_h, fwd_f = fwd_rows_fn()
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
        if use_dev:
            mgr.set_goal_score(goal)
            mgr.goal_base_dev = (dev_cut[0], dev_cut[1], cj - dev_cut_off,
                                 width + 1)
        else:
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


def _windowed_cut_ok(backend: str, hb: int, width: int, device) -> bool:
    """Would this hop run the strip kernel on a card?  Only there does a
    window of the stored cut, read alone and matched on the device, stand
    in for the whole row (reverse_pass_and_match's backend rule)."""
    if width <= 0 or torch.device(device).type != "cuda":
        return False
    return resolve_backend(backend, hb * width, 16_000_000,
                           device) == "kernel"


def _fetch_window_cut(specials, r: int, cj: int, j_low: int, device):
    """The stored cut's [j_low, cj] column window as tensors on
    ``device`` (a store's get_window reads only the window of a row in
    the "none" codec).  Returns ((dev_h, dev_f, h0, f0), cut_off) or None;
    cut_off is the bus index of the window's element 0, j_low - 1."""
    get_window = getattr(specials, "get_window", None)
    if get_window is None:
        return None
    wh, wf_ = get_window(r, j_low, cj + 1)
    if len(wh) != cj + 1 - j_low:
        return None
    dev_h = torch.from_numpy(np.ascontiguousarray(wh, np.int32)).to(device)
    dev_f = torch.from_numpy(np.ascontiguousarray(wf_, np.int32)).to(device)
    return (dev_h, dev_f, 0, 0), j_low - 1


# Hops a chained segment issues before it reads its verdicts (masa_tpu's
# cap): what a segment that breaks at its first hop computes in vain.
CHAIN_HOPS = 32


def _hop_window(cp: Crosspoint, r: int, backend: str) -> int:
    """The window of a hop from ``cp`` to row ``r`` on the host path's
    first try, where it clears column 0: ``initial_window`` raised to a
    power of two (``reverse_pass_and_match``'s width rule).  While cj
    stays above it, it is the same for every hop of one height."""
    return 1 << (initial_window(cp, r, backend) - 1).bit_length()


def _run_segment(rows, cp: Crosspoint, W: int, seq0, params: ScoreParams,
                 specials, dev_cache, sw: bool, rev_views, cps: list,
                 on_crosspoint, stats) -> tuple[int, int]:
    """Issue one hop for each of ``rows`` (descending, each in the row
    cache) from ``cp`` at window W, the state passed on the device from
    hop to hop; then read the verdicts and the kernels' error flags
    at once (a set flag raises) and hand on the hops before the first
    with ok = 0, as the host march would have found them.  Returns
    (hops handed on, hops issued)."""
    s0r, s1r = rev_views
    m = len(seq0)
    st = torch.empty((len(rows) + 1, 4), dtype=torch.int32,
                     device=s1r.device)
    st[0] = torch.tensor([cp.j, cp.score, int(cp.type), 1],
                         dtype=torch.int32)
    flags: list = []
    ci = cp.i
    routes: list = []
    for t, r in enumerate(rows):
        cut = dev_cache.get(r)
        wf.hop_step(s0r[m - ci:m - r], s1r, cut[0], cut[1], st[t],
                    st[t + 1], W, match=params.match,
                    mismatch=params.mismatch, gap_open=params.gap_open,
                    gap_ext=params.gap_ext, sw=sw, flags=flags,
                    routes=routes)
        ci = r
    got = torch.cat([st[1:].reshape(-1)] + flags)
    with trace.span("wait"):
        got = got.cpu().tolist()
    kernels.check_flags(got[4 * len(rows):])
    done = 0
    for r, t in zip(rows, range(0, 4 * len(rows), 4)):
        cj, score, typ, ok = got[t:t + 4]
        if not ok:
            break
        cp = Crosspoint(r, cj, score, CrosspointType(typ))
        cps.append(cp)
        if on_crosspoint:
            on_crosspoint(cp)
        specials.truncate_above(r)
        dev_cache.truncate_above(r)
        done += 1
    if stats is not None:
        stats.segments += 1
        stats.chained += done
        stats.dev_matches += done
        stats.chain_breaks += done < len(rows)
        stats.issued += len(rows)
        stats.issued_three += routes.count("three")
    return done, len(rows)


def _run_hop_chain(seq0, params: ScoreParams, cp: Crosspoint, specials,
                   dev_cache, sw: bool, rev_views, backend: str, cps: list,
                   on_crosspoint, stats):
    """Chain a steady segment of the march on the device (the port of
    masa_tpu's ``_run_hop_chain``): the next up to CHAIN_HOPS special rows
    below ``cp`` one spacing hb apart, each in the row cache, at least 3
    of them, at the window the host path takes for that height
    (``_hop_window``, which ``cp.j`` must clear).  Each hop checks on the
    device, with the live state, that it is eligible (cj >= W + 1, under
    SW the goal out of reach inside the hop); one that is not, or whose
    match is no hit, hands the march back to the host from there.
    Returns ``_run_segment``'s (handed on, issued), or None where no
    segment applies."""
    r1 = specials.next_below(cp.i, 1)
    if r1 is None or r1 <= 0:
        return None
    hb = cp.i - r1
    W = _hop_window(cp, r1, backend)
    if cp.j < W + 1:
        return None
    rows, prev = [], cp.i
    while len(rows) < CHAIN_HOPS:
        r = specials.next_below(prev, 1)
        if r is None or r <= 0 or prev - r != hb or dev_cache.get(r) is None:
            break
        rows.append(r)
        prev = r
    if len(rows) < 3:
        return None
    return _run_segment(rows, cp, W, seq0, params, specials, dev_cache, sw,
                        rev_views, cps, on_crosspoint, stats)


def _run_arb_hop(seq0, params: ScoreParams, cp: Crosspoint, specials,
                 dev_cache, sw: bool, rev_views, backend: str, cps: list,
                 on_crosspoint, stats):
    """One hop of any height on the device, as a segment of one: the
    endpoint hop, and the rows near the origin whose spacing differs (the
    port of masa_tpu's ``_run_arb_hop``).  The hop kernels take any
    height, so masa_tpu's ladder of rung strips, dynamic tail and
    row-sweep residue is not needed.  The same conditions as a chain's
    hop, checked on the host first.  Returns (handed on, issued), or None
    where the hop cannot run on the device."""
    r = specials.next_below(cp.i, 1)
    if r is None or r <= 0 or dev_cache.get(r) is None:
        return None
    if sw and goal_reachable(cp, r, params.match):
        return None
    W = _hop_window(cp, r, backend)
    if cp.j < W + 1:
        return None
    return _run_segment([r], cp, W, seq0, params, specials, dev_cache, sw,
                        rev_views, cps, on_crosspoint, stats)


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
    dev_cache: DevRowCache | None = None,
    stats: MarchStats | None = None,
    chain: bool | None = None,
) -> list[Crosspoint]:
    """The stage-2 loop: march crosspoints from `endpoint` back toward the
    origin, matching at stored special rows (virtual row 0 included).

    ``specials`` is any row store with ``get``, ``next_below`` and
    ``truncate_above``: a SpecialRowStore, or a special-rows-area
    partition (``core/sra``), which the runner passes.  A hop whose row
    ``dev_cache`` holds matches on the device; one whose row it lacks
    reads the cut's window from the store where the hop runs the kernel
    on a card (``_windowed_cut_ok``); the rest match on the host.
    ``stats`` counts them.  Returns crosspoints ordered from start to
    endpoint (ascending i).  row_init/col_init describe the matrix
    borders, used for the final row-0 matching and origin fixups.

    ``chain``: run the hops whose rows the cache holds on the device,
    chained (``_run_hop_chain``, ``_run_arb_hop``); None means so on a
    card where ``dev_cache`` is given and ``min_dist`` is 1.  A hop that
    is not eligible or does not hit goes to the host path; nothing else
    does: a failed launch or a set error flag raises."""
    n = len(seq1)
    sw_anywhere = alignment_start == AlignmentStart.ANYWHERE
    if chain is None:
        chain = (torch.device(device).type == "cuda"
                 and dev_cache is not None and min_dist == 1)
    elif chain and (dev_cache is None or min_dist != 1):
        raise ValueError("a chained march needs the row cache and "
                         "min_dist 1")
    cps: list[Crosspoint] = [endpoint]
    cp = endpoint
    rev_seqs = (np.ascontiguousarray(seq0[::-1]),
                np.ascontiguousarray(seq1[::-1]))
    rev_views = None
    if backend != "numpy" or chain:
        # the reversed views as flips of stage 1's forward ones on the
        # device, found by every hop's aligner under the reversed arrays
        for fwd, rev in zip((seq0, seq1), rev_seqs):
            wf.dev_seq_seed_reversed(fwd, rev, device)
    if chain:
        rev_views = tuple(wf.dev_seq(x, device) for x in rev_seqs)
    row0_h = (border_cells(n + 1, row_init, params)[0]
              if row_init != InitType.CUSTOM else None)
    host_hop = None  # the row a broken segment's failing hop starts at

    while True:
        if sw_anywhere and cp.score <= 0:
            break
        if cp.i == 0 or (cp.j == 0 and not sw_anywhere):
            break
        if chain and cp.i != host_hop:
            args = (seq0, params, cp, specials, dev_cache, sw_anywhere,
                    rev_views, backend, cps, on_crosspoint, stats)
            got = _run_hop_chain(*args)
            if got is None:
                got = _run_arb_hop(*args)
            if got is not None:
                done, issued = got
                if done < issued:
                    host_hop = cps[-1].i
                if done:
                    cp = cps[-1]
                    continue
        dist = min_dist
        while True:
            # row-widen loop: a full-width miss at a stored row skips that
            # row and rematches at the next one below; only a full-width
            # miss at virtual row 0 is a lost backtrace
            r = specials.next_below(cp.i, dist)
            dev_cut = fwd_rows_fn = None
            window_viable = False
            if r is None or r == 0:
                r = 0
                fh = row0_h.astype(np.int64)
                ff = np.full(n + 1, NEG, np.int64)
                if col_init == InitType.WITH_GAPS_OPENED:
                    # a GAP_2 start: the vertical gap is open at the
                    # corner, as the stored rows' synthesized F[0] is
                    ff[0] = _border_f_value(col_init, 0, params)
            else:
                dev_cut = dev_cache.get(r) if dev_cache is not None else None
                window_viable = (dev_cut is None and _windowed_cut_ok(
                    backend, cp.i - r, cp.j, device))
                if dev_cut is None and not window_viable:
                    fh, ff = specials.get(r)
                else:
                    # the host row only if a try falls back to the host
                    fh = ff = None
                    fwd_rows_fn = functools.cache(
                        functools.partial(specials.get, r))
            goal_anywhere = (sw_anywhere
                             and goal_reachable(cp, r, params.match))
            # free column border: the path may start mid-border at (i, 0)
            free_col = (not sw_anywhere
                        and col_init == InitType.WITH_ZEROES)
            j_low = cp.j - initial_window(cp, r, backend)
            while True:
                cut, cut_off = dev_cut, 0
                if window_viable and j_low > 0:
                    # the window the pass will take (its power-of-two
                    # width), read alone
                    j_low_q = max(cp.j - (1 << (cp.j - j_low - 1)
                                          .bit_length()), 0)
                    if j_low_q >= 1 and _windowed_cut_ok(
                            backend, cp.i - r, cp.j - j_low_q, device):
                        got = _fetch_window_cut(specials, r, cp.j, j_low_q,
                                                device)
                        if got is not None:
                            cut, cut_off = got
                            if stats is not None:
                                stats.window_reads += 1
                                stats.window_bytes += 8 * (cp.j + 1
                                                           - j_low_q)
                rm = reverse_pass_and_match(
                    seq0, seq1, params, cp, r, fh, ff, max(j_low, 0),
                    goal_anywhere, backend=backend, cfg=cfg,
                    rev_seqs=rev_seqs, want_rev_col=free_col and j_low <= 0,
                    free_col_start=free_col, device=device, dev_cut=cut,
                    fwd_rows_fn=fwd_rows_fn, dev_cut_off=cut_off,
                    stats=stats)
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
        if dev_cache is not None:
            dev_cache.truncate_above(cp.i)

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
