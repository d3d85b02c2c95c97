"""Taken from ``masa_tpu/ops/oracle.py`` (the JAX reference).

NumPy reference implementation of the affine-gap DP.

This is the engine's ground truth (the role CPUBlockProcessor plays in the
reference: libs/masa-core/src/libmasa/processors/CPUBlockProcessor.cpp:113-174).
Two independent implementations cross-check each other:

  * `dp_matrix`    — cell-by-cell loops, trivially correct, O(m*n) slow.
  * `dp_rows`      — row-vectorized with a lazy-E fixpoint, fast enough for
                     multi-megacell tests; produces rows/columns only
                     (linear space).

Both honor the border-init contract of IManager.hpp:113-182 and the
(H,E,F) recurrence of CUDAligner.cu:276-289.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from masa_tpu_torch.models.scoring import border_cells
from masa_tpu_torch.types import INF, InitType, Recurrence, ScoreParams

NEG = -INF


@dataclasses.dataclass
class DPResult:
    """Dense DP result (small matrices only)."""

    h: np.ndarray  # (m+1, n+1) int64
    e: np.ndarray  # horizontal gap component
    f: np.ndarray  # vertical gap component

    @property
    def last_row(self) -> tuple[np.ndarray, np.ndarray]:
        """(H, F) of the last row over j in [0, n] — special-row convention."""
        return self.h[-1], self.f[-1]

    @property
    def last_col(self) -> tuple[np.ndarray, np.ndarray]:
        """(H, E) of the last column over i in [0, m]."""
        return self.h[:, -1], self.e[:, -1]

    def best(self) -> tuple[int, int, int]:
        """Best score and its position, ties broken by smallest i then
        smallest j (the engine-wide deterministic tie-break)."""
        best = int(self.h.max())
        ii, jj = np.nonzero(self.h == best)
        order = np.lexsort((jj, ii))
        k = order[0]
        return best, int(ii[k]), int(jj[k])


def _border(
    length: int,
    init: InitType,
    params: ScoreParams,
    custom: tuple[np.ndarray, np.ndarray] | None,
) -> tuple[np.ndarray, np.ndarray]:
    if init == InitType.CUSTOM:
        assert custom is not None, "CUSTOM init requires explicit border data"
        h, g = custom
        return np.asarray(h, np.int64), np.asarray(g, np.int64)
    h, g = border_cells(length, init, params)
    return h.astype(np.int64), g.astype(np.int64)


def dp_matrix(
    seq0: np.ndarray,
    seq1: np.ndarray,
    params: ScoreParams = ScoreParams(),
    recurrence: Recurrence = Recurrence.SMITH_WATERMAN,
    row_init: InitType = InitType.WITH_ZEROES,
    col_init: InitType = InitType.WITH_ZEROES,
    first_row: tuple[np.ndarray, np.ndarray] | None = None,
    first_col: tuple[np.ndarray, np.ndarray] | None = None,
) -> DPResult:
    """Dense cell-by-cell DP. first_row/first_col are (H, gap-component)
    vectors of length n+1 / m+1 (index 0 = the shared corner)."""
    m, n = len(seq0), len(seq1)
    h = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    e = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    f = np.full((m + 1, n + 1), NEG, dtype=np.int64)

    # A row border's gap component is F (continues vertical gaps downward);
    # a column border's is E (continues horizontal gaps rightward) — the
    # reference's union-cell convention (libmasaTypes.hpp:35-41).
    row_h, row_g = _border(n + 1, row_init, params, first_row)
    col_h, col_g = _border(m + 1, col_init, params, first_col)
    h[0, :], f[0, :] = row_h, row_g
    h[:, 0], e[:, 0] = col_h, col_g
    # The corner must agree between the two borders; the row wins (the
    # reference reads the corner from the first row: FirstRow.cpp).
    h[0, 0] = row_h[0]

    go, ge = params.gap_open, params.gap_ext
    sw = recurrence == Recurrence.SMITH_WATERMAN
    for i in range(1, m + 1):
        c0 = seq0[i - 1]
        for j in range(1, n + 1):
            e[i, j] = max(h[i, j - 1] - go, e[i, j - 1]) - ge
            f[i, j] = max(h[i - 1, j] - go, f[i - 1, j]) - ge
            s = params.match if c0 == seq1[j - 1] else params.mismatch
            v = max(h[i - 1, j - 1] + s, e[i, j], f[i, j])
            h[i, j] = max(v, 0) if sw else v
    return DPResult(h, e, f)


@dataclasses.dataclass
class RowsResult:
    """Linear-space forward pass result."""

    last_h: np.ndarray  # (n+1,) H of the final row
    last_f: np.ndarray  # (n+1,) F of the final row
    col_h: np.ndarray   # (m+1,) H of the last column
    col_e: np.ndarray   # (m+1,) E of the last column
    best: int
    best_i: int
    best_j: int
    specials: dict[int, tuple[np.ndarray, np.ndarray]]
    row_best_val: np.ndarray | None = None  # (m,) per-row max (SW)
    row_best_j: np.ndarray | None = None


def dp_rows(
    seq0: np.ndarray,
    seq1: np.ndarray,
    params: ScoreParams = ScoreParams(),
    recurrence: Recurrence = Recurrence.SMITH_WATERMAN,
    row_init: InitType = InitType.WITH_ZEROES,
    col_init: InitType = InitType.WITH_ZEROES,
    first_row: tuple[np.ndarray, np.ndarray] | None = None,
    first_col: tuple[np.ndarray, np.ndarray] | None = None,
    special_rows: tuple[int, ...] = (),
    row_bests: bool = False,
    special_best: dict | None = None,
) -> RowsResult:
    """Row-sweep DP in O(n) memory.  ``special_best`` (SW), a dict, gets
    for each special row the best (score, i, j) of the rows down to it.

    Each row is computed with the lazy-E fixpoint: H is first formed without
    E, then E is derived from the prefix-max of (H + j*ext) and H re-maxed;
    repeat until stable (exact — E only ever raises H, which only ever raises
    E monotonically, and both are bounded).
    """
    m, n = len(seq0), len(seq1)
    go, ge = params.gap_open, params.gap_ext
    sw = recurrence == Recurrence.SMITH_WATERMAN

    row_h, row_e = _border(n + 1, row_init, params, first_row)
    col_h, col_f = _border(m + 1, col_init, params, first_col)

    h_prev = row_h.copy()
    # Row 0's stored gap component is F by the row convention when the caller
    # supplied custom data; synthesized borders carry -INF gap components.
    f_prev = row_e.copy() if row_init == InitType.CUSTOM else np.full(
        n + 1, NEG, dtype=np.int64
    )

    col_h64 = col_h.astype(np.int64)
    col_f64 = col_f.astype(np.int64)

    best, best_i, best_j = NEG, 0, 0
    if sw:
        b0, bi0, bj0 = _border_best(h_prev)
        best, best_i, best_j = b0, 0, bj0
    out_col_h = np.empty(m + 1, dtype=np.int64)
    out_col_e = np.empty(m + 1, dtype=np.int64)
    out_col_h[0] = h_prev[n]
    # E along row 0 is unrepresentable in the union-cell convention and
    # never influences rows below; report -INF like the reference borders.
    out_col_e[0] = NEG
    specials: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    special_set = set(special_rows)
    jext = np.arange(n + 1, dtype=np.int64) * ge
    if row_bests:
        rb_val = np.zeros(m, np.int64)
        rb_j = np.zeros(m, np.int64)

    for i in range(1, m + 1):
        c0 = seq0[i - 1]
        sub = np.where(seq1 == c0, params.match, params.mismatch).astype(
            np.int64
        )

        f_cur = np.empty(n + 1, dtype=np.int64)
        f_cur[0] = NEG
        f_cur[1:] = np.maximum(h_prev[1:] - go, f_prev[1:]) - ge

        h_cur = np.empty(n + 1, dtype=np.int64)
        h_cur[0] = col_h64[i]
        diag = h_prev[:-1] + sub
        h_cur[1:] = np.maximum(diag, f_cur[1:])
        if sw:
            np.maximum(h_cur[1:], 0, out=h_cur[1:])

        # lazy-E fixpoint; E(i,0) is the border's gap component (E for
        # columns when the caller supplied custom data, else -INF).
        e_cur = np.full(n + 1, NEG, dtype=np.int64)
        e_cur[0] = col_f64[i] if col_init == InitType.CUSTOM else NEG
        while True:
            # E[j] = max_{k<j} ( max(H[k]-go, E[k]) - (j-k)*ge )
            g = np.maximum(h_cur - go, e_cur) + jext
            run = np.maximum.accumulate(g[:-1])
            e_new = run - jext[1:]
            e_new = np.maximum(e_new, NEG)
            h_new = np.maximum(h_cur[1:], e_new)
            if sw:
                np.maximum(h_new, 0, out=h_new)
            if np.array_equal(h_new, h_cur[1:]) and np.array_equal(
                e_new, e_cur[1:]
            ):
                e_cur[1:] = e_new
                break
            h_cur[1:] = h_new
            e_cur[1:] = e_new

        if sw:
            mx = int(h_cur.max())
            if mx > best:
                js = np.nonzero(h_cur == mx)[0]
                best, best_i, best_j = mx, i, int(js[0])
            if row_bests:
                rb_val[i - 1] = mx
                rb_j[i - 1] = int(np.argmax(h_cur))
        h_prev, f_prev = h_cur, f_cur
        out_col_h[i] = h_cur[n]
        out_col_e[i] = e_cur[n]
        if i in special_set:
            specials[i] = (h_cur.copy(), f_cur.copy())
            if sw and special_best is not None:
                special_best[i] = (best, best_i, best_j)

    if not sw:
        best, best_i, best_j = int(h_prev[n]), m, n
    return RowsResult(
        last_h=h_prev,
        last_f=f_prev,
        col_h=out_col_h,
        col_e=out_col_e,
        best=best,
        best_i=best_i,
        best_j=best_j,
        specials=specials,
        row_best_val=rb_val if row_bests else None,
        row_best_j=rb_j if row_bests else None,
    )


def _border_best(row_h: np.ndarray) -> tuple[int, int, int]:
    b = int(row_h.max())
    j = int(np.nonzero(row_h == b)[0][0])
    return b, 0, j
