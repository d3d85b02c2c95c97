"""Strip chaining: run a whole partition strip by strip, carrying the bus,
the borders, the best score and the special rows.

Counterpart of ``masa_tpu/ops/strips.py:run_partition`` with what the main
path uses: the strip loop with its bus carry, special rows at any cadence
(flushed inside the strip by the kernel), the best fold, the last row and
column, and the goal stop.  Strips run at their true height, so
``pad_rows`` needs no sentinel rows here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from masa_tpu.models.scoring import border_cells
from masa_tpu.types import INF, InitType, Recurrence, ScoreParams
from masa_tpu_torch.ops import wavefront as wf

# Device bytes the interior rows of one launch may hold (H and F, int32).
FLUSH_ROWS_BYTES = 1 << 30


@dataclasses.dataclass
class PartitionResult:
    last_h: np.ndarray | None   # (n+1,) DP last row H (index 0 = border)
    last_f: np.ndarray | None   # (n+1,)
    best: int
    best_i: int                 # DP coordinates
    best_j: int
    col_h: np.ndarray | None    # (m+1,) DP last column H if store_lastcol
    col_e: np.ndarray | None
    specials: dict[int, tuple[np.ndarray, np.ndarray]]
    cells: int = 0


def _border_vec(init, params, length, start, custom):
    """(H, gap) border values for DP indices start .. start+length-1."""
    if init == InitType.CUSTOM:
        h, g = custom
        return (np.asarray(h[start:start + length], np.int32),
                np.asarray(g[start:start + length], np.int32))
    return border_cells(length, init, params, start=start)


def _as_chars(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(np.asarray(x, np.uint8))


def strip_height(cfg: wf.StripConfig, nj: int, special_every: int) -> int:
    """Rows per strip: ``cfg.rows``, made a multiple of the special-row
    interval (interior rows then land on it) and capped so one launch's
    interior rows fit FLUSH_ROWS_BYTES."""
    if not special_every:
        return cfg.rows
    fit = max(FLUSH_ROWS_BYTES // (8 * nj), 1)
    return special_every * max(min(cfg.rows // special_every, fit), 1)


def run_partition(
    cfg: wf.StripConfig,
    seq0,
    seq1,
    params: ScoreParams = ScoreParams(),
    row_init: InitType = InitType.WITH_ZEROES,
    col_init: InitType = InitType.WITH_ZEROES,
    first_row: tuple[np.ndarray, np.ndarray] | None = None,
    first_col: tuple[np.ndarray, np.ndarray] | None = None,
    special_every: int = 0,
    on_special_row: Callable | None = None,
    stop_check: Callable | None = None,
    pad_rows: bool = False,
    want_last_row: bool = True,
) -> PartitionResult:
    """Align one partition.  ``seq0``/``seq1`` are uint8 tensors or numpy
    arrays (which stay on the CPU); the strips run where ``seq1`` lies.
    first_row=(H,F) and first_col=(H,E) are DP border vectors of length
    n+1 / m+1 when the init type is CUSTOM.

    ``on_special_row(dp_row, bus_h, bus_f)`` receives every row at a
    multiple of ``special_every`` below the last (int64 host arrays of
    length n, border excluded); without it the rows land in
    ``specials``.  ``stop_check(out, rows_done, strip_rows)`` sees each
    strip's ``StripOut`` (its best is strip-local) and may return True to
    stop.  ``pad_rows`` (score-only callers) drops the last-row output,
    as in masa_tpu; the tail strip still runs at its true height."""
    seq1 = _as_chars(seq1)
    seq0 = _as_chars(seq0).to(seq1.device)
    dev = seq1.device
    m, nj = seq0.numel(), seq1.numel()
    if nj < 1:
        raise ValueError("a partition needs at least one column")
    go, ge = params.gap_open, params.gap_ext
    sw = cfg.recurrence == Recurrence.SMITH_WATERMAN
    kw = dict(match=params.match, mismatch=params.mismatch, gap_open=go,
              gap_ext=ge, sw=sw, track_best=cfg.track_best,
              store_lastcol=cfg.store_lastcol, flush_every=special_every)
    R = strip_height(cfg, nj, special_every)

    row_h, row_f = _border_vec(row_init, params, nj + 1, 0, first_row)
    if row_init == InitType.CUSTOM:
        bus_h = torch.from_numpy(np.ascontiguousarray(row_h[1:])).to(dev)
        bus_f = torch.from_numpy(np.ascontiguousarray(row_f[1:])).to(dev)
    else:
        bus_h, bus_f = wf.init_bus(row_init, nj, go, ge, dev)

    best, best_i, best_j = -INF, 0, 0
    if cfg.track_best:
        # border cells are part of the matrix (the kernel tracks interior
        # cells only), for NW too (nw_best endpoint selection)
        best, best_j = int(row_h.max()), int(np.argmax(row_h))
        ch0, _ = _border_vec(col_init, params, m + 1, 0, first_col)
        if int(ch0.max()) > best:
            best, best_i, best_j = int(ch0.max()), int(np.argmax(ch0)), 0
    dev_best = torch.tensor([best, best_i, best_j], dtype=torch.int64,
                            device=dev)

    col_h = np.empty(m + 1, np.int64) if cfg.store_lastcol else None
    col_e = np.empty(m + 1, np.int64) if cfg.store_lastcol else None
    if cfg.store_lastcol:
        col_h[0] = row_h[nj]
        col_e[0] = -INF

    specials: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def emit_special(r, h, f):
        bh = h.cpu().numpy().astype(np.int64)
        bf = f.cpu().numpy().astype(np.int64)
        if on_special_row:
            on_special_row(r, bh, bf)
        else:
            specials[r] = (bh, bf)

    cells = 0
    i0 = 0
    while i0 < m:
        hs = min(R, m - i0)
        if col_init == InitType.CUSTOM:
            ich, ice = _border_vec(col_init, params, hs, i0 + 1, first_col)
            c_h = torch.from_numpy(np.ascontiguousarray(ich)).to(dev)
            c_e = torch.from_numpy(np.ascontiguousarray(ice)).to(dev)
        else:
            k = torch.arange(i0 + 1, i0 + 1 + hs, device=dev)
            c_h = wf.border_h(col_init, k, go, ge)
            c_e = torch.full((hs,), -INF, dtype=torch.int32, device=dev)
        corner = int(_border_vec(col_init, params, 1, i0, first_col)[0][0])

        out = wf.strip(seq0[i0:i0 + hs], seq1, bus_h, bus_f, c_h, c_e,
                       corner, **kw)
        if out.rows_h is not None:
            for q in range(out.rows_h.shape[0]):
                emit_special(i0 + (q + 1) * special_every, out.rows_h[q],
                             out.rows_f[q])
        bus_h, bus_f = out.bus_h, out.bus_f
        cells += hs * nj

        if cfg.track_best and stop_check is None:
            # fold on the device; the earlier strip wins ties
            s, bi, bj = out.best
            cand = torch.stack([s, i0 + bi + 1, bj + 1])
            dev_best = torch.where(s > dev_best[0], cand, dev_best)
        elif cfg.track_best:
            s, bi, bj = (int(v) for v in out.best.tolist())
            if s > best:
                best, best_i, best_j = s, i0 + bi + 1, bj + 1
        if cfg.store_lastcol:
            col_h[i0 + 1:i0 + 1 + hs] = out.lastcol_h.cpu().numpy()
            col_e[i0 + 1:i0 + 1 + hs] = out.lastcol_e.cpu().numpy()

        i0 += hs
        if special_every and i0 % special_every == 0 and i0 < m:
            emit_special(i0, bus_h, bus_f)
        if stop_check and stop_check(out, i0, hs):
            break

    if cfg.track_best and stop_check is None:
        best, best_i, best_j = (int(v) for v in dev_best.tolist())
    last_h = last_f = None
    if want_last_row and not pad_rows:
        last_h = np.empty(nj + 1, np.int64)
        last_f = np.empty(nj + 1, np.int64)
        last_h[0] = _border_vec(col_init, params, 1, i0, first_col)[0][0]
        last_f[0] = -INF
        last_h[1:] = bus_h.cpu().numpy()
        last_f[1:] = bus_f.cpu().numpy()
    return PartitionResult(last_h=last_h, last_f=last_f, best=best,
                           best_i=best_i, best_j=best_j, col_h=col_h,
                           col_e=col_e, specials=specials, cells=cells)
