"""Strip chaining: run a whole partition strip by strip, carrying the bus,
the borders, the best score and the special rows.

Counterpart of ``masa_tpu/ops/strips.py:run_partition`` with what the main
path uses: the strip loop with its bus carry, special rows at any cadence
(flushed inside the strip by the kernel), the best fold, the last row and
column, the goal stop, block pruning, the blocks sink, and the streamed
left border and last column of the column-split modes.  Strips run at
their true height, so ``pad_rows`` needs no sentinel rows here.

Block pruning (SW with best tracking, ``core/pruning``): before each strip
the bus's per-chunk maxima (``PRUNE_CHUNK`` columns a chunk, taken on the
device, so ng ints cross to the host) and the best so far give the
``[wl, wr)`` column window that can still beat the best.  The strip runs
on that window only, with -INF buses outside it; a window starting past
column 0 has a -INF left wall and corner; an empty window skips the strip
and leaves -INF buses.  The TPU's compile-key bucketing of window widths
is left out: the kernel takes any width.  On the card one launch covers a
whole stage-1 partition (``strip_height``), so the window between launches
alone would be decided once, before any best is known: there the kernel
also prunes inside the launch, each sub-strip with the same bound against
the best of the rows above it (``wavefront.LaunchPrune``, the best handed
over as a device tensor), and one read of its record a launch counts the
cells it skipped.  The CPU's 512-row strips keep masa_tpu's window between
strips alone, unless ``cfg.launch_prune`` asks the plain strips for the
in-launch rule.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from masa_tpu_torch.core import pruning
from masa_tpu_torch.models.scoring import border_cells
from masa_tpu_torch.types import INF, InitType, Recurrence, ScoreParams
from masa_tpu_torch.ops import kernels
from masa_tpu_torch.ops import wavefront as wf

# Device bytes the interior rows of one launch may hold (H and F, int32).
FLUSH_ROWS_BYTES = 1 << 30
# Columns per pruning chunk (and per --dump-blocks block): the window's
# granularity, a cost the host pays per strip (ng = nj / 512 maxima), and
# the grain of the kernel's decisions inside a launch.
PRUNE_CHUNK = wf.PRUNE_CHUNK
NEG = -INF


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
    pruned_cells: int = 0


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


def chunk_maxima(bus_h: torch.Tensor, ng: int) -> np.ndarray:
    """Per-chunk max of a bus padded with -INF to ng chunks, reduced where
    the bus lies; ng ints come back."""
    pad = torch.full((ng * PRUNE_CHUNK - bus_h.numel(),), NEG,
                     dtype=bus_h.dtype, device=bus_h.device)
    return (torch.cat([bus_h, pad]).view(ng, PRUNE_CHUNK).amax(1)
            .cpu().numpy().astype(np.int64))


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
    prune: bool = False,
    pad_rows: bool = False,
    blocks_sink: Callable | None = None,
    want_last_row: bool = True,
    first_col_reader=None,
    lastcol_writer=None,
    best_in: int | None = None,
) -> PartitionResult:
    """Align one partition.  ``seq0``/``seq1`` are uint8 tensors or numpy
    arrays (which stay on the CPU); the strips run where ``seq1`` lies.
    first_row=(H,F) and first_col=(H,E) are DP border vectors of length
    n+1 / m+1 when the init type is CUSTOM.

    ``on_special_row(dp_row, bus_h, bus_f)`` receives every row at a
    multiple of ``special_every`` below the last (int64 host arrays of
    length n, border excluded); without it the rows land in
    ``specials``.  ``stop_check(out, rows_done, strip_rows, col_off)``
    sees each strip's ``StripOut`` (its best is local to the strip and to
    its window starting at column ``col_off``) and may return True to
    stop.  ``prune`` enables block pruning (SW with best tracking, no last
    column): between strips, and inside each launch on a CUDA device (on
    the CPU with ``cfg.launch_prune``).  ``blocks_sink(rows_done,
    chunk_maxima)`` receives the bus's per-chunk maxima after every
    strip.  ``pad_rows`` (score-only callers)
    drops the last-row output, as in masa_tpu; the tail strip still runs
    at its true height.

    ``first_col_reader`` (``masa_tpu.io.cells`` reader) streams the left
    border of a column slab: each strip reads its rows' (H, E) from it, and
    its corner is the last H read before it (``row_h[0]`` for the first).
    Those border cells belong to the slab on the left, so they do not seed
    the best.  ``lastcol_writer`` receives each strip's last column as
    int32 (H, E); it needs ``cfg.store_lastcol``.  ``best_in``, a score
    reached above the partition (a resumed stage 1's best), is the least
    best the pruning inside a launch starts from."""
    seq1 = _as_chars(seq1)
    seq0 = _as_chars(seq0).to(seq1.device)
    dev = seq1.device
    m, nj = seq0.numel(), seq1.numel()
    if nj < 1:
        raise ValueError("a partition needs at least one column")
    if first_col_reader is not None and pad_rows:
        raise ValueError("streamed borders need exact strip heights")
    if lastcol_writer is not None and not cfg.store_lastcol:
        raise ValueError("lastcol_writer needs cfg.store_lastcol")
    go, ge = params.gap_open, params.gap_ext
    sw = cfg.recurrence == Recurrence.SMITH_WATERMAN
    prune = prune and cfg.track_best and sw and not cfg.store_lastcol
    in_launch = prune and (dev.type == "cuda" or cfg.launch_prune is not None)
    ng = -(-nj // PRUNE_CHUNK)
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
        if first_col_reader is None:
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

    def neg(*shape):
        return torch.full(shape, NEG, dtype=torch.int32, device=dev)

    def host_col(ich, ice):
        return (torch.from_numpy(np.ascontiguousarray(ich, np.int32)).to(dev),
                torch.from_numpy(np.ascontiguousarray(ice, np.int32)).to(dev))

    cells = pruned_cells = 0
    stream_corner = int(row_h[0])  # H(i0, 0) carried between border reads
    i0 = 0
    while i0 < m:
        hs = min(R, m - i0)
        n_int = (hs - 1) // special_every if special_every else 0
        if first_col_reader is not None:
            ich, ice = first_col_reader.read(hs)
            c_h, c_e = host_col(ich, ice)
            corner, stream_corner = stream_corner, int(ich[-1])
        elif col_init == InitType.CUSTOM:
            c_h, c_e = host_col(*_border_vec(col_init, params, hs, i0 + 1,
                                             first_col))
        else:
            k = torch.arange(i0 + 1, i0 + 1 + hs, device=dev)
            c_h = wf.border_h(col_init, k, go, ge)
            c_e = neg(hs)
        if first_col_reader is None:
            corner = int(_border_vec(col_init, params, 1, i0,
                                     first_col)[0][0])

        wl, wr = 0, nj  # the strip's column window
        if prune:
            if stop_check is None and not in_launch:
                best = int(dev_best[0])
            cl, cr = pruning.pruning_window(
                chunk_maxima(bus_h, ng), best, i0, m, nj, PRUNE_CHUNK,
                params, border_max=int(c_h.max()))
            wl, wr = cl * PRUNE_CHUNK, min(cr * PRUNE_CHUNK, nj)
        out = None
        if wl >= wr:
            # the whole strip is pruned: -INF buses, interior rows too
            pruned_cells += hs * nj
            bus_h, bus_f = neg(nj), neg(nj)
            rows_h = rows_f = neg(n_int, nj) if n_int else None
        else:
            if wl > 0:
                # -INF wall at the window's left edge (clearPrunedBlocks)
                c_h, c_e, corner = neg(hs), neg(hs), NEG
            args = (seq0[i0:i0 + hs], seq1[wl:wr], bus_h[wl:wr],
                    bus_f[wl:wr], c_h, c_e, corner)
            if in_launch:  # the best above the launch stays on the device
                b_in = (dev_best[:1] if stop_check is None
                        else torch.tensor([best], device=dev))
                if best_in is not None:
                    b_in = b_in.clamp(min=best_in)
                lp = wf.LaunchPrune(m, nj, i0, wl, b_in)
                out = wf.strip_out(*(
                    kernels.strip_cuda(*args, **kw, prune=lp)
                    if dev.type == "cuda" else
                    wf.strip_plain_pruned(*args, lp, cfg.launch_prune, **kw)))
            else:
                out = wf.strip(*args, **kw)
            cells += hs * (wr - wl)
            pruned_cells += hs * (nj - (wr - wl))
            rows_h, rows_f = out.rows_h, out.rows_f
            if wr - wl == nj:
                bus_h, bus_f = out.bus_h, out.bus_f
            else:
                bus_h, bus_f = neg(nj), neg(nj)
                bus_h[wl:wr], bus_f[wl:wr] = out.bus_h, out.bus_f
                if rows_h is not None:
                    rows_h, rows_f = neg(n_int, nj), neg(n_int, nj)
                    rows_h[:, wl:wr] = out.rows_h
                    rows_f[:, wl:wr] = out.rows_f
        if rows_h is not None:
            for q in range(rows_h.shape[0]):
                emit_special(i0 + (q + 1) * special_every, rows_h[q],
                             rows_f[q])

        if out is not None and cfg.track_best and stop_check is None:
            # fold on the device; the earlier strip wins ties
            s, bi, bj = out.best
            cand = torch.stack([s, i0 + bi + 1, wl + bj + 1])
            dev_best = torch.where(s > dev_best[0], cand, dev_best)
        elif out is not None and cfg.track_best:
            s, bi, bj = (int(v) for v in out.best.tolist())
            if s > best:
                best, best_i, best_j = s, i0 + bi + 1, wl + bj + 1
        if out is not None and out.prune is not None:
            # one read a launch: the first columns each sub-strip kept, and
            # the best so far for the next launch's window
            got = torch.cat([out.prune.record[:, 0].long(),
                             dev_best[:1]]).cpu().numpy()
            if stop_check is None:
                best = int(got[-1])
            skipped = out.prune.pruned_cells(hs, got[:-1])
            cells -= skipped
            pruned_cells += skipped
        if cfg.store_lastcol:
            lch = out.lastcol_h.cpu().numpy()
            lce = out.lastcol_e.cpu().numpy()
            col_h[i0 + 1:i0 + 1 + hs] = lch
            col_e[i0 + 1:i0 + 1 + hs] = lce
            if lastcol_writer is not None:
                lastcol_writer.write(lch, lce)

        i0 += hs
        if blocks_sink is not None:
            blocks_sink(i0, chunk_maxima(bus_h, ng))
        if special_every and i0 % special_every == 0 and i0 < m:
            emit_special(i0, bus_h, bus_f)
        if stop_check and out is not None and stop_check(out, i0, hs, wl):
            break

    if cfg.track_best and stop_check is None:
        best, best_i, best_j = (int(v) for v in dev_best.tolist())
    last_h = last_f = None
    if want_last_row and not pad_rows:
        last_h = np.empty(nj + 1, np.int64)
        last_f = np.empty(nj + 1, np.int64)
        last_h[0] = (stream_corner if first_col_reader is not None else
                     _border_vec(col_init, params, 1, i0, first_col)[0][0])
        last_f[0] = -INF
        last_h[1:] = bus_h.cpu().numpy()
        last_f[1:] = bus_f.cpu().numpy()
    return PartitionResult(last_h=last_h, last_f=last_f, best=best,
                           best_i=best_i, best_j=best_j, col_h=col_h,
                           col_e=col_e, specials=specials, cells=cells,
                           pruned_cells=pruned_cells)
