"""The strip contract in logical coordinates, its plain PyTorch version,
and the dispatcher to the Hopper kernel.

Counterpart of ``masa_tpu/ops/wavefront.py``.  A strip is ``h`` rows by
``nj`` columns of the Gotoh affine-gap DP (SW or NW), with the index
conventions of the TPU kernel:

  kernel column ``j`` in [0, nj)  <->  DP column ``j+1`` (consumes b[j])
  kernel row    ``i`` in [0, h)   <->  DP row ``i0+i+1`` (consumes a[i])
  ``bus_h/bus_f[j]`` = DP (H, F) at (i0, j+1); the corner (i0, 0) is
                       ``corner``
  ``col_h/col_e[i]`` = DP (H, E) of the left border at row i0+i+1

and its outputs: the last row's bus, the best ``(score, i, j)`` with ties
to the smallest i and then the smallest j, the last column's H/E, and the
H/F of the interior rows ``i`` with ``(i+1) % flush_every == 0``.  The TPU
layout (lanes, the physical bus offset, padded widths) is not part of it:
heights, widths and the flush cadence are runtime values.

Block pruning inside a launch (``prune``, a ``LaunchPrune``; SW with the
best tracked and no last column): the strip is cut into sub-strips of
``rows`` rows, as the kernel cuts it, and sub-strip g skips the prefix of
its ``PRUNE_CHUNK``-column chunks that the host's bound
(``core/pruning.pruning_window``) says cannot beat
``B_g = max(best_in, the best of sub-strips 0 .. g - blocks)``, where
``blocks`` is the launch's grid: skipped columns are -INF in the bus and
the flushed rows and take no part in the best, and the first kept column
has a -INF left wall and corner.  The outputs then carry a ``PruneRecord``:
per sub-strip the first column kept and ``B_g``.

``strip`` runs the plain version for CPU tensors and the kernel for CUDA
tensors.  ``strip_plain`` is a row sweep (one cumulative max per row, the
algorithm of ``masa_tpu/ops/rowsweep.sweep``), so it shares nothing with
the kernel's anti-diagonal order and serves as its independent check.
``ops/rowsweep`` gives the row sweeps the reference's entry names; it
calls ``strip_plain`` and ``batched_sweep_plain`` and keeps no sweep of
its own.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from masa_tpu_torch.types import CrosspointType, INF, InitType, Recurrence
from masa_tpu_torch.ops import kernels
from masa_tpu_torch.utils import trace

NEG = -INF
# Columns per pruning chunk: the grain of the host's window between strips
# and of the decisions inside a launch (csrc/strip.cu PCHUNK).
PRUNE_CHUNK = 512


@dataclasses.dataclass(frozen=True)
class StripConfig:
    """What a partition's strips are run with.

    ``rows`` is the strip height: the rows one kernel launch covers (the
    kernel spreads them over the card).  ``launch_prune`` = (rows a
    sub-strip, blocks) asks the plain strips (CPU tensors) for the
    in-launch pruning rule at that geometry; on a CUDA device the kernel
    prunes inside every pruning launch at its own geometry.  The rest
    mirrors the scoring fields of
    ``masa_tpu.ops.wavefront.WavefrontConfig``."""

    rows: int = 512
    recurrence: Recurrence = Recurrence.SMITH_WATERMAN
    match: int = 1
    mismatch: int = -3
    gap_open: int = 3
    gap_ext: int = 2
    track_best: bool = True
    store_lastcol: bool = False
    launch_prune: tuple[int, int] | None = None


class LaunchPrune(NamedTuple):
    """What the in-launch pruning rule needs besides the strip: the
    partition's rows ``m`` and columns ``n``, its rows ``i0`` above the
    launch, the partition column ``col_off`` of the launch's column 0, and
    ``best_in``, a tensor on the strip's device whose first element is the
    best score above the launch (no host read on the card)."""

    m: int
    n: int
    i0: int
    col_off: int
    best_in: torch.Tensor


class PruneRecord(NamedTuple):
    """What a pruning launch decided: ``record`` (n_sub, 2) int32, per
    sub-strip the first column kept (``nj`` when all were skipped) and
    ``B_g``; the geometry it was decided at, ``rows`` a sub-strip and
    ``blocks`` (the grid)."""

    record: torch.Tensor
    rows: int
    blocks: int

    def pruned_cells(self, h: int, first=None) -> int:
        """Cells a launch of ``h`` rows skipped, from the record's first
        columns kept (``first``: already read to the host)."""
        if first is None:
            first = self.record[:, 0].cpu().numpy()
        heights = np.full(len(first), self.rows, np.int64)
        heights[-1] = h - self.rows * (len(first) - 1)
        return int((np.asarray(first, np.int64) * heights).sum())


@dataclasses.dataclass
class StripOut:
    bus_h: torch.Tensor                  # (nj,) int32, the last row's H
    bus_f: torch.Tensor                  # (nj,) int32, the last row's F
    best: torch.Tensor | None = None     # (3,) int64 (score, i, j), local
    lastcol_h: torch.Tensor | None = None  # (h,) int32
    lastcol_e: torch.Tensor | None = None
    rows_h: torch.Tensor | None = None   # (n_int, nj) int32
    rows_f: torch.Tensor | None = None
    prune: PruneRecord | None = None     # a pruning launch's decisions
    best_v: torch.Tensor | None = None   # (h,) per-row captures: value,
    best_j: torch.Tensor | None = None   # and the first j reaching it


def merge_best(best_v: torch.Tensor, best_j: torch.Tensor) -> torch.Tensor:
    """Reduce per-row captures (value, first j reaching it) to (score, i,
    j): the largest value, the smallest row among those, and that row's
    j.  Runs on the tensors' device with no host transfer: the row is
    gathered by a 1-element index, since indexing by a 0-dim tensor reads
    the index back to the host (a sync after every launch)."""
    score = best_v.max()
    rows = torch.arange(best_v.numel(), device=best_v.device)
    i = torch.where(best_v == score, rows, best_v.numel()).min()
    j = best_j.gather(0, i.view(1)).squeeze(0)
    return torch.stack([score.long(), i, j.long()])


def strip_out(bus_h, bus_f, best_v, best_j, last_h, last_e, rows_h,
              rows_f, prune=None) -> StripOut:
    """A StripOut from raw outputs (per-row best captures merged)."""
    best = merge_best(best_v, best_j) if best_v is not None else None
    return StripOut(bus_h, bus_f, best, last_h, last_e, rows_h, rows_f,
                    prune, best_v, best_j)


def _rows(a, b, hp, fp, ch, ce, up_left, *, match: int, mismatch: int,
          gap_open: int, gap_ext: int, sw: bool):
    """The row sweep of ``strip_plain``: each row's (H, E, F), int64, from
    the row above ``hp``/``fp`` (int64), the left border's H and E as lists
    ``ch``/``ce`` (one value a row) and the corner ``up_left``."""
    nj = b.numel()
    dev = b.device
    go, ge = gap_open, gap_ext
    jge = torch.arange(1, nj, device=dev, dtype=torch.int64) * ge
    ramp = torch.arange(1, nj + 1, device=dev, dtype=torch.int64) * ge
    for i in range(len(ch)):
        f = torch.maximum(hp - go, fp) - ge
        diag = torch.empty_like(hp)
        diag[0] = up_left
        diag[1:] = hp[:-1]
        d = torch.maximum(diag + torch.where(b == a[i], match, mismatch), f)
        if sw:
            d.clamp_(min=0)
        y = torch.empty_like(d)
        y[0] = max(ch[i] - go, ce[i])
        y[1:] = d[:-1] - go + jge
        e = torch.cummax(y, 0).values - ramp
        hc = torch.maximum(d, e)
        yield hc, e, f
        hp, fp, up_left = hc, f, ch[i]


def strip_plain(a, b, bus_h, bus_f, col_h, col_e, corner: int, *,
                match: int, mismatch: int, gap_open: int, gap_ext: int,
                sw: bool, track_best: bool = False,
                store_lastcol: bool = False,
                flush_every: int = 0) -> StripOut:
    """One strip as a row sweep on any device.  Per row:

        F_j  = max(H_up_j - go, F_up_j) - ge
        D_j  = max(H_up_{j-1} + sub_j, F_j)          [max 0 for SW]
        E_j  = max_{k<j}(D_k - go - (j-k) ge, border terms)
             = cummax(Y)_j - (j+1) ge
        H_j  = max(D_j, E_j)

    One cumulative max is exact: a horizontal gap reopened from a cell
    whose H came from E is dominated by extending that gap."""
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_ext=gap_ext, sw=sw)
    h = a.numel()
    dev = b.device
    i64 = torch.int64
    hp, fp = bus_h.to(i64), bus_f.to(i64)
    best_v = torch.empty(h, dtype=i64, device=dev) if track_best else None
    best_j = torch.empty(h, dtype=i64, device=dev) if track_best else None
    last_h = torch.empty(h, dtype=i64, device=dev) if store_lastcol else None
    last_e = torch.empty(h, dtype=i64, device=dev) if store_lastcol else None
    rows_h, rows_f = [], []
    for i, (hc, e, f) in enumerate(_rows(a, b, hp, fp, col_h.tolist(),
                                         col_e.tolist(), int(corner), **kw)):
        if track_best:
            k = torch.argmax(hc)  # first occurrence of the row's max
            best_v[i] = hc[k]
            best_j[i] = k
        if store_lastcol:
            last_h[i] = hc[-1]
            last_e[i] = e[-1]
        if flush_every and (i + 1) % flush_every == 0 and i < h - 1:
            rows_h.append(hc)
            rows_f.append(f)
        hp, fp = hc, f

    def i32(x):
        return None if x is None else x.to(torch.int32)

    rh = torch.stack(rows_h).to(torch.int32) if rows_h else None
    rf = torch.stack(rows_f).to(torch.int32) if rows_f else None
    return strip_out(i32(hp), i32(fp), best_v, best_j, i32(last_h),
                     i32(last_e), rh, rf)


def strip_plain_pruned(a, b, bus_h, bus_f, col_h, col_e, corner: int,
                       prune: LaunchPrune, geometry: tuple[int, int], *,
                       match: int, mismatch: int, gap_open: int,
                       gap_ext: int, sw: bool = True, track_best: bool = True,
                       store_lastcol: bool = False, flush_every: int = 0):
    """``strip_plain`` with the in-launch pruning rule, sub-strip by
    sub-strip, at ``geometry`` = (rows a sub-strip, blocks).  Returns the
    raw outputs of ``kernels.strip_cuda(..., prune=...)``: ``(bus_h,
    bus_f, best_v, best_j, None, None, rows_h, rows_f, PruneRecord)``, the
    per-row bests int64.  ``csrc/strip.cu`` decides the same way, with the
    same numbers (``prune_start`` there)."""
    if not (sw and track_best) or store_lastcol:
        raise ValueError("pruning inside a launch needs SW, the best "
                         "tracked and no last column")
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_ext=gap_ext, sw=sw)
    corner = int(corner)
    rows, blocks = geometry
    h, nj = a.numel(), b.numel()
    dev = b.device
    i64 = torch.int64
    C = PRUNE_CHUNK
    ng = -(-nj // C)
    n_int = (h - 1) // flush_every if flush_every else 0
    ch, ce = col_h.tolist(), col_e.tolist()
    b_in = int(prune.best_in.reshape(-1)[0])
    hp, fp = bus_h.to(i64), bus_f.to(i64)
    best_v = torch.full((h,), NEG, dtype=i64, device=dev)
    best_j = torch.zeros(h, dtype=i64, device=dev)
    rows_h = torch.full((n_int, nj), NEG, dtype=i64, device=dev)
    rows_f = torch.full((n_int, nj), NEG, dtype=i64, device=dev)
    pad = torch.full((ng * C - nj,), NEG, dtype=i64, device=dev)
    record, prefix = [], []  # prefix[g]: the best of sub-strips 0..g
    for g, top in enumerate(range(0, h, rows)):
        hs = min(rows, h - top)
        bg = max(b_in, prefix[g - blocks]) if g >= blocks else b_in
        up_left = corner if g == 0 else ch[top - 1]
        vinit = max([up_left] + ch[top:top + hs])
        maxima = torch.cat([hp, pad]).view(ng, C).amax(1).tolist()
        rows_left = prune.m - prune.i0 - top
        lo, v = nj, vinit
        for k in range(ng):
            v = max(maxima[k], vinit if k == 0 else v + C * match)
            gain = min(rows_left, prune.n - prune.col_off - k * C) * match
            if max(v, 0) + gain > bg:
                lo = k * C
                break
        record.append((lo, bg))
        out_h = torch.full((nj,), NEG, dtype=i64, device=dev)
        out_f = torch.full((nj,), NEG, dtype=i64, device=dev)
        if lo < nj:
            # a -INF wall and corner left of the first column kept
            wall = [NEG] * hs
            left = ((ch[top:top + hs], ce[top:top + hs], up_left) if lo == 0
                    else (wall, wall, NEG))
            for r, (hc, _, f) in enumerate(_rows(a[top:top + hs], b[lo:],
                                                 hp[lo:], fp[lo:], *left,
                                                 **kw)):
                i = top + r
                k = torch.argmax(hc)
                best_v[i] = hc[k]
                best_j[i] = lo + k
                if flush_every and (i + 1) % flush_every == 0 and i < h - 1:
                    q = (i + 1) // flush_every - 1
                    rows_h[q, lo:] = hc
                    rows_f[q, lo:] = f
            out_h[lo:], out_f[lo:] = hc, f
        hp, fp = out_h, out_f
        sub = int(best_v[top:top + hs].max())
        prefix.append(max(prefix[-1], sub) if prefix else sub)
    rec = PruneRecord(torch.tensor(record, dtype=torch.int32, device=dev),
                      rows, blocks)
    i32 = torch.int32
    return (hp.to(i32), fp.to(i32), best_v, best_j, None, None,
            rows_h.to(i32) if n_int else None,
            rows_f.to(i32) if n_int else None, rec)


def strip(a, b, bus_h, bus_f, col_h, col_e, corner: int, *, match: int,
          mismatch: int, gap_open: int, gap_ext: int, sw: bool,
          track_best: bool = False, store_lastcol: bool = False,
          flush_every: int = 0, flags: list | None = None) -> StripOut:
    """One strip: the plain version for CPU tensors, the Hopper kernel for
    CUDA tensors (which raises if it cannot build or launch).  ``flags``:
    see ``kernels.strip_cuda`` (the plain version has no error flag)."""
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_ext=gap_ext, sw=sw, track_best=track_best,
              store_lastcol=store_lastcol, flush_every=flush_every)
    if b.device.type == "cpu":
        return strip_plain(a, b, bus_h, bus_f, col_h, col_e, corner, **kw)
    if b.device.type == "cuda":
        return strip_out(*kernels.strip_cuda(a, b, bus_h, bus_f, col_h,
                                             col_e, corner, flags=flags,
                                             **kw))
    raise ValueError(f"no strip implementation for device {b.device}")


def border_h(code: int, k: torch.Tensor, gap_open: int,
             gap_ext: int) -> torch.Tensor:
    """Border H at positions ``k`` (``models.scoring.border_cells``
    semantics; port of ``border_h_traced``): WITH_ZEROES 0, WITH_GAPS 0 at
    k = 0 and -open - k*ext after, WITH_GAPS_OPENED -k*ext."""
    if code not in (InitType.WITH_ZEROES, InitType.WITH_GAPS,
                    InitType.WITH_GAPS_OPENED):
        raise ValueError(f"cannot synthesize a border for {code!r}")
    k = k.to(torch.int32)
    return border_h_codes(torch.full_like(k, int(code)), k, gap_open,
                          gap_ext).to(torch.int32)


def init_bus(code: int, nj: int, gap_open: int, gap_ext: int,
             device) -> tuple[torch.Tensor, torch.Tensor]:
    """The first row's (H, F) bus for DP columns 1..nj, made on the device
    (port of ``init_bus_synth``)."""
    j = torch.arange(1, nj + 1, device=device, dtype=torch.int32)
    return (border_h(code, j, gap_open, gap_ext),
            torch.full((nj,), NEG, dtype=torch.int32, device=device))


def border_h_codes(codes: torch.Tensor, k: torch.Tensor, gap_open: int,
                   gap_ext: int) -> torch.Tensor:
    """``border_h`` with a border code per element: ``codes`` (B,) int64
    against positions ``k`` broadcastable to (B, ...)."""
    while codes.dim() < k.dim():
        codes = codes.unsqueeze(-1)
    gaps = torch.where(k == 0, 0, -gap_open - k * gap_ext)
    return torch.where(codes == InitType.WITH_ZEROES, torch.zeros_like(k),
                       torch.where(codes == InitType.WITH_GAPS, gaps,
                                   -k * gap_ext))


def batched_sweep_plain(a, b, i0, j0, r0, col_code, bus_h, bus_f, rows, *,
                        sw: bool, match: int, mismatch: int, gap_open: int,
                        gap_ext: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Many score-only strips as one row sweep over a (B, width) batch, on
    any device (the algorithm of ``masa_tpu/ops/rowsweep.
    batched_sweep_engine``; ``ops/rowsweep`` and ``batched_strip_plain``
    both call it).  Element e covers the columns ``[j0, j0 + width)`` of
    ``b`` from the row bus ``bus_h``/``bus_f`` (B, width) and advances
    ``rows[e]`` rows of ``a`` from row ``i0 + r0`` on; its left border is
    synthesized from ``col_code`` at border positions ``r0``, ``r0 + 1``,
    ...  Each step advances every element at once; an element stops
    changing after its own rows.  Characters past a sequence's end are
    clamped.  Returns the (H, F) bus after those rows, int32."""
    dev = a.device
    i64 = torch.int64
    go, ge = gap_open, gap_ext
    i0, j0, r0, cc, rows = (torch.as_tensor(x, dtype=i64).to(dev)
                            for x in (i0, j0, r0, col_code, rows))
    hp, fp = bus_h.to(i64), bus_f.to(i64)
    width = hp.shape[1]
    cols = torch.arange(width, device=dev, dtype=i64)
    bch = b[(j0[:, None] + cols).clamp(max=b.numel() - 1)]
    jge = cols[1:] * ge
    ramp = (cols + 1) * ge
    for r in range(int(rows.max()) if len(rows) else 0):
        act = (r < rows)[:, None]
        ach = a[(i0 + r0 + r).clamp(max=a.numel() - 1)]
        up_left = border_h_codes(cc, r0 + r, go, ge)  # H(row above, border)
        left = border_h_codes(cc, r0 + r + 1, go, ge)  # this row's border H
        f = torch.maximum(hp - go, fp) - ge
        diag = torch.cat([up_left[:, None], hp[:, :-1]], 1)
        d = torch.maximum(
            diag + torch.where(bch == ach[:, None], match, mismatch), f)
        if sw:
            d.clamp_(min=0)
        y = torch.cat([(left - go).clamp(min=NEG)[:, None],
                       d[:, :-1] - go + jge], 1)
        e = torch.cummax(y, 1).values - ramp
        hp = torch.where(act, torch.maximum(d, e), hp)
        fp = torch.where(act, f, fp)
    return hp.to(torch.int32), fp.to(torch.int32)


def batched_strip_plain(a, b, elems, width: int, *, match: int,
                        mismatch: int, gap_open: int,
                        gap_ext: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Many score-only NW strips as one row sweep over a (B, width) batch
    (``batched_sweep_plain`` from each element's synthesized first row):
    the contract of ``kernels.batched_strip_cuda`` on any device.  Columns
    past an element's ``w`` see clamped characters (nothing flows
    leftward) and end as -INF."""
    dev = a.device
    el = torch.as_tensor(elems, dtype=torch.int64).to(dev)
    i0, h, j0, w, rc, cc = el.unbind(1)
    cols = torch.arange(width, device=dev, dtype=torch.int64)
    hp = border_h_codes(rc, (cols + 1).expand(len(el), -1), gap_open,
                        gap_ext)
    hp, fp = batched_sweep_plain(
        a, b, i0, j0, torch.zeros_like(i0), cc, hp, torch.full_like(hp, NEG),
        h, sw=False, match=match, mismatch=mismatch, gap_open=gap_open,
        gap_ext=gap_ext)
    keep = cols < w[:, None]
    neg = torch.tensor(NEG, dtype=torch.int32, device=dev)
    return torch.where(keep, hp, neg), torch.where(keep, fp, neg)


def batched_strip(a, b, elems, width: int, *, match: int, mismatch: int,
                  gap_open: int, gap_ext: int):
    """Many score-only NW strips: the plain version for CPU tensors, the
    Hopper batched kernel for CUDA tensors (which raises if it cannot
    build or launch)."""
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_ext=gap_ext)
    if a.device.type == "cpu":
        return batched_strip_plain(a, b, elems, width, **kw)
    if a.device.type == "cuda":
        return kernels.batched_strip_cuda(a, b, elems, width, **kw)
    raise ValueError(f"no batched strip implementation for device "
                     f"{a.device}")


def batched_strip_fixed_plain(a, b, col_h, col_e, bus_h, bus_f, corners, *,
                              match: int, mismatch: int, gap_open: int,
                              gap_ext: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """B equal-shape score-only NW strips as one row sweep over the batch:
    ``batched_strip_plain``'s sweep with every border given, not
    synthesized.  ``a`` (B, h) and ``b`` (B, nj) are the characters; per
    element the left border ``col_h``/``col_e`` (B, h) is DP (H, E) at rows
    1..h of the border column, ``bus_h``/``bus_f`` (B, nj) the row above
    and ``corners`` (B,) its border cell.  Returns the last row's (H, F),
    (B, nj) int32 (the contract of ``kernels.batched_strip_fixed_cuda``)."""
    i64 = torch.int64
    go, ge = gap_open, gap_ext
    nj = b.shape[1]
    cols = torch.arange(nj, device=b.device, dtype=i64)
    jge = cols[1:] * ge
    ramp = (cols + 1) * ge
    ch, ce = col_h.to(i64), col_e.to(i64)
    hp, fp = bus_h.to(i64), bus_f.to(i64)
    up_left = corners.to(i64)  # H(row above, border column)
    for r in range(a.shape[1]):
        f = torch.maximum(hp - go, fp) - ge
        diag = torch.cat([up_left[:, None], hp[:, :-1]], 1)
        d = torch.maximum(
            diag + torch.where(b == a[:, r:r + 1], match, mismatch), f)
        y = torch.cat([torch.maximum(ch[:, r] - go, ce[:, r])[:, None],
                       d[:, :-1] - go + jge], 1)
        e = torch.cummax(y, 1).values - ramp
        hp, fp, up_left = torch.maximum(d, e), f, ch[:, r]
    return hp.to(torch.int32), fp.to(torch.int32)


def batched_strip_fixed(a, b, col_h, col_e, bus_h, bus_f, corners, *,
                        match: int, mismatch: int, gap_open: int,
                        gap_ext: int) -> tuple[torch.Tensor, torch.Tensor]:
    """B equal-shape score-only NW strips with given borders (the port of
    ``masa_tpu.ops.wavefront.batched_strip_pallas``, in logical column
    order): the plain version for CPU tensors, the Hopper kernel for CUDA
    tensors (which raises if it cannot build or launch)."""
    args = (a, b, col_h, col_e, bus_h, bus_f, corners)
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_ext=gap_ext)
    if b.device.type == "cpu":
        return batched_strip_fixed_plain(*args, **kw)
    if b.device.type == "cuda":
        return kernels.batched_strip_fixed_cuda(*args, **kw)
    raise ValueError(f"no batched strip implementation for device "
                     f"{b.device}")


def decode_packed_row(u, mark, exact, nj: int):
    """The host inverse of masa_tpu's packed special-row form (the port of
    ``masa_tpu.ops.wavefront.decode_packed_row``): ``u`` holds two signed
    4-bit deltas per byte (low nibble first), ``mark``/``exact`` the
    escape positions and their absolute values.  Returns the (nj,) int64
    row."""
    u = np.asarray(u, np.uint8)
    nib = np.empty(2 * len(u), np.int64)
    nib[0::2] = u & 0xF
    nib[1::2] = u >> 4
    nib[nib > 7] -= 16
    out = np.cumsum(nib[:nj])
    if len(mark):
        # each escape resets the running value to its exact one
        corr = np.asarray(exact, np.int64) - out[mark]
        add = np.zeros(nj, np.int64)
        add[mark] = np.diff(np.concatenate([[0], corr]))
        out += np.cumsum(add)
    return out


def goal_match_device(cut_h, cut_f, rev_h, rev_f, cj: int, goal: int,
                      rev0h: int, rev0f: int, W1: int, go: int
                      ) -> torch.Tensor:
    """``models.scoring.match_column`` where the rows lie: a stored
    stage-1 cut against the reverse pass's last-row bus, neither pulled to
    the host (the port of ``masa_tpu.ops.wavefront.goal_match_device``,
    there XLA outside any Pallas kernel, here plain tensor operations).

    ``cut_h``/``cut_f``: the stored cut as a bus, index j-1 -> column j
    (a whole row from the row cache, or a window whose element 0 is bus
    index ``cj - W1``).  ``rev_h``/``rev_f``: the reverse pass's last-row
    bus, index k-1 -> reverse column k; ``rev0h``/``rev0f`` its border
    element.  Match index k in [0, W1) is column cj - k and needs
    j_low = cj - (W1 - 1) >= 1 (the column-0 border is matched on the
    host).  Sums are taken in int64, as ``match_column`` takes them.

    Returns an int32 tensor (status, k, score) on the rows' device:
    status 0 aligned, 1 gapped, 2 error-sum match, 3 error-sum gap, 4 no
    stop; k the first stopping index (-1 for 4); score the stored value
    at a hit (0 otherwise)."""
    lo = cj - W1
    if lo < 0 or cj > cut_h.numel() or W1 - 1 > rev_h.numel():
        raise ValueError(f"match window [{lo}, {cj}) outside the cut of "
                         f"{cut_h.numel()} or the reverse row of "
                         f"{rev_h.numel()}")
    dev = cut_h.device
    fwd_h = cut_h[lo:cj].flip(0).long()
    fwd_f = cut_f[lo:cj].flip(0).long()
    head = torch.tensor([[rev0h], [rev0f]], dtype=torch.int64, device=dev)
    rh = torch.cat([head[0], rev_h[:W1 - 1].long()])
    rf = torch.cat([head[1], rev_f[:W1 - 1].long()])
    sum_m = fwd_h + rh
    sum_g = fwd_f + rf + go
    stop = (sum_m >= goal) | (sum_g >= goal)
    k = torch.arange(W1, device=dev)
    idx = torch.where(stop, k, W1).min()
    at = idx.clamp(max=W1 - 1)
    m_at = sum_m[at] == goal
    hit = (idx < W1) & (m_at | (sum_g[at] == goal))
    status = torch.where(
        idx >= W1, 4, torch.where(hit, torch.where(m_at, 0, 1),
                                  torch.where(sum_m[at] > goal, 2, 3)))
    score = torch.where(hit, torch.where(m_at, fwd_h[at], fwd_f[at]), 0)
    return torch.stack([status, torch.where(idx >= W1, -1, at),
                        score]).int()


# ---------------------------------------------------------------------------
# The device sequence cache (the port of masa_tpu's dev_seq family)
# ---------------------------------------------------------------------------
#
# Key: (host pointer, length, reversed, pad, device) and a sampled
# fingerprint of the host array, as masa_tpu keys its views, with the
# array's dtype and strides (two views of one buffer may share a pointer
# and a length).  An entry also
# holds the host array, so no other array can take its address while the
# entry lives.  The views are uint8, as the kernels take them; masa_tpu
# pads its int32 views with a sentinel so that any fixed-size slice stays
# in bounds, which the port's kernels, taking exact-length views, do not
# need: its callers ask for no pad, and a pad (PAD_CHAR bytes) serves only
# the rule that a larger-pad entry serves a smaller-pad request.

_DEV_SEQ_CACHE: "collections.OrderedDict | None" = None
DEV_SEQ_ENTRIES = 10         # the LRU's bound in entries
DEV_SEQ_BYTES = 2 << 30      # and in bytes
PAD_CHAR = 0xFF              # a pad byte: no encoded base has it
# What the cache did since the counts were last set to 0: sequences copied
# from the host, and views made by a flip of a cached twin on the device.
dev_seq_counts = {"uploads": 0, "flips": 0}


def _device_of(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _dev_seq_key(arr: np.ndarray, reverse: bool, pad: int, dev) -> tuple:
    a = np.asarray(arr)
    n = len(a)
    step = max(n // 16, 1)
    fp = bytes(a[::step][:32].tobytes())
    return (a.__array_interface__["data"][0], n, reverse, pad, str(dev),
            a.dtype.str, a.strides, fp)


def _dev_seq_find(a: np.ndarray, reverse: bool, min_pad: int, dev):
    """A cached entry for this array, direction and device whose pad is at
    least ``min_pad`` (a larger pad serves).  Returns (key, view) or
    (None, None)."""
    if _DEV_SEQ_CACHE is None:
        return None, None
    probe = _dev_seq_key(a, reverse, 0, dev)
    for key, (view, _) in _DEV_SEQ_CACHE.items():
        if key[:3] == probe[:3] and key[4:] == probe[4:] \
                and key[3] >= min_pad:
            return key, view
    return None, None


def _padded(body: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return body
    return torch.cat([body, torch.full((pad,), PAD_CHAR, dtype=torch.uint8,
                                       device=body.device)])


def _flipped(twin: torch.Tensor, n: int, pad: int) -> torch.Tensor:
    dev_seq_counts["flips"] += 1
    return _padded(twin[:n].flip(0), pad)


def _dev_seq_put(key, view, host) -> None:
    _DEV_SEQ_CACHE[key] = (view, host)
    while len(_DEV_SEQ_CACHE) > DEV_SEQ_ENTRIES or sum(
            v.numel() for v, _ in _DEV_SEQ_CACHE.values()) > DEV_SEQ_BYTES:
        _DEV_SEQ_CACHE.popitem(last=False)


def dev_seq(arr: np.ndarray, device, pad: int = 0,
            reverse: bool = False) -> torch.Tensor:
    """A uint8 view of ``arr`` (reversed if asked) on ``device``, copied
    there once and cached (the port of ``masa_tpu.ops.wavefront.dev_seq``,
    masa_tpu's rules): an entry of the same direction with at least this
    pad serves as it is; an entry of the other direction serves by a flip
    on the device, never unflipped and with no copy from the host; else
    the array is copied.  The cache holds at most DEV_SEQ_ENTRIES views and
    DEV_SEQ_BYTES bytes, the least recently used leaving first."""
    global _DEV_SEQ_CACHE
    if _DEV_SEQ_CACHE is None:
        _DEV_SEQ_CACHE = collections.OrderedDict()
    a = np.asarray(arr)
    dev = _device_of(device)
    hitk, hit = _dev_seq_find(a, reverse, pad, dev)
    if hit is not None:
        _DEV_SEQ_CACHE.move_to_end(hitk)
        return hit
    n = len(a)
    _, twin = _dev_seq_find(a, not reverse, 0, dev)
    if twin is not None and twin.numel() >= n:
        view = _flipped(twin, n, pad)
    else:
        host = np.ascontiguousarray(a[::-1] if reverse else a, np.uint8)
        view = _padded(torch.tensor(host, device=dev), pad)
        dev_seq_counts["uploads"] += 1
    _dev_seq_put(_dev_seq_key(a, reverse, pad, dev), view, a)
    return view


def dev_seq_peek(arr: np.ndarray, device, pad: int = 0,
                 reverse: bool = False):
    """A view of ``arr`` in the asked direction if one can be had with no
    copy from the host (a cached entry, or a flip of its cached twin),
    else None."""
    if _DEV_SEQ_CACHE is None:
        return None
    a = np.asarray(arr)
    dev = _device_of(device)
    hit = _dev_seq_find(a, reverse, pad, dev)[1]
    if hit is not None:
        return hit
    twin = _dev_seq_find(a, not reverse, 0, dev)[1]
    if twin is not None and twin.numel() >= len(a):
        return dev_seq(arr, device, pad, reverse)
    return None


def dev_seq_seed_reversed(fwd_host: np.ndarray, rev_host: np.ndarray,
                          device, pad: int = 0) -> None:
    """Cache, under the host array ``rev_host`` (a reversed copy of
    ``fwd_host``), the flip of ``fwd_host``'s cached view: a consumer that
    hands over the reversed array (stage 2's reverse march) then finds it
    with no copy from the host.  Nothing happens when ``fwd_host`` has no
    view on ``device``."""
    global _DEV_SEQ_CACHE
    if _DEV_SEQ_CACHE is None:
        _DEV_SEQ_CACHE = collections.OrderedDict()
    rev = np.asarray(rev_host)
    dev = _device_of(device)
    if _dev_seq_find(rev, False, pad, dev)[1] is not None:
        return
    fwd_key, fwd = _dev_seq_find(np.asarray(fwd_host), False, 0, dev)
    if fwd is None or fwd.numel() < len(rev):
        return
    _DEV_SEQ_CACHE.move_to_end(fwd_key)  # used: it outlives older views
    _dev_seq_put(_dev_seq_key(rev, False, pad, dev),
                 _flipped(fwd, len(rev), pad), rev)


# ---------------------------------------------------------------------------
# One stage-2 hop on the device (the port of masa_tpu's hop_step_device)
# ---------------------------------------------------------------------------
#
# A hop's state is an int32 (4,) tensor on the device: the crosspoint's
# column cj, its score, its CrosspointType and ``ok``.  A hop reads the
# state left by the hop before it and writes its own, so a chain of hops
# needs no read on the host until its end.

# The corner of a hop's reverse partition: the border H at its origin,
# 0 for both codes a hop's border takes (border_h(code, 0)).
HOP_CORNER = 0


def hop_codes(typ):
    """(row code, column code) of a reverse partition pinned at a
    crosspoint of type ``typ`` (``stages/core.init_types_for``): the row
    border continues an open gap only for GAP_1, the column border only
    for GAP_2."""
    gaps, opened = int(InitType.WITH_GAPS), int(InitType.WITH_GAPS_OPENED)
    return (torch.where(typ == CrosspointType.GAP_1, opened, gaps),
            torch.where(typ == CrosspointType.GAP_2, opened, gaps))


def hop_prep_plain(s1r, st, W: int, hb: int, gap_open: int, gap_ext: int):
    """What a hop's strip starts from, made from its state ``st`` with no
    read on the host: the window ``b`` of W characters of the reversed
    sequence ``s1r`` from n - cj on (clamped into the sequence where the
    hop is not eligible, cj < W + 1: its result is then dropped), the
    entering bus from the row code and the left border H/E (rows 1..hb)
    from the column code.  The plain version of ``kernels.hop_prep_cuda``.
    Returns ``(b, bus_h, bus_f, col_h, col_e)``."""
    dev = s1r.device
    n = s1r.numel()
    j0 = (n - st[0].long()).clamp(min=0, max=n - W)
    b = s1r[j0 + torch.arange(W, device=dev)]
    row_code, col_code = hop_codes(st[2])
    i32 = torch.int32
    bus_h = border_h_codes(row_code.view(1).long(),
                           torch.arange(1, W + 1, device=dev, dtype=i32),
                           gap_open, gap_ext).to(i32)
    col_h = border_h_codes(col_code.view(1).long(),
                           torch.arange(1, hb + 1, device=dev, dtype=i32),
                           gap_open, gap_ext).to(i32)
    return (b, bus_h, torch.full((W,), NEG, dtype=i32, device=dev), col_h,
            torch.full((hb,), NEG, dtype=i32, device=dev))


def hop_eligible(cj: int, score: int, ok: int, W: int, hb: int,
                 cut_n: int, match: int, sw: bool) -> bool:
    """Does a hop match at all?  Where the host march would take this
    exact window: cj >= W + 1 (the window clear of column 0), cj inside
    the cut, and, under SW, the goal not reachable inside the hop (score >
    min(hb, cj) * match), else the host would search for the alignment's
    start; and the state entered with ok."""
    return bool(ok) and W + 1 <= cj <= cut_n and not (
        sw and score <= min(hb, cj) * match)


def hop_match_plain(cut_h, cut_f, rev_h, rev_f, st_in, st_out, W: int,
                    hb: int, *, match: int, gap_open: int, gap_ext: int,
                    sw: bool):
    """The end of a hop: ``goal_match_device`` of the reverse pass's last
    row (``rev_h``/``rev_f``, W columns) against the stored cut, and the
    state update, written to ``st_out``.  The plain version of
    ``kernels.hop_match_cuda`` (it reads the state on the host).

    A hop that is not eligible (``hop_eligible``), or whose match is not
    a hit carries (cj, score, type) through with ok = 0; a hit moves to
    (cj - k, the stored score, MATCH or GAP_2, 1)."""
    cj, score, typ, ok = (int(x) for x in st_in.tolist())
    out = [cj, score, typ, 0]
    if hop_eligible(cj, score, ok, W, hb, cut_h.numel(), match, sw):
        goal = score + (gap_open if typ != CrosspointType.MATCH else 0)
        # the reverse row's border element: H and F of the column border
        # at row hb (border_h and stages/core._border_f_value agree there)
        edge = -hb * gap_ext - (0 if typ == CrosspointType.GAP_2
                                else gap_open)
        status, k, got = goal_match_device(
            cut_h, cut_f, rev_h, rev_f, cj, goal, edge, edge, W1=W + 1,
            go=gap_open).tolist()
        if status in (0, 1):
            out = [cj - k, got, CrosspointType.MATCH if status == 0
                   else CrosspointType.GAP_2, 1]
    st_out.copy_(torch.tensor(out, dtype=torch.int32))
    return st_out


def hop_plain(a, s1r, cut_h, cut_f, st_in, st_out, W: int, *, match: int,
              mismatch: int, gap_open: int, gap_ext: int, sw: bool,
              last_row: bool = False):
    """One stage-2 hop from the state ``st_in`` to ``st_out`` on any
    device: ``hop_prep_plain``, the reverse strip (``strip_plain``: NW,
    nothing tracked, corner 0) and ``hop_match_plain``.  The plain version
    of ``kernels.hop_cuda``, with its contract: ``a`` the hop's rows of
    the reversed seq0 (hb of them), ``s1r`` the reversed seq1, ``cut_h``/
    ``cut_f`` the stored cut.  ``last_row``: also the hop's last row
    ``(rev_h, rev_f)`` (W columns), swept on the clamped window where the
    hop is not eligible.  Returns ``(st_out, rev_h, rev_f)``, the last row
    None unless asked; a hop that is not eligible and not asked for its
    row is not swept."""
    hb = a.numel()
    cj, score, _, ok = (int(x) for x in st_in.tolist())
    if not last_row and not hop_eligible(cj, score, ok, W, hb,
                                         cut_h.numel(), match, sw):
        st_out.copy_(st_in)
        st_out[3] = 0
        return st_out, None, None
    b, bus_h, bus_f, col_h, col_e = hop_prep_plain(s1r, st_in, W, hb,
                                                   gap_open, gap_ext)
    out = strip_plain(a, b, bus_h, bus_f, col_h, col_e, HOP_CORNER,
                      match=match, mismatch=mismatch, gap_open=gap_open,
                      gap_ext=gap_ext, sw=False)
    hop_match_plain(cut_h, cut_f, out.bus_h, out.bus_f, st_in, st_out, W,
                    hb, match=match, gap_open=gap_open, gap_ext=gap_ext,
                    sw=sw)
    if last_row:
        return st_out, out.bus_h, out.bus_f
    return st_out, None, None


def hop_three(a, s1r, cut_h, cut_f, st_in, st_out, W: int, *, match: int,
              mismatch: int, gap_open: int, gap_ext: int, sw: bool,
              flags: list | None = None):
    """One hop on the card as three launches: ``kernels.hop_prep_cuda``,
    the strip kernel (NW, nothing tracked; its error flag appended to
    ``flags``) and ``kernels.hop_match_cuda``.  The route of a hop taller
    than a cluster of ``kernels.hop_cuda`` holds.  Returns ``(st_out,
    rev_h, rev_f)``, the hop's last row (W columns) swept by the strip
    kernel, as ``hop_cuda`` returns it with ``last_row``."""
    hb = a.numel()
    b, bus_h, bus_f, col_h, col_e = kernels.hop_prep_cuda(
        s1r, st_in, W, hb, gap_open, gap_ext)
    out = strip(a, b, bus_h, bus_f, col_h, col_e, HOP_CORNER, match=match,
                mismatch=mismatch, gap_open=gap_open, gap_ext=gap_ext,
                sw=False, flags=flags)
    kernels.hop_match_cuda(cut_h, cut_f, out.bus_h, out.bus_f, st_in,
                           st_out, W, hb, match=match, gap_open=gap_open,
                           gap_ext=gap_ext, sw=sw)
    return st_out, out.bus_h, out.bus_f


def hop_step(a, s1r, cut_h, cut_f, st_in, st_out, W: int, *, match: int,
             mismatch: int, gap_open: int, gap_ext: int, sw: bool,
             flags: list | None = None, routes: list | None = None):
    """One stage-2 hop from the state ``st_in`` to ``st_out``, with no read
    on the host (the contract of ``hop_plain``).  CPU tensors run
    ``hop_plain``; CUDA tensors run ``kernels.hop_cuda``, one launch,
    where ``kernels.hop_route`` gives the hop's shape a cluster, else
    ``hop_three`` (the route follows the shape alone); the kernels' error
    flags go to ``flags``, the route taken (``"plain"``, ``"one"`` or
    ``"three"``) to ``routes``.  Any other device raises."""
    hb = a.numel()
    if not 1 <= W < s1r.numel() or hb < 1:
        raise ValueError(f"a hop of {hb} rows needs 1 <= W < "
                         f"{s1r.numel()}, got W = {W}")
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_ext=gap_ext, sw=sw)
    args = (a, s1r, cut_h, cut_f, st_in, st_out, W)
    routes = [] if routes is None else routes
    if s1r.device.type == "cpu":
        routes.append("plain")
        return hop_plain(*args, **kw)[0]
    if s1r.device.type != "cuda":
        raise ValueError(f"no hop implementation for device {s1r.device}")
    geo = kernels.hop_route(hb, W, s1r.device)
    if geo is None:
        routes.append("three")
        return hop_three(*args, flags=flags, **kw)[0]
    routes.append("one")
    return kernels.hop_cuda(*args, flags=flags, geometry=geo, **kw)[0]


# ---------------------------------------------------------------------------
# Delta-packed rows (the port of masa_tpu's delta_pack_device family)
# ---------------------------------------------------------------------------
#
# masa_tpu computes these in XLA outside any Pallas kernel; here they are
# plain tensor operations on the row's device.  A DP row's neighbouring
# values differ by a small amount almost everywhere, so each difference is
# a signed nibble, two a byte (the low nibble first); a difference outside
# [-7, 7] is written -8, an escape, and its exact value is read from the
# row on the device.


def delta_pack_device(v, nj: int) -> torch.Tensor:
    """The first nj values of ``v`` as ceil(nj/2) bytes of nibble deltas
    (the first delta is the first value), on ``v``'s device."""
    x = v[:nj].to(torch.int64)
    dh = torch.cat([x[:1], x[1:] - x[:-1]])
    nib = torch.where((dh >= -7) & (dh <= 7), dh, -8) & 0xF
    if nj % 2:
        nib = torch.cat([nib, nib.new_zeros(1)])
    return (nib[0::2] | (nib[1::2] << 4)).to(torch.uint8)


def gather_device(v, idx) -> torch.Tensor:
    """``v`` at the positions ``idx`` (a tensor on ``v``'s device)."""
    return v[idx]


def _escapes(u, nj: int) -> np.ndarray:
    """The positions among the first nj nibbles of ``u`` that are escapes
    (each half of a byte tested where it lies: no nibble array)."""
    u = np.asarray(u, np.uint8)
    mark = np.sort(np.concatenate([np.flatnonzero((u & 0xF) == 8) * 2,
                                   np.flatnonzero((u >> 4) == 8) * 2 + 1]))
    return mark[mark < nj].astype(np.int64)


class DeltaPull(NamedTuple):
    """A packed row on its way to the host: ``packed`` (host, pinned where
    the row lies on a card), the row on its device (the escapes' exact
    values), its length, and the event behind the copy (None on the
    CPU)."""

    packed: torch.Tensor
    row: torch.Tensor
    nj: int
    done: object


def pull_row_delta_start(bus, nj: int, stream=None,
                         snapshot: bool = True) -> DeltaPull:
    """Pack ``bus[:nj]`` on the current stream and begin copying the packed
    bytes to the host, on ``stream`` where given (a side stream: the copy
    runs beside later work; the packed bytes' memory is kept from reuse
    until it has read them).  ``snapshot`` keeps a copy of the row for
    the escapes (masa_tpu's snapshot); a caller whose row is already its
    own passes False."""
    with trace.span("rows.pack"):
        row = bus[:nj].clone() if snapshot else bus
        packed = delta_pack_device(row, nj)
        if not packed.is_cuda:
            return DeltaPull(packed, row, nj, None)
        host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        cur = torch.cuda.current_stream(packed.device)
        side = stream if stream is not None else cur
        if side != cur:
            side.wait_stream(cur)
        with torch.cuda.stream(side):
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        if side != cur:
            packed.record_stream(side)
        return DeltaPull(host, row, nj, done)


def packed_row_host(handle: DeltaPull):
    """The packed row as masa_tpu persists it: ``(u, esc_idx, esc_val)``,
    the packed bytes (uint8), the escapes' positions and their exact
    values (int64), gathered from the row on its device now, so that the
    result decodes with no device (``decode_packed_row``)."""
    if handle.done is not None:
        with trace.span("rows.pull"):
            handle.done.synchronize()
    with trace.span("rows.escapes"):
        u = handle.packed.numpy()
        mark = _escapes(u, handle.nj)
        exact = np.empty(0, np.int64)
        if len(mark):
            idx = torch.from_numpy(mark).to(handle.row.device)
            exact = (gather_device(handle.row, idx).cpu().numpy()
                     .astype(np.int64))
    return u, mark, exact


def pull_row_delta_finish(handle: DeltaPull) -> np.ndarray:
    """The host side of a packed pull: the (nj,) int64 row, exact."""
    return decode_packed_row(*packed_row_host(handle), handle.nj)


def pull_row_delta(bus, nj: int) -> np.ndarray:
    """``bus[:nj]`` pulled packed: ceil(nj/2) bytes and the escapes cross
    to the host, and the row comes back exact as int64."""
    return pull_row_delta_finish(pull_row_delta_start(bus, nj,
                                                      snapshot=False))


# ---------------------------------------------------------------------------
# Special rows packed a batch at a time (``kernels.rowpack_cuda``, plain
# version ``rowpack_plain``)
# ---------------------------------------------------------------------------
#
# The disk-bound special rows of one stage-1 launch, H and F of each (its
# two halves), go to the host together: each half's nibble bytes, its
# escapes (positions ascending, exact values) and its anchors land in one
# buffer, laid out by ``RowPackLayout``, that crosses in one copy.  The
# host neither scans the bytes for escapes nor reads the row again.

# Cells between the absolute values an MSRQ row file keeps (its anchors),
# by which a window of a disk row decodes alone (core/sra.read_row_window).
ANCHOR_STRIDE = 1 << 16


def rowpack_capacity(nj: int) -> int:
    """The escapes a half-row's slot holds: 64, and one more for every 256
    cells (4,160 at 2^20 cells: 65 KiB of slot beside 512 KiB of nibble
    bytes), at most ``nj``.  A half-row with more takes the per-row path
    (``packed_row_host``)."""
    return min(nj, 64 + nj // 256)


class RowPackLayout(NamedTuple):
    """The buffer of a batch of ``rows`` rows of ``nj`` cells: per half
    (row r's H is half 2r, its F half 2r + 1) ``upad`` bytes of nibbles
    (ceil(nj/2), then zeros to a multiple of 8), then per half its
    ``anchors`` int64 values, its int64 count of escapes (past ``cap``,
    the slot overflowed), and a slot of ``cap`` escape positions followed
    by ``cap`` exact values (int64)."""

    rows: int
    nj: int
    stride: int
    cap: int

    @classmethod
    def of(cls, rows: int, nj: int) -> "RowPackLayout":
        return cls(rows, nj, ANCHOR_STRIDE, rowpack_capacity(nj))

    @property
    def ubytes(self) -> int:
        return (self.nj + 1) // 2

    @property
    def upad(self) -> int:
        return -(-self.ubytes // 8) * 8

    @property
    def anchors(self) -> int:
        return -(-self.nj // self.stride)

    def offsets(self) -> tuple[int, int, int, int, int]:
        """Byte offsets of the nibbles, anchors, counts and escapes, and
        the buffer's size."""
        halves = 2 * self.rows
        anc = halves * self.upad
        cnt = anc + 8 * halves * self.anchors
        esc = cnt + 8 * halves
        return 0, anc, cnt, esc, esc + 16 * halves * self.cap

    def views(self, buf: np.ndarray):
        """(nibbles (rows, 2, upad) uint8, anchors (rows, 2, anchors),
        counts (rows, 2), escapes (rows, 2, 2, cap) int64) over the bytes
        ``buf``."""
        u, anc, cnt, esc, end = self.offsets()
        k = self.rows
        return (buf[u:anc].reshape(k, 2, self.upad),
                buf[anc:cnt].view(np.int64).reshape(k, 2, self.anchors),
                buf[cnt:esc].view(np.int64).reshape(k, 2),
                buf[esc:end].view(np.int64).reshape(k, 2, 2, self.cap))


def rowpack_plain(halves, layout: RowPackLayout, out: torch.Tensor) -> None:
    """The plain version of ``kernels.rowpack_cuda``: each half-row of
    ``halves`` (int32 tensors of ``layout.nj`` cells, H then F of each
    row) packed into the uint8 buffer ``out`` by ``delta_pack_device``,
    its escapes found by ``_escapes`` and their values and the anchors
    gathered from the row.  Escape slots past a half's count keep what
    ``out`` held."""
    u, anc, cnt, esc = layout.views(out.numpy())
    nj, cap = layout.nj, layout.cap
    at = torch.arange(0, nj, layout.stride)
    for q, x in enumerate(halves):
        r, s = divmod(q, 2)
        packed = delta_pack_device(x, nj).numpy()
        u[r, s, :len(packed)] = packed
        u[r, s, len(packed):] = 0
        mark = _escapes(packed, nj)
        cnt[r, s] = len(mark)
        mark = mark[:cap]
        esc[r, s, 0, :len(mark)] = mark
        esc[r, s, 1, :len(mark)] = gather_device(
            x, torch.from_numpy(mark)).numpy()
        anc[r, s] = gather_device(x, at).numpy()


def rowpack(halves, layout: RowPackLayout, out: torch.Tensor) -> None:
    """Pack ``halves`` into ``out`` as ``layout`` says, where ``out``
    lies: the plain version on the CPU, the kernel on a card."""
    if out.device.type == "cpu":
        rowpack_plain(halves, layout, out)
    elif out.device.type == "cuda":
        kernels.rowpack_cuda(halves, layout, out)
    else:
        raise ValueError(f"no row packing for device {out.device}")
