"""Row-sweep DP engine under the reference's names: the affine-gap
recurrence swept over ROWS with one cumulative max per row.

Counterpart of ``masa_tpu/ops/rowsweep.py`` (``sweep``,
``batched_sweep_engine``), which is plain XLA device code in the
reference, not a Pallas kernel: it has no hand-written kernel here.  The
sweep itself lives once, in ``ops/wavefront`` (``strip_plain`` and
``batched_sweep_plain``, the plain versions the Hopper kernels are held
against); this module maps the reference's bus conventions onto those two
and keeps no sweep of its own.  It runs on the tensors' device, CPU or
CUDA, through ordinary PyTorch operations, and on no main path on the
card: there the kernels of ``csrc/`` do this work.

Conventions, as in the reference (``ops/oracle.dp_rows``' exactly): a bus
row is ``n1`` wide and holds the border column at index 0; it stores
(H, F) with F the VERTICAL gap; the column border carries (H, E) with E
the HORIZONTAL gap.  Chaining: the returned (h, f) row is the next
sweep's (row_h, row_f) input.
"""

from __future__ import annotations

import torch

from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.types import INF

NEG = -INF


def sweep(a_chars, b_row, h0, e0, row_h, row_f, stop_after,
          n1: int, m_steps: int, sw: bool, go: int, ge: int,
          match: int, mismatch: int,
          track_best: bool = False, want_lastcol: bool = False) -> dict:
    """Run ``m_steps`` DP rows over a width-(n1-1) matrix.

    a_chars: (m_steps,) row characters.
    b_row:   (n1,), b_row[j] = character of column j (b_row[0] unused).
    h0, e0:  (m_steps,) column-border H and HORIZONTAL-gap values at rows
        i0+1..i0+m_steps (e0 is -INF for synthesized borders).
    row_h, row_f: (n1,) entering row bus including the corner at 0
        (f = vertical gap, the bus convention).
    stop_after: rows beyond it leave the bus frozen, so the returned bus is
        exactly the row-``stop_after`` state (pass m_steps to run all).

    Returns a dict of int32 tensors on ``b_row``'s device: ``h``, ``f``
    (n1,) the final row bus; ``best`` (3,) [value, i (1-based sweep step),
    j] if track_best (the border column counts, ties to the first row and
    then the first column); ``lastcol_h``/``lastcol_e`` (m_steps,) if
    want_lastcol (e = horizontal gap; a frozen row reports the frozen H
    and the E that row would have had, as the reference does)."""
    if b_row.numel() != n1 or row_h.numel() != n1 or row_f.numel() != n1:
        raise ValueError(f"b_row, row_h and row_f must hold n1 = {n1} values")
    if n1 < 2:
        raise ValueError("a sweep needs at least one column beside the "
                         "border")
    if any(x.numel() != m_steps for x in (a_chars, h0, e0)):
        raise ValueError(f"a_chars, h0 and e0 must hold m_steps = {m_steps} "
                         f"values")
    i32 = torch.int32
    dev = b_row.device
    h0, e0 = h0.to(i32), e0.to(i32)
    H, F = row_h.to(i32), row_f.to(i32)
    stop = max(0, min(int(stop_after), m_steps))
    kw = dict(match=match, mismatch=mismatch, gap_open=go, gap_ext=ge, sw=sw)
    edge = torch.maximum(h0, e0)  # H of the border column, row by row
    neg = torch.full((1,), NEG, dtype=i32, device=dev)
    out = {}
    s = None
    if stop:
        s = wf.strip_plain(a_chars[:stop], b_row[1:], H[1:], F[1:],
                           h0[:stop], e0[:stop], int(H[0]), **kw,
                           track_best=track_best, store_lastcol=want_lastcol)
        H = torch.cat([edge[stop - 1:stop], s.bus_h])
        F = torch.cat([neg, s.bus_f])
    out["h"], out["f"] = H, F
    if track_best:
        best = (NEG, 0, 0)
        if stop:
            v, i, j = (int(x) for x in s.best)
            v0, i0 = int(edge[:stop].max()), int(edge[:stop].argmax())
            # the border column is column 0 of its row: it wins a tie
            best = (v0, i0 + 1, 0) if v0 > v or (v0 == v and i0 <= i) \
                else (v, i + 1, j + 1)
            if best[0] <= NEG:
                best = (NEG, 0, 0)
        out["best"] = torch.tensor(best, dtype=i32, device=dev)
    if want_lastcol:
        last_h = torch.empty(m_steps, dtype=i32, device=dev)
        last_e = torch.empty(m_steps, dtype=i32, device=dev)
        if stop:
            last_h[:stop] = s.lastcol_h
            last_e[:stop] = s.lastcol_e.clamp(min=NEG)
        for i in range(stop, m_steps):  # frozen rows
            row = wf.strip_plain(a_chars[i:i + 1], b_row[1:], H[1:], F[1:],
                                 h0[i:i + 1], e0[i:i + 1], int(H[0]), **kw,
                                 store_lastcol=True)
            last_h[i] = H[-1]
            last_e[i] = row.lastcol_e[0].clamp(min=NEG)
        out["lastcol_h"], out["lastcol_e"] = last_h, last_e
    return out


def batched_sweep_engine(n1: int, R: int, sw: bool, go: int, ge: int,
                         match: int, mismatch: int):
    """The row sweep for half-passes against the sequence views: a callable
    over ``(s0, s1, i0, j0, r0, col_code, bus_h, bus_f, h_rem)``, each of
    the last seven one value per element, that chains up to ``R`` rows per
    element from a logical (n1-1,)-wide bus: element e advances
    ``clip(h_rem[e], 0, R)`` rows of ``s0`` from row ``i0 + r0`` against
    the columns ``[j0, j0 + n1 - 1)`` of ``s1``, its left border
    synthesized from ``col_code`` (InitType 0-2) at border positions
    ``r0``...  Returns the (B, n1-1) int32 buses ``(h, f)``; an element
    with no rows left keeps its bus."""

    def engine(s0, s1, i0, j0, r0, col_code, bus_h, bus_f, h_rem):
        rows = torch.as_tensor(h_rem).clamp(0, R)
        return wf.batched_sweep_plain(
            s0, s1, i0, j0, r0, col_code, bus_h[:, :n1 - 1],
            bus_f[:, :n1 - 1], rows, sw=sw, match=match, mismatch=mismatch,
            gap_open=go, gap_ext=ge)

    return engine
