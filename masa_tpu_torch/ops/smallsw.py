"""Taken from ``masa_tpu/ops/smallsw.py`` (the JAX reference).

Exact small-partition DP with state-constrained endpoints + traceback.

The stage-5 compute core (reference: stage5/sw_stage5.cpp:86-319), built on
a cleaner state algebra:

A crosspoint (i, j, score, type) pins the optimal path to a DP *state* at
cell (i, j): H for MATCH, E for GAP_1 (mid horizontal gap), F for GAP_2
(mid vertical gap); `score` is that state's DP value (gap state values
include the single gap_open charged where the gap began).  The segment
between consecutive crosspoints is therefore a state-to-state constrained
alignment whose score must equal the difference of the crosspoint scores —
the invariant stage 5 re-checks for every partition
(sw_stage5.cpp:407-414,446-450).

Gap positions recorded into the Alignment follow the reference convention:
one gap char before 1-based sequence position p (stage5/sw_stage5.cpp:67-83).
"""

from __future__ import annotations

import numpy as np
import torch

from masa_tpu_torch.biology.alignment import Alignment
from masa_tpu_torch.ops import kernels
from masa_tpu_torch.types import INF, CrosspointType, ScoreParams
from masa_tpu_torch.utils import trace

NEG = -INF


def _traceback_native(bindings, seq0, seq1, type_s, type_e, params,
                      alignment, pos0, pos1) -> int:
    """Native C++ constrained DP + run-length traceback (same tie-break
    preferences as the Python path: diagonal, then E, then F)."""
    with trace.span("dp"):
        seg, ops = bindings.traceback_ops(seq0, seq1, type_s, type_e, params)
    apply_ops(seq0, seq1, ops, alignment, pos0, pos1)
    return seg


def apply_ops(seq0, seq1, ops, alignment, pos0, pos1) -> None:
    """Emit a partition's run-length path (``bindings.traceback_ops``'
    (code, length) rows, forward order) into ``alignment``: the matches
    and mismatches of its diagonal runs, its gaps and gap counts.  pos0/
    pos1 map local residue index to 1-based global position."""
    i = j = 0  # local consumed counts
    for code, length in ops:
        opened = bool(code & 4)
        kind = code & 3
        if kind == 0:  # diagonal run
            eq = int(
                (seq0[i : i + length] == seq1[j : j + length]).sum()
            )
            alignment.matches += eq
            alignment.mismatches += length - eq
            i += length
            j += length
        elif kind == 1:  # up: gap chars in seq1
            alignment.add_gap(1, pos1(j), length)
            alignment.gap_extensions += length
            if opened:
                alignment.gap_opens += 1
            i += length
        else:  # left: gap chars in seq0
            alignment.add_gap(0, pos0(i), length)
            alignment.gap_extensions += length
            if opened:
                alignment.gap_opens += 1
            j += length


def constrained_dp(
    seq0: np.ndarray,
    seq1: np.ndarray,
    type_s: int,
    params: ScoreParams,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DP over the (h+1, w+1) grid with the start state pinned by type_s.

    Returns (H, E, F) int64 matrices.  seq0/seq1 are the partition's
    residues (lengths h, w).
    """
    h, w = len(seq0), len(seq1)
    go, ge = params.gap_open, params.gap_ext
    H = np.full((h + 1, w + 1), NEG, np.int64)
    E = np.full((h + 1, w + 1), NEG, np.int64)
    F = np.full((h + 1, w + 1), NEG, np.int64)
    # H(0,0) = 0 in every case: a pinned gap state may close for free
    # (H = max(..., E, F)); the E/F seeds steer gap continuation.
    H[0, 0] = 0
    E[0, 0] = 0 if type_s == CrosspointType.GAP_1 else NEG
    F[0, 0] = 0 if type_s == CrosspointType.GAP_2 else NEG
    for j in range(1, w + 1):
        E[0, j] = max(H[0, j - 1] - go, E[0, j - 1]) - ge
        H[0, j] = E[0, j]
    jext = np.arange(w + 1, dtype=np.int64) * ge
    for i in range(1, h + 1):
        F[i, 0] = max(H[i - 1, 0] - go, F[i - 1, 0]) - ge
        H[i, 0] = F[i, 0]
        c0 = seq0[i - 1]
        sub = np.where(seq1 == c0, params.match, params.mismatch).astype(
            np.int64
        )
        F[i, 1:] = np.maximum(H[i - 1, 1:] - go, F[i - 1, 1:]) - ge
        hrow = np.maximum(H[i - 1, :-1] + sub, F[i, 1:])
        H[i, 1:] = hrow
        # lazy-E fixpoint (same scheme as oracle.dp_rows)
        while True:
            g = np.maximum(H[i] - go, E[i]) + jext
            run = np.maximum.accumulate(g[:-1])
            e_new = np.maximum(run - jext[1:], NEG)
            h_new = np.maximum(H[i, 1:], e_new)
            if np.array_equal(h_new, H[i, 1:]) and np.array_equal(
                e_new, E[i, 1:]
            ):
                E[i, 1:] = e_new
                break
            H[i, 1:] = h_new
            E[i, 1:] = e_new
    return H, E, F


def traceback_segment(
    seq0: np.ndarray,
    seq1: np.ndarray,
    i0: int,
    j0: int,
    type_s: int,
    type_e: int,
    params: ScoreParams,
    alignment: Alignment | None = None,
    pos0=None,
    pos1=None,
) -> int:
    """Align the partition exactly and (optionally) emit gaps/stats into
    `alignment`.  seq0/seq1 are the partition residues; (i0, j0) the global
    DP coordinates of the start crosspoint; pos0/pos1 map local residue
    index (0-based) to 1-based global sequence positions (default: i0+1+k).

    Returns the segment score (to be checked against the crosspoint score
    difference).
    """
    h, w = len(seq0), len(seq1)
    if pos0 is None:
        pos0 = lambda k: i0 + 1 + k
    if pos1 is None:
        pos1 = lambda k: j0 + 1 + k

    if alignment is not None:
        try:
            from masa_tpu_torch.native import bindings

            if bindings.available():
                return _traceback_native(
                    bindings, seq0, seq1, type_s, type_e, params,
                    alignment, pos0, pos1,
                )
        except ImportError:
            pass

    with trace.span("dp"):
        H, E, F = constrained_dp(seq0, seq1, type_s, params)
    go, ge = params.gap_open, params.gap_ext

    if type_e == CrosspointType.MATCH:
        seg = int(H[h, w])
    elif type_e == CrosspointType.GAP_1:
        seg = int(E[h, w])
    else:
        seg = int(F[h, w])

    if alignment is None:
        return seg

    # Walk back from (h, w) in state `state`.
    i, j, state = h, w, int(type_e)
    ops = []  # reversed ops: ("d", i, j) diag | ("u", i, j) up | ("l", i, j)
    while i > 0 or j > 0:
        if state == CrosspointType.MATCH:
            if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + (
                params.match if seq0[i - 1] == seq1[j - 1] else params.mismatch
            ):
                ops.append(("d", i, j))
                i, j = i - 1, j - 1
                continue
            if H[i, j] == E[i, j]:
                state = CrosspointType.GAP_1
                continue
            if H[i, j] == F[i, j]:
                state = CrosspointType.GAP_2
                continue
            raise AssertionError("traceback lost (H state)")
        if state == CrosspointType.GAP_1:
            # gap char in seq0, consuming seq1[j-1]
            assert j > 0, "traceback lost (E state at border)"
            opened = E[i, j] == H[i, j - 1] - go - ge
            ops.append(("l", i, j, opened))
            j -= 1
            if opened:
                state = CrosspointType.MATCH
            continue
        # GAP_2: gap char in seq1, consuming seq0[i-1]
        assert i > 0, "traceback lost (F state at border)"
        opened = F[i, j] == H[i - 1, j] - go - ge
        ops.append(("u", i, j, opened))
        i -= 1
        if opened:
            state = CrosspointType.MATCH

    assert (i, j) == (0, 0)
    if int(state) not in (int(type_s), int(CrosspointType.MATCH)):
        # The path must arrive in the pinned start state (or in H, which
        # is the free closure of a pinned gap: H(0,0)=0 in every case).
        raise AssertionError("traceback arrived in wrong start state")

    # Emit in forward order.
    for op in reversed(ops):
        kind = op[0]
        if kind == "d":
            _, oi, oj = op
            if seq0[oi - 1] == seq1[oj - 1]:
                alignment.matches += 1
            else:
                alignment.mismatches += 1
        elif kind == "u":
            _, oi, oj, opened = op
            # gap char inserted into seq1 before its position j+1
            alignment.add_gap(1, pos1(oj))
            alignment.gap_extensions += 1
            if opened:
                alignment.gap_opens += 1
        else:
            _, oi, oj, opened = op
            alignment.add_gap(0, pos0(oi))
            alignment.gap_extensions += 1
            if opened:
                alignment.gap_opens += 1
    return seg


# --- many partitions at once: the card's kernel and its plain version ------


def traceback_plain(a, b, items, params: ScoreParams) -> torch.Tensor:
    """The plain version of ``kernels.traceback_cuda`` (``csrc/
    traceback.cu``): the same output from CPU tensors.

    ``a``/``b`` are uint8 sequence views, ``items`` a host (B, 6) int
    array of ``kernels.TRACEBACK_FIELDS``.  The batch's DP runs along
    anti-diagonals over all partitions at once (padded to the largest; a
    cell depends only on cells above and to its left, so padding never
    reaches a partition's own cells), in int64 as ``masa_traceback``
    computes it.  Its bits make the kernel's 4-bit table (H's source:
    diagonal 0, E 1, F 2, none 3; E opened, bit 2; F opened, bit 3; row 0
    and column 0 as the native borders make them), and the walk steps
    every partition at once over that table, one cell a step (a change of
    state joins the move that follows it).  Returns the int32 output
    that ``kernels.traceback_layout`` lays out."""
    it = torch.from_numpy(np.asarray(items, np.int64).reshape(-1, 6).copy())
    B = len(it)
    i0, h, j0, w, ts, te = it.unbind(1)
    hm, wm = int(h.max()), int(w.max())
    go, ge = params.gap_open, params.gap_ext
    gof = -(go + ge)
    # characters; -1/-2 past a view (cells past a partition are never read)
    av = torch.cat([a.long(), torch.tensor([-1])])
    bv = torch.cat([b.long(), torch.tensor([-2])])
    A = av[(i0[:, None] + torch.arange(hm)).clamp(max=len(av) - 1)]
    Bc = bv[(j0[:, None] + torch.arange(wm)).clamp(max=len(bv) - 1)]
    sub = torch.where(A[:, :, None] == Bc[:, None, :], params.match,
                      params.mismatch)
    full = (B, hm + 1, wm + 1)
    H = torch.full(full, NEG, dtype=torch.int64)
    E = torch.full(full, NEG, dtype=torch.int64)
    F = torch.full(full, NEG, dtype=torch.int64)
    e00 = torch.where(ts == CrosspointType.GAP_1, 0, NEG)
    f00 = torch.where(ts == CrosspointType.GAP_2, 0, NEG)
    H[:, 0, 0], E[:, 0, 0], F[:, 0, 0] = 0, e00, f00
    # the borders: a gap along row 0 (H = E) and column 0 (H = F)
    for k in range(1, wm + 1):
        E[:, 0, k] = torch.maximum(H[:, 0, k - 1] - go, E[:, 0, k - 1]) - ge
        H[:, 0, k] = E[:, 0, k]
    for k in range(1, hm + 1):
        F[:, k, 0] = torch.maximum(H[:, k - 1, 0] - go, F[:, k - 1, 0]) - ge
        H[:, k, 0] = F[:, k, 0]
    for d in range(2, hm + wm + 1):
        ii = torch.arange(max(1, d - wm), min(hm, d - 1) + 1)
        if len(ii) == 0:
            continue
        jj = d - ii
        e = torch.maximum(H[:, ii, jj - 1] + gof, E[:, ii, jj - 1] - ge)
        f = torch.maximum(H[:, ii - 1, jj] + gof, F[:, ii - 1, jj] - ge)
        dg = H[:, ii - 1, jj - 1] + sub[:, ii - 1, jj - 1]
        H[:, ii, jj] = torch.maximum(dg, torch.maximum(e, f))
        E[:, ii, jj] = e
        F[:, ii, jj] = f
    # the table
    src = torch.where(H == E, 1, torch.where(H == F, 2, 3))
    src[:, 1:, 1:] = torch.where(H[:, 1:, 1:] == H[:, :-1, :-1] + sub, 0,
                                 src[:, 1:, 1:])
    bits = src
    bits[:, :, 1:] |= (E[:, :, 1:] == H[:, :, :-1] + gof).long() << 2
    bits[:, 1:, :] |= (F[:, 1:, :] == H[:, :-1, :] + gof).long() << 3
    bits[:, 0, 0] = 0
    # the walk, every partition a step at a time
    ar = torch.arange(B)
    seg = torch.stack([H, E, F], 1)[ar, te, h, w]
    i, j, st = h.clone(), w.clone(), te.clone()
    failed = torch.zeros(B, dtype=torch.bool)
    live = (i > 0) | (j > 0)
    codes = []
    for _ in range(int((h + w).max())):
        if not bool(live.any()):
            break
        here = bits[ar, i, j]
        s0 = live & (st == 0)
        st = torch.where(s0 & ((here & 3) == 1), 1, st)
        st = torch.where(s0 & ((here & 3) == 2), 2, st)
        failed |= s0 & ((here & 3) == 3)
        left = live & (st == 1)
        up = live & (st == 2)
        failed |= (left & (j <= 0)) | (up & (i <= 0))
        live &= ~failed
        diag, left, up = live & (st == 0), left & live, up & live
        eop, fop = (here >> 2) & 1, (here >> 3) & 1
        codes.append(torch.where(diag, 0, torch.where(
            left, 2 + 4 * eop, torch.where(up, 1 + 4 * fop, -1))))
        i = i - (diag | up).long()
        j = j - (diag | left).long()
        st = torch.where((left & (eop == 1)) | (up & (fop == 1)), 0, st)
        live &= (i > 0) | (j > 0)
    failed |= (st != ts) & (st != 0)
    hdr, ops, total = kernels.traceback_layout(
        torch.stack([h, w], 1).numpy())
    out = torch.zeros(total, dtype=torch.int32)
    out[hdr] = seg.int()
    steps = torch.stack(codes, 1) if codes else torch.empty(
        (B, 0), dtype=torch.int64)
    for k in range(B):
        if failed[k]:
            out[hdr[k] + 1] = -1
            continue
        walk = steps[k][steps[k] >= 0].flip(0)
        run, n = (torch.unique_consecutive(walk, return_counts=True)
                  if len(walk) else (walk, walk))
        end = int(ops[k]) + 2 * int(h[k] + w[k])
        out[hdr[k] + 1] = len(run)
        out[end - 2 * len(run):end] = torch.stack([run, n], 1).reshape(-1)
    return out


def traceback_batch(a, b, items, params: ScoreParams) -> torch.Tensor:
    """``kernels.traceback_cuda`` for CUDA tensors, ``traceback_plain``
    for CPU ones."""
    if a.device.type == "cuda":
        return kernels.traceback_cuda(
            a, b, items, match=params.match, mismatch=params.mismatch,
            gap_open=params.gap_open, gap_ext=params.gap_ext)
    return traceback_plain(a, b, items, params)


def traceback_decode(out, hw) -> list:
    """The output of ``traceback_batch`` (a host array) for partitions of
    ``hw`` ((B, 2) heights and widths): each partition's ``(score, ops)``,
    ``ops`` the (code, length) int32 rows of ``bindings.traceback_ops``,
    or None where the walk failed."""
    out = np.asarray(out)
    hw = np.asarray(hw, np.int64).reshape(-1, 2)
    hdr, ops, _ = kernels.traceback_layout(hw)
    end = ops + 2 * hw.sum(1)
    return [(seg, None if n < 0 else out[e - 2 * n:e].reshape(-1, 2).copy())
            for seg, n, e in zip(out[hdr].tolist(), out[hdr + 1].tolist(),
                                 end.tolist())]


def traceback_on_card(seq0, seq1, cps, params: ScoreParams, device) -> dict:
    """Stage 5's constrained DP and walks on a CUDA ``device``
    (``traceback_partitions`` under the card's shared memory); on another
    device nothing: every partition takes ``traceback_segment``."""
    dev = torch.device(device)
    if dev.type != "cuda" or len(cps) < 2:
        return {}
    return traceback_partitions(seq0, seq1, cps, params, dev,
                                kernels.traceback_max_shared(dev))


def traceback_partitions(seq0, seq1, cps, params: ScoreParams, dev,
                         smem_limit: int) -> dict:
    """Every partition between consecutive crosspoints of ``cps`` that
    ``kernels.traceback_fits`` admits under ``smem_limit`` bytes of shared
    memory, through ``traceback_batch`` on ``dev``,
    ``kernels.TRACEBACK_BATCH`` at a time: each batch one pass of
    launches and one copy back.  Returns ``{k: (score, ops or None)}`` by
    the partition's index (``ops`` as ``traceback_decode`` gives them);
    the partitions it does not admit are not in it."""
    ci = np.array([c.i for c in cps], np.int64)
    cj = np.array([c.j for c in cps], np.int64)
    ct = np.array([int(c.type) for c in cps], np.int64)
    h, w = np.diff(ci), np.diff(cj)
    take = np.flatnonzero(kernels.traceback_fits(h, w, params, smem_limit))
    if not len(take):
        return {}
    # the stretch of each sequence the path crosses, sent once
    lo0, lo1 = int(ci[take].min()), int(cj[take].min())
    a = torch.from_numpy(np.ascontiguousarray(
        seq0[lo0:int(ci[take + 1].max())], np.uint8)).to(dev)
    b = torch.from_numpy(np.ascontiguousarray(
        seq1[lo1:int(cj[take + 1].max())], np.uint8)).to(dev)
    items = np.stack([ci[take] - lo0, h[take], cj[take] - lo1, w[take],
                      ct[take], ct[take + 1]], 1)
    res = {}
    for k0 in range(0, len(take), kernels.TRACEBACK_BATCH):
        part = slice(k0, k0 + kernels.TRACEBACK_BATCH)
        with trace.span("dp"):
            out = traceback_batch(a, b, items[part], params).cpu().numpy()
        res.update(zip(take[part].tolist(),
                       traceback_decode(out, items[part, 1:4:2])))
    trace.count("partitions.card", len(take))
    return res
