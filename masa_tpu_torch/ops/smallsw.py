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

from masa_tpu_torch.biology.alignment import Alignment
from masa_tpu_torch.types import INF, CrosspointType, ScoreParams
from masa_tpu_torch.utils import trace

NEG = -INF


def _traceback_native(bindings, seq0, seq1, type_s, type_e, params,
                      alignment, pos0, pos1) -> int:
    """Native C++ constrained DP + run-length traceback (same tie-break
    preferences as the Python path: diagonal, then E, then F)."""
    with trace.span("dp"):
        seg, ops = bindings.traceback_ops(seq0, seq1, type_s, type_e, params)
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
    return seg


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
