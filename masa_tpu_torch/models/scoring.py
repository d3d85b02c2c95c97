"""Taken from ``masa_tpu/models/scoring.py`` (the JAX reference).

Scoring model: sequence encoding, border initialization, Myers-Miller
column matching.

The matching procedure re-creates AlignerUtils::matchColumn
(libs/masa-core/src/libmasa/utils/AlignerUtils.cpp:50-107) with vectorized
NumPy instead of a scalar scan.
"""

from __future__ import annotations

import numpy as np

from masa_tpu_torch.types import (
    INF,
    InitType,
    MatchResult,
    MatchType,
    ScoreParams,
)


def encode_sequence(data: bytes | str | np.ndarray) -> np.ndarray:
    """Encode a DNA sequence as uint8 byte values.

    The engine compares raw (uppercased) byte values for match/mismatch,
    exactly like the reference kernel's `s1 != s0` byte compare
    (CUDAligner.cu:280). 'N' therefore matches 'N' unless cleared upstream.
    """
    if isinstance(data, str):
        data = data.encode("ascii")
    if isinstance(data, (bytes, bytearray)):
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        arr = np.asarray(data, dtype=np.uint8)
    # Uppercase in-place equivalent: 'a'..'z' -> 'A'..'Z'.
    lower = (arr >= ord("a")) & (arr <= ord("z"))
    if lower.any():
        arr = np.where(lower, arr - 32, arr).astype(np.uint8)
    return arr


def border_cells(
    length: int,
    init_type: InitType,
    params: ScoreParams,
    start: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Synthesize border (H, gap-component) vectors for positions
    start .. start+length-1 along a first row or first column.

    Mirrors InitialCellsReader (common/io/InitialCellsReader) semantics:
      WITH_ZEROES:      H_k = 0
      WITH_GAPS:        H_0 = 0, H_k = -open - k*ext
      WITH_GAPS_OPENED: H_k = -k*ext
    The gap component is -INF at every border position.
    """
    k = np.arange(start, start + length, dtype=np.int64)
    if init_type == InitType.WITH_ZEROES:
        h = np.zeros(length, dtype=np.int64)
    elif init_type == InitType.WITH_GAPS:
        h = np.where(k == 0, 0, -params.gap_open - k * params.gap_ext)
    elif init_type == InitType.WITH_GAPS_OPENED:
        h = -k * params.gap_ext
    else:
        raise ValueError(f"cannot synthesize border for {init_type!r}")
    g = np.full(length, -INF, dtype=np.int64)
    return h.astype(np.int32), g.astype(np.int32)


def match_column(
    rev_h: np.ndarray,
    rev_g: np.ndarray,
    fwd_h: np.ndarray,
    fwd_g: np.ndarray,
    goal: int,
    gap_open: int,
) -> MatchResult:
    """Myers-Miller matching of a reverse-pass cut against a stored forward
    cut (AlignerUtils::matchColumn, AlignerUtils.cpp:50-107).

    All four vectors are indexed by the same cut coordinate k. `fwd_*` is the
    stored stage-1/3 cut ("base"), `rev_*` the freshly computed reverse cut
    ("buffer"). The gap components are the one orthogonal to the cut: F for a
    horizontal cut, E for a vertical cut.

    Scans k in increasing order; the first k where
        fwd_h[k] + rev_h[k] == goal          -> MATCH_ALIGNED (score=fwd_h[k])
        fwd_g[k] + rev_g[k] + open == goal   -> MATCH_GAPPED  (score=fwd_g[k])
    wins. Like the reference, a k where either sum EXCEEDS the goal before a
    match is found means the backtrace is lost (returned as an error result;
    callers treat it as fatal).
    """
    n = len(rev_h)
    sum_match = fwd_h.astype(np.int64) + rev_h.astype(np.int64)
    sum_gap = fwd_g.astype(np.int64) + rev_g.astype(np.int64) + gap_open
    hit = (sum_match == goal) | (sum_gap == goal)
    over = (sum_match > goal) | (sum_gap > goal)
    stop = hit | over
    idx = int(np.argmax(stop)) if stop.any() else n
    if idx < n and hit[idx]:
        if sum_match[idx] == goal:
            return MatchResult(True, idx, int(fwd_h[idx]), MatchType.ALIGNED)
        return MatchResult(True, idx, int(fwd_g[idx]), MatchType.GAPPED)
    if idx < n:
        err = (
            MatchType.ERROR_SUM_MATCH
            if sum_match[idx] > goal
            else MatchType.ERROR_SUM_GAP
        )
        return MatchResult(False, idx, 0, err)
    return MatchResult(False, -1, 0, MatchType.ALIGNED)
