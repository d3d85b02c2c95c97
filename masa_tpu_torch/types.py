"""Taken from ``masa_tpu/types.py`` (the JAX reference).

Core value types of the masa_tpu engine.

These mirror the reference framework's contracts (cell components, score
parameters, crosspoints, matching results) without copying its code:
see MASA-CUDAlign 4.0's libs/masa-core/src/libmasa/libmasaTypes.hpp:35-112
for the original C structs.

Conventions (fixed for the whole engine):
  * seq0 is vertical (rows, length m); seq1 is horizontal (columns, length n).
  * DP matrix H(i,j) with i in [0,m], j in [0,n]; cell (i,j) consumes
    seq0[i-1] and seq1[j-1].
  * E is the horizontal gap component (gap characters inserted into seq0,
    consuming seq1); F is the vertical gap component (gap chars in seq1).
  * A "row" of cells stores (H, F); a "column" stores (H, E) — the same
    union-cell convention as the reference's cell_t (libmasaTypes.hpp:35-41).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

# Infinity sentinel used inside the DP matrices (libmasaTypes.hpp:46).
INF = 999999999


class Recurrence(enum.IntEnum):
    """DP recurrence family (CUDAligner.cu:36-64 template axis)."""

    SMITH_WATERMAN = 0
    NEEDLEMAN_WUNSCH = 1


class InitType(enum.IntEnum):
    """Border initialization types (IManager.hpp:31-58)."""

    WITH_ZEROES = 0       # H_k = 0
    WITH_GAPS = 1         # H_0 = 0, H_k = -open - k*ext (k >= 1)
    WITH_GAPS_OPENED = 2  # H_k = -k*ext
    CUSTOM = 3            # explicit (H, E-or-F) vectors


class StartType(enum.IntEnum):
    """How a partition's alignment starts at its origin corner
    (IManager.hpp start types)."""

    MATCH = 0
    GAP_H = 1  # continuing a horizontal gap: first ROW init skips gap_open
    GAP_V = 2  # continuing a vertical gap:  first COLUMN init skips gap_open


class CrosspointType(enum.IntEnum):
    """Where the optimal path sits when crossing a cut
    (biology/Alignment.hpp:32-34)."""

    MATCH = 0
    GAP_1 = 1  # inside a horizontal gap run (E component; gap chars in seq0)
    GAP_2 = 2  # inside a vertical gap run (F component; gap chars in seq1)


class AlignmentStart(enum.IntEnum):
    """Which matrix borders may start/end the alignment (the reference's
    --alignment-start / --alignment-end flag values)."""

    ANYWHERE = 0        # local (SW)
    SEQUENCE_1 = 1      # alignment must contain all of seq1 (first row gapped)
    SEQUENCE_2 = 2      # alignment must contain all of seq0 (first col gapped)
    SEQUENCE_1_OR_2 = 3 # semi-global: starts at row 0 or column 0
    SEQUENCE_1_AND_2 = 4# global (NW): starts at the origin corner


class MatchType(enum.IntEnum):
    """Result of the Myers-Miller matching procedure
    (libmasaTypes.hpp:51-82)."""

    ALIGNED = 0
    GAPPED = 1
    ERROR_SUM_MATCH = -1
    ERROR_SUM_GAP = -2


class Crosspoint(NamedTuple):
    """A coordinate where the optimal alignment crosses a cut.

    `score` is the remaining alignment score from the origin up to this
    crosspoint, stored WITHOUT the +gap_open adjustment when type != MATCH
    (the consumer re-adds it; see stage2/sw_stage2.cpp:369-372).
    """

    i: int
    j: int
    score: int
    type: int = CrosspointType.MATCH

    def reversed(self, m: int, n: int) -> "Crosspoint":
        """Mirror through the matrix center (CrosspointsFile::reverse)."""
        return Crosspoint(m - self.i, n - self.j, self.score, self.type)

    def transposed(self) -> "Crosspoint":
        t = self.type
        if t == CrosspointType.GAP_1:
            t = CrosspointType.GAP_2
        elif t == CrosspointType.GAP_2:
            t = CrosspointType.GAP_1
        return Crosspoint(self.j, self.i, self.score, t)


class MatchResult(NamedTuple):
    found: bool
    k: int
    score: int
    type: int


class BestScore(NamedTuple):
    """A best-score candidate (score_t in libmasaTypes.hpp:88)."""

    i: int
    j: int
    score: int


@dataclasses.dataclass(frozen=True)
class ScoreParams:
    """Match/mismatch and affine gap penalties (libmasaTypes.hpp:100-107).

    `gap_open` and `gap_ext` are stored positive; a gap of length k costs
    gap_open + k*gap_ext (the first gap cell costs open+ext, matching the
    reference kernel's E/F recurrence in CUDAligner.cu:280-281).
    """

    match: int = 1
    mismatch: int = -3
    gap_open: int = 3
    gap_ext: int = 2

    @property
    def gap_first(self) -> int:
        """Cost of the first cell of a gap (open + ext)."""
        return self.gap_open + self.gap_ext


@dataclasses.dataclass(frozen=True)
class Partition:
    """A rectangle (i0,j0)-(i1,j1), end-exclusive on cells consumed
    (libmasa/Partition.hpp:25-96)."""

    i0: int
    j0: int
    i1: int
    j1: int

    @property
    def height(self) -> int:
        return self.i1 - self.i0

    @property
    def width(self) -> int:
        return self.j1 - self.j0

    def translated(self, di: int, dj: int) -> "Partition":
        return Partition(self.i0 + di, self.j0 + dj, self.i1 + di, self.j1 + dj)

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return f"({self.i0},{self.j0})-({self.i1},{self.j1})"
