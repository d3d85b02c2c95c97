"""Taken from ``masa_tpu/core/grid.py`` (the JAX reference).

Grid: block decomposition of a partition.

Re-creation of the reference's Grid (libmasa/Grid.cpp:27-235): a partition
is cut into a lattice of blocks, either by fixed block height/width or by
even splits (AlignerUtils::splitBlocksEvenly, utils/AlignerUtils.cpp:38-45
— sizes differ by at most one).  Block aligners schedule whole blocks;
the pruning family indexes its state by (block row, block column).
"""

from __future__ import annotations

import numpy as np

from masa_tpu_torch.types import Partition


def split_evenly(total: int, count: int) -> list[int]:
    """Cut `total` into `count` cumulative split points with sizes
    differing by at most one (AlignerUtils::splitBlocksEvenly)."""
    count = max(1, min(count, total)) if total > 0 else 1
    base, rem = divmod(total, count)
    sizes = [base + (1 if k < rem else 0) for k in range(count)]
    out = [0]
    for s in sizes:
        out.append(out[-1] + s)
    return out


class Grid:
    """Block lattice over a partition (libmasa/Grid.cpp).

    Construct with either explicit split arrays (cumulative offsets,
    starting at 0 and ending at height/width) or block dimensions.
    """

    def __init__(self, partition: Partition,
                 splits_i: list[int] | None = None,
                 splits_j: list[int] | None = None):
        self.partition = partition
        self.splits_i = splits_i or [0, partition.height]
        self.splits_j = splits_j or [0, partition.width]
        assert self.splits_i[0] == 0 and self.splits_i[-1] == partition.height
        assert self.splits_j[0] == 0 and self.splits_j[-1] == partition.width

    @classmethod
    def with_block_size(cls, partition: Partition, block_height: int,
                        block_width: int) -> "Grid":
        """Fixed block dimensions; the last row/column of blocks is the
        remainder."""
        si = list(range(0, partition.height, block_height))
        si.append(partition.height)
        sj = list(range(0, partition.width, block_width))
        sj.append(partition.width)
        return cls(partition, _dedup(si), _dedup(sj))

    @classmethod
    def with_block_count(cls, partition: Partition, nbi: int,
                         nbj: int) -> "Grid":
        """Even splits into nbi x nbj blocks (splitGridHorizontally/
        Vertically, Grid.cpp:97-138)."""
        return cls(partition, split_evenly(partition.height, nbi),
                   split_evenly(partition.width, nbj))

    @property
    def nbi(self) -> int:
        return len(self.splits_i) - 1

    @property
    def nbj(self) -> int:
        return len(self.splits_j) - 1

    def block(self, bi: int, bj: int) -> Partition:
        """The block's rectangle in absolute (super-partition) coordinates
        (Grid::getBlockPosition, Grid.cpp:181)."""
        p = self.partition
        return Partition(
            p.i0 + self.splits_i[bi], p.j0 + self.splits_j[bj],
            p.i0 + self.splits_i[bi + 1], p.j0 + self.splits_j[bj + 1],
        )

    def block_of(self, i: int, j: int) -> tuple[int, int]:
        """Block indices containing absolute cell (i, j)."""
        p = self.partition
        bi = int(np.searchsorted(self.splits_i, i - p.i0, "right")) - 1
        bj = int(np.searchsorted(self.splits_j, j - p.j0, "right")) - 1
        return min(max(bi, 0), self.nbi - 1), min(max(bj, 0), self.nbj - 1)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Grid({self.nbi}x{self.nbj} over {self.partition})"


def _dedup(xs: list[int]) -> list[int]:
    out = [xs[0]]
    for x in xs[1:]:
        if x != out[-1]:
            out.append(x)
    return out
