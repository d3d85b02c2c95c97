"""Taken from ``masa_tpu/core/blocks_file.py`` (the JAX reference).

Block-score dumps for pruning visualization (--dump-blocks,
common/BlocksFile.cpp:27-80): a binary grid of per-(strip, chunk) maxima,
renderable by the stage-6 SVG plot."""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"MBLK"


class BlocksFile:
    def __init__(self, path: str):
        self.path = path
        self.rows: list[np.ndarray] = []

    def add_row(self, chunk_maxima: np.ndarray) -> None:
        self.rows.append(np.asarray(chunk_maxima, np.int32))

    def save(self) -> None:
        grid = np.stack(self.rows) if self.rows else np.zeros(
            (0, 0), np.int32
        )
        with open(self.path, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<qq", *grid.shape))
            f.write(grid.tobytes())

    @classmethod
    def load(cls, path: str) -> np.ndarray:
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:4] != MAGIC:
            raise IOError("not a blocks file")
        h, w = struct.unpack_from("<qq", raw, 4)
        return np.frombuffer(raw, np.int32, h * w, offset=20).reshape(h, w)

    def reduce(self, out_h: int, out_w: int) -> np.ndarray:
        """Downsample for plotting (BlocksFile::reduceData)."""
        grid = np.stack(self.rows)
        h, w = grid.shape
        ys = np.linspace(0, h, out_h + 1).astype(int)
        xs = np.linspace(0, w, out_w + 1).astype(int)
        out = np.zeros((out_h, out_w), np.int32)
        for a in range(out_h):
            for b in range(out_w):
                cell = grid[ys[a]:max(ys[a + 1], ys[a] + 1),
                            xs[b]:max(xs[b + 1], xs[b] + 1)]
                if cell.size:
                    out[a, b] = cell.max()
        return out
