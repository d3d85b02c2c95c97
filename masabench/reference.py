"""The plain reference: local alignment with affine gaps (Smith-Waterman
with Gotoh's three matrices), row by row, in plain PyTorch, and the
re-scoring of an alignment path in NumPy.

It imports numpy and torch only: nothing of the program, and no JAX.  It is
handed the sequences and the configuration's scores, never anything the
program derived from them.

Scores: a gap of k bases costs ``gap_open + k * gap_ext``; a column of two
bases scores ``match`` where they are equal, else ``mismatch``.  The best
cell is the largest H; of equal ones the first in row-major order (the
earlier row, then the earlier column), in the matrix's 1-based coordinates
(row i covers s0's i-th base).

Row i from row i-1, with j the 0-based column of the row's arrays:

    F[j]  = max(F[j] - ext, H[i-1][j+1] - open - ext)       (vertical gap)
    P[j]  = max(0, H[i-1][j] + sub(s0[i], s1[j]), F[j])
    E[j]  = max over k < j of P[k] - open - ext * (j - k)    (horizontal gap)
    H[i][j+1] = max(P[j], E[j])

E is taken from P, not from H: a gap that opens after a horizontal gap is
never better than the same gap extended (open >= 0).  ``max over k < j``
is a prefix maximum of ``P[k] + ext * k``, taken in three levels of
``torch.cummax``.  On a CUDA device the rows run in chunks captured once
as a CUDA graph, so the host issues a chunk, not a kernel.

``dtype`` is the cells' integer type: int32 is exact at the benchmark's
sizes (scores stay below 2^31); the control computes in int16, which
wraps."""

from __future__ import annotations

import numpy as np
import torch

GAP = ord("-")


class _Rows:
    """The state of one pass: the last ``chunk`` rows of H, F, scratch,
    and per column the best value and the first row that reached it."""

    def __init__(self, s0, s1, scores, dev, dtype, chunk):
        m, n = len(s0), len(s1)
        self.m, self.n, self.chunk = m, n, chunk
        self.go, self.ge = scores["gap_open"], scores["gap_ext"]
        self.neg = torch.iinfo(dtype).min // 4
        codes, inv = np.unique(s0, return_inverse=True)
        b = torch.from_numpy(np.array(s1, np.uint8)).to(dev)
        # one profile row per distinct base of s0: sub(base, s1[j])
        self.prof = torch.stack(
            [torch.where(b == int(c), scores["match"], scores["mismatch"])
             for c in codes]).to(dtype)
        self.rowcode = torch.from_numpy(inv.astype(np.int64).ravel()).to(dev)
        w = 8
        while w ** 3 < n:
            w *= 2
        self.w = w
        npad = -(-n // (w * w)) * (w * w)
        full = lambda *shape: torch.full(shape, self.neg, dtype=dtype,
                                         device=dev)
        self.buf = torch.zeros(chunk + 1, n + 1, dtype=dtype, device=dev)
        self.F = full(n)
        self.D = full(n)
        self.T = full(n)
        self.S = full(1, n)
        self.K = full(npad)  # the padding stays at neg
        self.E = full(n)     # E[0] stays at neg: no column left of it
        self.v1 = full(npad // w, w)
        self.i1 = torch.zeros(npad // w, w, dtype=torch.long, device=dev)
        self.c1 = full(npad // w)
        self.v2 = full(npad // (w * w), w)
        self.i2 = torch.zeros(npad // (w * w), w, dtype=torch.long,
                              device=dev)
        self.v3 = full(npad // (w * w))
        self.i3 = torch.zeros(npad // (w * w), dtype=torch.long, device=dev)
        ar = torch.arange(n, device=dev, dtype=torch.long)
        self.extj = (self.ge * ar).to(dtype)
        self.oec = (self.go + self.ge * ar).to(dtype)
        self.bestv = full(n)
        self.besti = torch.zeros(n, dtype=torch.int32, device=dev)
        self.base = torch.zeros(1, dtype=torch.int32, device=dev)
        self.rowidx = torch.arange(chunk, dtype=torch.int32,
                                   device=dev).view(chunk, 1)
        self.cm = full(n)

    def _prefix_max(self):
        """Inclusive prefix maximum of K, in v1 (flattened)."""
        w = self.w
        torch.cummax(self.K.view(-1, w), 1, out=(self.v1, self.i1))
        self.c1.copy_(self.v1[:, -1])
        torch.cummax(self.c1.view(-1, w), 1, out=(self.v2, self.i2))
        torch.cummax(self.v2[:, -1], 0, out=(self.v3, self.i3))
        torch.maximum(self.v2[1:], self.v3[:-1, None], out=self.v2[1:])
        v2 = self.v2.view(-1)
        torch.maximum(self.v1[1:], v2[:-1, None], out=self.v1[1:])
        return self.v1.view(-1)

    def row(self, prev, cur, code):
        n = self.n
        torch.index_select(self.prof, 0, code, out=self.S)
        torch.add(prev[:-1], self.S[0], out=self.D)
        torch.sub(prev[1:], self.go + self.ge, out=self.T)
        self.F.sub_(self.ge)
        torch.maximum(self.F, self.T, out=self.F)
        torch.maximum(self.D, self.F, out=self.D)
        self.D.clamp_(min=0)
        torch.add(self.D, self.extj, out=self.K[:n])
        pm = self._prefix_max()
        torch.sub(pm[:n - 1], self.oec[1:], out=self.E[1:])
        torch.maximum(self.D, self.E, out=cur[1:])

    def rows(self, codes, g):
        """``g`` rows (``codes``: their bases' profile rows), then their
        maxima folded into the per-column bests."""
        for r in range(1, g + 1):
            self.row(self.buf[r - 1], self.buf[r], codes[r - 1:r])
        blk = self.buf[1:g + 1, 1:]
        torch.amax(blk, 0, out=self.cm)
        first = torch.where(blk == self.cm, self.rowidx[:g], g).amin(0)
        upd = self.cm > self.bestv
        torch.where(upd, first + self.base + 1, self.besti, out=self.besti)
        torch.maximum(self.bestv, self.cm, out=self.bestv)
        self.base.add_(g)
        self.buf[0].copy_(self.buf[g])

    def best(self):
        v = self.bestv.max()
        cols = torch.nonzero(self.bestv == v).flatten()
        rows = self.besti[cols]
        i = rows.min()
        j = cols[rows == i].min()
        return int(v), int(i), int(j) + 1


def sw_best(s0: np.ndarray, s1: np.ndarray, scores: dict, device="cpu",
            dtype=torch.int32, chunk: int = 64) -> tuple[int, int, int]:
    """(best score, i, j) of the local alignment of s0 (rows) and s1
    (columns): the first best cell in row-major order, 1-based."""
    dev = torch.device(device)
    st = _Rows(s0, s1, scores, dev, dtype, chunk)
    full = st.m // chunk
    with torch.no_grad():
        if dev.type == "cuda" and full >= 3:
            codes2d = st.rowcode[:full * chunk].view(full, chunk)
            idx = torch.zeros(1, dtype=torch.long, device=dev)
            cur = torch.empty(1, chunk, dtype=torch.long, device=dev)

            def step():
                torch.index_select(codes2d, 0, idx, out=cur)
                idx.add_(1)
                st.rows(cur[0], chunk)

            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                step()  # two chunks eagerly before the capture
                step()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()  # captured, not run
            for _ in range(full - 2):
                graph.replay()
        else:
            for k in range(full):
                st.rows(st.rowcode[k * chunk:(k + 1) * chunk], chunk)
        tail = st.m - full * chunk
        if tail:
            st.rows(st.rowcode[full * chunk:], tail)
        return st.best()


def expand(seq: np.ndarray, start: int, end: int, runs) -> np.ndarray:
    """The gapped row of one side: ``seq[start-1:end]`` with ``n`` gap
    characters before each 1-based position ``pos`` of ``runs``, a list of
    (pos, n)."""
    out, p = [], start
    for pos, k in sorted(runs):
        if not start <= pos <= end + 1:
            raise ValueError(f"gap at {pos} outside [{start}, {end + 1}]")
        out.append(seq[p - 1:pos - 1])
        out.append(np.full(k, GAP, np.uint8))
        p = pos
    out.append(seq[p - 1:end])
    return np.concatenate(out)


def judge_path(s0, s1, start, end, row0, row1, scores) -> dict:
    """An alignment path as its two gapped rows, from ``start`` to ``end``
    (1-based, inclusive), judged against the sequences.  ``score``: the
    path's score under ``scores``, worked out from the rows alone.
    ``faults``: columns of two gaps, bases that differ from the
    sequences' at the path's positions, and the difference in length where
    the rows do not cover the sequences' spans."""
    row0 = np.asarray(row0, np.uint8)
    row1 = np.asarray(row1, np.uint8)
    faults = abs(len(row0) - len(row1))
    k = min(len(row0), len(row1))
    row0, row1 = row0[:k], row1[:k]
    g0, g1 = row0 == GAP, row1 == GAP
    faults += int((g0 & g1).sum())
    for row, g, seq, a, b in ((row0, g0, s0, start[0], end[0]),
                              (row1, g1, s1, start[1], end[1])):
        bases = row[~g]
        span = seq[max(a - 1, 0):b]
        faults += abs(len(bases) - len(span))
        k = min(len(bases), len(span))
        faults += int((bases[:k] != span[:k]).sum())
    both = ~g0 & ~g1
    matches = int((both & (row0 == row1)).sum())
    mismatches = int(both.sum()) - matches

    def opens(g):
        return int(g[0]) + int((np.diff(g.astype(np.int8)) == 1).sum()) \
            if len(g) else 0

    score = (matches * scores["match"] + mismatches * scores["mismatch"]
             - (opens(g0) + opens(g1)) * scores["gap_open"]
             - int(g0.sum() + g1.sum()) * scores["gap_ext"])
    return {"score": score, "faults": faults}
