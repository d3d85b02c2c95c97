"""Taken from ``masa_tpu/core/crosspoints.py`` (the JAX reference).

Crosspoints file: text format compatible with the reference's
CrosspointsFile (common/CrosspointsFile.cpp:101-106):

    START
    type,i,j,score
    ...
    END

with crash-safe tmp+rename writes and incremental autosave.  Each
autosaved append is the trace span ``cps.write`` of the stage it runs in.
"""

from __future__ import annotations

import os

from masa_tpu_torch.types import Crosspoint
from masa_tpu_torch.utils import trace


class CrosspointsFile:
    def __init__(self, path: str):
        self.path = path
        self.crosspoints: list[Crosspoint] = []
        self._autosave = False
        self._fh = None

    def set_autosave(self) -> None:
        """Append incrementally as crosspoints are written (the reference's
        setAutoSave); the END sentinel is added on close."""
        self._autosave = True
        self._fh = open(self.path, "w")
        self._fh.write("START\n")
        self._fh.flush()

    def write(self, cp: Crosspoint) -> None:
        self.crosspoints.append(cp)
        if self._fh:
            with trace.span("cps.write"):
                self._fh.write(f"{int(cp.type)},{cp.i},{cp.j},{cp.score}\n")
                self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.write("END\n")
            self._fh.close()
            self._fh = None
        elif self.crosspoints:
            self.save()

    def save(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write("START\n")
            for cp in self.crosspoints:
                f.write(f"{int(cp.type)},{cp.i},{cp.j},{cp.score}\n")
            f.write("END\n")
        os.replace(tmp, self.path)

    def load(self) -> list[Crosspoint]:
        self.crosspoints = []
        with open(self.path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        if not lines or lines[0] != "START":
            raise ValueError(f"corrupt crosspoints file {self.path}")
        complete = lines[-1] == "END"
        body = lines[1:-1] if complete else lines[1:]
        for ln in body:
            t, i, j, s = (int(x) for x in ln.split(","))
            self.crosspoints.append(Crosspoint(i, j, s, t))
        self.complete = complete
        return self.crosspoints

    def reversed_(self, m: int, n: int) -> list[Crosspoint]:
        return [c.reversed(m, n) for c in reversed(self.crosspoints)]

    def largest_partition(self) -> int:
        best = 0
        for a, b in zip(self.crosspoints, self.crosspoints[1:]):
            best = max(best, max(abs(b.i - a.i), abs(b.j - a.j)))
        return best
