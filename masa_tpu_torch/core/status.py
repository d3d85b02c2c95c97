"""Taken from ``masa_tpu/core/status.py`` (the JAX reference).

Crash-safe run status file (common/Status.cpp:27-105): current stage,
last flushed special row, best score — the resume anchor.  Writes go
through tmp+rename so a crash never leaves a torn file.  Each write is
the trace span ``status.save`` of the stage it runs in."""

from __future__ import annotations

import json
import os

from masa_tpu_torch.utils import trace


class Status:
    def __init__(self, path: str):
        self.path = path
        self.stage = 0
        self.last_special_row = -1
        self.best = (0, 0, 0)  # (i, j, score)
        if os.path.exists(path):
            self.load()

    def load(self) -> None:
        with open(self.path) as f:
            d = json.load(f)
        self.stage = d["stage"]
        self.last_special_row = d["last_special_row"]
        self.best = tuple(d["best"])

    def save(self) -> None:
        tmp = self.path + ".tmp"
        with trace.span("status.save"):
            with open(tmp, "w") as f:
                json.dump({
                    "stage": self.stage,
                    "last_special_row": self.last_special_row,
                    "best": list(self.best),
                }, f)
            os.replace(tmp, self.path)

    def update(self, stage: int | None = None,
               last_special_row: int | None = None,
               best: tuple | None = None) -> None:
        if stage is not None:
            self.stage = stage
        if last_special_row is not None:
            self.last_special_row = last_special_row
        if best is not None:
            self.best = best
        self.save()
