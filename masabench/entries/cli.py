"""The command line as a user runs it: ``masa_tpu_torch.cli.main(argv)``
in-process, one job at a time, each on its pair's FASTA files (written
before its job, off the clock) and with a fresh work directory.

The configuration's ``cli_options`` name its keys that go on the command
line (``ram_size`` as ``--ram-size``; ``true`` as the bare flag), after
the scores; the traffic mix's ``cli_flags`` follow them."""

from __future__ import annotations

import contextlib
import io
import os
import re
import shutil

import numpy as np

from masabench import pairs

STAGES = [("masa_tpu_torch.stages.runner", f"stage{k}", f"stage{k}")
          for k in range(1, 7)]
SCORE_FLAGS = ("match", "mismatch", "gap_open", "gap_ext")

_STAGE1 = re.compile(r"stage1: best=(-?\d+) at \((\d+),(\d+)\)")
_BEST = re.compile(r"best score: (-?\d+) at \((\d+),(\d+)\)")
_FINAL = re.compile(r"alignment score: (-?\d+)")


class _Tap(io.TextIOBase):
    """What the program prints, kept as lines."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, s):
        self._part += s
        *done, self._part = self._part.split("\n")
        self.lines.extend(done)
        return len(s)


def _flag(key):
    return "--" + key.replace("_", "-")


class Entry:
    stages = STAGES

    def __init__(self, run):
        self.run = run
        cfg, traffic = run.config, run.traffic
        if traffic["mode"] not in ("full", "score"):
            raise ValueError(f"the CLI has no mode {traffic['mode']!r}")
        self.full = traffic["mode"] == "full"
        args = []
        for key in SCORE_FLAGS:
            args += [_flag(key), str(cfg[key])]
        for key in cfg.get("cli_options", []):
            v = cfg[key]
            args += [_flag(key)] if v is True else [_flag(key), str(v)]
        self.args = args + list(traffic.get("cli_flags", []))

    def _write(self, s0, s1, name):
        paths = []
        for k, seq in enumerate((s0, s1)):
            path = os.path.join(self.run.tmp, f"{name}.{k}.fa")
            pairs.write_fasta(path, f"{name}-s{k} seed {self.run.seed}", seq)
            paths.append(path)
        return paths

    def _work(self, k):
        return os.path.join(self.run.tmp, f"work.{k}")

    def _main(self, fasta, work):
        from masa_tpu_torch import cli

        tap = _Tap()
        argv = fasta + ["--work-dir", work, "--device",
                        str(self.run.device)] + self.args
        with contextlib.redirect_stdout(tap):
            rc = cli.main(argv)
        if rc != 0:
            raise RuntimeError(f"the CLI exited with {rc}")
        return tap.lines

    def warm_up(self, s0, s1):
        work = self._work("warm")
        self._main(self._write(s0, s1, "warm"), work)
        shutil.rmtree(work)

    def prepare(self, k):
        self.fasta = self._write(*self.run.pair(k), f"pair.{k}")

    def pair(self, k):
        self._lines = self._main(self.fasta, self._work(k))

    def collect(self, k) -> dict:
        """The answer of pair k, read from what the CLI printed and, for a
        full alignment, the stage-6 text its work directory holds; then
        the work directory goes."""
        work = self._work(k)
        lines = self._lines
        ans = {"scores": [], "ends": []}
        for line in lines:
            for rx in (_STAGE1, _BEST):
                if m := rx.match(line):
                    ans["scores"].append(int(m[1]))
                    ans["ends"].append((int(m[2]), int(m[3])))
            if m := _FINAL.match(line):
                ans["scores"].append(int(m[1]))
        if self.full:
            ans["path"] = read_text(os.path.join(work, "alignment.00.txt"))
            ans["scores"].append(ans["path"].pop("score"))
        shutil.rmtree(work)
        for path in self.fasta:
            os.remove(path)
        return ans

    def close(self):
        pass


def read_text(path: str) -> dict:
    """Stage 6's text rendering: the stated score, and the path as its two
    gapped rows with their 1-based first and last positions."""
    rows = {"Seq0:": [], "Seq1:": []}
    first, last = {}, {}
    score = None
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if parts[:1] == ["Score:"]:
                score = int(parts[1])
            elif parts and parts[0] in rows and len(parts) == 4:
                side = parts[0]
                first.setdefault(side, int(parts[1]))
                last[side] = int(parts[3])
                rows[side].append(parts[2])
    row0 = np.frombuffer("".join(rows["Seq0:"]).encode(), np.uint8)
    row1 = np.frombuffer("".join(rows["Seq1:"]).encode(), np.uint8)
    return {"score": score, "start": (first["Seq0:"], first["Seq1:"]),
            "end": (last["Seq0:"], last["Seq1:"]), "rows": (row0, row1)}
