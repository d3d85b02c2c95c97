"""Taken from ``masa_tpu/core/job.py`` (the JAX reference).  ``Job``
also carries the device the stages run on.

Job: run state, work directory layout, flush-interval ladder, resume
detection (common/Job.cpp).

Work dir layout (Job.cpp:118-146):
    work.tmp/
      info                       sequence fingerprint (mismatch detection)
      status                     crash-safe progress
      crosspoints/crosspoint_SS.II[.rDD]
      special_rows/stage.SS.II[.rDD]/   (SRA areas)
      statistics_SS.II           per-stage stats
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

from masa_tpu_torch.core.crosspoints import CrosspointsFile
from masa_tpu_torch.core.sra import SpecialRowsArea
from masa_tpu_torch.core.status import Status
from masa_tpu_torch.types import AlignmentStart, ScoreParams
from masa_tpu_torch.utils.devices import resolve_device


@dataclasses.dataclass
class JobConfig:
    work_dir: str = "work.tmp"
    ram_limit: int = 1 << 30
    disk_limit: int = 16 << 30
    flush_deepness: int = 7
    alignment_start: AlignmentStart = AlignmentStart.ANYWHERE
    # None mirrors alignment_start (the classic SW/NW pairings)
    alignment_end: AlignmentStart | None = None
    params: ScoreParams = dataclasses.field(default_factory=ScoreParams)
    max_alignments: int = 1
    clear: bool = False
    stage4_max_partition: int = 16
    stage4_strategy: str = "OPTIMIZED"  # ORIGINAL_MM / ORTHOGONAL / OPTIMIZED
    stage5_max_cells: int = 1 << 18
    backend: str = "auto"
    block_pruning: bool = True
    # SRA row compression: none / 8bit / 4bit / vlc (io/rowcodec.py)
    sra_compression: str = "none"
    # --dump-blocks: persist the per-(strip, chunk) score grid
    dump_blocks: bool = False
    # near-duplicate suppression radius for multi-alignment runs
    best_score_distance: int = 64


class Job:
    def __init__(self, cfg: JobConfig, seq0_fingerprint: str = "",
                 seq1_fingerprint: str = "", device="cuda"):
        """``device``: "cuda" (raises when no GPU is present) or "cpu"."""
        self.device = str(resolve_device(device))
        # stage 1's special rows on the device, for the same call's stage
        # 2 (stages/runner)
        self.runtime_dev_rows = None
        self.cfg = cfg
        self.dir = cfg.work_dir
        if cfg.clear and os.path.isdir(self.dir):
            shutil.rmtree(self.dir)
        os.makedirs(self.dir, exist_ok=True)
        os.makedirs(self.path("crosspoints"), exist_ok=True)
        os.makedirs(self.path("special_rows"), exist_ok=True)
        os.makedirs(self.path("shared"), exist_ok=True)
        self._check_info(seq0_fingerprint, seq1_fingerprint)
        self.status = Status(self.path("status"))
        self.flush_intervals: list[int] = []
        # areas are cached so RAM-placed special rows survive across
        # stage boundaries within the process (the reference's Job owns
        # its areas for the same reason, Job.cpp:202-211)
        self._sra_areas: dict[str, SpecialRowsArea] = {}

    def path(self, *parts: str) -> str:
        return os.path.join(self.dir, *parts)

    def _check_info(self, f0: str, f1: str) -> None:
        """Detect sequence mismatch across resumed runs (Job.cpp:69-92)."""
        info_path = self.path("info")
        info = {"seq0": f0, "seq1": f1}
        if os.path.exists(info_path):
            with open(info_path) as f:
                old = json.load(f)
            if old != info:
                raise RuntimeError(
                    "work directory belongs to a different sequence pair; "
                    "use --clear"
                )
        else:
            with open(info_path, "w") as f:
                json.dump(info, f)

    # --- flush ladder (Job::calculateFlushIntervals, Job.cpp:231-265) ----

    def calculate_flush_intervals(self, m: int, n: int,
                                  align_to: int = 1) -> list[int]:
        """interval_0 = m*n*8/limit + 1, then geometric decay per deep so
        each traceback stage sees denser special rows."""
        limit = self.cfg.ram_limit + self.cfg.disk_limit
        iv = m * n * 8 // max(limit, 1) + 1
        iv = max(((iv + align_to - 1) // align_to) * align_to, align_to)
        out = [iv]
        for _ in range(1, self.cfg.flush_deepness):
            iv = max(iv // 8, 1)
            out.append(iv)
        self.flush_intervals = out
        return out

    def flush_interval(self, deep: int) -> int:
        if not self.flush_intervals:
            raise RuntimeError("flush intervals not calculated")
        return self.flush_intervals[min(deep, len(self.flush_intervals) - 1)]

    def sra_limit(self) -> int:
        return self.cfg.ram_limit + self.cfg.disk_limit

    # --- named artifacts -------------------------------------------------

    def crosspoints_file(self, stage: int, aln_id: int,
                         deep: int | None = None) -> CrosspointsFile:
        name = f"crosspoint_{stage:02d}.{aln_id:02d}"
        if deep is not None:
            name += f".r{deep:02d}"
        return CrosspointsFile(self.path("crosspoints", name))

    def sra_area(self, stage: int, aln_id: int,
                 deep: int | None = None) -> SpecialRowsArea:
        name = f"stage.{stage:02d}.{aln_id:02d}"
        if deep is not None:
            name += f".r{deep:02d}"
        if name not in self._sra_areas:
            self._sra_areas[name] = SpecialRowsArea(
                self.path("special_rows", name),
                ram_limit=self.cfg.ram_limit,
                disk_limit=self.cfg.disk_limit,
                codec=self.cfg.sra_compression,
            )
        return self._sra_areas[name]

    def clear_sra_area(self, stage: int, aln_id: int,
                       deep: int | None = None) -> None:
        name = f"stage.{stage:02d}.{aln_id:02d}"
        if deep is not None:
            name += f".r{deep:02d}"
        self._sra_areas.pop(name, None)
        p = self.path("special_rows", name)
        if os.path.isdir(p):
            shutil.rmtree(p)

    def stats_file(self, stage: int, aln_id: int):
        return open(self.path(f"statistics_{stage:02d}.{aln_id:02d}"), "w")
