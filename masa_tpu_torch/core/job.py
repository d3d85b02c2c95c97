"""The run state of a persistent alignment, for the port.

masa_tpu's ``core/job.Job`` (work directory, status file, crosspoint
files, flush ladder, info check) is host code and the port reuses it.
This subclass adds the device the stages run on, and opens the port's
special rows areas (``core/sra``), whose packed rows decode without
JAX."""

from __future__ import annotations

from masa_tpu.core import job as _ref
from masa_tpu.core.crosspoints import CrosspointsFile
from masa_tpu.core.job import JobConfig
from masa_tpu_torch.core.sra import SpecialRowsArea
from masa_tpu_torch.utils.devices import resolve_device

# the work directory's crosspoint files (``Job.crosspoints_file``)
__all__ = ["CrosspointsFile", "Job", "JobConfig"]


class Job(_ref.Job):
    def __init__(self, cfg: JobConfig, seq0_fingerprint: str = "",
                 seq1_fingerprint: str = "", device="cuda"):
        """``device``: "cuda" (raises when no GPU is present) or "cpu"."""
        self.device = str(resolve_device(device))
        super().__init__(cfg, seq0_fingerprint, seq1_fingerprint)

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
