"""The manager side of the aligner contract, for the port.

``masa_tpu.core.manager.AlignerManager`` is host code, but two of its
methods reach JAX at run time: ``_col_borders`` imports
``masa_tpu.stages.core`` (and so ``ops/wavefront`` and ``jax``) on every
special-row dispatch, and ``dispatch_last_row_device`` imports
``jax.numpy``.  This subclass replaces both, so the port's dispatch funnel
never imports JAX."""

from __future__ import annotations

import numpy as np

from masa_tpu.core import manager as _ref
from masa_tpu.models.scoring import border_cells
from masa_tpu.types import InitType


class AlignerManager(_ref.AlignerManager):
    def _col_borders(self, height: int):
        """Column-border H for rows 0..height and the synthesized gap
        values along it (stages.core.border_gap_values)."""
        if self._col_h_cache is None or len(self._col_h_cache) <= height:
            from masa_tpu_torch.stages.core import border_gap_values

            if self.first_col_init == InitType.CUSTOM:
                col_h = np.asarray(self._first_col[0], np.int64)
            else:
                col_h, _ = border_cells(height + 1, self.first_col_init,
                                        self.params)
                col_h = col_h.astype(np.int64)
            self._col_h_cache = col_h
            self._col_f_syn = border_gap_values(col_h, self.params)
        return self._col_h_cache, self._col_f_syn

    def dispatch_last_row_device(self, row: int, bus_h, bus_f) -> None:
        """Device-side goal matching is not ported: the port matches the
        pulled last row on the host (dispatch_last_row)."""
        raise NotImplementedError(
            "masa_tpu_torch matches the reverse pass's last row on the "
            "host; device goal matching is not ported")
