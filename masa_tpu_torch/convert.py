"""State carried between masa_tpu and the port, as plain values.

``strip_config_from_jax`` maps the fields of a masa_tpu ``WavefrontConfig``
and ``ScoreParams`` (for example ``dataclasses.asdict`` of either) to a
``StripConfig``; ``special_rows_from_numpy`` and ``special_rows_to_numpy``
carry a stage-1 result's special rows across, so one package's stage 1
can feed the other's stage 2."""

from __future__ import annotations

import numpy as np

from masa_tpu.types import Recurrence
from masa_tpu_torch.ops.wavefront import StripConfig
from masa_tpu_torch.stages.core import SpecialRowStore

# WavefrontConfig fields that describe the TPU kernel's layout and tuning
# only; heights, widths and the flush cadence are runtime values here.
_TPU_LAYOUT = {"chunk", "interpret", "unroll", "track_pos", "flush_every"}
_SCORING = {"match", "mismatch", "gap_open", "gap_ext", "track_best",
            "store_lastcol"}


def strip_config_from_jax(fields: dict) -> StripConfig:
    """A StripConfig from masa_tpu config fields.  ``alpha``/``rs`` (the
    TPU strip of alpha*rs*128 rows) become the strip height."""
    unknown = set(fields) - _TPU_LAYOUT - _SCORING - {
        "alpha", "rs", "recurrence"}
    if unknown:
        raise KeyError(f"not masa_tpu config fields: {sorted(unknown)}")
    kw = {k: fields[k] for k in _SCORING if k in fields}
    if "recurrence" in fields:
        kw["recurrence"] = Recurrence(fields["recurrence"])
    if "alpha" in fields or "rs" in fields:
        rows = fields.get("alpha", 4) * fields.get("rs", 8) * 128
        kw["rows"] = rows
    return StripConfig(**kw)


def special_rows_from_numpy(rows: dict) -> SpecialRowStore:
    """{row: (h, f)} of (n+1,) arrays -> the port's SpecialRowStore."""
    store = SpecialRowStore()
    for r, (h, f) in rows.items():
        store.put(int(r), np.asarray(h, np.int64), np.asarray(f, np.int64))
    return store


def special_rows_to_numpy(store) -> dict:
    """Any special-row store (masa_tpu's or the port's) -> {row: (h, f)}
    of int64 numpy arrays."""
    out = {}
    for r in store.rows():
        h, f = store.get(r)
        out[int(r)] = (np.asarray(h, np.int64), np.asarray(f, np.int64))
    return out
