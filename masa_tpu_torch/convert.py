"""State carried between masa_tpu and the port, as plain values.

The port keeps its own copy of masa_tpu's value types, so a value of
one package is not a value of the other (``masa_tpu.types.ScoreParams()``
does not equal the port's).  ``to_port`` turns a masa_tpu value into the
port's and ``to_ref`` the other way, both through ``to_plain``: ints,
strings, lists and numpy arrays only.  They take ``ScoreParams``,
``Partition``, ``Crosspoint``, ``BestScore``, ``MatchResult``, the enums of
``types``, ``Sequence`` and ``Alignment``, and lists, tuples and dicts of
those.  This module imports nothing of masa_tpu, at import time or later:
``to_ref`` is handed masa_tpu's already imported ``types``,
``biology.sequence`` and ``biology.alignment`` modules by its caller.

``strip_config_from_jax`` maps the fields of a masa_tpu ``WavefrontConfig``
and ``ScoreParams`` (for example ``dataclasses.asdict`` of either) to a
``StripConfig``; ``special_rows_from_numpy`` and ``special_rows_to_numpy``
carry a stage-1 result's special rows across, so one package's stage 1
can feed the other's stage 2."""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from masa_tpu_torch.types import Recurrence
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


# kind -> fields, for the flat value types of ``types``
_FLAT = {
    "ScoreParams": ("match", "mismatch", "gap_open", "gap_ext"),
    "Partition": ("i0", "j0", "i1", "j1"),
    "Crosspoint": ("i", "j", "score", "type"),
    "BestScore": ("i", "j", "score"),
    "MatchResult": ("found", "k", "score", "type"),
}
_ENUMS = ("Recurrence", "InitType", "StartType", "CrosspointType",
          "AlignmentStart", "MatchType")
_ALIGNMENT = ("method", "match", "mismatch", "gap_open", "gap_ext",
              "raw_score", "matches", "mismatches", "gap_opens",
              "gap_extensions")


def to_plain(value):
    """``value`` of either package as plain data: a ``{"kind": ...}`` dict
    of ints, strings and numpy arrays for each value type, containers
    kept, anything else (ints, strings, arrays, None) as it is."""
    kind = type(value).__name__
    if isinstance(value, enum.Enum) and kind in _ENUMS:
        return {"kind": kind, "value": int(value)}
    if kind in _FLAT and hasattr(value, _FLAT[kind][0]):
        return {"kind": kind,
                **{f: to_plain(getattr(value, f)) for f in _FLAT[kind]}}
    if kind == "Sequence" and hasattr(value, "modifiers"):
        return {"kind": kind, "data": np.array(value._base, np.uint8),
                "info": dataclasses.asdict(value.info),
                "modifiers": dataclasses.asdict(value.modifiers)}
    if kind == "Alignment" and hasattr(value, "gaps"):
        return {"kind": kind,
                **{f: int(getattr(value, f)) for f in _ALIGNMENT},
                "sequences": [to_plain(s) for s in value.sequences],
                "start": [int(x) for x in value.start],
                "end": [int(x) for x in value.end],
                "gaps": [[(int(g.pos), int(g.len)) for g in side]
                         for side in value.gaps]}
    if isinstance(value, dict):
        return {k: to_plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_plain(v) for v in value)
    return value


def from_plain(plain, types, sequence, alignment):
    """The inverse of ``to_plain`` into the value types of one package,
    given as its imported ``types``, ``biology.sequence`` and
    ``biology.alignment`` modules."""

    def back(x):
        return from_plain(x, types, sequence, alignment)

    if isinstance(plain, dict) and "kind" in plain:
        kind = plain["kind"]
        if kind in _ENUMS:
            return getattr(types, kind)(plain["value"])
        if kind in _FLAT:
            return getattr(types, kind)(*(back(plain[f])
                                          for f in _FLAT[kind]))
        if kind == "Sequence":
            return sequence.Sequence(
                plain["data"], sequence.SequenceInfo(**plain["info"]),
                sequence.SequenceModifiers(**plain["modifiers"]))
        if kind == "Alignment":
            return alignment.Alignment(
                sequences=[back(s) for s in plain["sequences"]],
                **{f: plain[f] for f in _ALIGNMENT},
                start=list(plain["start"]), end=list(plain["end"]),
                gaps=[[alignment.GapRun(p, n) for p, n in side]
                      for side in plain["gaps"]])
        raise ValueError(f"unknown kind {kind!r}")
    if isinstance(plain, dict):
        return {k: back(v) for k, v in plain.items()}
    if isinstance(plain, (list, tuple)):
        return type(plain)(back(v) for v in plain)
    return plain


def to_port(value):
    """A masa_tpu value (or a container of them) as the port's."""
    from masa_tpu_torch import types
    from masa_tpu_torch.biology import alignment, sequence

    return from_plain(to_plain(value), types, sequence, alignment)


def to_ref(value, types, sequence, alignment):
    """A value of the port as masa_tpu's, whose imported ``types``,
    ``biology.sequence`` and ``biology.alignment`` modules the caller
    hands in."""
    return from_plain(to_plain(value), types, sequence, alignment)
