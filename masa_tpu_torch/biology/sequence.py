"""Taken from ``masa_tpu/biology/sequence.py`` (the JAX reference).

Sequences: FASTA loading, modifiers (trim/reverse/complement/clear-N),
and views.

Mirrors the reference biology layer's behavior (SequenceData.cpp:40-135,
Sequence.cpp:98-147, SequenceModifiers.cpp) with NumPy storage; a C++
fast path for FASTA parsing lives in masa_tpu.native (optional).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

_COMPLEMENT = np.arange(256, dtype=np.uint8)
for a, b in [(ord("A"), ord("T")), (ord("C"), ord("G")),
             (ord("G"), ord("C")), (ord("T"), ord("A"))]:
    _COMPLEMENT[a] = b

_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a"): ord("z") + 1] = np.arange(ord("A"), ord("Z") + 1,
                                           dtype=np.uint8)


@dataclasses.dataclass
class SequenceModifiers:
    """Reference: SequenceModifiers.cpp / CGFF flags
    (Constants.hpp:26-28)."""

    clear_n: bool = False
    complement: bool = False
    reverse: bool = False
    trim_start: int = 0  # 1-based inclusive; 0 = no trim
    trim_end: int = 0    # 1-based inclusive; 0 = no trim

    @property
    def flags(self) -> int:
        return (
            (0x0001 if self.reverse else 0)
            | (0x0002 if self.complement else 0)
            | (0x0004 if self.clear_n else 0)
        )

    @classmethod
    def from_flags(cls, flags: int, trim_start: int, trim_end: int):
        return cls(
            clear_n=bool(flags & 0x0004),
            complement=bool(flags & 0x0002),
            reverse=bool(flags & 0x0001),
            trim_start=trim_start,
            trim_end=trim_end,
        )


@dataclasses.dataclass
class SequenceInfo:
    description: str = ""
    size: int = 0
    type: int = 1  # SEQUENCE_TYPE_DNA (Constants.hpp:30)
    filename: str = ""
    hash: str = ""


def parse_fasta(data: bytes) -> tuple[str, np.ndarray]:
    """Parse a single-record FASTA: returns (description, uppercase bytes).

    Like the reference loader (SequenceData.cpp:85-111): the first '>' line
    is the description; every residue is uppercased; whitespace removed.
    """
    if data[:1] == b">":
        nl = data.find(b"\n")
        if nl < 0:
            return data[1:].decode("ascii", "replace").strip(), np.empty(
                0, np.uint8
            )
        desc = data[1:nl].decode("ascii", "replace").strip()
        body = np.frombuffer(data, np.uint8, offset=nl + 1)
    else:
        desc = ""
        body = np.frombuffer(data, np.uint8)
    # strip all ASCII control/whitespace (<= ' ')
    body = body[body > 32]
    if (body >= ord("a")).any():
        body = _UPPER[body]
    return desc, np.ascontiguousarray(body)


def load_fasta(path: str) -> tuple[str, np.ndarray]:
    try:
        from masa_tpu_torch.native import bindings

        if bindings.available():
            return bindings.load_fasta(path)
    except Exception:
        pass
    with open(path, "rb") as f:
        return parse_fasta(f.read())


class Sequence:
    """A (possibly modified) view of sequence data.

    Forward and reverse copies are materialized lazily (the reference keeps
    both in RAM: SequenceData.cpp:58-65).
    """

    def __init__(
        self,
        data: np.ndarray,
        info: SequenceInfo | None = None,
        modifiers: SequenceModifiers | None = None,
    ):
        self._base = np.asarray(data, np.uint8)
        self.info = info or SequenceInfo(size=len(self._base))
        self.modifiers = modifiers or SequenceModifiers()
        if not self.info.size:
            self.info.size = len(self._base)
        self._cache: np.ndarray | None = None

    @classmethod
    def from_file(cls, path: str,
                  modifiers: SequenceModifiers | None = None) -> "Sequence":
        desc, data = load_fasta(path)
        info = SequenceInfo(
            description=desc,
            size=len(data),
            filename=os.path.basename(path),
            hash=hashlib.md5(data.tobytes()).hexdigest(),
        )
        return cls(data, info, modifiers)

    @property
    def trim_start(self) -> int:
        return self.modifiers.trim_start or 1

    @property
    def trim_end(self) -> int:
        return self.modifiers.trim_end or len(self._base)

    def __len__(self) -> int:
        return self.trim_end - self.trim_start + 1

    def data(self) -> np.ndarray:
        """The modified residue array (trim -> clear_n -> complement ->
        reverse, matching the reference's modifier order)."""
        if self._cache is not None:
            return self._cache
        d = self._base[self.trim_start - 1 : self.trim_end]
        if self.modifiers.clear_n:
            d = d.copy()
            d[d == ord("N")] = ord("\0")
        if self.modifiers.complement:
            d = _COMPLEMENT[d]
        if self.modifiers.reverse:
            d = d[::-1]
        self._cache = np.ascontiguousarray(d)
        return self._cache

    def reversed_view(self) -> "Sequence":
        mods = dataclasses.replace(
            self.modifiers, reverse=not self.modifiers.reverse
        )
        return Sequence(self._base, self.info, mods)

    def trimmed_view(self, start: int, end: int) -> "Sequence":
        """1-based inclusive absolute coordinates over the base data."""
        mods = dataclasses.replace(
            self.modifiers, trim_start=start, trim_end=end
        )
        return Sequence(self._base, self.info, mods)

    def absolute_pos(self, local: int) -> int:
        """Map a 1-based position in the modified view back to the base
        coordinate system (Sequence::getAbsolutePos)."""
        if self.modifiers.reverse:
            return self.trim_end - (local - 1)
        return self.trim_start + (local - 1)
