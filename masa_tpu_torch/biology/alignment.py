"""Taken from ``masa_tpu/biology/alignment.py`` (the JAX reference).

Alignment result model (gap lists) and the CGFF binary file format.

The format is wire-compatible with the reference's AlignmentBinaryFile
(biology/AlignmentBinaryFile.cpp:34-63: magic "CGFF" v0.1, big-endian TLV
fields, 7-bit varint gap deltas) so existing CUDAlign result files can be
read and ours can be consumed by its tooling.  Implementation is original.
"""

from __future__ import annotations

import dataclasses
import io
import struct

import numpy as np

from masa_tpu_torch.biology.sequence import (
    Sequence,
    SequenceInfo,
    SequenceModifiers,
)

MAGIC = b"CGFF"
VERSION = (0, 1)

# field tags (AlignmentBinaryFile.cpp:41-62)
END_OF_FIELDS = 0
F_ALIGNMENT_METHOD = 1
F_SCORING_SYSTEM = 2
F_PENALTY_SYSTEM = 3
F_SEQUENCE_PARAMS = 4
FS_DESCRIPTION = 1
FS_TYPE = 2
FS_SIZE = 3
FR_RAW_SCORE = 1
FR_SCORE_STATISTICS = 4
FR_GAP_LIST = 5
FR_BLOCKS = 6

ALIGNMENT_METHOD_GLOBAL = 1
ALIGNMENT_METHOD_LOCAL = 2
SCORE_MATCH_MISMATCH = 1
PENALTY_AFFINE_GAP = 2
SEQUENCE_TYPE_DNA = 1


@dataclasses.dataclass
class GapRun:
    """`len` gap characters inserted before 1-based position `pos` of the
    sequence (gap_t, biology/Alignment.hpp:52-64)."""

    pos: int
    len: int


@dataclasses.dataclass
class Alignment:
    """An alignment result: per-sequence bounds + gap lists + statistics."""

    sequences: list  # list[Sequence]
    method: int = ALIGNMENT_METHOD_LOCAL
    match: int = 1
    mismatch: int = -3
    gap_open: int = 3
    gap_ext: int = 2
    raw_score: int = 0
    matches: int = 0
    mismatches: int = 0
    gap_opens: int = 0
    gap_extensions: int = 0
    start: list = dataclasses.field(default_factory=lambda: [0, 0])
    end: list = dataclasses.field(default_factory=lambda: [0, 0])
    gaps: list = dataclasses.field(default_factory=lambda: [[], []])

    def add_gap(self, seq: int, pos: int, count: int = 1) -> None:
        """Record `count` gap chars before 1-based position `pos` of
        sequence `seq`.  Consecutive calls at the same position merge."""
        runs = self.gaps[seq]
        if runs and runs[-1].pos == pos:
            runs[-1].len += count
        else:
            runs.append(GapRun(pos, count))

    def sorted_gaps(self, seq: int) -> list:
        return sorted(self.gaps[seq], key=lambda g: g.pos)

    def aligned_length(self, seq: int) -> int:
        span = abs(self.end[seq] - self.start[seq]) + 1
        return span + sum(g.len for g in self.gaps[seq])

    def check_consistency(self) -> bool:
        """Both gapped sequences must have equal aligned lengths."""
        return self.aligned_length(0) == self.aligned_length(1)


# --- binary primitives (big-endian like the reference's htonl) -------------


def _w1(b: io.BufferedIOBase, v: int) -> None:
    b.write(struct.pack("B", v & 0xFF))


def _w4(b: io.BufferedIOBase, v: int) -> None:
    b.write(struct.pack(">i", v))


def _ws(b: io.BufferedIOBase, s: str) -> None:
    raw = s.encode("utf-8")
    _w4(b, len(raw))
    b.write(raw)


def _wv(b: io.BufferedIOBase, v: int) -> None:
    """7-bit big-endian varint (fwrite_uint4_compressed): all groups but the
    last carry the continuation bit."""
    assert v >= 0
    groups = []
    while True:
        groups.append(v & 0x7F)
        v >>= 7
        if not v:
            break
    for idx in range(len(groups) - 1, 0, -1):
        _w1(b, 0x80 | groups[idx])
    _w1(b, groups[0])


def _r1(b: io.BufferedIOBase) -> int:
    return struct.unpack("B", b.read(1))[0]


def _r4(b: io.BufferedIOBase) -> int:
    return struct.unpack(">i", b.read(4))[0]


def _rs(b: io.BufferedIOBase) -> str:
    n = _r4(b)
    return b.read(n).decode("utf-8")


def _rv(b: io.BufferedIOBase) -> int:
    v = 0
    byte = _r1(b)
    v = byte & 0x7F
    while byte & 0x80:
        byte = _r1(b)
        v = (v << 7) | (byte & 0x7F)
    return v


# --- CGFF write/read --------------------------------------------------------


def write_cgff(path: str, aln: Alignment) -> None:
    with open(path, "wb") as f:
        f.write(MAGIC)
        _w1(f, VERSION[0])
        _w1(f, VERSION[1])
        # sequences
        _w4(f, len(aln.sequences))
        for seq in aln.sequences:
            info = seq.info
            _w1(f, FS_DESCRIPTION)
            _ws(f, info.description)
            _w1(f, FS_TYPE)
            _w1(f, info.type)
            _w1(f, FS_SIZE)
            _w4(f, info.size)
            _w1(f, END_OF_FIELDS)
        # params
        _w1(f, F_ALIGNMENT_METHOD)
        _w1(f, aln.method)
        _w1(f, F_SCORING_SYSTEM)
        _w1(f, SCORE_MATCH_MISMATCH)
        _w4(f, aln.match)
        _w4(f, aln.mismatch)
        _w1(f, F_PENALTY_SYSTEM)
        _w1(f, PENALTY_AFFINE_GAP)
        _w4(f, aln.gap_open)
        _w4(f, aln.gap_ext)
        _w1(f, F_SEQUENCE_PARAMS)
        _w4(f, len(aln.sequences))
        for i, seq in enumerate(aln.sequences):
            _w4(f, i)
            mods = seq.modifiers
            _w4(f, mods.flags)
            _w4(f, mods.trim_start)
            _w4(f, mods.trim_end)
        _w1(f, END_OF_FIELDS)
        # result
        _w4(f, 1)
        _w1(f, FR_RAW_SCORE)
        _w4(f, aln.raw_score)
        _w1(f, FR_SCORE_STATISTICS)
        _w4(f, aln.matches)
        _w4(f, aln.mismatches)
        _w4(f, aln.gap_opens)
        _w4(f, aln.gap_extensions)
        _w1(f, FR_GAP_LIST)
        for i in range(len(aln.sequences)):
            _w4(f, aln.start[i])
            _w4(f, aln.end[i])
            runs = aln.sorted_gaps(i)
            _w4(f, len(runs))
            last = 0
            for g in runs:
                _wv(f, g.pos - last)
                _wv(f, g.len)
                last = g.pos
        _w1(f, END_OF_FIELDS)


def read_cgff(path: str) -> Alignment:
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError("not a CGFF file")
        major, _minor = _r1(f), _r1(f)
        if major > VERSION[0]:
            raise ValueError("unsupported CGFF version")
        nseq = _r4(f)
        infos = []
        for _ in range(nseq):
            info = SequenceInfo()
            while (field := _r1(f)) != END_OF_FIELDS:
                if field == FS_DESCRIPTION:
                    info.description = _rs(f)
                elif field == FS_TYPE:
                    info.type = _r1(f)
                elif field == FS_SIZE:
                    info.size = _r4(f)
                else:
                    raise ValueError(f"unknown sequence field {field}")
            infos.append(info)
        aln = Alignment(sequences=[])
        seq_order: list[int] = []
        while (field := _r1(f)) != END_OF_FIELDS:
            if field == F_ALIGNMENT_METHOD:
                aln.method = _r1(f)
            elif field == F_SCORING_SYSTEM:
                if _r1(f) != SCORE_MATCH_MISMATCH:
                    raise ValueError("unsupported score system")
                aln.match, aln.mismatch = _r4(f), _r4(f)
            elif field == F_PENALTY_SYSTEM:
                system = _r1(f)
                if system == PENALTY_AFFINE_GAP:
                    aln.gap_open, aln.gap_ext = _r4(f), _r4(f)
                else:  # linear
                    aln.gap_open, aln.gap_ext = 0, _r4(f)
            elif field == F_SEQUENCE_PARAMS:
                count = _r4(f)
                for _ in range(count):
                    idx = _r4(f)
                    mods = SequenceModifiers.from_flags(
                        _r4(f), _r4(f), _r4(f)
                    )
                    aln.sequences.append(
                        Sequence(np.empty(0, np.uint8), infos[idx], mods)
                    )
                    seq_order.append(idx)
            else:
                raise ValueError(f"unknown param field {field}")
        results = _r4(f)
        if results > 1:
            raise ValueError("multiple results unsupported")
        nseq_r = len(aln.sequences)
        aln.start = [0] * nseq_r
        aln.end = [0] * nseq_r
        aln.gaps = [[] for _ in range(nseq_r)]
        while (field := _r1(f)) != END_OF_FIELDS:
            if field == FR_RAW_SCORE:
                aln.raw_score = _r4(f)
            elif field == FR_SCORE_STATISTICS:
                aln.matches = _r4(f)
                aln.mismatches = _r4(f)
                aln.gap_opens = _r4(f)
                aln.gap_extensions = _r4(f)
            elif field == FR_GAP_LIST:
                for i in range(nseq_r):
                    aln.start[i] = _r4(f)
                    aln.end[i] = _r4(f)
                    count = _r4(f)
                    last = 0
                    for _ in range(count):
                        last += _rv(f)
                        aln.gaps[i].append(GapRun(last, _rv(f)))
            elif field == FR_BLOCKS:
                h, w = _r4(f), _r4(f)
                f.read(4 * h * w)
            else:
                raise ValueError(f"unknown result field {field}")
        return aln
