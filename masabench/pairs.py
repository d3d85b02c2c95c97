"""The benchmark's pairs, drawn from ``--seed``: the k-th pair of a run
from the stream (seed, k), so that a run aligns pairs that differ, and
the same seed gives the same pairs.

s0 is uniform random bases; s1 is s0 under a configuration's ``pair``:
a share ``sub_rate`` of its bases redrawn and a short indel every
``indel_every`` bases, by a frozen copy of the port's homolog model
(``masa_tpu_torch/tools/pairs.py`` ``homolog``), so that a change to the
program cannot move the yardstick.  A rate and a cadence of 0 give s1 =
s0: a sequence against itself, as the published 1M pair is."""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def homolog(rng, seq, sub_rate, indel_every, indel_max):
    """``seq`` with a share ``sub_rate`` of its bases redrawn, and at every
    ``indel_every``-th base (none where it is 0) either 1 to ``indel_max``
    random bases inserted or as many deleted, by a fair coin."""
    out = seq.copy()
    if sub_rate:
        idx = rng.random(len(seq)) < sub_rate
        out[idx] = rng.choice(BASES, int(idx.sum())).astype(np.uint8)
    if not indel_every:
        return out
    parts = []
    prev = 0
    for cut in range(indel_every, len(out), indel_every):
        parts.append(out[prev:cut])
        if rng.random() < 0.5:
            parts.append(rng.choice(BASES, int(rng.integers(1, indel_max + 1))
                                    ).astype(np.uint8))
            prev = cut
        else:
            prev = cut + int(rng.integers(1, indel_max + 1))
    parts.append(out[prev:])
    return np.concatenate(parts)


def draw(seed: int, pair: dict, k: int = 0
         ) -> tuple[np.ndarray, np.ndarray]:
    """The k-th pair of ``seed`` (k >= 0), (s0, s1) as ASCII bytes: s0 of
    ``pair["m"]`` uniform bases, s1 its homolog under ``pair``'s
    substitution rate and indel cadence (s0 itself where both are 0)."""
    rng = np.random.default_rng([k, seed])
    s0 = rng.choice(BASES, size=pair["m"]).astype(np.uint8)
    s1 = homolog(rng, s0, pair["sub_rate"], pair["indel_every"],
                 pair["indel_max"])
    return s0, s1


def write_fasta(path: str, name: str, seq: np.ndarray, width: int = 80):
    """One FASTA record, ``width`` bases a line."""
    body = seq.tobytes()
    with open(path, "wb") as fh:
        fh.write(b">" + name.encode() + b"\n")
        for k in range(0, len(body), width):
            fh.write(body[k:k + width] + b"\n")
