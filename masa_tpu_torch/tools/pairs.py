"""The pairs of bench.py and tools/big_run.py, drawn as they draw them.
``random_pair(m, n)``: ``rng(0)`` draws s0 (m bases), then s1 (n bases),
the stage-1 pair.  The 1M x 1M pair of the full runs (``bench_pair``): the
random pair's s0 at 2^20 bases, and as s1 bench.py's homolog of it (8%
point substitutions, a short indel every 2^16 bases) from ``rng(1)``.  Its
local score is 796634 (``SCORE_1M``).

The chromosome-scale pairs of tools/big_run.py (``big_pair(size)``, sizes
``SIZES``): s0 is the first draw of ``rng(0)``, as the random pair's s0,
and s1 its homolog from ``rng(1)``; at 23M, s1 is padded to 25 x 2^20
bases with unrelated bases from ``rng(2)``.  ``big_pair("1M")`` is
``bench_pair()``.  masa_tpu's full six-stage scores on them are
``SCORES``."""

from __future__ import annotations

import numpy as np

M_1M = 1 << 20
SCORE_1M = 796634  # masa_tpu's full six-stage score on this pair
SIZES = {"1M": 1 << 20, "3M": 3 << 20, "5M": 5 << 20, "8M": 1 << 23,
         "23M": 23 << 20}
# s1's length where the pair is asymmetric (tools/big_run.py: "23M pairs
# with 25M")
PADDED = {"23M": 25 << 20}
# records/big_run_5M_r5_pruneON_final.log: 5,242,880 x 5,242,945 bases
SCORE_5M = 3984627
# records/big_run_23M_r5.log: 24,117,248 x 26,214,400 bases
SCORE_23M = 18334019
SCORES = {"1M": SCORE_1M, "5M": SCORE_5M, "23M": SCORE_23M}


def homolog(rng, seq, sub_rate=0.08, indel_every=1 << 16):
    """bench.py's homolog: point substitutions + sparse short indels."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    out = seq.copy()
    idx = rng.random(len(seq)) < sub_rate
    out[idx] = rng.choice(bases, int(idx.sum())).astype(np.uint8)
    parts = []
    prev = 0
    for cut in range(indel_every, len(out), indel_every):
        parts.append(out[prev:cut])
        if rng.random() < 0.5:
            parts.append(rng.choice(bases, int(rng.integers(1, 8))
                                    ).astype(np.uint8))
            prev = cut
        else:
            prev = cut + int(rng.integers(1, 8))
    parts.append(out[prev:])
    return np.concatenate(parts)


def random_pair(m: int = M_1M, n: int = M_1M):
    """bench.py's stage-1 pair: ``rng(0)`` draws s0, then s1."""
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, size=m).astype(np.uint8)
    s1 = rng.choice(bases, size=n).astype(np.uint8)
    return s0, s1


def bench_pair():
    """The 1M x 1M pair exactly as bench.py builds it."""
    return homolog_pair(M_1M)


def homolog_pair(m: int, n: int | None = None):
    """tools/big_run.py's pair at m bases: s0 from ``rng(0)``, s1 its
    homolog from ``rng(1)``; where ``n`` exceeds m, s1 padded to n bases
    from ``rng(2)`` (else it keeps the homolog's own length)."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = np.random.default_rng(0).choice(bases, size=m).astype(np.uint8)
    s1 = homolog(np.random.default_rng(1), s0, indel_every=1 << 16)
    if n is not None and n > m:
        extra = np.random.default_rng(2).choice(
            bases, size=n - len(s1)).astype(np.uint8)
        s1 = np.concatenate([s1, extra])
    return s0, s1


def big_pair(size: str = "5M"):
    """The pair tools/big_run.py aligns at ``size`` (a key of SIZES)."""
    m = SIZES[size]
    return homolog_pair(m, PADDED.get(size, m))
