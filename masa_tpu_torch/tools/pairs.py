"""The pairs of bench.py, drawn as it draws them.  ``random_pair(m, n)``:
``rng(0)`` draws s0 (m bases), then s1 (n bases), the stage-1 pair.  The
1M x 1M pair of the full runs (``bench_pair``): the random pair's s0 at
2^20 bases, and as s1 bench.py's homolog of it (8% point substitutions, a
short indel every 2^16 bases) from ``rng(1)``.  Its local score is
796634 (``SCORE_1M``)."""

from __future__ import annotations

import numpy as np

M_1M = 1 << 20
SCORE_1M = 796634  # masa_tpu's full six-stage score on this pair


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
    s0, _ = random_pair()
    return s0, homolog(np.random.default_rng(1), s0, indel_every=1 << 16)
