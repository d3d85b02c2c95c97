"""The plain reference against a brute-force Gotoh DP on tiny pairs: the
best score, its first cell in row-major order, and the re-score of a path
traced back from it."""

import numpy as np
import pytest

from masabench import reference

SCORES = {"match": 1, "mismatch": -3, "gap_open": 3, "gap_ext": 2}


def brute(s0, s1, sc):
    """Python loops over the three matrices; the traceback of the first
    best cell as two gapped rows."""
    m, n = len(s0), len(s1)
    neg = -(1 << 40)
    H = np.zeros((m + 1, n + 1), np.int64)
    E = np.full((m + 1, n + 1), neg, np.int64)
    F = np.full((m + 1, n + 1), neg, np.int64)
    oe = sc["gap_open"] + sc["gap_ext"]
    best = (-1, 0, 0)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            E[i, j] = max(E[i, j - 1] - sc["gap_ext"], H[i, j - 1] - oe)
            F[i, j] = max(F[i - 1, j] - sc["gap_ext"], H[i - 1, j] - oe)
            d = H[i - 1, j - 1] + (sc["match"] if s0[i - 1] == s1[j - 1]
                                   else sc["mismatch"])
            H[i, j] = max(0, d, E[i, j], F[i, j])
            if H[i, j] > best[0]:
                best = (int(H[i, j]), i, j)
    # traceback from the best cell
    r0, r1 = [], []
    i, j, state = best[1], best[2], "H"
    while i > 0 and j > 0:
        if state == "H":
            if H[i, j] == 0:
                break
            d = H[i - 1, j - 1] + (sc["match"] if s0[i - 1] == s1[j - 1]
                                   else sc["mismatch"])
            if H[i, j] == d:
                r0.append(s0[i - 1]), r1.append(s1[j - 1])
                i, j = i - 1, j - 1
            elif H[i, j] == E[i, j]:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            r0.append(reference.GAP), r1.append(s1[j - 1])
            state = "H" if E[i, j] == H[i, j - 1] - oe else "E"
            j -= 1
        else:
            r0.append(s0[i - 1]), r1.append(reference.GAP)
            state = "H" if F[i, j] == H[i - 1, j] - oe else "F"
            i -= 1
    start = (i + 1, j + 1)
    return best, start, np.array(r0[::-1], np.uint8), \
        np.array(r1[::-1], np.uint8)


def pair(seed, m, n, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(alphabet, np.uint8)
    s0 = rng.choice(bases, m).astype(np.uint8)
    s1 = rng.choice(bases, n).astype(np.uint8)
    if seed % 2:  # a homolog, with an indel: long paths and ties
        s1 = np.concatenate([s0[:m // 2], s0[m // 2 + 3:]]).copy()
        flip = rng.random(len(s1)) < 0.1
        s1[flip] = rng.choice(bases, int(flip.sum()))
    return s0, s1


@pytest.mark.parametrize("seed,m,n,chunk", [
    (0, 30, 41, 4), (1, 57, 40, 8), (2, 1, 9, 4), (3, 64, 70, 64),
    (4, 40, 1, 3), (5, 100, 90, 7), (6, 12, 12, 64), (7, 80, 81, 16),
])
def test_best_equals_brute_force(seed, m, n, chunk):
    s0, s1 = pair(seed, m, n)
    (score, i, j), _, _, _ = brute(s0, s1, SCORES)
    assert reference.sw_best(s0, s1, SCORES, chunk=chunk) == (score, i, j)


def test_ties_take_the_first_cell_in_row_major_order():
    # "ACAC" against "ACTTAC": cells of 2 at rows 2 and 4, columns 2 and 6
    s0 = np.frombuffer(b"ACAC", np.uint8)
    s1 = np.frombuffer(b"ACTTAC", np.uint8)
    (score, i, j), _, _, _ = brute(s0, s1, SCORES)
    assert reference.sw_best(s0, s1, SCORES, chunk=3) == (score, i, j)
    assert (score, i, j) == (2, 2, 2)


@pytest.mark.parametrize("seed", [1, 5, 7, 9])
def test_a_traced_path_rescores_to_the_best(seed):
    s0, s1 = pair(seed, 90, 95)
    (score, i, j), start, r0, r1 = brute(s0, s1, SCORES)
    got = reference.judge_path(s0, s1, start, (i, j), r0, r1, SCORES)
    assert got == {"score": score, "faults": 0}
    # a base altered on the path, and a path that ends one base short
    bad = r1.copy()
    k = int(np.flatnonzero(bad != reference.GAP)[0])
    bad[k] = ord("N")
    assert reference.judge_path(s0, s1, start, (i, j), r0, bad,
                                SCORES)["faults"] == 1
    assert reference.judge_path(s0, s1, start, (i, j), r0[:-1], r1[:-1],
                                SCORES)["faults"] > 0


def test_expand_places_gap_runs_before_their_positions():
    seq = np.frombuffer(b"ACGTACGT", np.uint8)
    row = reference.expand(seq, 2, 6, [(4, 2), (6, 1)])
    assert row.tobytes() == b"CG--TA-C"
    with pytest.raises(ValueError):
        reference.expand(seq, 2, 6, [(8, 1)])

