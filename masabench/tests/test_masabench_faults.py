"""``correct`` comes out false when the timed path is broken underneath:
a whole run of each cell on the CPU at a tiny size (the look for a card
skipped), with a fault planted where the program produces its answer; and
the control, the reference computed in int16 in the program's place,
fails the comparison at a size where int16 cannot hold the score."""

import numpy as np
import pytest
import torch

from masabench import check, pairs, reference, run
from masabench.tests.test_masabench_harness import BIG_SEED, CELLS, tiny

M = 400


def _first_pass(monkeypatch, alter):
    """Replace stage 1's forward pass over the whole matrix (the pass over
    all M rows) by ``alter(fn, seq0, *args, **kwargs)``."""
    from masa_tpu_torch.stages import core

    fn = core.forward_pass

    def planted(seq0, *args, **kwargs):
        if len(seq0) == M and kwargs.get("track_best", True):
            return alter(fn, seq0, *args, **kwargs)
        return fn(seq0, *args, **kwargs)

    monkeypatch.setattr(core, "forward_pass", planted)


def score_altered(monkeypatch, name):
    def alter(fn, *args, **kwargs):
        res = fn(*args, **kwargs)
        res.best += 1
        return res
    _first_pass(monkeypatch, alter)


def half_the_rows_left_out(monkeypatch, name):
    _first_pass(monkeypatch, lambda fn, seq0, *a, **k: fn(seq0[:M // 2],
                                                          *a, **k))


def path_altered(monkeypatch, name):
    """One base of the path changed where stage 6 renders it (the CLI), or
    the path moved a row down where stage 5 emits it (the library)."""
    if name.startswith("cp1m-cli"):
        from masa_tpu_torch.stages import stage6

        fn = stage6.render_text

        def planted(*args, **kwargs):
            lines = fn(*args, **kwargs).split("\n")
            i = next(i for i, x in enumerate(lines) if x.startswith("Seq1:"))
            res = lines[i].split()[2]
            k = next(k for k, c in enumerate(res) if c != "-")
            alt = res[:k] + ("A" if res[k] != "A" else "C") + res[k + 1:]
            lines[i] = lines[i].replace(res, alt, 1)
            return "\n".join(lines)

        monkeypatch.setattr(stage6, "render_text", planted)
    else:
        from masa_tpu_torch.stages import pipeline

        fn = pipeline.stage5_emit

        def planted(*args, **kwargs):
            aln = fn(*args, **kwargs)
            aln.start[0] += 1
            aln.end[0] += 1
            return aln

        monkeypatch.setattr(pipeline, "stage5_emit", planted)


FAULTS = [score_altered, half_the_rows_left_out, path_altered]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, name, fault):
    cell = tiny(name, m=M)
    if fault is path_altered and cell.traffic["mode"] != "full":
        pytest.skip("a score-only run returns no path")
    sound, _ = run.run_cell(cell, BIG_SEED, 0.01, False, device="cpu")
    assert sound["correct"]
    fault(monkeypatch, name)
    result, failed = run.run_cell(tiny(name, m=M), BIG_SEED, 0.01, False,
                                  device="cpu")
    assert not result["correct"] and failed == result["attempted"] == 1


def test_the_int16_control_fails_the_comparison():
    # a pair whose best, 33,000 and more, int16 cannot hold; the exact
    # answer of a sequence against itself is known without the reference
    s0 = pairs.draw(11, {"m": 33000, "sub_rate": 0.0, "indel_every": 1 << 20,
                         "indel_max": 7})[0]
    scores = {"match": 1, "mismatch": -3, "gap_open": 3, "gap_ext": 2}
    best = (33000, 33000, 33000)
    assert reference.sw_best(s0[:500], s0[:500], scores) == (500, 500, 500)
    got = reference.sw_best(s0, s0, scores, dtype=torch.int16, chunk=256)
    worst, failed = check.judge([{"scores": [got[0]], "ends": [got[1:]]}],
                                [(s0, s0)], scores, 0, best)
    assert failed == 1 and worst["score_gap"] > check.LIMITS["score_gap"]
    # the exact answer passes the same comparison
    worst, failed = check.judge([{"scores": [best[0]], "ends": [best[1:]]}],
                                [(s0, s0)], scores, 0, best)
    assert failed == 0 and worst == {"score_gap": 0, "end_gap": 0,
                                     "score_spread": 0, "end_faults": 0}


def test_the_judge_counts_a_pair_that_raised_as_failed():
    s = np.frombuffer(b"ACGT", np.uint8)
    worst, failed = check.judge([{"error": "boom"}], [(s, s)], {}, 0,
                                (4, 4, 4))
    assert failed == 1 and worst == {}


@pytest.mark.parametrize("answer,number", [
    ({"scores": [4, 5], "ends": [(4, 4)]}, "score_spread"),
    ({"scores": [4, 4], "ends": [(4, 4), (3, 3)]}, "end_faults"),
    ({"scores": [4], "ends": [(5, 4)]}, "end_faults"),
    ({"scores": [4], "ends": [(0, 4)]}, "end_faults"),
])
def test_a_pair_the_reference_does_not_see_is_still_judged(answer, number):
    # pair 0 is the sample and sound; pair 1 contradicts itself or ends
    # outside its 4 x 4 matrix
    s = np.frombuffer(b"ACGT", np.uint8)
    sound = {"scores": [4, 4], "ends": [(4, 4), (4, 4)]}
    worst, failed = check.judge([sound, answer], [(s, s), (s, s)], {}, 0,
                                (4, 4, 4))
    assert failed == 1 and worst[number] > check.LIMITS[number]
    assert worst["score_gap"] == worst["end_gap"] == 0
