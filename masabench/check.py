"""What decides ``correct``: the answers of the pairs the window finished,
held to the plain reference's optimum of one of them, drawn from the seed
(the sample), and every pair's answer to itself and to its own pair's
sequences.

Each number is the worst over the pairs it covers; each limit is 0, since
the alignment is exact (integer scores, one first best cell):

- ``score_gap`` (the sample): |a score the program reports - the
  reference's best|, over every score it reports (stage 1's best, the
  final alignment's, the score stage 6's file states);
- ``end_gap`` (the sample): |di| + |dj| between the program's end point and
  the reference's first best cell in row-major order;
- ``score_spread`` (every pair): the largest less the smallest of the
  scores the program reports for the pair;
- ``end_faults`` (every pair): how far the end points the program reports
  lie apart (|di| + |dj| from the first) and outside the matrix, rows
  1..m and columns 1..n;
- ``path_gap`` (the sample, full alignments): |the path's own re-score -
  the reference's best|;
- ``rescore_gap`` (every pair, full alignments): |the path's re-score - a
  score the program reports for it|;
- ``path_faults`` (every pair, full alignments): columns of the path that
  disagree with the pair's sequences, and the distance between the path's
  last cell and the end point the program reports."""

from __future__ import annotations

from masabench import reference

LIMITS = {"score_gap": 0, "end_gap": 0, "score_spread": 0, "end_faults": 0,
          "path_gap": 0, "rescore_gap": 0, "path_faults": 0}


def judge(answers, seqs, scores, sample, best) -> tuple[dict, int]:
    """({number: worst value}, pairs that failed) for ``answers`` (pair k's
    sequences ``seqs[k]``), the pair ``sample`` against ``best`` =
    (score, i, j).  An answer holds the ``scores`` and the ``ends`` (i, j)
    the program reported, the first end the one judged, and for a full
    alignment the ``path``.  A pair that raised, or reports no score or no
    end point, fails."""
    worst = {}
    failed = 0

    def see(name, value):
        worst[name] = max(worst.get(name, 0), value)
        return value > LIMITS[name]

    for k, ans in enumerate(answers):
        if "error" in ans or not ans.get("scores") or not ans.get("ends"):
            failed += 1
            continue
        m, n = (len(s) for s in seqs[k])
        end = i, j = ans["ends"][0]
        bad = see("score_spread", max(ans["scores"]) - min(ans["scores"]))
        bad |= see("end_faults", max(1 - i, i - m, 0) + max(1 - j, j - n, 0)
                   + max(abs(a - i) + abs(b - j) for a, b in ans["ends"]))
        if k == sample:
            bad |= see("score_gap", max(abs(s - best[0])
                                        for s in ans["scores"]))
            bad |= see("end_gap", abs(i - best[1]) + abs(j - best[2]))
        path = ans.get("path")
        if path is not None:
            got = reference.judge_path(*seqs[k], path["start"], path["end"],
                                       *path["rows"], scores)
            if k == sample:
                bad |= see("path_gap", abs(got["score"] - best[0]))
            bad |= see("rescore_gap", max(abs(got["score"] - s)
                                          for s in ans["scores"]))
            bad |= see("path_faults", got["faults"]
                       + abs(path["end"][0] - i) + abs(path["end"][1] - j))
        failed += bad
    return worst, failed
