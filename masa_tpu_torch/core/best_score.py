"""Taken from ``masa_tpu/core/best_score.py`` (the JAX reference).

Top-k best score list with near-duplicate suppression
(common/BestScoreList.cpp:43-139)."""

from __future__ import annotations

import threading

from masa_tpu_torch.types import BestScore


class BestScoreList:
    """Keeps up to `limit` best scores; a candidate within `min_distance`
    (Chebyshev) of a better kept score is considered derived from the same
    alignment and suppressed (BestScoreList::isDerived)."""

    def __init__(self, limit: int = 1, min_score: int = 0,
                 min_distance: int = 0):
        self.limit = limit
        self.min_score = min_score
        self.min_distance = min_distance
        self._scores: list[BestScore] = []
        self._lock = threading.Lock()

    def _derived(self, a: BestScore, b: BestScore) -> bool:
        if self.min_distance <= 0:
            return False
        return (abs(a.i - b.i) <= self.min_distance
                and abs(a.j - b.j) <= self.min_distance)

    def add(self, i: int, j: int, score: int) -> bool:
        cand = BestScore(i, j, score)
        if score < self.min_score:
            return False
        with self._lock:
            for kept in self._scores:
                if kept.score >= score and self._derived(cand, kept):
                    return False
            self._scores = [
                s for s in self._scores
                if not (s.score < score and self._derived(s, cand))
            ]
            self._scores.append(cand)
            self._scores.sort(key=lambda s: (-s.score, s.i, s.j))
            del self._scores[self.limit:]
            return cand in self._scores

    @property
    def best(self) -> BestScore:
        return self._scores[0] if self._scores else BestScore(0, 0, 0)

    def __iter__(self):
        return iter(list(self._scores))

    def __len__(self):
        return len(self._scores)
