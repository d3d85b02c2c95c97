"""The library call as a user makes it: ``masa_tpu_torch.align(s0, s1)``
on fresh host arrays (copied before the call, off the clock), one call at
a time, nothing persisted, at the call's own defaults but the scores."""

from __future__ import annotations

STAGES = [
    ("masa_tpu_torch.stages.pipeline", "stage1_pass", "stage1"),
    ("masa_tpu_torch.stages.pipeline", "stage2_march", "stage2"),
    ("masa_tpu_torch.stages.pipeline", "stage3_densify", "stage3"),
    ("masa_tpu_torch.ops.myers_miller", "stage4_reduce", "stage4"),
    ("masa_tpu_torch.stages.pipeline", "stage5_emit", "stage5"),
]
SCORE_KEYS = ("match", "mismatch", "gap_open", "gap_ext")


class Entry:
    stages = STAGES

    def __init__(self, run):
        if run.traffic["mode"] != "full":
            raise ValueError("the library call has only the full alignment")
        self.run = run
        cfg = run.config
        self.kwargs = {k: cfg[k] for k in SCORE_KEYS}
        self.kwargs["device"] = str(run.device)

    def _align(self, s0, s1):
        import masa_tpu_torch

        return masa_tpu_torch.align(s0, s1, **self.kwargs)

    def warm_up(self, s0, s1):
        self._align(s0, s1)

    def prepare(self, k):
        self.a, self.b = (s.copy() for s in self.run.pair(k))

    def pair(self, k):
        self._aln = self._align(self.a, self.b)

    def collect(self, k) -> dict:
        from masabench.reference import expand

        aln, self._aln = self._aln, None
        start, end = tuple(aln.start), tuple(aln.end)
        rows = tuple(expand(seq, start[s], end[s],
                            [(g.pos, g.len) for g in aln.gaps[s]])
                     for s, seq in enumerate(self.run.pair(k)))
        return {"scores": [int(aln.raw_score)], "ends": [end],
                "path": {"start": start, "end": end, "rows": rows}}

    def close(self):
        self._aln = None
