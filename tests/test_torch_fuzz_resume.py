"""Lane 5 of tests/test_fuzz_modes.py on the port (crash-resume anywhere,
masa_tpu_torch/tools/fuzz_soak.py), and the soak tool, on the CPU.

The port's lane kills ``runner.align_job`` at a call drawn among those an
uninterrupted run made (stage 1's row store, stage 2's reverse pass,
stage 4, stage 5: the stage cycles with the seed), resumes it, and holds
the resumed alignment to the uninterrupted one and its score to the
oracle's (its gaps only where the kill lost no special row kept in
RAM, ``fuzz_soak._rows_lost``); here the uninterrupted run is also held
to masa_tpu's ``runner.align_job`` at the same JobConfig (its numpy
backend, as test_fuzz_modes.py runs it): score, start, end and gap
lists, tolerance 0.  The reference's own draw (m < 512) stores no special row, so its
kill point is reached once at most and its lane never crashes: the
port's lane raises on it."""

import dataclasses
import os
import re
import subprocess
import sys
import types

import pytest

import masa_tpu.biology.alignment
import masa_tpu.biology.sequence
import masa_tpu.types
from masa_tpu.core.job import Job, JobConfig
from masa_tpu.stages import runner as jrunner
from masa_tpu_torch import convert
from masa_tpu_torch.ops import oracle
from masa_tpu_torch.stages import stage6
from masa_tpu_torch.tools import fuzz_soak as fz

REF = (masa_tpu.types, masa_tpu.biology.sequence, masa_tpu.biology.alignment)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", range(4))
def test_crash_resume_anywhere(seed, tmp_path):
    rec = fz.crash_resume(seed, "cpu")
    c = rec["case"]
    point, k = rec["kill"]
    stage = fz.KILL_STAGES[seed % len(fz.KILL_STAGES)]
    assert point in [f"{mod}.{attr}" for st, mod, attr in fz.KILL_POINTS
                     if st == stage]
    assert 1 <= k <= rec["calls"][point]
    # stage 1 stored 2 to 5 special rows, and stage 2 matched at each
    rows = c["calls"].get("runner._OffsetStore.put", 0) + c["calls"].get(
        "runner._OffsetStore.put_lazy", 0)
    assert 2 <= rows <= 5
    assert c["calls"]["core.reverse_pass_and_match"] >= rows
    want = jrunner.align_job(Job(JobConfig(
        work_dir=str(tmp_path),
        params=convert.to_ref(c["params"], *REF),
        **{**c["limits"], "backend": "numpy"})), c["s0"], c["s1"],
        log=lambda *a, **k: None)
    clean = c["clean"]
    assert clean.raw_score == want.raw_score == rec["score"]
    assert (list(clean.start), list(clean.end)) == (list(want.start),
                                                    list(want.end))
    assert fz.gaps(clean) == fz.gaps(want)


@pytest.mark.parametrize("seed", range(4))
def test_reference_sizes_store_no_special_row(seed):
    """The reference's draw (m from 200 to 500, under one 512-row
    special-row interval) cannot crash where it matters: the lane
    raises instead of passing with no kill."""
    with pytest.raises(AssertionError, match="no special row stored"):
        fz.crash_resume(seed, "cpu", sizes=(200, 500))


def test_ram_rows_do_not_outlive_a_kill(tmp_path, monkeypatch):
    """At the reference's limits (1 MiB of RAM beside 1 MiB of disk) the
    special rows alternate between RAM and disk, and the kill of seed 1
    (in stage 2's first reverse pass) loses the RAM rows: the resumed
    march matches at the disk rows alone, at the same score and into an
    alignment that re-scores.  masa_tpu's runner, killed at the same call
    of the same job, resumes to the same alignment as the port's."""
    from masa_tpu.stages import core as jcore

    c = fz.kill_and_resume(1, "cpu")
    assert c["kill"] == ["core.reverse_pass_and_match", 1]
    assert c["lost"] == [512, 1536]
    clean, resumed = c["clean"], c["resumed"]
    assert resumed.raw_score == clean.raw_score == int(
        oracle.dp_rows(c["s0"], c["s1"], c["params"]).best)
    assert stage6.recheck(resumed, c["s0"], c["s1"],
                          c["params"]).score == resumed.raw_score

    cfg = JobConfig(work_dir=str(tmp_path),
                    params=convert.to_ref(c["params"], *REF),
                    **{**c["limits"], "backend": "numpy"})

    def killed(*a, **k):
        raise KeyboardInterrupt("killed at the first reverse pass")

    with monkeypatch.context() as mp:
        mp.setattr(jcore, "reverse_pass_and_match", killed)
        with pytest.raises(KeyboardInterrupt):
            jrunner.align_job(Job(cfg), c["s0"], c["s1"],
                              log=lambda *a, **k: None)
    want = jrunner.align_job(Job(cfg), c["s0"], c["s1"],
                             log=lambda *a, **k: None)
    assert want.raw_score == resumed.raw_score
    assert (list(want.start), list(want.end)) == (list(resumed.start),
                                                  list(resumed.end))
    assert fz.gaps(want) == fz.gaps(resumed)


def test_soak_tool_runs_every_lane():
    r = subprocess.run(
        [sys.executable, "-m", "masa_tpu_torch.tools.fuzz_soak", "--device",
         "cpu", "--offset", "100", "--per-lane", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stdout + r.stderr
    runs = re.findall(r"\] (\w+) seed=100 (\w+)", r.stdout)
    assert runs == [(name, "ok") for name in fz.LANES]
    assert "=== soak done: 0 failures ===" in r.stdout


def _off_by_one(fn, bump):
    def wrong(*a, **k):
        return bump(fn(*a, **k))
    return wrong


def test_soak_tool_fails_on_a_wrong_answer(monkeypatch, capsys):
    """Every lane against an oracle one point off: each seed fails, the
    tool prints it with its traceback and exits 1."""
    monkeypatch.setattr(fz, "oracle", types.SimpleNamespace(
        dp_matrix=_off_by_one(oracle.dp_matrix, lambda r: dataclasses.replace(
            r, h=r.h + 1)),
        dp_rows=_off_by_one(oracle.dp_rows, lambda r: dataclasses.replace(
            r, best=r.best + 1, last_h=r.last_h + 1, col_h=r.col_h + 1))))
    assert fz.main(["--device", "cpu", "--offset", "100",
                    "--per-lane", "1"]) == 1
    out = capsys.readouterr().out
    for name in fz.LANES:
        assert f"{name} seed=100 FAIL" in out
        assert f"--- {name} seed=100 ---" in out
    assert "=== soak done: 5 failures ===" in out
