"""The port's fork mode on the CPU: one worker process per slab
(``python -m masa_tpu_torch.parallel.fork``), localhost-socket borders,
masa_tpu's AlignerPool choreography (score relay, pipelined crosspoints
with "Not me!" routing, the stage-4 file splice).  Scores against the
oracle and the stage-6 re-score of the written CGFF; tolerance: exact.
Ports are picked free by the OS (the CLI's fixed 7300 is exercised in
test_torch_runner_cli.py)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from masa_tpu.ops import oracle
from masa_tpu.types import ScoreParams
from masa_tpu_torch import convert
from masa_tpu_torch.parallel.fork import run_fork
from masa_tpu_torch.stages import pipeline, stage6
from masa_tpu_torch.types import Crosspoint

from test_torch_split import free_base

P = ScoreParams()
PP = convert.to_port(P)  # the port takes its own types
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fork(s0, s1, nparts, work_dir, **kw):
    return run_fork(s0, s1, [1.0] * nparts, str(work_dir), PP,
                    base_port=free_base(nparts - 1), device="cpu",
                    timeout=300, **kw)


def test_three_processes_oracle_exact(dna, homolog, tmp_path):
    """3 workers, a path across every slab: node 0's spliced chain scores
    the oracle's best, and the CGFF it wrote re-scores to it.  Each CPU
    worker kept a special row every 512 rows (masa_tpu's cadence)."""
    s0 = dna(900, seed=121)
    s1 = homolog(s0, seed=122)
    best = oracle.dp_rows(s0, s1, P).best
    res = fork(s0, s1, 3, tmp_path / "fw")
    assert res["score"] == best
    cps = res["crosspoints"]
    assert len(cps) > 10 and cps[-1][2] == best
    assert (res["matches"] * P.match + res["mismatches"] * P.mismatch
            - res["gap_opens"] * P.gap_open
            - res["gap_extensions"] * P.gap_ext) == best
    # stages 5 and 6 again on the chain node 0 returned
    aln = pipeline.stage5_emit(s0, s1, pipeline.PipelineConfig(device="cpu"),
                               [Crosspoint(*c) for c in cps])
    assert stage6.recheck(aln, s0, s1, PP).score == best
    assert os.path.getsize(tmp_path / "fw" / "alignment.00.cgff") > 0
    assert [w["part"] for w in res["workers"]] == [0, 1, 2]
    assert {w["device"] for w in res["workers"]} == {"cpu"}
    assert {w["special_every"] for w in res["workers"]} == {512}
    assert os.path.exists(tmp_path / "fw" / "shared" / "alignment.txt")


def test_not_me_routing(dna, homolog, tmp_path):
    """The endpoint lies in the first slab: the right workers pass the
    crosspoint on untouched and add no crosspoints (sw_stage2.cpp:197-205)."""
    s0 = dna(300, seed=123)
    s1 = np.concatenate([homolog(s0, seed=124), dna(900, seed=125)])
    res = fork(s0, s1, 3, tmp_path / "fw")
    assert res["score"] == oracle.dp_rows(s0, s1, P).best
    assert all(c[1] <= len(s1) // 3 for c in res["crosspoints"])


def test_speculative_traceback_mode(dna, homolog, tmp_path):
    s0 = dna(900, seed=128)
    s1 = homolog(s0, seed=129)
    best = oracle.dp_rows(s0, s1, P).best
    res = fork(s0, s1, 3, tmp_path / "fw", traceback="speculative")
    assert res["score"] == best and res["crosspoints"][-1][2] == best


def test_worker_failure_detected(dna, tmp_path):
    """A worker that fails (an empty slab) ends the run with an error
    instead of a hang (libmasa.cpp:605-630)."""
    with pytest.raises(RuntimeError, match="fork workers failed"):
        fork(dna(200, seed=126), np.array([], np.uint8), 2, tmp_path / "fw")


def test_cuda_without_a_gpu_raises(dna, tmp_path):
    """No fallback to the CPU: a CUDA run without a GPU raises in the
    parent, and a worker told to use one exits with an error."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    s0 = dna(100, seed=127)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fork(s0, s0, [1.0, 1.0], str(tmp_path / "fw"), PP)
    cfg = tmp_path / "fork.00.json"
    cfg.write_text(json.dumps({"part": 0, "device": "cuda:0"}))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run([sys.executable, "-m", "masa_tpu_torch.parallel.fork",
                        str(cfg)], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
