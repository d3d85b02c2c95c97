"""The port's multi-process sharded stage 1 on the CPU: the counterpart of
tests/test_multihost.py.  Two processes of
``python -m masa_tpu_torch.tools.multihost_worker`` join a gloo group over
localhost (a port the OS picks), each runs its slabs, the boundary column
crosses between them by send/recv and the best by all_reduce; process 0
writes the result.  Held against the oracle and against one process
running the same slabs; tolerance: exact equality."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

from masa_tpu.ops import oracle
from masa_tpu.types import ScoreParams
from masa_tpu_torch import convert
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.parallel import mesh, sharded
from masa_tpu_torch.tools import multihost_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, size: int, *extra) -> dict:
    coord = f"127.0.0.1:{_free_port()}"
    out = tmp_path / "mh.json"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "masa_tpu_torch.tools.multihost_worker",
         coord, "2", str(pid), str(out), str(size), "--device", "cpu",
         *extra], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=120)
            outs.append((p.returncode, so, se[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _, _ in outs), outs
    res = json.loads(out.read_text())
    assert res["processes"] == 2
    return res


def test_two_process_sharded_stage1_tiny(tmp_path):
    """One slab a process, 128 x 128: the oracle's best."""
    res = _run_workers(tmp_path, 128)
    s0, s1 = multihost_worker.pair(128)
    assert res["slabs"] == 2
    assert res["best"] == oracle.dp_rows(s0, s1, ScoreParams()).best


def test_two_processes_of_two_slabs_equal_one_process(tmp_path):
    """2 processes x 2 slabs, 256-row strips, pruning on: the best, the
    final row and the strips pruned on each slab equal one process running
    the same 4 slabs (the border crosses processes between slabs 1 and 2,
    the best is reduced across them every round)."""
    size, rows = 1500, 256
    res = _run_workers(tmp_path, size, "--slabs", "4", "--rows", str(rows),
                       "--prune")
    s0, s1 = multihost_worker.pair(size)
    one = sharded.sharded_stage1(
        s0, s1, mesh.make_mesh(4, device="cpu"), wf.StripConfig(rows=rows),
        convert.to_port(ScoreParams()), prune=True)
    assert res["slabs"] == 4
    assert res["best"] == one.best == oracle.dp_rows(s0, s1,
                                                     ScoreParams()).best
    assert res["last_h"] == [int(x) for x in one.last_h]
    assert res["pruned_strips"] == [int(x) for x in one.pruned_strips]
    assert sum(res["pruned_strips"]) > 0
    np.testing.assert_array_equal(one.pruned_strips, res["pruned_strips"])


def test_two_processes_checkpoint_and_resume(tmp_path):
    """sharded_stage1_full of two processes sharing a state directory:
    process 0 makes the sink's files, each process writes its slabs'
    rows, every chunk ends at a barrier before the carry.  The endpoint
    and every slab's last row, special rows and border equal one
    process's; a second run resumes from the finished carry (it rewrites
    nothing) and gives the same."""
    size, rows = 1100, 256
    state = tmp_path / "state"
    flags = ["--slabs", "3", "--rows", str(rows), "--state-dir", str(state)]
    first = _run_workers(tmp_path, size, *flags)
    s0, s1 = multihost_worker.pair(size)
    one = sharded.sharded_stage1_full(
        s0, s1, mesh.make_mesh(3, device="cpu"), wf.StripConfig(rows=rows),
        convert.to_port(ScoreParams()))
    assert first["endpoint"] == [one.best, one.best_i, one.best_j]
    assert first["parts_digest"] == multihost_worker.parts_digest(one.parts)
    carry = state / "sharded_carry.npz"
    stamp = carry.stat().st_mtime_ns
    again = _run_workers(tmp_path, size, *flags)
    assert again["endpoint"] == first["endpoint"]
    assert again["parts_digest"] == first["parts_digest"]
    assert carry.stat().st_mtime_ns == stamp
