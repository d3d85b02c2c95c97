"""The bench's wall time alone and beside what a long parent process leaves
around it, in turns within one call: which condition moves its host time.

    python -m masa_tpu_torch.tools.bench_spread

Four turns, in the order ``TURNS``, each run ``python -m
masa_tpu_torch.bench`` in a child process (``run_child``, as
``chip_smoke.py``'s bench phase runs it) under one condition:

- ``alone``: no other process of the tool holds the card;
- ``held``: a holder process keeps a CUDA context with ``HELD_DEVICE_GIB``
  allocated on the card, and ``HELD_HOST_GIB`` of host memory written,
  1 GiB of it pinned, while the child runs: what a parent that ran
  earlier phases keeps;
- ``written``: just before the child, ``WRITTEN_GIB`` of 1 MiB files
  written into the temporary directory and removed, as earlier phases'
  work directories are.

Before each child ``disk_probe`` times, in the same temporary directory,
what stage 1 does for each special row it puts on disk: a file of a packed
row's size written under a temporary name and renamed (and the files
removed afterwards, as stage 2 removes them).  Beside each child's wall
seconds by stage: its CPU seconds (user, system), this process's CPU
seconds while it ran, and the load average before.  Prints one JSON line
last; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

from masa_tpu_torch.tools import roofline

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROW_BYTES = 1_048_900  # a packed special row of the 1M pair (~1.05 MB)
TURNS = ("alone", "held", "written", "alone")
HELD_DEVICE_GIB, HELD_HOST_GIB, WRITTEN_GIB = 4.0, 16.0, 8.0


def cpu_seconds(who) -> tuple[float, float]:
    r = resource.getrusage(who)
    return r.ru_utime, r.ru_stime


def run_child(timeout: float = 900, module: str = "masa_tpu_torch.bench",
              args=()) -> dict:
    """``python -m <module> <args>`` (the bench by default) in a child
    process with the repository on its path: exit code, stdout lines, the
    end of stderr, wall seconds, the child's CPU seconds (user, system),
    this process's CPU seconds while it ran, and the load average
    before."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    load = os.getloadavg()
    kids, me = cpu_seconds(resource.RUSAGE_CHILDREN), cpu_seconds(
        resource.RUSAGE_SELF)
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", module, *args],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=timeout)
    wall = time.time() - t0
    kids2, me2 = cpu_seconds(resource.RUSAGE_CHILDREN), cpu_seconds(
        resource.RUSAGE_SELF)
    return {"rc": r.returncode, "lines": r.stdout.splitlines(),
            "stderr": r.stderr[-3000:], "wall_s": wall,
            "child_cpu_s": [b - a for a, b in zip(kids, kids2)],
            "parent_cpu_s": [b - a for a, b in zip(me, me2)],
            "loadavg": list(load)}


def disk_probe(rows: int = 512, row_bytes: int = ROW_BYTES) -> dict:
    """Milliseconds a row to write ``rows`` files of ``row_bytes`` under a
    temporary name and rename them, and to remove them, in a fresh
    directory under the temporary directory (where the bench's work
    directories go)."""
    data = os.urandom(row_bytes)
    with tempfile.TemporaryDirectory(prefix="masa_probe_") as d:
        t0 = time.perf_counter()
        for k in range(rows):
            tmp = os.path.join(d, f"{k}.tmp")
            with open(tmp, "wb") as fh:
                fh.write(data)
            os.replace(tmp, os.path.join(d, f"row_{k}"))
        t1 = time.perf_counter()
        for k in range(rows):
            os.remove(os.path.join(d, f"row_{k}"))
        t2 = time.perf_counter()
    return {"rows": rows, "write_ms": 1e3 * (t1 - t0) / rows,
            "remove_ms": 1e3 * (t2 - t1) / rows}


def write_and_remove(gib: float) -> None:
    """Write ``gib`` GiB of 1 MiB files into a temporary directory and
    remove them."""
    block = os.urandom(1 << 20)
    with tempfile.TemporaryDirectory(prefix="masa_written_") as d:
        for k in range(int(gib * 1024)):
            with open(os.path.join(d, str(k)), "wb") as fh:
                fh.write(block)


def hold() -> None:
    """Hold a CUDA context with ``HELD_DEVICE_GIB`` allocated on the card,
    and ``HELD_HOST_GIB`` of host memory written, 1 GiB of it pinned,
    until stdin closes (``--hold``: the held condition's holder)."""
    import numpy as np
    import torch

    dev = torch.empty(int(HELD_DEVICE_GIB * (1 << 30)), dtype=torch.uint8,
                      device="cuda")
    pinned = torch.ones(1 << 30, dtype=torch.uint8, pin_memory=True)
    rest = np.ones(int(HELD_HOST_GIB * (1 << 30)) - pinned.numel(),
                   np.uint8)
    torch.cuda.synchronize()
    print("held", flush=True)
    sys.stdin.read()
    del dev, pinned, rest


def holder() -> subprocess.Popen:
    """A process that holds what ``hold`` holds, once it has."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "masa_tpu_torch.tools.bench_spread", "--hold"],
        cwd=REPO, env=env,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    if proc.stdout.readline().strip() != "held":
        proc.kill()
        raise RuntimeError(f"the holder exited {proc.wait()}")
    return proc


def summary(turn: dict) -> dict:
    """A turn's numbers: its wall, the bench's full runs and stages, and
    stage 1's phase."""
    d = json.loads(turn["lines"][-1])["detail"]
    return {"full_runs_s": d["full_runs_s"], "full_stage_s": d["full_stage_s"],
            "full_kernel_ms": d["full_kernel_ms"],
            "stage1_runs_s": d["stage1_runs_s"],
            "full_score": d["full_score"], "best_score": d["best_score"],
            **{k: turn[k] for k in ("wall_s", "child_cpu_s", "parent_cpu_s",
                                    "loadavg")}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hold", action="store_true", help=argparse.SUPPRESS)
    if p.parse_args(argv).hold:
        hold()
        return 0
    card = roofline.card()
    print(f"# card: {card}", flush=True)
    turns = []
    for k, cond in enumerate(TURNS):
        held, t0 = None, time.time()
        if cond == "held":
            held = holder()
        elif cond == "written":
            write_and_remove(WRITTEN_GIB)
        setup = time.time() - t0
        try:
            probe = disk_probe()
            turn = run_child()
        finally:
            if held is not None:
                held.stdin.close()
                held.wait(timeout=120)
        if turn["rc"] != 0:
            raise RuntimeError(f"turn {k + 1} ({cond}): the bench exited "
                               f"{turn['rc']}: {turn['stderr']}")
        got = {"turn": k + 1, "condition": cond, "setup_s": setup,
               "disk_probe": probe, **summary(turn)}
        turns.append(got)
        print("# " + json.dumps(got), flush=True)
    print(json.dumps({"card": card, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
