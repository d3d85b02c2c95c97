"""A full six-stage alignment at chromosome scale, crash-resumable: the
port's counterpart of the repository's ``tools/big_run.py``.

    python -m masa_tpu_torch.tools.big_run 5M          # the CUDA card
    python -m masa_tpu_torch.tools.big_run 23M --work-dir /big/disk/w
    python -m masa_tpu_torch.tools.big_run 5M --fresh --no-prune

The pair (``tools/pairs.big_pair``): s0 ``rng(0)``'s first draw of m
bases, s1 its homolog from ``rng(1)``; at 23M (24,117,248 bases) s1 is
padded to 26,214,400 bases from ``rng(2)``.  It goes through
``stages/runner.align_job``, the CLI's path, at ``JobConfig``'s defaults
(1 GiB of RAM and 16 GiB of disk for special rows), but at 23M with
``disk_limit`` 64 GiB, as the reference runs it; ``block_pruning`` unless
``--no-prune``.  masa_tpu's scores (``pairs.SCORES``: 3984627 at 5M,
18334019 at 23M) stand beside the run's as ``reference_score``.

The work directory (default ``masa_big_<size>[_noprune].work`` under the
temporary directory) carries ``big_run_meta.json``, the reference's
contract: the wall time of every attempt, so a crash-resumed run reports
the sum over its attempts as ``full_alignment_s``, and rerunning the same
command resumes it; a directory with no meta (one this tool did not
write) or a finished run's is cleared, never replayed; ``--fresh``
clears it too.

One JSON line at the end, the last line of the output, with the
reference's keys (``size``, ``m``, ``n``, ``full_alignment_s``,
``full_gcups``, ``steady_s``, ``steady_gcups``, ``pruning``,
``pruned_cells``, ``score``, ``attempts``, ``resumed``,
``this_attempt_s``, ``stage_end_marks_s``, ``work_dir``), but for its
``cold_load_s`` and ``cold_by_stage_s``: those were Mosaic's compile and
cache-load seconds, which have no counterpart here.  In their place
``build_s``: the seconds this attempt spent building the kernels
(``csrc/strip.cu``, ``csrc/batched_strip.cu``, ``csrc/hop.cu`` with nvcc
and the native helpers with g++, started together; 0 for a library built
before), which ``steady_s`` leaves out.  Beside them: the card
(``nvidia-smi --query-gpu=name,power.limit``), per stage of this attempt
the kernels' milliseconds (CUDA events around every launch) and launches
by wrapper (``stage_kernel_ms``, ``stage_launches``), the special rows
(``special_rows``: their interval, the rows and bytes kept on the card,
in RAM and on disk, ``statistics_01.00``), stage 2's hops split into
those of one launch and those of three (``hops``, ``statistics_02.00``),
the peak device memory of this attempt, this process's peak resident
memory, and the work directory's peak bytes on disk (sampled at a log
line at most every 5 s, and at every stage's end).  The meta is brought
up to date as often, so a killed attempt loses at most 5 s of its
seconds (the reference saved it every minute).

Left out of the reference, as TPU and tunnel workarounds: the probe loop
that waits for a healthy window, the persistent compile cache, the stop
sentinel file and the probe's strips.  With no card (and no ``--device
cpu``) the tool exits 2 and prints no line.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import tempfile
import threading
import time

META = "big_run_meta.json"
# how often the meta (and the work directory's bytes) are brought up to
# date: a killed attempt loses at most this much of its seconds
SAMPLE_S = 5.0


def work_dir_of(size: str, no_prune: bool) -> str:
    return os.path.join(tempfile.gettempdir(), f"masa_big_{size}"
                        f"{'_noprune' if no_prune else ''}.work")


def open_meta(wd: str, fresh: bool, say) -> dict | None:
    """The meta of a run to resume in ``wd``, or None after clearing
    ``wd`` where there is nothing to resume: ``--fresh``, no readable
    meta (a directory this tool did not write), or a finished run."""
    if not os.path.isdir(wd):
        return None
    meta = None
    try:
        with open(os.path.join(wd, META)) as fh:
            meta = json.load(fh)
    except (OSError, ValueError):
        meta = None
    if fresh or meta is None or meta.get("done"):
        why = ("--fresh" if fresh else
               "no meta (a directory this tool did not write)"
               if meta is None else "the previous run finished")
        say(f"[clear] removing work dir {wd} ({why})")
        shutil.rmtree(wd)
        return None
    return meta


def save_meta(wd: str, size: str, elapsed: float, attempts: int,
              done: bool, marks: dict) -> None:
    """The meta after this attempt's ``elapsed`` seconds so far (tmp and
    rename: a crash never leaves half a file)."""
    path = os.path.join(wd, META)
    with open(path + ".tmp", "w") as fh:
        json.dump({"size": size, "elapsed_s": elapsed, "attempts": attempts,
                   "done": done, "marks": marks}, fh)
    os.replace(path + ".tmp", path)


def tree_bytes(top: str) -> int:
    """The bytes of every file under ``top`` (files that vanish while it
    walks count 0)."""
    total = 0
    for d, _, files in os.walk(top):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(d, f))
            except OSError:
                pass
    return total


class RunLog:
    """The runner's ``log``: each line printed with the attempt's seconds
    (stage 1's progress lines about once a minute), the stage marks (the
    seconds at each line starting with "stage"), per stage the kernels'
    milliseconds and launches since the stage before (at each completion
    line, ``bench.stage_done``), the meta saved and the work directory's
    bytes sampled at a line at most every SAMPLE_S seconds and at each
    completion line (stage 1's progress lines come every 2 s)."""

    def __init__(self, t0: float, save, wd: str):
        from masa_tpu_torch import bench

        self.t0, self.save, self.wd = t0, save, wd
        self.marks, self.kernel_ms, self.launches = {}, {}, {}
        self.peak_disk = tree_bytes(wd)
        self._seen = bench.launch_counts()
        self._last_meta = self._last_disk = time.time()
        self._lock = threading.Lock()

    def sample_disk(self, force: bool = False) -> None:
        now = time.time()
        if force or now - self._last_disk >= SAMPLE_S:
            self._last_disk = now
            self.peak_disk = max(self.peak_disk, tree_bytes(self.wd))

    def __call__(self, *a, **_):
        from masa_tpu_torch import bench
        from masa_tpu_torch.ops import kernels

        msg = " ".join(str(x) for x in a)
        now = time.time()
        with self._lock:
            self.sample_disk()
            if now - self._last_meta >= SAMPLE_S:
                self._last_meta = now
                self.save(self.marks)
        if msg.startswith("stage1: ... flushed"):
            if int(now) % 60 < 2:
                print(f"[{now - self.t0:9.2f}s] {msg}", flush=True)
            return
        if msg.startswith("stage"):
            with self._lock:  # the progress lines come from another thread
                self.marks[msg.split(":")[0]] = round(now - self.t0, 2)
        print(f"[{now - self.t0:9.2f}s] {msg}", flush=True)
        done = bench.stage_done(msg)
        if done is None:
            return
        with self._lock:
            self.sample_disk(force=True)
            self._last_meta = now
            self.save(self.marks)
        self.kernel_ms[done[0]] = kernels.drain_events()  # waits for the card
        counts = bench.launch_counts()
        self.launches[done[0]] = {k: counts[k] - self._seen[k]
                                  for k in counts}
        self._seen = counts


def main(argv=None) -> int:
    from masa_tpu_torch.tools import pairs

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("size", nargs="?", default="5M", choices=list(pairs.SIZES))
    p.add_argument("--fresh", action="store_true",
                   help="clear the work directory first")
    p.add_argument("--no-prune", action="store_true",
                   help="stage 1 without block pruning")
    p.add_argument("--work-dir", default=None,
                   help="default: masa_big_<size>[_noprune].work under the "
                        "temporary directory")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu runs the plain versions (for the tests)")
    args = p.parse_args(argv)

    import torch

    from masa_tpu_torch.utils.devices import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"big_run: {e}", file=sys.stderr)
        return 2
    cuda = dev.type == "cuda"

    def say(text):
        print(text, flush=True)

    size = args.size
    wd = os.path.abspath(args.work_dir or work_dir_of(size, args.no_prune))
    meta = open_meta(wd, args.fresh, say)
    prev_elapsed = float(meta["elapsed_s"]) if meta else 0.0
    attempts = int(meta["attempts"]) if meta else 0
    resumed = meta is not None
    if resumed:
        say(f"[resume] attempt {attempts + 1}, {prev_elapsed:.1f}s "
            f"accumulated")

    from masa_tpu_torch import bench
    from masa_tpu_torch.core.job import Job, JobConfig
    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.stages import runner
    from masa_tpu_torch.tools import roofline

    card = roofline.card() if cuda else None
    if card:
        say(f"[card] {card}")
    build_s = bench.build_all() if cuda else {"all": 0.0}
    say(f"[build] {json.dumps(bench.rounded(build_s, 2))}")
    if cuda:
        kernels.event_log = []
        torch.cuda.reset_peak_memory_stats(dev)

    s0, s1 = pairs.big_pair(size)
    m = len(s0)
    say(f"[gen] {size}: m={m} n={len(s1)}")

    jcfg = JobConfig(work_dir=wd)
    if size == "23M":
        jcfg.disk_limit = 64 << 30
    jcfg.block_pruning = not args.no_prune
    job = Job(jcfg, device=dev)

    t0 = time.time()

    def save(marks, done=False):
        save_meta(wd, size, prev_elapsed + time.time() - t0, attempts + 1,
                  done, marks)

    log = RunLog(t0, save, wd)
    save(log.marks)
    try:
        aln = runner.align_job(job, s0, s1, log=log)
    except BaseException:
        save(log.marks)  # the attempt's seconds, for the next one
        raise
    finally:
        kernels.event_log = None
    dt = time.time() - t0
    total = prev_elapsed + dt
    save(log.marks, done=True)
    log.sample_disk(force=True)
    cells = m * len(s1)
    steady = max(total - build_s["all"], 1e-9)
    rows = bench.stats_of(wd, 1, bench.STATS_1)
    st2 = bench.stats_of(wd, 2, bench.STATS_2)
    print(json.dumps({
        "size": size, "m": m, "n": len(s1),
        "full_alignment_s": round(total, 2),
        "full_gcups": round(cells / total / 1e9, 2),
        "steady_s": round(steady, 2),
        "steady_gcups": round(cells / steady / 1e9, 2),
        "pruning": not args.no_prune,
        "pruned_cells": rows["pruned_cells"],
        "score": int(aln.raw_score),
        "reference_score": pairs.SCORES.get(size),
        "attempts": attempts + 1,
        "resumed": resumed,
        "this_attempt_s": round(dt, 2),
        "stage_end_marks_s": log.marks,
        "work_dir": wd,
        # the port's own keys
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card": card,
        "build_s": build_s,
        "stage_kernel_ms": log.kernel_ms,
        "stage_launches": log.launches,
        "special_rows": rows,
        "hops": {"issued": st2["issued"],
                 "one_launch": st2["issued"] - st2["issued_three"],
                 "three_launch": st2["issued_three"],
                 "stage2": st2},
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if cuda else None),
        "peak_rss_bytes": 1024 * resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss,
        "peak_work_dir_bytes": log.peak_disk,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
