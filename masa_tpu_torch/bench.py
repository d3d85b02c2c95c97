"""Stage-1 Smith-Waterman GCUPS and the full six-stage alignment on one
device: the port's counterpart of the repository's ``bench.py``, with its
pairs, phases and JSON keys.

    python -m masa_tpu_torch.bench                 # the CUDA card
    python -m masa_tpu_torch.bench --device cpu    # plain versions, small

First the kernels the card's path loads are built (``csrc/strip.cu``,
``csrc/batched_strip.cu``, ``csrc/hop.cu`` with nvcc, the native helpers
with g++, all started together, into ``masa_tpu_torch/_build/``), timed
apart from everything else.

Stage 1: bench.py's random 2^20 x 2^20 pair (``tools/pairs.random_pair``)
through ``ops/strips.run_partition`` with the best tracked and no last
column, at the card's own strip geometry (``stages/core.default_config``:
one launch of the strip kernel covers the partition), after one warm-up
strip; the best of 2 timed runs, each run's seconds printed.

Full: bench.py's 1M homolog (``tools/pairs.bench_pair``) through
``stages/runner.align_job`` at ``JobConfig``'s defaults (1 GiB of RAM and
16 GiB of disk for special rows: a row every 512 rows here), in a
temporary work directory removed afterwards; twice, the first run's time
is the cold one and the faster one is kept.  Per stage: seconds between
the runner's completion lines, kernel milliseconds (CUDA events around
every launch) and launches by wrapper.  Beside them the special rows
(interval, rows and bytes on the card, in RAM and on disk:
``statistics_01.00``), stage 2's hops (``statistics_02.00``) and the peak
device memory.

``--device cpu`` runs bench.py's CPU sizes (2048 x 2048 for stage 1, a
full run of 1024 bases with an indel every 2^9) on the plain versions,
once each; its line says ``"device": "cpu"``.  ``MASA_BENCH_FULL=0``
skips the full phase.  A CUDA run with no card, and a failure in any
phase, raise: no line is printed then.  The last line of the output is
one JSON object; every line before it starts with ``#``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

BASELINE_GCUPS = 25.82   # 1M x 1M stage 1, GTX 560 Ti (CUDAlign, TPDS 2013)
BASELINE_FULL_S = 43.0   # the full 1M x 1M run on the same card
COUNTED = ("strip", "batched_strip", "hop", "hop_prep", "hop_match")
STATS_1 = ("flush_interval", "dev_rows", "dev_row_bytes", "dev_row_budget",
           "lazy_rows", "ram_rows", "ram_bytes", "disk_rows", "disk_bytes",
           "pruned_cells")
STATS_2 = ("dev_matches", "host_matches", "window_reads", "window_bytes",
           "chained", "segments", "chain_breaks", "issued")

# a stage's completion line, as the runner (stages/runner.py) and the
# CLI's split and sharded modes print it: "stageN: ... in X.XXs" for
# stages 1-5, with the stage's own seconds, and "stage6: wrote PATH";
# progress lines, resume notes and stage 4's level lines ("stage4[batched]:
# level ...") are none of them
_DONE = re.compile(r"(stage[1-5]): .*? in ([\d.]+)s\b|(stage6): wrote ")


def stage_done(msg: str) -> tuple[str, float | None] | None:
    """(the stage, the seconds its line states: None for stage 6) if
    ``msg`` is a stage's completion line, else None."""
    m = _DONE.match(msg)
    if m is None:
        return None
    return (m[1], float(m[2])) if m[1] else (m[3], None)


def say(text: str) -> None:
    print(f"# {text}", flush=True)


def launch_counts() -> dict:
    from masa_tpu_torch.ops import kernels

    return {k: getattr(kernels, f"{k}_cuda").launches for k in COUNTED}


class StageClock:
    """The runner's ``log``: at each completion line, the stage's seconds
    since the line before (the first from the clock's start), the kernel
    milliseconds its launches took and its launches by wrapper.  Every
    line but stage 1's progress lines is echoed."""

    def __init__(self):
        self.seconds, self.kernel_ms, self.launches = {}, {}, {}
        self._seen = launch_counts()
        self._t = time.time()

    def __call__(self, *a, **_):
        from masa_tpu_torch.ops import kernels

        msg = " ".join(str(x) for x in a)
        if not msg.startswith("stage1: ... flushed"):
            say(msg)
        done = stage_done(msg)
        if done is None:
            return
        name = done[0]
        ms = kernels.drain_events()  # waits for the card
        now = time.time()
        self.seconds[name] = now - self._t
        self._t = now
        counts = launch_counts()
        self.kernel_ms[name] = ms
        self.launches[name] = {k: counts[k] - self._seen[k] for k in counts}
        self._seen = counts


def build_all() -> dict:
    """Build the card path's libraries, one compiler each, all started
    together: seconds by library and in all (0 for one already built)."""
    from masa_tpu_torch.native import bindings
    from masa_tpu_torch.ops import kernels

    def timed(fn, *args):
        t0 = time.time()
        fn(*args)
        return time.time() - t0

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        futs = {name: ex.submit(timed, kernels.build, name)
                for name in ("strip", "batched_strip", "hop")}
        futs["masanative"] = ex.submit(timed, bindings.available)
    out = {name: f.result() for name, f in futs.items()}
    out["all"] = time.time() - t0
    return out


def stats_of(work: str, stage: int, keys) -> dict:
    """The integer lines ``keys`` of a work dir's statistics file."""
    with open(os.path.join(work, f"statistics_0{stage}.00")) as fh:
        got = dict(re.findall(r"^\s*(\w+): (-?\d+)$", fh.read(), re.M))
    return {k: int(got[k]) for k in keys}


def stage1_phase(dev: torch.device, s0, s1, runs: int) -> dict:
    """bench.py's stage-1 timing: a warm-up strip, then the best of
    ``runs`` whole partitions."""
    from masa_tpu_torch.ops import kernels, strips
    from masa_tpu_torch.stages import core
    from masa_tpu_torch.types import InitType, ScoreParams

    cfg = core.default_config(dev)
    params = ScoreParams()
    zero = InitType.WITH_ZEROES

    def one(rows, **kw):
        t0 = time.time()
        a = torch.from_numpy(s0[:rows]).to(dev)
        b = torch.from_numpy(s1).to(dev)
        res = strips.run_partition(cfg, a, b, params, zero, zero, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res, time.time() - t0

    one(min(cfg.rows, len(s0)))
    kernels.drain_events()
    secs, ms, best = [], [], None
    for k in range(runs):
        res, dt = one(len(s0), want_last_row=False)
        secs.append(dt)
        ms.append(kernels.drain_events())
        say(f"stage 1 run {k + 1}: {dt:.4f} s, kernel ms "
            f"{json.dumps(ms[-1])}, best {res.best}")
        if best is None or dt < secs[best]:
            best = k
    return {"res": res, "seconds": secs[best], "runs_s": secs,
            "kernel_ms": ms[best]}


def full_phase(dev: torch.device, s0, s1, runs: int) -> dict:
    """bench.py's full runs: ``runs`` alignments at JobConfig's defaults,
    each in a temporary work directory; the faster run's numbers and
    the first run's seconds."""
    from masa_tpu_torch.core.job import Job, JobConfig
    from masa_tpu_torch.stages import runner
    from masa_tpu_torch.types import ScoreParams

    cuda = dev.type == "cuda"
    kept, cold, all_s = None, None, []
    for k in range(runs):
        work = tempfile.mkdtemp(prefix="masa_bench_")
        try:
            free = shutil.disk_usage(work).free
            if cuda:
                torch.cuda.empty_cache()  # each run sees the same budget
                torch.cuda.reset_peak_memory_stats(dev)
            job = Job(JobConfig(work_dir=work, params=ScoreParams()),
                      device=dev)
            clock = StageClock()
            t0 = time.time()
            aln = runner.align_job(job, s0, s1, log=clock)
            dt = time.time() - t0
            run = {"seconds": dt, "score": aln.raw_score,
                   "stage_s": clock.seconds, "kernel_ms": clock.kernel_ms,
                   "launches": clock.launches,
                   "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if cuda else None),
                   "special_rows": stats_of(work, 1, STATS_1),
                   "stage2": stats_of(work, 2, STATS_2)}
        finally:
            shutil.rmtree(work, ignore_errors=True)
        say(f"full run {k + 1}: {dt:.3f} s, score {aln.raw_score}; per "
            f"stage {json.dumps(rounded(clock.seconds))}; special rows "
            f"{json.dumps(run['special_rows'])}; stage 2 "
            f"{json.dumps(run['stage2'])}; peak device memory "
            f"{run['peak_device_bytes']} bytes; {free} bytes free where "
            f"the work directory was")
        all_s.append(dt)
        cold = dt if cold is None else cold
        if kept is None or dt < kept["seconds"]:
            kept = run
    return {**kept, "cold": cold, "runs_s": all_s}


def rounded(d: dict, nd: int = 3) -> dict:
    return {k: round(v, nd) for k, v in d.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu runs the plain versions at small sizes (for "
                        "the tests)")
    args = p.parse_args(argv)

    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.tools import roofline
    from masa_tpu_torch.tools.pairs import homolog, random_pair
    from masa_tpu_torch.utils.devices import resolve_device

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    card = roofline.card() if cuda else None
    if card:
        say(f"card: {card}")
    build_s = build_all() if cuda else None
    if build_s:
        say(f"build seconds {json.dumps(rounded(build_s, 2))}")
    kernels.event_log = [] if cuda else None
    base = launch_counts()

    m = n = (1 << 20) if cuda else 2048
    runs = 2 if cuda else 1
    s0, s1 = random_pair(m, n)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    st1 = stage1_phase(dev, s0, s1, runs)
    res, dt = st1["res"], st1["seconds"]
    gcups = res.cells / dt / 1e9
    if cuda:
        say(f"stage 1 phase: peak device memory "
            f"{torch.cuda.max_memory_allocated(dev)} bytes")

    full = None
    if os.environ.get("MASA_BENCH_FULL", "1") != "0":
        fm = m if cuda else 1024
        h1 = homolog(np.random.default_rng(1), s0[:fm],
                     indel_every=1 << (16 if cuda else 9))
        full = full_phase(dev, s0[:fm], h1, runs)
        full["gcups"] = fm * len(h1) / full["seconds"] / 1e9
    counts = launch_counts()
    kernels.event_log = None

    def of_full(key, fn=lambda v: v):
        return fn(full[key]) if full is not None else None

    print(json.dumps({
        "metric": "stage1_sw_gcups_1chip",
        "value": round(gcups, 2),
        "unit": "GCUPS",
        "vs_baseline": round(gcups / BASELINE_GCUPS, 3),
        "detail": {
            "m": m, "n": n, "seconds": round(dt, 3),
            "best_score": res.best,
            "backend": "cuda" if cuda else "plain",
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "full_alignment_s": of_full("seconds", lambda v: round(v, 2)),
            "full_alignment_cold_s": of_full("cold", lambda v: round(v, 2)),
            "full_gcups": of_full("gcups", lambda v: round(v, 2)),
            "full_score": of_full("score"),
            "full_vs_baseline_s": of_full(
                "seconds", lambda v: round(BASELINE_FULL_S / v, 3)),
            "full_stage_s": of_full("stage_s", rounded),
            "full_error": None,  # a failing phase raises instead
            # the port's own keys
            "card": card,
            "build_s": build_s,
            "stage1_runs_s": st1["runs_s"],
            "stage1_kernel_ms": st1["kernel_ms"],
            "full_runs_s": of_full("runs_s"),
            "full_kernel_ms": of_full("kernel_ms"),
            "full_launches": of_full("launches"),
            "full_peak_device_bytes": of_full("peak_device_bytes"),
            "full_special_rows": of_full("special_rows"),
            "full_stage2": of_full("stage2"),
            "launches": {k: counts[k] - base[k] for k in COUNTED},
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
