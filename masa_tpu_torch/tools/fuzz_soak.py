"""The randomized differential lanes of the port: the counterpart of the
repository's ``tests/test_fuzz_modes.py`` (the lanes) and
``tools/fuzz_soak.py`` (the soak at fresh seeds), on either device.

    python -m masa_tpu_torch.tools.fuzz_soak                # the CUDA card
    python -m masa_tpu_torch.tools.fuzz_soak --offset 300 --per-lane 5
    python -m masa_tpu_torch.tools.fuzz_soak --device cpu   # plain versions

Each lane is a plain function ``lane(seed, device) -> record``: it draws
its case from ``numpy.random.default_rng(base + seed)`` exactly as the
reference's lane draws it (its base: 5000, 8000, 7000, 9000 and 9500 in
the order below; the committed tests' seeds are 0, 1, ...), runs it
through the port and holds the result to the port's oracle
(``ops/oracle.py``), raising on any mismatch.
The record is a dict: the lane, the seed, the shape, the scores, the
modes, the result's score, start and end, the seconds, and under
``"case"`` the drawn inputs and the port's outputs (for a caller that
holds them to another implementation).

1. ``pipeline_vs_oracle`` (``test_fuzz_modes.py:58``): ``align_pair``
   under random shapes, scores, start and end modes and special-row
   interval; the endpoint score per mode from the dense matrix (from the
   row oracle past ``DENSE_CELLS``), then the stage-6 re-check.
2. ``stage4_differential`` (``:145``): stage 1 and 2, then each of the
   three ``SplitStrategy`` values and the batched reducer (kernel 3 on a
   card), each followed by stage 5, each at stage 1's score.
3. ``sharded_vs_oracle`` (``:103``): ``sharded_align`` over 2, 3, 5 or
   8 slabs (all on the one device), random pruning, flush stride and
   traceback; the strip config carries no scores, so the engine must use
   the caller's.
4. ``oversize_weighted`` (``:179``): ``align_oversize`` with a random
   slab width.
5. ``crash_resume`` (``:210``): ``kill_and_resume`` kills
   ``runner.align_job`` with ``KeyboardInterrupt`` at a call drawn among
   those an uninterrupted run made of the kill points (``KILL_POINTS``:
   stage 1's row store, stage 2's reverse pass and device hops, stage 4,
   stage 5; the stage cycles with the seed) and resumes it, at the
   reference's ``LIMITS``: it must equal the uninterrupted run, in its
   gaps too unless the kill lost special rows kept in RAM.  m is drawn
   from 1100 to 2600, so that stage 1 stores 2 to 5 special rows; a case
   in which stage 1 stored none raises (the reference's own draw,
   m < 512, never crashes: its kill point is never reached twice).

Lanes 2 and 5 also record stage 2's crosspoints as a ``digest``, which
holds one device's stage 2 to another's.  ``sizes`` (each lane but 3)
replaces the reference's range of m; lane 1 also takes ``flush`` (the
range of special-row intervals) and ``modes`` (a fixed (start, end) pair,
drawn all the same so the rest of the case is the seed's).  Past
``DENSE_CELLS`` lane 1 takes the row oracle, which has no global maximum
of a global (NW) matrix: that mode pair raises there.  ``backend`` (lanes
1, 2 and 5) picks the passes' engine: on the CPU, "kernel" runs the
plain strips where "auto" would run the numpy engine, whose
goal-tracking passes take the dense oracle (minutes at 4096 x 4096 under
SW).

The soak prints one line per seed and lane and exits 1 on any failure,
each failure's traceback after the lines, as the reference's tool does;
on a card it also prints the kernels' launches per lane.  It imports no
module of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
import sys
import tempfile
import time
import traceback

import numpy as np

from masa_tpu_torch.ops import oracle
from masa_tpu_torch.stages import pipeline, stage6
from masa_tpu_torch.types import AlignmentStart, Recurrence, ScoreParams

S = AlignmentStart
STARTS = [S.ANYWHERE, S.SEQUENCE_1_AND_2, S.SEQUENCE_1, S.SEQUENCE_2,
          S.SEQUENCE_1_OR_2]
ENDS = [None, S.ANYWHERE, S.SEQUENCE_1_AND_2, S.SEQUENCE_1, S.SEQUENCE_2,
        S.SEQUENCE_1_OR_2]
# the dense oracle's size limit in lane 1 (its cell loop is Python)
DENSE_CELLS = 1 << 18
BASES = np.frombuffer(b"ACGT", np.uint8)


def _expected(ref, m, n, start, end, rec):
    """Endpoint score per mode, derived from the dense matrix alone."""
    h = ref.h
    if end is None:
        end = S.ANYWHERE if start == S.ANYWHERE else S.SEQUENCE_1_AND_2
    if end == S.ANYWHERE:
        if rec == Recurrence.SMITH_WATERMAN:
            return int(h.max())
        b, _, _ = ref.best()
        return int(b)
    if end == S.SEQUENCE_1_AND_2:
        return int(h[m, n])
    cands = []
    if end in (S.SEQUENCE_2, S.SEQUENCE_1_OR_2):
        cands.append(int(h[m, :].max()))
    if end in (S.SEQUENCE_1, S.SEQUENCE_1_OR_2):
        cands.append(int(h[:, n].max()))
    return max(cands)


def _expected_rows(ref, n, start, end, rec):
    """The same from the row oracle: the best for SW, the corner, the
    maxima of the last row and column; no global maximum under NW."""
    if end is None:
        end = S.ANYWHERE if start == S.ANYWHERE else S.SEQUENCE_1_AND_2
    if end == S.ANYWHERE:
        if rec != Recurrence.SMITH_WATERMAN:
            raise ValueError("the row oracle keeps no global maximum of a "
                             "global matrix: draw this mode pair smaller")
        return int(ref.best)
    if end == S.SEQUENCE_1_AND_2:
        return int(ref.last_h[n])
    cands = []
    if end in (S.SEQUENCE_2, S.SEQUENCE_1_OR_2):
        cands.append(int(ref.last_h.max()))
    if end in (S.SEQUENCE_1, S.SEQUENCE_1_OR_2):
        cands.append(int(ref.col_h.max()))
    return max(cands)


def _params(rng, top=(3, 4, 4, 3)):
    """Random scores, drawn as the reference draws them."""
    return ScoreParams(match=int(rng.integers(1, top[0])),
                       mismatch=-int(rng.integers(1, top[1])),
                       gap_open=int(rng.integers(1, top[2])),
                       gap_ext=int(rng.integers(1, top[3])))


def _mutate(rng, s1, rate):
    idx = rng.random(len(s1)) < rate
    s1[idx] = rng.choice(BASES, int(idx.sum())).astype(np.uint8)
    return s1


def _homolog(rng, lo, hi, rate):
    """m from [lo, hi), s0 random, s1 its copy with ``rate`` mutations."""
    m = int(rng.integers(lo, hi))
    s0 = rng.choice(BASES, m).astype(np.uint8)
    return s0, _mutate(rng, s0.copy(), rate)


def _record(lane, seed, s0, s1, params, aln, t0, **kw):
    return {"lane": lane, "seed": seed, "m": len(s0), "n": len(s1),
            "params": [params.match, params.mismatch, params.gap_open,
                       params.gap_ext],
            "score": int(aln.raw_score), "start": [int(x) for x in aln.start],
            "end": [int(x) for x in aln.end],
            "seconds": round(time.perf_counter() - t0, 3), **kw}


def _same(what, got, want):
    if got != want:
        raise AssertionError(f"{what}: the port gave {got}, the oracle "
                             f"{want}")


def gaps(aln) -> list:
    return [[(int(g.pos), int(g.len)) for g in side] for side in aln.gaps]


def digest(cps) -> str:
    """A crosspoint chain's length and a hash of its (i, j, score, type):
    what holds one run's stage 2 to another's."""
    rows = np.array([[int(x) for x in cp] for cp in cps], np.int64)
    return f"{len(cps)}:{hashlib.sha256(rows.tobytes()).hexdigest()[:16]}"


def pipeline_vs_oracle(seed: int, device="cuda", *, sizes=None, flush=None,
                       modes=None, backend="auto") -> dict:
    """Lane 1: the full pipeline against the dense oracle across the
    start/end mode matrix, random scores and special-row interval."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(5000 + seed)
    lo, hi = sizes or (40, 320)
    m = int(rng.integers(lo, hi))
    n = int(rng.integers(lo, hi))
    s0 = rng.choice(BASES, m).astype(np.uint8)
    if rng.random() < 0.6:
        # homologous core so paths are nontrivial
        s1 = s0[: n].copy() if n <= m else np.concatenate(
            [s0, rng.choice(BASES, n - m)]).astype(np.uint8)
        s1 = _mutate(rng, s1, 0.1)
    else:
        s1 = rng.choice(BASES, n).astype(np.uint8)
    n = len(s1)
    params = _params(rng, (4, 5, 5, 4))
    start = STARTS[rng.integers(len(STARTS))]
    end = ENDS[rng.integers(len(ENDS))]
    if modes is not None:
        start, end = modes
    row_init, col_init = pipeline._mode_inits(start)
    rec = pipeline._recurrence(start)
    if m * n <= DENSE_CELLS:
        ref = oracle.dp_matrix(s0, s1, params, rec, row_init, col_init)
        want = _expected(ref, m, n, start, end, rec)
    else:
        ref = oracle.dp_rows(s0, s1, params, rec, row_init, col_init)
        want = _expected_rows(ref, n, start, end, rec)
    flush_lo, flush_hi = flush or (32, 128)
    pcfg = pipeline.PipelineConfig(
        params=params, alignment_start=start, alignment_end=end,
        backend=backend, max_cells_stage5=1 << 12,
        flush_interval=int(rng.integers(flush_lo, flush_hi)), device=device)
    aln = pipeline.align_pair(s0, s1, pcfg)
    # local alignments clamp at the empty alignment
    if start == S.ANYWHERE and (end is None or end == S.ANYWHERE):
        want = max(want, 0)
    _same(f"mode ({start.name}, {None if end is None else end.name}) "
          f"params {params}",
          aln.raw_score, want)
    stage6.recheck(aln, s0, s1, params)
    return _record("pipeline_vs_oracle", seed, s0, s1, params, aln, t0,
                   modes=[start.name, None if end is None else end.name],
                   flush=pcfg.flush_interval,
                   case={"s0": s0, "s1": s1, "params": params,
                         "start": start, "end": end,
                         "flush": pcfg.flush_interval, "aln": aln})


def sharded_vs_oracle(seed: int, device="cuda") -> dict:
    """Lane 3: the full sharded alignment over a random slab count, flush
    stride, pruning and traceback, against the row oracle.  Returns a
    record with ``skipped`` set where the best local score is not
    positive (nothing to trace)."""
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.parallel.mesh import make_mesh
    from masa_tpu_torch.parallel.sharded import sharded_align

    t0 = time.perf_counter()
    rng = np.random.default_rng(7000 + seed)
    m = int(rng.integers(80, 400))
    s0 = rng.choice(BASES, m).astype(np.uint8)
    s1 = s0[: int(rng.integers(60, m + 60))].copy()
    if len(s1) > m:
        s1 = np.concatenate([s1[:m], rng.choice(
            BASES, len(s1) - m)]).astype(np.uint8)
    s1 = _mutate(rng, s1, 0.12)
    params = _params(rng, (3, 4, 4, 3))
    D = int(rng.choice([2, 3, 5, 8]))
    # deliberately NO scores of the caller's in the cfg (it holds the
    # defaults): the engine must use the caller's params
    cfg = wf.StripConfig(rows=512, track_best=True, store_lastcol=True)
    ref = oracle.dp_rows(s0, s1, params)
    kw = dict(prune=bool(rng.integers(2)),
              flush_stride=int(rng.choice([1, 2, 4])),
              traceback=str(rng.choice(["pipelined", "speculative"])))
    case = {"s0": s0, "s1": s1, "params": params, "D": D, **kw}
    if ref.best <= 0:
        return {"lane": "sharded_vs_oracle", "seed": seed, "m": m,
                "n": len(s1), "skipped": "best <= 0", "case": case,
                "seconds": round(time.perf_counter() - t0, 3)}
    best, aln = sharded_align(s0, s1, make_mesh(D, device=device), cfg,
                              params, **kw)
    _same(f"sharded over {D} slabs {kw}", (best, aln.raw_score),
          (ref.best, ref.best))
    stage6.recheck(aln, s0, s1, params)
    return _record("sharded_vs_oracle", seed, s0, s1, params, aln, t0,
                   slabs=D, **kw, case={**case, "best": best, "aln": aln})


def stage4_differential(seed: int, device="cuda", *, sizes=None,
                        backend="auto") -> dict:
    """Lane 2: the three Myers-Miller strategies and the batched reducer
    on the same stage-2 crosspoints, each followed by stage 5, each at
    stage 1's score (the row oracle's)."""
    from masa_tpu_torch.ops import batched_mm
    from masa_tpu_torch.ops import myers_miller as mm

    t0 = time.perf_counter()
    rng = np.random.default_rng(8000 + seed)
    s0, s1 = _homolog(rng, *(sizes or (100, 300)), 0.15)
    params = _params(rng, (3, 4, 4, 3))
    pcfg = pipeline.PipelineConfig(params=params, max_cells_stage5=1 << 18,
                                   backend=backend, device=device)
    res, ep = pipeline.stage1_pass(s0, s1, pcfg)
    _same("stage 1's best", ep.score, int(oracle.dp_rows(s0, s1, params)
                                          .best))
    cps = pipeline.stage2_march(s0, s1, pcfg, ep, res.specials,
                                res.dev_cache)
    res = None
    mps = int(rng.choice([8, 16, 32]))
    out = {}
    for strat in mm.SplitStrategy:
        out[strat.name] = mm.reduce_partitions(s0, s1, cps, params, mps,
                                               strat)
    out["batched"] = batched_mm.reduce_partitions_batched(
        s0, s1, cps, params, mps, device=device)
    for name, got in out.items():
        aln = pipeline.stage5_emit(s0, s1, pcfg, got)
        _same(f"stage 5 after {name}", aln.raw_score, ep.score)
    return _record("stage4_differential", seed, s0, s1, params, aln, t0,
                   max_partition=mps, stage2=digest(cps),
                   case={"s0": s0, "s1": s1, "params": params, "mps": mps,
                         "stage2": cps, "out": out})


def oversize_weighted(seed: int, device="cuda", *, sizes=None) -> dict:
    """Lane 4: chained column slabs of a random width against the row
    oracle."""
    from masa_tpu_torch.parallel.split import align_oversize

    t0 = time.perf_counter()
    rng = np.random.default_rng(9000 + seed)
    lo, hi = sizes or (150, 350)
    s0, s1 = _homolog(rng, lo, hi, 0.12)
    params = _params(rng, (3, 4, 4, 3))
    ref = oracle.dp_rows(s0, s1, params)
    width = int(rng.integers(lo * 2 // 5, lo * 14 // 15))
    case = {"s0": s0, "s1": s1, "params": params, "width": width}
    if ref.best <= 0:
        return {"lane": "oversize_weighted", "seed": seed, "m": len(s0),
                "n": len(s1), "skipped": "best <= 0", "case": case,
                "seconds": round(time.perf_counter() - t0, 3)}
    with tempfile.TemporaryDirectory() as td:
        best, aln = align_oversize(s0, s1, width, td, params,
                                   max_cells_stage5=1 << 12, device=device)
    _same(f"oversize at width {width}", (best, aln.raw_score),
          (ref.best, ref.best))
    return _record("oversize_weighted", seed, s0, s1, params, aln, t0,
                   width=width, case={**case, "best": best, "aln": aln})


# (stage, module, attribute): the calls lane 5 may be killed in
KILL_POINTS = (
    (1, "runner", "_OffsetStore.put"),
    (1, "runner", "_OffsetStore.put_lazy"),
    (1, "runner", "_OffsetStore.put_best"),
    (2, "core", "reverse_pass_and_match"),
    (2, "core", "_run_hop_chain"),
    (2, "core", "_run_arb_hop"),
    (4, "myers_miller", "stage4_reduce"),
    (5, "pipeline", "stage5_emit"),
)
KILL_STAGES = (1, 2, 4, 5)


def _kill_owner(mod, attr):
    """The object holding the kill point, and the attribute's name."""
    from masa_tpu_torch.ops import myers_miller
    from masa_tpu_torch.stages import core, runner

    obj = {"runner": runner, "core": core, "myers_miller": myers_miller,
           "pipeline": pipeline}[mod]
    *path, name = attr.split(".")
    for p in path:
        obj = getattr(obj, p)
    return obj, name


@contextlib.contextmanager
def _counting(kill=None):
    """Count the calls of every kill point inside the block; with
    ``kill`` = (point, k), raise KeyboardInterrupt at that point's k-th
    call, before it runs."""
    calls = {f"{mod}.{attr}": 0 for _, mod, attr in KILL_POINTS}
    saved = []
    for _, mod, attr in KILL_POINTS:
        obj, name = _kill_owner(mod, attr)
        orig = obj.__dict__[name]
        key = f"{mod}.{attr}"

        def wrapped(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            if kill is not None and kill == (_key, calls[_key]):
                raise KeyboardInterrupt(f"crash-monkey at {_key} call "
                                        f"{calls[_key]}")
            return _orig(*a, **kw)

        saved.append((obj, name, orig))
        setattr(obj, name, wrapped)
    try:
        yield calls
    finally:
        for obj, name, orig in saved:
            setattr(obj, name, orig)


# the reference lane's JobConfig limits (test_fuzz_modes.py:233): the
# special rows alternate between RAM and disk
LIMITS = {"ram_limit": 1 << 20, "disk_limit": 1 << 20,
          "stage4_max_partition": 16, "stage5_max_cells": 1 << 12}


def _rows_lost(job) -> list:
    """The special rows of stage 1 that a job killed before the end of
    stage 2 held in RAM or in flight to the disk (a fresh open of its
    area sees the disk rows alone), and that its resumed run neither
    reads back nor recomputes: all of them where stage 1 had ended,
    those above the last disk row, where stage 1 resumes, where it had
    not."""
    from masa_tpu_torch.core.sra import SpecialRowsArea
    from masa_tpu_torch.stages import runner

    if runner._load(job.crosspoints_file(runner.STAGE_2, 0))[1]:
        return []
    area = job.sra_area(runner.STAGE_1, 0)
    disk = {r for p in SpecialRowsArea(area.dir).partitions()
            for r in p.rows()}
    lost = {r for p in area.partitions() for r in p.rows()} - disk
    if not runner._load(job.crosspoints_file(runner.STAGE_1, 0))[1]:
        lost = {r for r in lost if r < max(disk, default=0)}
    return sorted(lost)


def kill_and_resume(seed: int, device="cuda", *, sizes=None,
                    backend="auto") -> dict:
    """Lane 5's run: an uninterrupted ``runner.align_job`` that counts the
    calls of every kill point, then the same job killed at a call drawn
    among them and re-run, at the reference's ``LIMITS``.  Returns the
    case: the inputs, the JobConfig's limits, both alignments, the clean
    run's stage-2 crosspoints, the kill, the counts and the rows the kill
    lost (``_rows_lost``: a row kept in RAM does not outlive the run that
    stored it, so a resumed stage 2 may match at other rows and emit
    another co-optimal path).  Raises where stage 1 stored no special
    row, and where the kill was not reached."""
    from masa_tpu_torch.core.job import Job, JobConfig
    from masa_tpu_torch.stages import runner

    rng = np.random.default_rng(9500 + seed)
    s0, s1 = _homolog(rng, *(sizes or (1100, 2600)), 0.12)
    params = _params(rng, (3, 4, 4, 3))
    limits = {**LIMITS, "backend": backend}

    def quiet(*a, **k):
        pass

    with tempfile.TemporaryDirectory() as td:
        def job(tag):
            return Job(JobConfig(work_dir=os.path.join(td, tag),
                                 params=params, **limits), device=device)

        with _counting() as calls:
            clean_job = job("clean")
            clean = runner.align_job(clean_job, s0, s1, log=quiet)
        if not calls["runner._OffsetStore.put"] + calls[
                "runner._OffsetStore.put_lazy"]:
            raise AssertionError(
                f"no special row stored (m = {len(s0)}): stage 1 cannot "
                f"be killed, and the case would resume nothing")
        stage2 = clean_job.crosspoints_file(runner.STAGE_2, 0).load()
        # the stage cycles with the seed; the point and call among those
        # of that stage the clean run made
        stage = KILL_STAGES[seed % len(KILL_STAGES)]
        points = [f"{mod}.{attr}" for st, mod, attr in KILL_POINTS
                  if st == stage and calls[f"{mod}.{attr}"]]
        point = points[int(rng.integers(len(points)))]
        k = int(rng.integers(1, calls[point] + 1))
        killed = job("crashy")
        try:
            with _counting((point, k)):
                runner.align_job(killed, s0, s1, log=quiet)
        except KeyboardInterrupt:
            pass
        else:
            raise AssertionError(f"the run was not killed at {point} call "
                                 f"{k} (the clean run made {calls[point]})")
        lost = _rows_lost(killed)
        resumed = runner.align_job(job("crashy"), s0, s1, log=quiet)
    return {"s0": s0, "s1": s1, "params": params, "limits": limits,
            "clean": clean, "resumed": resumed, "stage2": stage2,
            "kill": [point, k], "lost": lost,
            "calls": {p: c for p, c in calls.items() if c}}


def crash_resume(seed: int, device="cuda", *, sizes=None,
                 backend="auto") -> dict:
    """Lane 5: ``kill_and_resume``; the resumed alignment must equal the
    uninterrupted one in score, start and end, in its gaps too unless the
    kill lost special rows, and re-score (stage 6); the uninterrupted
    score must be the oracle's.  Every case must crash."""
    t0 = time.perf_counter()
    c = kill_and_resume(seed, device, sizes=sizes, backend=backend)
    clean, resumed = c["clean"], c["resumed"]
    _same("the uninterrupted run", clean.raw_score,
          int(oracle.dp_rows(c["s0"], c["s1"], c["params"]).best))
    held = [("score", resumed.raw_score, clean.raw_score),
            ("start, end", (resumed.start, resumed.end),
             (clean.start, clean.end)),
            ("re-score", stage6.recheck(resumed, c["s0"], c["s1"],
                                        c["params"]).score,
             resumed.raw_score)]
    if not c["lost"]:
        held.append(("gaps", gaps(resumed), gaps(clean)))
    for what, got, want in held:
        if got != want:
            raise AssertionError(f"resumed after a kill at {c['kill']}: "
                                 f"{what} {got}, uninterrupted {want}")
    return _record("crash_resume", seed, c["s0"], c["s1"], c["params"],
                   resumed, t0, kill=c["kill"], lost=c["lost"],
                   calls=c["calls"], stage2=digest(c["stage2"]), case=c)


# in the reference tool's order
LANES = {
    "pipeline_vs_oracle": pipeline_vs_oracle,
    "sharded_vs_oracle": sharded_vs_oracle,
    "stage4_differential": stage4_differential,
    "oversize_weighted": oversize_weighted,
    "crash_resume": crash_resume,
}


def pool_init():
    """A worker of a process pool of lanes: one thread of torch's, so
    that the workers share the host's cores."""
    import torch

    torch.set_num_threads(1)


# the kernels the lanes run on a card
COUNTED = ("strip", "batched_strip", "hop", "hop_prep", "hop_match")


def launches() -> dict:
    """The launch counts of ``COUNTED``'s wrappers, by name."""
    from masa_tpu_torch.ops import kernels

    return {k: getattr(kernels, f"{k}_cuda").launches for k in COUNTED}


def lane_record(name: str, seed: int, device: str, **kw) -> dict:
    """Lane ``name`` at ``seed``: its record without the case (what a
    worker process hands back), with the launches of each kernel the
    lane made under ``"launches"``."""
    before = launches()
    rec = LANES[name](seed, device, **kw)
    made = {k: v - before[k] for k, v in launches().items()}
    return {**{k: v for k, v in rec.items() if k != "case"},
            "launches": made}


def summary(rec: dict) -> str:
    """A record's line, without its case."""
    skip = ("lane", "seed", "case", "seconds")
    return " ".join(f"{k}={v}" for k, v in rec.items() if k not in skip)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--offset", type=int, default=100,
                   help="first seed (the committed tests' seeds end well "
                        "below 100)")
    p.add_argument("--per-lane", type=int, default=20)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu runs the plain versions")
    args = p.parse_args(argv)

    from masa_tpu_torch.utils.devices import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"fuzz_soak: {e}", file=sys.stderr)
        return 2
    failures = []
    t0 = time.time()
    for name in LANES:
        made = dict.fromkeys(COUNTED, 0)
        for s in range(args.offset, args.offset + args.per_lane):
            try:
                rec = lane_record(name, s, str(dev))
                for k, v in rec.pop("launches").items():
                    made[k] += v
                status = "ok " + summary(rec)
            except Exception:  # noqa: BLE001 - a soak records, never stops
                status = "FAIL"
                failures.append((name, s, traceback.format_exc()))
            print(f"[{time.time() - t0:7.1f}s] {name} seed={s} {status}",
                  flush=True)
        if dev.type == "cuda":
            print(f"  {name}: launches " + " ".join(
                f"{k}={v}" for k, v in made.items()), flush=True)

    print(f"\n=== soak done: {len(failures)} failures ===", flush=True)
    for name, s, tb in failures:
        print(f"\n--- {name} seed={s} ---\n{tb}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
