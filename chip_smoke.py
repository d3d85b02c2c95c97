#!/usr/bin/env python3
"""Drive masa_tpu_torch once on one CUDA card, end to end.

Run from the root of a checkout:  python3 chip_smoke.py
(``--save-stage4 FILE.npz`` also keeps the 1M pair and the element tables
of its stage-4 launches, for ``tools/batched_tune.py --tables``).

Phases (any failure raises and the run exits non-zero):
  1. the card's name and power limit; build csrc/strip.cu,
     csrc/batched_strip.cu, csrc/roofline.cu, csrc/hop.cu and
     csrc/traceback.cu with nvcc, one process each, all started together;
  2. each kernel against its plain PyTorch version on the card, exact
     integer equality.  The strip kernel: SW/NW x four border types x full
     and partial heights x flush on/off x best/last-column tracking x odd
     widths, blocks reused on a capped grid, and a strip of more sub-strips
     than the card holds at once (sampled intervals); then two main-path
     shapes, timed: 8192 rows x 2^20 columns (SW), and one stage-2 hop,
     8192 x 16384 (NW, best tracked, pinned borders).  The batched strip kernel:
     batches of mixed heights, widths and border codes, tall elements
     that chain in one block, zero widths.  The equal-shape batched strip
     kernel: CUSTOM borders, odd widths, 1 to 3000 elements, tall
     elements that chain sub-strips; then timed at 8192 x 64 x 128.  Every
     roofline body (the TPU tool's five and the three with the kernels'
     own cell) at 0, 1 and 61 iterations.  The stage-2 hop
     (csrc/hop.cu): the one-launch hop kernel against wavefront.hop_plain
     (``tools/hop_tune.check_fused``: its state with the last row asked
     for and without, and the whole last row) and the three-launch
     route's prologue and epilogue against theirs
     (``tools/hop_tune.check``), in every case: every crosspoint type, SW
     and NW, hits at k = 0 and beyond, no stop, an overshoot, ok = 0 on
     entry, cj < W + 1, a reachable goal, random states, at the hops the
     main paths issue on the 1M pair (a cut of 2^20; the CLI's W 16384,
     hb 8192, the bench's W 1024, hb 512, both read off the code that
     picks them) and, for the one launch, at a hop past one CTA (W 2048,
     hb 1000); then both forms timed at both main-path hops
     (``hop_tune.timed``: the three launches back to back, each alone
     and whole, against the one launch, its first stop planted at k = hb
     and swept to the end; a segment's in-path events and host issue
     time), outputs held equal to the plain versions'; the device delta
     packing against its plain form (the same row on the CPU), and one
     row of 2^20 pulled to the host as int32 and packed, timed;
  2m. stage 5's batched traceback kernel (csrc/traceback.cu) against its
     plain version and the native call at every degenerate and main-path
     shape and state; the 1M self-pair's stage 5 on the card and on the
     host, byte for byte the same alignment file; the kernel timed against
     its bound (``traceback_phase``);
  3. the golden real pairs through masa_tpu_torch.align(device="cuda"):
     real1 must score 11367 ending at (16384, 15805), real2 32466;
  4. the bench.py 1M x 1M homologous pair through the six pipeline stages
     (pipeline.align_pair, then the stage-6 re-score): score 796634, stage 5
     verified, the re-score equal, strip-kernel launches in stages 1, 2 and
     3 (stage 4 stops at isqrt(max_cells_stage5) and may find nothing to
     split after stage 3); the rows stage 1 kept on the card (count, bytes,
     budget, the peak device memory) and stage 2's hops matched on the card
     (more than 0, or the run fails) and on the host;
  4b. stage 1 of align_pair's passes on the same pair with the rows handed
     to the store eagerly (pulled as int32) and lazily, then stage 2 four ways over the lazy run's rows: on the
     host (a whole row a hop), from cut windows (no cache), from the row
     cache hop by hop, and from the row cache with chained hops; the four
     crosspoint lists must be equal, the cache's marches must match on the
     card, the windows' must read windows and the chained one must chain
     hops; each march's sequence uploads and flips are printed;
  5. the CLI on the same pair, written as FASTA files, every special row
     on disk: one full call (stage 2 from the rows stage 1 kept on the
     card: its hops matched there must be more than 0, its chained hops
     too, each issued hop one launch of the hop kernel and none of the
     three-launch route's, and its stage 2 must copy no sequence from the
     host; the cache's
     rows, bytes and budget, the peak device memory, the chained hops and
     segments (one verdict pull each) are printed), then
     `--stage-1` (lazy rows, written packed; block pruning on, the CLI's
     default: its pruned cells and their share of m n are printed, and
     none fails the run), the same `--stage-1` again in another work
     directory with the rows handed over eagerly (every row must read
     back through the special-rows area equal to the lazy run's, with the
     same crosspoint and pruned cells; both runs' bytes on disk are
     printed), then the full run
     resuming the first (stage 1 reported as already executed, stage 2
     reading cut windows off the disk rows: more than 0) and the full run
     resuming the second with the window reads off (the host match); the
     three full runs score 796634, stage 5 verified, with the same
     crosspoint and alignment files; strip launches in the stage-1 calls
     and batched launches in the full ones; per-stage times; then a full
     call with sparse special rows (``--ram-size 0 --disk-size 64M``: a
     row every 131072, taller than a cluster of hop CTAs holds), whose
     chained hops must each take the three launches (hop_prep and
     hop_match launches equal to the hops issued, no hop launch), score
     796634;
     then the batched kernel at that run's own shapes: every launch of
     stage 4, forward and reverse, level by level, rebuilt from its
     stage-3 crosspoints, each timed against its plain version and its
     own bound;
  6. `python -m masa_tpu_torch --test --device cuda` as a subprocess;
  7. the roofline tool (`masa_tpu_torch.tools.roofline.measure`), printed
     as its JSON line: every body on a full card (SMs x the blocks the
     runtime fits on an SM) by events around the launch alone, the least
     of 5 with the spread, its instructions counted in the built SASS, the
     SM clock read while a body runs; then its filling launch (the k1
     body) against its plain version on the same inputs at the same
     iterations, both timed, and the strip kernel's rate on the stage-1
     shape; then the CLI's stage-1 launch on the 1M pair with pruning
     inside the launch and without, timed in turns (unpruned, pruned,
     pruned, unpruned): the two pruned runs write the same rows and
     record, the best is the unpruned one's, two of its flush intervals
     (the last, and the one whose first columns kept lie nearest the
     middle) equal the twin's from its own flushed rows, and the pruned
     launch is held against the bound of the cells it computed;
  8. the column split (run after phase 4, beside the CLI run): first the
     strip kernel on a streamed left border at a slab's shape, the border
     written by the slab before it (kernel = plain, exact); then the 1M
     pair through `--split 1,1 --ram-size 0 --disk-size 1G` and through
     `--fork 2` (796634), real2 through `--split 1,2,1 --traceback
     speculative` and through `parallel.split.align_oversize` with
     16384-column slabs (32466), each with its seconds per stage and its
     launches per kernel;
  2h. (after phase 3, on the 1M pair's characters) the strip kernel's
     pruning instances against their plain twin, byte for byte, outputs
     and record: the pair's first 16384 x 16384 on 4 blocks, and a launch
     below and right of a partition's corner with a best handed in, on 3
     blocks; the pruned share of each is printed;
  2i. the pruning instances at 8 and 4 rows a thread on launches of more
     sub-strips than the grid (the full grid, 4 and 64 blocks), sampled
     sub-strips against the twin byte for byte from the launch's own
     flushed rows, among them every sub-strip where the rule skips a part
     of the columns (``tools/strip_tune.pruned_waves``);
  9. the sharded mode (beside phase 8): stage 1 of the 1M pair as the
     diagonal pipeline at the strip height the sweep chose
     (``parallel/sharded.CUDA_ROWS``, ``tools/sharded_tune.py``) over 1 and
     2 slabs, seconds and kernel ms; the CLI with ``--split 1`` and
     ``--split 2`` (pruning on, the pruned strips per slab) on the 1M pair
     (796634, stage 5 verified, per stage beside the monolithic CLI run of
     phase 5) and real2 with ``--split 3 --traceback speculative``
     (32466); two processes of ``masa_tpu_torch.tools.multihost_worker``
     over gloo on the card, a 2^15 pair, equal to one process; then the
     strip kernel on a round's hand-off: the border slab 1 holds for round
     1 is slab 0's last column of round 0 (exact), and the kernel equals
     its plain version on the first 8192 rows of slab 1's first strip
     with that border.
  10. (after phase 6) the port's bench, ``python -m masa_tpu_torch.bench``,
     as a child process at full size: stage 1 of bench.py's random 1M pair
     (best of 2, best score 19) and two full runs of the 1M homolog at
     JobConfig's defaults, 1 GiB of RAM and 16 GiB of disk (a special row
     every 512 rows; score 796634); its lines echoed, its JSON line
     printed whole and checked (every key of bench.py's line, the card;
     its stage 2's launches of the hop kernel equal to the hops it issued,
     none of the three-launch route's); its launches count with the main
     path's.  Before it, what this
     process holds and a probe of the temporary directory's files; beside
     it, its CPU seconds and this process's.
  2k. (after phase 2j) the stage-2 hops of the chromosome-scale runs
     (``big_hops``: the shapes tools/big_run.py's JobConfig gives, read
     off the code): the 5M run's hop, 12,288 x 32,768, one launch of the
     hop kernel, timed and held to the plain versions by
     ``hop_tune.timed``; then one hop of the 23M run's shape, 72,704 x
     262,144 (past 2^31 cells, taller than a cluster), on a stretch of
     the 23M pair with a real entering state (stage 1 of the pair's first
     4 hb rows x 2 W columns through the strip kernel, the crosspoint the
     best cell of its last row), through ``wavefront.hop_step``, which
     must take ``hop_three`` (one launch each of hop_prep, kernel 1 and
     hop_match) and hit; its state and last row equal to the three plain
     steps' (``hop_prep_plain``, ``strip_plain``, ``hop_match_plain``),
     max |diff| 0; timed against its bound;
  2l. (after phase 2k) stage 1's launch at the 5M run's shape (307,200
     rows x 5,242,945 columns of the 5M pair, its last full launch's
     rows, a row flushed every 12,288, pruning inside the launch from a
     zero row with a best handed in that keeps a band of each sub-strip's
     last rows-left columns): the first flush interval's sub-strips and
     every one from the grid's size to the launch's end against the
     plain twin from the launch's own flushed rows, byte for byte
     (``big_launch_phase``);
  11. (after phase 10) ``python -m masa_tpu_torch.tools.big_run 5M
     --fresh`` as a child process: the 5M pair (5,242,880 x 5,242,945)
     through ``runner.align_job`` at JobConfig's defaults (a special row
     every 12,288 rows); it must score masa_tpu's 3984627 with stage 5
     verified and stage 6 written, launch the strip kernel in stage 1,
     the batched kernel in stage 4 and the hop kernel once a hop its
     stage 2 issued, and no hop_prep or hop_match; its line is printed
     whole, its launches count with the main path's;
  11b. the 5M run's stage 4 rebuilt from phase 11's stage-3 crosspoints:
     the forward launch of its largest level against
     ``batched_strip_plain``, equal (``big_stage4_level``).
  12. (after phase 11b) the randomized differential lanes of
     ``masa_tpu_torch/tools/fuzz_soak.py`` (tests/test_fuzz_modes.py's
     five) on the card, at seeds from FUZZ_SEED (``fuzz_cases``): tier a
     at the reference's sizes, lane 1 cycling all 30 start/end mode pairs
     under random scores; tier b at 4096 to 16384 a side with special rows
     every 512 to 4096 (hops on a cluster of CTAs; on every other seed of
     lanes 1, 2 and 5 kernels.hop_route is forced to None, so hop_prep
     and hop_match run under NW and random scores).  Each lane holds its result to the
     port's oracle (the crash lane kills align_job at a call drawn among
     stage 1's row store, stage 2's passes and hops, stage 4 and stage 5,
     and resumes it), and a pool of CPU processes runs the same cases
     through the plain versions beside it: each card result must equal
     its score, start and end, and in lanes 2 and 5 its stage-2
     crosspoints (a digest, equal: stage 2 is exact, so the hops and the
     three launches are held to the plain route at these shapes and
     scores).  The strip, batched strip, hop, hop_prep
     and hop_match kernels must each launch in the phase (``fuzz_phase``).
Each main-path run prints, per stage, the kernels' summed milliseconds
(CUDA events around every launch) beside the stage's wall time.
The kernels line counts each kernel's launches over every main-path run
(phases 5, 7, 8, 9, 10, 11 and 12, less the host-matched call of phase 5,
which is a comparison; the fork and multihost workers and the bench report
theirs) and
gives each kernel's bound: the larger of its bytes over the card's memory rate and
its operations over the card's int32 peak (SMs x 64 INT32 lanes x the SM
clock read in this run).  A Gotoh cell counts the fewest INT32-lane
instructions the recurrence needs, whatever implements it: four (three
add-max and a max), five where the launch tracks the best; the roofline
kernel counts the INT32-lane instructions of its filling launch, found in
the SASS.  Each bound line also gives two diagnostics that are no bounds:
the share under the ruler of earlier runs (the better of the mix and DPX
rates) and the share of the rate that the kernels' own cell code reaches
alone (the roofline's k1 and k1n bodies).  A kernel faster than its bound
fails the run: the ruler would be wrong.  The batched strip kernel's times and
bound are sums over every launch of the CLI run's stage 4 (each launch
beside its own bound under "stage4_launches"); a short kernel's time is
taken by events around its launch alone, the least of a few.  No PyTorch call computes a Gotoh strip,
so library_ms is null.  Before the last line the script checks that no
module of JAX or of the JAX package was imported (here and in the
multihost workers) and that the sharded modules were.  The last two lines are
a JSON summary of the kernels and the contract line {"ok": true,
"device": {...}}.  Without a CUDA device the script exits non-zero and
prints no result.
"""

import concurrent.futures
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = {  # name -> (source, the TPU kernel it replaces, or the code)
    "strip": ("masa_tpu_torch/csrc/strip.cu",
              "masa_tpu/ops/wavefront.py:518"),  # strip_pallas
    "batched_strip": ("masa_tpu_torch/csrc/batched_strip.cu",
                      "masa_tpu/ops/wavefront.py:1427"),  # ..._pallas_dyn
    "batched_strip_fixed": ("masa_tpu_torch/csrc/batched_strip.cu",
                            "masa_tpu/ops/wavefront.py:1289"),  # ..._pallas
    "roofline": ("masa_tpu_torch/csrc/roofline.cu",
                 "tools/roofline.py:86"),  # bench_kernel.make_call
    # no Pallas counterpart: masa_tpu runs a hop as one XLA program
    "hop": ("masa_tpu_torch/csrc/hop.cu",
            "masa_tpu/ops/wavefront.py:1216"),  # hop_step_device
    # the prologue and epilogue of a hop taller than a cluster holds
    "hop_prep": ("masa_tpu_torch/csrc/hop.cu",
                 "masa_tpu/ops/wavefront.py:1216"),  # hop_step_device
    "hop_match": ("masa_tpu_torch/csrc/hop.cu",
                  "masa_tpu/ops/wavefront.py:1171"),  # goal_match_device
    # no TPU kernel: masa_tpu's stage 5 is a native host call a partition
    "traceback": ("masa_tpu_torch/csrc/traceback.cu",
                  "masa_tpu/ops/smallsw.py:112"),  # traceback_segment
}
# the wrappers whose launches the main-path runs count
COUNTED = ("strip", "batched_strip", "hop", "hop_prep", "hop_match",
           "traceback")
# the route of each: the one-launch hop, or the three launches
THREE = ("hop_prep", "hop_match")
M_1M = 1 << 20
SCORE_1M = 796634  # masa_tpu's full six-stage score on the 1M pair
NEG = -999999999
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FUZZ_SEED = 20000  # phase 12's first seed: past the soak's default range


def log(*a):
    print(*a, flush=True)


def counters():
    """The wrappers of COUNTED, by name."""
    from masa_tpu_torch.ops import kernels

    return {k: getattr(kernels, f"{k}_cuda") for k in COUNTED}


def stage5_partitions():
    """Stage 5's partitions so far and those of them the card took, as the
    port's trace counts them (``partitions``, ``partitions.card``; only
    while ``kernels.event_log`` is a list), over every stage."""
    from masa_tpu_torch.utils import trace

    return tuple(sum(v for (_, n), v in trace.counts.items() if n == name)
                 for name in ("partitions", "partitions.card"))


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def build_kernels():
    """Every kernel source, one nvcc each, all started together."""
    from masa_tpu_torch.ops import kernels

    def build(name):
        t0 = time.time()
        return kernels.build(name), time.time() - t0

    with concurrent.futures.ThreadPoolExecutor(len(kernels.SOURCES)) as ex:
        built = {name: ex.submit(build, name) for name in kernels.SOURCES}
    for name, fut in built.items():
        path, secs = fut.result()
        log(f"build: {os.path.relpath(path, REPO)} in {secs:.1f} s")
        for line in kernels.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    rows = kernels.block_rows()
    log(f"strip kernel: {rows} rows per block, "
        f"{kernels.resident_blocks()} blocks resident")
    return rows


def strip_inputs(rng, h, nj, border, params, dev):
    """Random strip inputs on the card: homologous a/b, the border and the
    row above per the border type (CUSTOM: arbitrary values)."""
    import numpy as np
    import torch

    from masa_tpu_torch import InitType
    from masa_tpu_torch.ops import wavefront as wf

    bases = np.frombuffer(b"ACGT", np.uint8)
    a = rng.choice(bases, h).astype(np.uint8)
    b = np.resize(a, nj).copy()
    flip = rng.random(nj) < 0.25
    b[flip] = rng.choice(bases, int(flip.sum()))
    go, ge = params.gap_open, params.gap_ext
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    if border == InitType.CUSTOM:
        bus_h = rng.integers(-40, 60, nj).astype(np.int32)
        bus_f = np.where(rng.random(nj) < 0.2, NEG,
                         rng.integers(-60, 40, nj)).astype(np.int32)
        col_h = rng.integers(-40, 60, h).astype(np.int32)
        col_e = np.where(rng.random(h) < 0.2, NEG,
                         rng.integers(-60, 40, h)).astype(np.int32)
        return (t(a), t(b), t(bus_h), t(bus_f), t(col_h), t(col_e),
                int(rng.integers(-40, 60)))
    # the first row's bus beside a left border from row i0 down
    i0 = int(rng.integers(0, 5000))
    bus_h, bus_f = wf.init_bus(border, nj, go, ge, dev)
    k = torch.arange(i0, i0 + h + 1, device=dev)
    col = wf.border_h(border, k, go, ge)
    col_e = torch.full((h,), NEG, dtype=torch.int32, device=dev)
    return t(a), t(b), bus_h, bus_f, col[1:].contiguous(), col_e, int(col[0])


def compare(out_k, out_p, what):
    """Exact equality of every output; returns the largest |difference|
    (0 when equal; a difference raises)."""
    worst = 0
    for field in ("bus_h", "bus_f", "best", "lastcol_h", "lastcol_e",
                  "rows_h", "rows_f"):
        k, p = getattr(out_k, field), getattr(out_p, field)
        if (k is None) != (p is None):
            raise AssertionError(f"{what}: {field} present on one side only")
        if k is None:
            continue
        if k.shape != p.shape:
            raise AssertionError(f"{what}: {field} shapes {tuple(k.shape)} "
                                 f"vs {tuple(p.shape)}")
        d = int((k.long() - p.long()).abs().max())
        worst = max(worst, d)
        if d:
            raise AssertionError(f"{what}: {field} differs (max |diff| {d})")
    return worst


def kernel_matrix(dev, block_rows):
    """Phase 2a: the kernel equals the plain version, case by case."""
    import numpy as np

    from masa_tpu_torch import InitType, ScoreParams
    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf

    rng = np.random.default_rng(7)
    borders = (InitType.WITH_ZEROES, InitType.WITH_GAPS,
               InitType.WITH_GAPS_OPENED, InitType.CUSTOM)
    full = 2 * block_rows
    cases = []
    for sw in (True, False):
        for bi, border in enumerate(borders):
            params = ScoreParams() if bi % 2 == 0 else ScoreParams(2, -1, 2, 1)
            # full height: flush on for half, every output requested
            cases.append(dict(sw=sw, border=border, params=params, h=full,
                              nj=(1000, 333, 1, 2501)[bi],
                              flush=(512 if (bi + sw) % 2 else 0),
                              track=True, lastcol=True))
            # partial heights, odd widths, outputs toggled
            cases.append(dict(sw=sw, border=border, params=params,
                              h=(1, 1000, block_rows + 1, 3333)[bi],
                              nj=(7, 1, 640, 1499)[bi],
                              flush=(0, 100, 1024, 0)[bi],
                              track=bi % 2 == 0, lastcol=bi in (1, 2)))
    worst = 0
    t0 = time.time()
    for c in cases:
        args = strip_inputs(rng, c["h"], c["nj"], c["border"], c["params"],
                            dev)
        p = c["params"]
        kw = dict(match=p.match, mismatch=p.mismatch, gap_open=p.gap_open,
                  gap_ext=p.gap_ext, sw=c["sw"], track_best=c["track"],
                  store_lastcol=c["lastcol"], flush_every=c["flush"])
        what = (f"{'SW' if c['sw'] else 'NW'} {c['border'].name} "
                f"h={c['h']} nj={c['nj']} flush={c['flush']} "
                f"track={c['track']} lastcol={c['lastcol']}")
        worst = max(worst, compare(wf.strip(*args, **kw),
                                   wf.strip_plain(*args, **kw), what))
    # persistent blocks: 5 sub-strips on 2 blocks, each block reused
    params = ScoreParams()
    args = strip_inputs(rng, 5 * block_rows + 17, 300,
                        InitType.WITH_ZEROES, params, dev)
    kw = dict(match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext, sw=True,
              track_best=True, store_lastcol=True, flush_every=777)
    out_k = wf.strip_out(*kernels.strip_cuda(*args, **kw, max_ctas=2))
    worst = max(worst, compare(out_k, wf.strip_plain(*args, **kw),
                               "SW h=5*block+17 on 2 persistent blocks"))
    worst = max(worst, multi_wave(rng, dev, block_rows))
    log(f"strip kernel vs plain: {len(cases) + 2} cases equal (max |diff| "
        f"{worst}, tolerance 0) in {time.time() - t0:.1f} s")
    return worst


def multi_wave(rng, dev, block_rows):
    """More sub-strips than the card holds at once, on a full grid: blocks
    take a second sub-strip.  Each sampled flushed interval (the first, the
    last of the first wave, the second wave, the partial last), recomputed
    by the plain version from the kernel's row above it, must equal the
    kernel's rows, bests and last column there."""
    from masa_tpu_torch import InitType, ScoreParams
    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf

    resident = kernels.resident_blocks()
    n_sub = resident + 3
    h, nj = n_sub * block_rows + 5, 300
    params = ScoreParams()
    args = strip_inputs(rng, h, nj, InitType.WITH_ZEROES, params, dev)
    a, b, bus_h, bus_f, col_h, col_e, corner = args
    kw = dict(match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext, sw=True,
              track_best=True, store_lastcol=True)
    out = kernels.strip_cuda(*args, **kw, flush_every=block_rows)
    _, _, best_v, best_j, last_h, last_e, rows_h, rows_f = out
    worst = 0
    for g in (0, resident - 1, resident, n_sub - 1, n_sub):
        lo, hi = g * block_rows, min((g + 1) * block_rows, h)
        above = ((bus_h, bus_f, corner) if g == 0 else
                 (rows_h[g - 1], rows_f[g - 1], int(col_h[lo - 1])))
        ref = wf.strip_plain(a[lo:hi], b, above[0], above[1], col_h[lo:hi],
                             col_e[lo:hi], above[2], **kw)
        bus = (rows_h[g], rows_f[g]) if g < n_sub else out[:2]
        got = wf.StripOut(bus[0], bus[1],
                          wf.merge_best(best_v[lo:hi], best_j[lo:hi]),
                          last_h[lo:hi], last_e[lo:hi])
        worst = max(worst, compare(got, ref, f"multi-wave h={h}: interval "
                                   f"{g} of {n_sub + 1}"))
    log(f"multi-wave: {h} rows = {n_sub} sub-strips on {resident} resident "
        f"blocks, 5 sampled intervals equal")
    return worst


def batched_matrix(dev):
    """Phase 2c: the batched kernel equals its plain version."""
    import numpy as np
    import torch

    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.tools import batched_tune

    rng = np.random.default_rng(13)
    bases = np.frombuffer(b"ACGT", np.uint8)
    n = 1 << 16
    s0 = rng.choice(bases, n).astype(np.uint8)
    s1 = np.where(rng.random(n) < 0.1, rng.choice(bases, n), s0)
    a, b = (torch.from_numpy(x).to(dev) for x in (s0, s1))
    worst = 0
    t0 = time.time()
    cases = ((1, 1, 1), (300, 70, 130), (64, 600, 40), (5, 5000, 300),
             (2000, 16, 2), (4096, 300, 300))
    for k, (B, h_max, w_max) in enumerate(cases):
        h = rng.integers(1, h_max + 1, B)
        w = rng.integers(0, w_max + 1, B)
        i0 = rng.integers(0, n - h)
        j0 = np.clip(i0 + rng.integers(-50, 50, B), 0, n - w)
        elems = np.stack([i0, h, j0, w, rng.integers(0, 3, B),
                          rng.integers(0, 3, B)], 1).astype(np.int32)
        kw = (dict(match=1, mismatch=-3, gap_open=3, gap_ext=2) if k % 2
              else dict(match=2, mismatch=-1, gap_open=2, gap_ext=1))
        got = wf.batched_strip(a, b, elems, max(w_max, 1), **kw)
        want = wf.batched_strip_plain(a, b, elems, max(w_max, 1), **kw)
        worst = max(worst, batched_diff(got, want,
                                        f"B={B} h<={h_max} w<={w_max}"))
    edges = batched_tune.check_batched(dev)
    log(f"batched kernel vs plain: {len(cases)} mixed cases and {edges} "
        f"comparisons by height, width, border code and forced block "
        f"geometry equal (max |diff| {worst}, tolerance 0) in "
        f"{time.time() - t0:.1f} s")
    return worst


def batched_diff(got, want, what):
    worst = 0
    for name, k, p in zip(("bus_h", "bus_f"), got, want):
        if k.shape != p.shape:
            raise AssertionError(f"{what}: {name} shapes {tuple(k.shape)} "
                                 f"vs {tuple(p.shape)}")
        d = int((k.long() - p.long()).abs().max())
        if d:
            raise AssertionError(f"{what}: {name} differs (max |diff| {d})")
        worst = max(worst, d)
    return worst


def fixed_matrix(dev):
    """Phase 2d: the equal-shape batched kernel equals its plain version:
    CUSTOM borders, odd widths, 1 to 3000 elements, elements taller than
    their warps' rows that chain sub-strips, then the tune tool's heights
    and forced geometries."""
    import numpy as np

    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.tools import batched_tune

    rng = np.random.default_rng(17)
    cases = ((1, 1, 1), (1, 300, 256), (3, 300, 255), (64, 64, 129),
             (3000, 8, 33), (5, 2049, 77), (2, 5000, 300))
    worst = 0
    t0 = time.time()
    for k, (B, h, nj) in enumerate(cases):
        args = batched_tune.fixed_inputs(rng, B, h, nj, dev)
        kw = (dict(match=1, mismatch=-3, gap_open=3, gap_ext=2) if k % 2
              else dict(match=2, mismatch=-1, gap_open=2, gap_ext=1))
        worst = max(worst, batched_diff(
            wf.batched_strip_fixed(*args, **kw),
            wf.batched_strip_fixed_plain(*args, **kw),
            f"fixed B={B} h={h} nj={nj}"))
    edges = batched_tune.check_fixed(dev)
    log(f"equal-shape batched kernel vs plain: {len(cases)} cases and "
        f"{edges} comparisons by height, width and forced block geometry "
        f"equal (max |diff| {worst}, tolerance 0) in "
        f"{time.time() - t0:.1f} s")
    return worst


def fixed_main(dev):
    """Phase 2e: the equal-shape batched strip through its entry point
    (``wavefront.batched_strip_fixed``) at 8192 elements of 64 x 128,
    counted and timed, then its plain version on the same inputs."""
    import numpy as np

    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.tools import batched_tune

    B, h, nj = batched_tune.FIXED
    args = batched_tune.fixed_inputs(np.random.default_rng(19), B, h, nj,
                                     dev)
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2)
    timed(wf.batched_strip_fixed, *args, **kw)  # warm
    kernels.batched_strip_fixed_cuda.launches = 0
    got, _ = timed(wf.batched_strip_fixed, *args, **kw)
    launches = kernels.batched_strip_fixed_cuda.launches
    if launches <= 0:
        raise AssertionError("batched_strip_fixed launched no kernel")
    _, call_ms, ms = timed_launch(5, wf.batched_strip_fixed, *args, **kw)
    want, plain_ms = timed(wf.batched_strip_fixed_plain, *args, **kw)
    err = batched_diff(got, want, f"fixed B={B} h={h} nj={nj}")
    cells = B * h * nj
    log(f"equal-shape batched strip {B} x {h} x {nj} ({cells} cells): "
        f"kernel {ms:.3f} ms ({cells / ms / 1e6:.2f} GCUPS; {call_ms:.3f} ms "
        f"around the wrapper's call), plain {plain_ms:.3f} ms, equal")
    return launches, err, ms, plain_ms, cells, nbytes(*args, *got)


# (W, hb) of a hop past one CTA of the hop kernel (a cluster of two, the
# second partial)
PAST_CTA = (2048, 1000)


def chained_hop(m, n, **limits):
    """The (W, hb) of the chained stage-2 hops of a run on an m x n pair
    at a JobConfig with ``limits``, from the code that picks them: hb the
    flush interval, W the window of a hop of that height whose column
    clears it (``stages/core._hop_window``)."""
    from masa_tpu_torch.core.job import Job, JobConfig
    from masa_tpu_torch.stages import core, pipeline
    from masa_tpu_torch.types import Crosspoint

    with tempfile.TemporaryDirectory() as tmp:
        job = Job(JobConfig(work_dir=tmp, **limits), device="cpu")
        hb = job.calculate_flush_intervals(
            m, n, align_to=pipeline.FLUSH_GRAIN)[0]
    return core._hop_window(Crosspoint(m, n, 0), m - hb, "auto"), hb


def main_path_hops():
    """The (W, hb) of the chained stage-2 hops that the main paths issue on
    the 1M pair (``chained_hop``): the CLI's runs (``--ram-size 0
    --disk-size 1G``) and the bench's full run (``JobConfig``'s
    defaults)."""
    from masa_tpu_torch.tools.pairs import bench_pair

    m, n = map(len, bench_pair())
    return sorted({chained_hop(m, n, ram_limit=0, disk_limit=1 << 30),
                   chained_hop(m, n)})


def hop_phase(dev):
    """Phase 2j: the stage-2 hop on the card.  The one-launch hop kernel
    against ``wavefront.hop_plain`` (``tools/hop_tune.check_fused``) and
    the three-launch route's prologue and epilogue against their plain
    versions (``tools/hop_tune.check``), every case (every type, SW and
    NW, hits at k = 0 and beyond, no stop, an overshoot, ok = 0 on entry,
    cj < W + 1, a reachable goal, random states) at each shape the main
    paths give them (``main_path_hops``: the CLI's hops of the 1M pair and
    the bench's) and, for the one launch, at a hop past one CTA; the
    device delta packing against its plain form (the same rows on the
    CPU: an odd length, one cell, -INF runs, a row of 2^20); both forms
    timed at both main-path hops (``hop_tune.timed``, which holds their
    outputs equal to the plain versions' there); one row of 2^20 pulled
    to the host as int32 (the port's eager pull) and packed (masa_tpu's).
    Returns (max |diff| of the three-launch kernels, of the hop kernel,
    {name: the timed figures at the CLI's hop, the tallest}, {shape:
    hop_tune.timed})."""
    import numpy as np
    import torch

    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.tools import hop_tune

    hop_tune.check(dev)
    shapes = main_path_hops()
    err, err_hop, seen, seen_hop = 0, 0, {}, {}
    for W, hb in shapes:
        e, got = hop_tune.check(dev, M_1M, W, hb)
        err = max(err, e)
        for k, v in got.items():
            seen[k] = seen.get(k, 0) + v
    for W, hb in shapes + [PAST_CTA]:
        e, got = hop_tune.check_fused(dev, M_1M, W, hb)
        err_hop = max(err_hop, e)
        for k, v in got.items():
            seen_hop[k] = seen_hop.get(k, 0) + v
    rng = np.random.default_rng(8)
    side = torch.cuda.Stream(dev)
    for nj in (1, 777, 1 << 20):
        v = np.cumsum(rng.integers(-9, 10, nj)).astype(np.int32)
        v[nj // 3:nj // 3 + 5] = NEG
        cpu = torch.from_numpy(v)
        if not torch.equal(wf.delta_pack_device(cpu.to(dev), nj).cpu(),
                           wf.delta_pack_device(cpu, nj)):
            raise AssertionError(f"delta_pack_device of {nj} on the card")
        got = wf.packed_row_host(wf.pull_row_delta_start(cpu.to(dev), nj,
                                                         side))
        want = wf.packed_row_host(wf.pull_row_delta_start(cpu, nj))
        if not all(np.array_equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"the packed pull of {nj} on the card")
    # one row of 2^20 pulled as int32 and packed, in turns (least of 5)
    row = cpu.to(dev)
    pulls = {"int32": lambda: row.cpu().numpy().astype(np.int64),
             "packed": lambda: wf.pull_row_delta(row, nj)}
    pull_ms = dict.fromkeys(pulls, float("inf"))
    for _ in range(5):
        for name, fn in pulls.items():
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            pull_ms[name] = min(pull_ms[name],
                                (time.perf_counter() - t0) * 1e3)
    timed = {f"{hb}x{W}": hop_tune.timed(dev, M_1M, W, hb)
             for W, hb in shapes}
    log(f"hop kernels: the one launch equal to hop_plain in every case "
        f"({json.dumps(seen_hop)} at a cut of 2^20, (W, hb) "
        f"{json.dumps(shapes + [PAST_CTA])}), the three-launch route's "
        f"prologue and epilogue equal to theirs ({json.dumps(seen)}, and at "
        f"the small shape); the device packing equal to the CPU's; a row "
        f"of 2^20 pulled to the host in {pull_ms['int32']:.3f} ms as int32, "
        f"{pull_ms['packed']:.3f} ms packed (least of 5, host clock)")
    for shape, t in timed.items():
        log(f"hop {shape} ({json.dumps(t['shape'])}, one launch as "
            f"{json.dumps(t['geometry'])}): ms a launch back to back "
            + json.dumps({k: round(v, 5) for k, v in t["ms"].items()})
            + "; plain ms " + json.dumps({k: round(v, 3) for k, v in
                                          t["plain_ms"].items()})
            + "; in a segment, events ms a hop "
            + json.dumps({f: {k: round(v, 5) for k, v in d.items()}
                          for f, d in t["in_path"].items()})
            + ", host issue ms a hop "
            + json.dumps({k: round(v, 5) for k, v in t["issue_ms"].items()}))
    W, hb = max(shapes, key=lambda s: s[1])  # the CLI's, the tallest
    cli = timed[f"{hb}x{W}"]
    figures = {k: (cli["ms"][k], cli["plain_ms"][k], cli["bytes"][k])
               for k in THREE}
    figures["hop"] = (cli["ms"]["hop"], cli["plain_ms"]["hop"],
                      cli["cells"]["hop"], cli["bytes"]["hop"])
    return err, err_hop, figures, timed


def big_hops(size):
    """(W, hb) of the chained stage-2 hops of ``tools/big_run.py``'s run at
    ``size`` (``chained_hop`` at its JobConfig: the defaults, 64 GiB of disk
    at 23M)."""
    from masa_tpu_torch.tools import pairs

    m = pairs.SIZES[size]
    limits = {"disk_limit": 64 << 30} if size == "23M" else {}
    return chained_hop(m, pairs.PADDED.get(size, m), **limits)


def big_hop_phase(dev):
    """Phase 2k: the stage-2 hops of the chromosome-scale runs.  The 5M
    run's hop (``big_hops("5M")``, one launch of the hop kernel) timed by
    ``hop_tune.timed`` on its planted inputs, its outputs held equal to
    the plain versions' there.  Then one hop of the 23M run's shape
    (``big_hops("23M")``: taller than a cluster holds, past 2^31 cells)
    on a stretch of the 23M pair with a real entering state: stage 1 of
    the pair's first 4 hb rows x 2 W columns through the strip kernel
    (SW, the cut at row 3 hb kept; a local alignment ending in the
    stretch's rows is the pair's own there), the crosspoint the best cell
    of its last row; the hop from it through ``wavefront.hop_step``,
    which must take ``hop_three`` (one launch each of hop_prep, kernel 1
    and hop_match, no hop launch) and hit; its state and last row equal
    to those of the three plain steps (``hop_prep_plain``,
    ``strip_plain``, ``hop_match_plain``) on the same inputs, max |diff|
    0.  The three launches timed (events around ``hop_three``, least of
    3), the plain steps by the host clock once.  Launches made here are
    comparisons, not the main path's.  Returns (max |diff| of the tall
    hop, the 5M hop's ``hop_tune.timed``, the tall hop's figures)."""
    import numpy as np
    import torch

    from masa_tpu_torch.ops import kernels, strips
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.tools import hop_tune, pairs
    from masa_tpu_torch.types import InitType, ScoreParams

    P = ScoreParams()
    kw = dict(match=P.match, mismatch=P.mismatch, gap_open=P.gap_open,
              gap_ext=P.gap_ext)
    W5, hb5 = big_hops("5M")
    if kernels.hop_route(hb5, W5, dev) is None:
        raise AssertionError(f"the 5M run's hop ({hb5} x {W5}) takes the "
                             f"three launches")
    t5 = hop_tune.timed(dev, pairs.SIZES["5M"], W5, hb5, iters=20)
    log(f"hop at the 5M run's shape {hb5} x {W5} (one launch as "
        f"{json.dumps(t5['geometry'])}): ms a launch back to back "
        + json.dumps({k: round(v, 5) for k, v in t5["ms"].items()})
        + "; plain ms " + json.dumps({k: round(v, 3) for k, v in
                                      t5["plain_ms"].items()}))

    W, hb = big_hops("23M")
    if kernels.hop_route(hb, W, dev) is not None:
        raise AssertionError(f"the 23M run's hop ({hb} x {W}) fits a "
                             f"cluster: no three-launch hop to hold")
    before = {k: c.launches for k, c in counters().items()}
    s0, s1 = pairs.big_pair("23M")
    ci, r, nj = 4 * hb, 3 * hb, 2 * W
    a0, b0 = s0[:ci].copy(), s1[:nj].copy()
    del s0, s1
    zero = InitType.WITH_ZEROES
    res = strips.run_partition(
        wf.StripConfig(rows=1 << 22), torch.from_numpy(a0).to(dev),
        torch.from_numpy(b0).to(dev), P, zero, zero, special_every=hb)
    cj = int(np.argmax(res.last_h[1:])) + 1
    score = int(res.last_h[cj])
    cut_h, cut_f = (torch.from_numpy(x.astype(np.int32)).to(dev)
                    for x in res.specials[r])
    s0r = torch.from_numpy(a0[::-1].copy()).to(dev)
    s1r = torch.from_numpy(b0[::-1].copy()).to(dev)
    a = s0r[:ci - r]
    st = torch.tensor([[cj, score, 0, 1], [0, 0, 0, 0]], dtype=torch.int32,
                      device=dev)
    taken = []
    three = wf.hop_three

    def spy(*args, **k):
        out = three(*args, **k)
        taken.append(out)
        return out

    at = {k: c.launches for k, c in counters().items()}
    flags = []
    with patched(wf, "hop_three", spy):
        wf.hop_step(a, s1r, cut_h, cut_f, st[0], st[1], W, sw=True,
                    flags=flags, **kw)
    kernels.check_flags(torch.cat(flags).tolist())
    ran = {k: c.launches - at[k] for k, c in counters().items()}
    if len(taken) != 1 or ran != {"strip": 1, "batched_strip": 0, "hop": 0,
                                  "hop_prep": 1, "hop_match": 1,
                                  "traceback": 0}:
        raise AssertionError(f"the 23M hop did not take hop_three: "
                             f"{len(taken)} calls, launches {ran}")
    _, rev_h, rev_f = taken[0]
    t0 = time.time()
    b, bh, bf, ch, ce = wf.hop_prep_plain(s1r, st[0], W, hb, P.gap_open,
                                          P.gap_ext)
    out = wf.strip_plain(a, b, bh, bf, ch, ce, wf.HOP_CORNER, sw=False,
                         **kw)
    st_p = torch.empty(4, dtype=torch.int32, device=dev)
    wf.hop_match_plain(cut_h, cut_f, out.bus_h, out.bus_f, st[0], st_p, W,
                       hb, match=P.match, gap_open=P.gap_open,
                       gap_ext=P.gap_ext, sw=True)
    torch.cuda.synchronize(dev)
    plain_ms = (time.time() - t0) * 1e3
    err = max(int((x.long() - y.long()).abs().max())
              for x, y in ((st[1], st_p), (rev_h, out.bus_h),
                           (rev_f, out.bus_f)))
    got = st[1].tolist()
    if err or not got[3] or got[0] >= cj:
        raise AssertionError(f"the 23M hop: {got} against the plain "
                             f"steps' {st_p.tolist()}, max |diff| {err}")
    _, ms = timed_best(3, wf.hop_three, a, s1r, cut_h, cut_f, st[0],
                       st_p, W, sw=True, **kw)
    for k, c in counters().items():
        c.launches = before[k]
    cells = hb * W
    moved = hb + W + 8 * (W + 1) + 32  # a, the window, the cut, the states
    log(f"hop at the 23M run's shape {hb} x {W} ({cells} cells, past 2^31) "
        f"on a stretch of the 23M pair ({ci} x {nj}, the cut at row {r}): "
        f"from ({cj}, {score}) to {got} through hop_three, equal to the "
        f"three plain steps (state and last row, max |diff| 0); "
        f"{ms:.3f} ms the three launches (least of 3), the plain steps "
        f"{plain_ms:.1f} ms")
    return err, t5, {"shape": {"hb": hb, "W": W}, "ms": ms,
                     "plain_ms": plain_ms, "cells": cells, "bytes": moved,
                     "state_in": [cj, score, 0, 1], "state_out": got}


def big_launch_phase(dev):
    """Phase 2l: stage 1's launch at the 5M run's shape against its plain
    twin.  The 5M run (``runner`` at JobConfig's defaults) launches the
    strip kernel on R rows (``strips.strip_height``: 307,200) x the whole
    s1 (5,242,945 columns), a row flushed every hb (12,288), with pruning
    inside the launch on the card's grid; here the rows of its last full
    launch (the 17th of 18) of the 5M pair, with the launch's own
    ``LaunchPrune`` (the partition's m and n, the rows above), from a zero
    row and a zero left border (a local alignment's fresh top) and with a
    best of n - 1 handed in (as a resumed stage 1 hands one): each
    sub-strip keeps the band of its last rows-left columns (where the
    pair's diagonal runs) and prunes the rest, writing -INF there into the
    bus and its flushed rows up to the launch's last offsets.  Sampled
    sub-strips, the first flush interval and every one from the interval
    at the grid's size to the launch's end (the bus leaving it), are held
    byte for byte against ``wavefront.strip_plain_pruned`` from the
    launch's own flushed rows (``tools/strip_tune.check_pruned_span``).
    A comparison: no launch here counts.  Returns (max |diff| (0: any
    difference raises), a summary)."""
    import numpy as np
    import torch

    from masa_tpu_torch import InitType, ScoreParams
    from masa_tpu_torch.ops import kernels, strips
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.stages import core
    from masa_tpu_torch.tools import pairs, strip_tune

    params = ScoreParams()
    s0, s1 = pairs.big_pair("5M")
    m, n = len(s0), len(s1)
    _, hb = big_hops("5M")
    R = strips.strip_height(core.default_config(dev), n, hb)
    i0 = (m // R - 1) * R
    a = torch.from_numpy(np.ascontiguousarray(s0[i0:i0 + R])).to(dev)
    b = torch.from_numpy(s1).to(dev)
    del s0, s1
    bus_h, bus_f = wf.init_bus(InitType.WITH_ZEROES, n, params.gap_open,
                               params.gap_ext, dev)
    args = (a, b, bus_h, bus_f, torch.zeros(R, dtype=torch.int32, device=dev),
            torch.full((R,), NEG, dtype=torch.int32, device=dev), 0)
    kw = dict(match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext, sw=True,
              track_best=True)
    lp = wf.LaunchPrune(m, n, i0, 0, torch.tensor([n - 1], device=dev))
    saved = kernels.strip_cuda.launches
    out, _, ms = timed_launch(1, kernels.strip_cuda, *args, **kw,
                              flush_every=hb, prune=lp)
    kernels.strip_cuda.launches = saved  # a comparison, no main path
    rec = out[8]
    first = rec.record[:, 0].tolist()
    n_sub, per = len(first), hb // rec.rows
    g0 = max(per, min(rec.blocks, n_sub - per) // per * per)
    t0 = time.time()
    for lo, hi in ((0, per), (g0, n_sub)):
        strip_tune.check_pruned_span(args, out, lp, hb, lo, hi, kw)
    twin_s = time.time() - t0
    pruned = rec.pruned_cells(R)
    res = dict(rows=R, cols=n, i0=i0, flush=hb, sub_strips=n_sub,
               blocks=rec.blocks, checked=per + n_sub - g0, ms=ms,
               cells=R * n - pruned, pruned_cells=pruned, twin_s=twin_s)
    log(f"stage-1 launch at the 5M run's shape ({R} x {n}, rows {i0} on of "
        f"the 5M pair, a row flushed every {hb}, pruning inside from a zero "
        f"row with a best of {n - 1} handed in): {n_sub} sub-strips of "
        f"{rec.rows} rows on {rec.blocks} blocks, {pruned} cells pruned "
        f"({100 * pruned / (R * n):.2f}%), kernel {ms:.1f} ms; sub-strips "
        f"0-{per - 1} (first columns kept {first[:per]}) and {g0}-"
        f"{n_sub - 1} ({first[g0]} to {first[-1]}) equal the twin's from "
        f"the launch's own rows, byte for byte ({twin_s:.1f} s)")
    return 0, res


def big_stage4_level(dev, cps3):
    """Phase 11b: one level of the 5M run's stage 4 against its plain
    version.  The engine (``ops/batched_mm``, at stage 4's stop of the
    runner's JobConfig) runs on phase 11's stage-3 crosspoints of the 5M
    pair with its element tables tapped; the forward launch of the level
    with the most elements runs again through ``wavefront.batched_strip``
    and ``batched_strip_plain`` on the same inputs, equal (tolerance 0).
    A comparison: no launch here counts.  Returns (max |diff|, a
    summary)."""
    import math

    import numpy as np
    import torch

    from masa_tpu_torch import ScoreParams
    from masa_tpu_torch.ops import batched_mm, kernels
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.stages import pipeline
    from masa_tpu_torch.tools import pairs

    params = ScoreParams()
    s0, s1 = pairs.big_pair("5M")
    mps = max(16, math.isqrt(pipeline.PipelineConfig().max_cells_stage5))
    tapped = []
    saved = kernels.batched_strip_cuda.launches
    batched_mm.reduce_partitions_batched(
        s0, s1, cps3, params, mps, device=dev,
        on_launches=lambda level, el_f, el_r, width: tapped.append(
            (level, el_f, width)))
    level, elems, width = max(tapped, key=lambda t: len(t[1]))
    a, b = (torch.from_numpy(x).to(dev) for x in (s0, s1))
    kw = dict(match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext)
    got, ms = timed(wf.batched_strip, a, b, elems, width, **kw)
    kernels.batched_strip_cuda.launches = saved  # a comparison
    want, plain_ms = timed(wf.batched_strip_plain, a, b, elems, width, **kw)
    err = batched_diff(got, want, f"the 5M run's stage-4 level {level}")
    cells = int((elems[:, 1].astype(np.int64) * elems[:, 3]).sum())
    log(f"stage 4 of the 5M run rebuilt from its {len(cps3)} stage-3 "
        f"crosspoints: {len(tapped)} levels; level {level} forward "
        f"({len(elems)} elements, heights {int(elems[:, 1].min())}-"
        f"{int(elems[:, 1].max())}, widths up to {width}, {cells} cells): "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, equal")
    return err, dict(level=level, elements=len(elems), cells=cells, ms=ms,
                     plain_ms=plain_ms)


def fuzz_cases():
    """Phase 12's cases, (tier, lane, seed, keywords, three launches).
    Tier a: the reference's sizes; lane 1 cycles the 30 start/end pairs.
    Tier b: m and n of 4096 to 16384, special rows every 512 to 4096 (a
    hop on a cluster of CTAs), lane 1 going over 14 of the 26 pairs the
    row oracle can check; on every other tier-b seed of lanes 1, 2 and 5
    the hops take the three launches.  Lane 3 stays at tier a: on the CPU
    its slab traceback runs the dense oracle for a local march, minutes
    at 4096 x 4096."""
    from masa_tpu_torch.tools import fuzz_soak as fz

    S = fz.S
    pairs = [(a, b) for a in fz.STARTS for b in fz.ENDS]
    cases = [("a", "pipeline_vs_oracle", FUZZ_SEED + k, {"modes": p}, False)
             for k, p in enumerate(pairs)]
    for name, count in (("stage4_differential", 3), ("sharded_vs_oracle", 6),
                        ("oversize_weighted", 3), ("crash_resume", 4)):
        cases += [("a", name, FUZZ_SEED + k, {}, False)
                  for k in range(count)]
    rows = [p for p in pairs if p[0] == S.ANYWHERE or p[1] != S.ANYWHERE]
    for k in range(14):
        big = k < 2
        cases.append(("b", "pipeline_vs_oracle", FUZZ_SEED + 100 + k, {
            "sizes": (12288, 16385) if big else (4096, 12289),
            "flush": (2048, 4097) if big else (512, 2049),
            "modes": rows[7 * k % len(rows)]}, k % 2 == 1))
    for name, sizes in (("stage4_differential", (4096, 6000)),
                        ("oversize_weighted", (4096, 8000)),
                        # kills in stage 1 and in stage 2, on the hops
                        ("crash_resume", (4096, 6000))):
        cases += [("b", name, FUZZ_SEED + 100 + k, {"sizes": sizes},
                   name != "oversize_weighted" and k == 1)
                  for k in range(2)]
    return cases


def fuzz_phase():
    """Phase 12: fuzz_soak's five lanes on the card (``device="cuda"``)
    through the entry points a user calls (``align_pair``,
    ``sharded_align``, ``align_oversize``, ``runner.align_job``, the
    stage-4 reducers), at ``fuzz_cases``' seeds, each lane holding its
    result to the port's oracle.  Meanwhile a pool of CPU processes runs
    the same cases on the CPU (the plain versions: ``backend="kernel"``
    where a lane takes one), and each card result must equal the CPU
    lane's score, start, end and, in lanes 2 and 5, stage-2 crosspoints
    (``fuzz_soak.digest``).  Fails on any mismatch, on a crash case
    that did not crash, where a start/end pair was not run, where tier b
    did not reach 4096 x 4096, and where strip, batched_strip, hop,
    hop_prep or hop_match launched no time in the phase.  Prints per
    lane and tier the seeds, the modes, the launches and the seconds.
    Returns the phase's launches by kernel."""
    import multiprocessing

    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.tools import fuzz_soak as fz

    t0 = time.time()
    cases = fuzz_cases()
    workers = max(1, min(6, (os.cpu_count() or 2) - 2))
    ctx = multiprocessing.get_context("spawn")
    ex = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=ctx, initializer=fz.pool_init)
    try:
        cpu = [ex.submit(fz.lane_record, name, seed, "cpu",
                         **({"backend": "kernel"} if name in (
                             "pipeline_vs_oracle", "stage4_differential",
                             "crash_resume") else {}), **kw)
               for _, name, seed, kw, _ in cases]
        wrappers = counters()
        for w in wrappers.values():
            w.launches = 0
        card, failures, groups = [], [], {}
        for (tier, name, seed, kw, three), fut in zip(cases, cpu):
            t = time.perf_counter()
            route = (patched(kernels, "hop_route", lambda hb, W, dev: None)
                     if three else contextlib.nullcontext())
            try:
                with route:
                    rec = fz.lane_record(name, seed, "cuda", **kw)
            except Exception as e:  # noqa: BLE001 - raised below, after all
                rec = None
                failures.append(f"{name} seed {seed} on the card: "
                                f"{type(e).__name__}: {e}")
            g = groups.setdefault((name, tier), {
                "seeds": [], "modes": [], "seconds": 0.0,
                "launches": dict.fromkeys(wrappers, 0)})
            g["seeds"].append(seed)
            g["seconds"] += time.perf_counter() - t
            if rec is not None:
                for k, v in rec["launches"].items():
                    g["launches"][k] += v
                rec["tier"], rec["three"] = tier, three
                g["modes"].append("x".join(
                    str(v) for v in rec.get("modes", ())) + (
                    f"({rec['m']}x{rec['n']})"))
            card.append(rec)
        launches = {k: w.launches for k, w in wrappers.items()}
        card_s = time.time() - t0
        for (tier, name, seed, _, _), rec, fut in zip(cases, card, cpu):
            try:
                want = fut.result(timeout=600)
            except Exception as e:  # noqa: BLE001 - raised below
                failures.append(f"{name} seed {seed} on the CPU: "
                                f"{type(e).__name__}: {e}")
                continue
            if rec is None:
                continue
            keys = ("skipped",) if "skipped" in want else ("score", "start",
                                                           "end", "stage2")
            got = [rec.get(k) for k in keys]
            if got != [want.get(k) for k in keys]:
                failures.append(f"{name} seed {seed}: the card gave "
                                f"{dict(zip(keys, got))}, the CPU lane "
                                f"{ {k: want.get(k) for k in keys} }")
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    for (name, tier), g in groups.items():
        log(f"fuzz {name} tier {tier}: seeds {g['seeds'][0]}.."
            f"{g['seeds'][-1]} ({len(g['seeds'])}), "
            f"{g['seconds']:.1f} s, launches " + json.dumps(g["launches"])
            + "; cases " + " ".join(g["modes"]))
    done = [r for r in card if r is not None]
    seen = {tuple(r["modes"]) for r in done
            if r["lane"] == "pipeline_vs_oracle" and r["tier"] == "a"}
    if len(seen) != 30:
        failures.append(f"{len(seen)} start/end pairs ran on the card, "
                        f"not 30")
    big = [r for r in done if r["tier"] == "b"
           and r["lane"] == "pipeline_vs_oracle"]
    if not big or min(min(r["m"], r["n"]) for r in big) < 4096:
        failures.append("tier b did not reach 4096 x 4096")
    crashes = [r for r in done if r["lane"] == "crash_resume"]
    log("fuzz crash kills: " + "; ".join(
        f"seed {r['seed']} ({r['m']}x{r['n']}) at {r['kill'][0]} call "
        f"{r['kill'][1]}, rows lost {r['lost']}" for r in crashes))
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        failures.append(f"no launch of {idle} in the phase: {launches}")
    secs = time.time() - t0
    log(f"fuzz phase: {len(cases)} cases, {len(done)} on the card in "
        f"{card_s:.1f} s, the CPU lanes on {workers} processes beside "
        f"them; {secs:.1f} s in all; launches " + json.dumps(launches))
    if failures:
        for f in failures:
            log(f"fuzz FAIL: {f}")
        raise AssertionError(f"phase 12: {len(failures)} failures")
    return launches


def big_run_phase(size="5M"):
    """Phase 11: ``python -m masa_tpu_torch.tools.big_run 5M --fresh`` as
    a user runs it, in a child process (its kernel counts start at 0
    there): the 5M pair, 5,242,880 x 5,242,945, through
    ``runner.align_job`` at JobConfig's defaults, in a work directory
    under the temporary directory, removed afterwards.  Its lines are
    echoed and its JSON line printed whole; it must score masa_tpu's
    3984627 with stage 5 verified and stage 6 written, launch the strip
    kernel in stage 1, the hop kernel in stage 2 (one launch a hop
    issued, every hop of one launch) and the batched kernel in stage 4,
    and no hop_prep or hop_match in any stage.  Returns its launches by
    kernel, summed over the stages, and its stage-3 crosspoints."""
    import torch

    from masa_tpu_torch.core.job import CrosspointsFile
    from masa_tpu_torch.tools import bench_spread, pairs

    torch.cuda.empty_cache()  # the child's row cache takes half the free
    with tempfile.TemporaryDirectory(prefix="masa_big_") as tmp:
        work = os.path.join(tmp, "w")
        r = bench_spread.run_child(
            timeout=900, module="masa_tpu_torch.tools.big_run",
            args=[size, "--fresh", "--work-dir", work])
        written = os.path.exists(os.path.join(work, "alignment.00.txt"))
        cps3 = CrosspointsFile(os.path.join(work, "crosspoints",
                                            "crosspoint_03.00")).load() \
            if r["rc"] == 0 else []
    lines = r["lines"]
    for line in lines[:-1]:
        if "flushed row" not in line:
            log(f"  big_run> {line}")
    if r["rc"] != 0 or not lines:
        raise AssertionError(f"big_run {size} exited {r['rc']}: "
                             f"{r['stderr']}")
    log(f"big_run line: {lines[-1]}")
    got = json.loads(lines[-1])
    marks = got["stage_end_marks_s"]
    per = got["stage_launches"]
    launches = {k: sum(v.get(k, 0) for v in per.values()) for k in COUNTED}
    hops = got["hops"]
    want = pairs.SCORES[size]
    if got["score"] != want or got["reference_score"] != want:
        raise AssertionError(f"big_run {size} scored {got['score']}, "
                             f"masa_tpu {want}")
    if not written or "stage5" not in marks or "stage6" not in marks:
        raise AssertionError(f"big_run {size}: stage 5 or 6 did not "
                             f"finish ({sorted(marks)}, alignment file "
                             f"{written})")
    if per["stage1"]["strip"] <= 0 or per["stage4"]["batched_strip"] <= 0:
        raise AssertionError(f"big_run {size} launched no strip kernel in "
                             f"stage 1 or no batched kernel in stage 4: "
                             f"{per}")
    if hops["issued"] <= 0 or per["stage2"]["hop"] != hops["issued"] \
            or hops["three_launch"] or any(launches[k] for k in THREE):
        raise AssertionError(f"big_run {size}: the hops issued were not one "
                             f"hop launch each: {hops}, {per}")
    t_prev, secs = 0.0, {}
    for k in ("stage1", "stage2", "stage3", "stage4", "stage5", "stage6"):
        secs[k] = round(marks[k] - t_prev, 2)
        t_prev = marks[k]
    log(f"big_run {size}: {got['m']} x {got['n']}, score {got['score']} "
        f"(masa_tpu {want}) in {got['full_alignment_s']} s, seconds by "
        f"stage {json.dumps(secs)}; {hops['issued']} hops of one launch; "
        f"peak device memory {got['peak_device_bytes']} bytes, peak RSS "
        f"{got['peak_rss_bytes']}, work directory at most "
        f"{got['peak_work_dir_bytes']} bytes; the child's CPU seconds "
        f"{json.dumps(r['child_cpu_s'])} in {r['wall_s']:.1f} s")
    return launches, cps3


def roofline_matrix(dev):
    """Phase 2f: every roofline body's kernel equals its plain version on
    the TPU tool's inputs, at 0, 1 and 61 iterations."""
    import torch

    from masa_tpu_torch.tools import roofline as rl

    worst = 0
    for body in rl.BODIES:
        xs = [torch.from_numpy(x).to(dev) for x in rl.inputs(body)]
        for iters in (0, 1, 61):
            d = int((rl.run_cuda(body, xs, iters).long()
                     - rl.run_plain(body, xs, iters).long()).abs().max())
            worst = max(worst, d)
            if d:
                raise AssertionError(f"roofline {body} x{iters}: differs "
                                     f"(max |diff| {d})")
    log(f"roofline bodies vs plain: {len(rl.BODIES)} bodies "
        f"({', '.join(rl.BODIES)}) equal at 0, 1 and 61 iterations "
        f"(max |diff| {worst}, tolerance 0)")
    return worst


def timed(fn, *args, **kw):
    """fn's result and its time on the card in ms (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def timed_best(n, fn, *args, **kw):
    """fn's result and the least of n timings (after the caller's warm
    run): a short kernel's single timing carries the launch's jitter."""
    out, best = None, None
    for _ in range(n):
        out, ms = timed(fn, *args, **kw)
        best = ms if best is None else min(best, ms)
    return out, best


def timed_launch(n, fn, *args, **kw):
    """fn's result and the least of n timings, twice over: by events
    around the call (the wrapper's host work shows where the card waits
    for it) and by the wrappers' own events around their launches alone,
    summed.  After the caller's warm run."""
    from masa_tpu_torch.ops import kernels

    saved, kernels.event_log = kernels.event_log, []
    out, best, best_launch = None, None, None
    try:
        for _ in range(n):
            out, ms = timed(fn, *args, **kw)
            launch = sum(kernels.drain_events().values())
            best = ms if best is None else min(best, ms)
            best_launch = launch if best_launch is None \
                else min(best_launch, launch)
    finally:
        kernels.event_log = saved
    return out, best, best_launch


def nbytes(*tensors):
    """Bytes of the given tensors (None skipped): what a kernel must move
    when these are its inputs and outputs."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def strip_bytes(args, out):
    """Inputs read once, outputs written once, for one strip."""
    return nbytes(*args[:6], out.bus_h, out.bus_f, out.best, out.lastcol_h,
                  out.lastcol_e, out.rows_h, out.rows_f)


def main_shape(dev):
    """Phase 2b: one strip at a main-path shape, kernel and plain timed."""
    import numpy as np

    from masa_tpu_torch import InitType, ScoreParams
    from masa_tpu_torch.ops import wavefront as wf

    h, nj, flush = 8192, M_1M, 2048
    params = ScoreParams()
    args = strip_inputs(np.random.default_rng(11), h, nj,
                        InitType.WITH_ZEROES, params, dev)
    kw = dict(match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext, sw=True,
              track_best=True, store_lastcol=False, flush_every=flush)
    timed(wf.strip, *args, **kw)  # warm
    out_k, ms = timed(wf.strip, *args, **kw)
    out_p, plain_ms = timed(wf.strip_plain, *args, **kw)
    err = compare(out_k, out_p, f"main shape {h}x{nj}")
    log(f"main shape {h} x {nj} (SW, best, flush every {flush}): kernel "
        f"{ms:.3f} ms ({h * nj / ms / 1e6:.2f} GCUPS), plain {plain_ms:.3f} "
        f"ms ({h * nj / plain_ms / 1e6:.4f} GCUPS), equal")
    return err, ms, plain_ms, h * nj, strip_bytes(args, out_k)


def hop_shape(dev):
    """Phase 2b': the strip kernel at the shape of one stage-2 hop: 8192
    rows against a 16384-column window, NW, both borders pinned to the
    crosspoint (WITH_GAPS_OPENED): with the best tracked, kernel and plain
    timed, then with nothing tracked, kernel timed."""
    import numpy as np

    from masa_tpu_torch import InitType, ScoreParams
    from masa_tpu_torch.ops import wavefront as wf

    h, nj = 8192, 16384
    params = ScoreParams()
    args = strip_inputs(np.random.default_rng(29), h, nj,
                        InitType.WITH_GAPS_OPENED, params, dev)
    kw = dict(match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext, sw=False,
              track_best=True, store_lastcol=False, flush_every=0)
    timed(wf.strip, *args, **kw)  # warm
    out_k, ms = timed_best(3, wf.strip, *args, **kw)
    out_p, plain_ms = timed(wf.strip_plain, *args, **kw)
    err = compare(out_k, out_p, f"stage-2 hop shape {h}x{nj}")
    log(f"stage-2 hop shape {h} x {nj} (NW, best, pinned borders): kernel "
        f"{ms:.3f} ms ({h * nj / ms / 1e6:.2f} GCUPS), plain {plain_ms:.3f} "
        f"ms, equal")
    # the same hop with nothing tracked, as stage 2 runs every hop whose
    # goal cannot be reached inside it
    kw["track_best"] = False
    timed(wf.strip, *args, **kw)  # warm
    out_n, ms_n = timed_best(3, wf.strip, *args, **kw)
    err = max(err, compare(out_n, wf.strip_plain(*args, **kw),
                           f"stage-2 hop shape {h}x{nj}, nothing tracked"))
    log(f"stage-2 hop shape {h} x {nj} (NW, nothing tracked): kernel "
        f"{ms_n:.3f} ms ({h * nj / ms_n / 1e6:.2f} GCUPS), equal")
    return err, ms, plain_ms, h * nj, strip_bytes(args, out_k), ms_n


def stage4_levels(s0, s1, cps, dev, save=None):
    """Every launch of stage 4 on the 1M pair, forward and reverse, level
    by level: the element tables are tapped from one run of the engine on
    the CLI's stage-3 crosspoints at stage 4's stop, then each launch is
    timed alone (least of 3, events around the launch and around the
    wrapper's call) and held against its plain version on the same inputs.
    ``save``: a path for the pair and the tables (``.npz``), which
    ``tools/batched_tune.py --tables`` times again, with this package or
    another.  Returns (max |diff|, [per-launch dict])."""
    import math

    import numpy as np
    import torch

    from masa_tpu_torch import ScoreParams
    from masa_tpu_torch.ops import batched_mm
    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.stages import pipeline

    params = ScoreParams()
    mps = max(16, math.isqrt(pipeline.PipelineConfig().max_cells_stage5))
    tapped = []
    batched_mm.reduce_partitions_batched(
        s0, s1, cps, params, mps, device=dev,
        on_launches=lambda level, el_f, el_r, width: tapped.extend(
            [(level, "forward", el_f, width), (level, "reverse", el_r,
                                                width)]))
    if save:
        np.savez(save, s0=s0, s1=s1, launches=np.array(
            [(level, way == "reverse", width)
             for level, way, _, width in tapped]),
            **{f"elems{k}": t[2] for k, t in enumerate(tapped)})
    views = {"forward": (s0, s1), "reverse": (s0[::-1], s1[::-1])}
    views = {k: tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                      for x in v) for k, v in views.items()}
    kw = dict(match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, worst = [], 0
    for level, way, elems, width in tapped:
        a, b = views[way]
        timed(wf.batched_strip, a, b, elems, width, **kw)  # warm
        got, call_ms, ms = timed_launch(3, wf.batched_strip, a, b, elems,
                                        width, **kw)
        want, plain_ms = timed(wf.batched_strip_plain, a, b, elems, width,
                               **kw)
        worst = max(worst, batched_diff(got, want,
                                        f"stage-4 level {level} {way}"))
        cells = int((elems[:, 1].astype(np.int64) * elems[:, 3]).sum())
        # each element reads its rows of a and columns of b and writes
        # its bus
        moved = int(elems[:, 1].sum() + elems[:, 3].sum()) + elems.nbytes \
            + nbytes(*got)
        geo = kernels.batched_geometry(elems[:, 1], sms)
        rows.append(dict(level=level, way=way, elements=len(elems),
                         heights=[int(elems[:, 1].min()),
                                  int(elems[:, 1].max())],
                         width=width, cells=cells, bytes=moved, ms=ms,
                         call_ms=call_ms, plain_ms=plain_ms,
                         geometry=[geo.alpha, geo.warps, geo.per_block]))
        log(f"stage-4 level {level} {way} halves: {len(elems)} elements, "
            f"heights {rows[-1]['heights'][0]}-{rows[-1]['heights'][1]}, "
            f"widths up to {width}, {cells} cells, alpha x warps x per "
            f"block {geo.alpha} x {geo.warps} x {geo.per_block}: kernel "
            f"{ms:.3f} ms ({cells / ms / 1e6:.2f} GCUPS; {call_ms:.3f} ms "
            f"around the call), plain {plain_ms:.3f} ms, equal")
    return worst, rows


def streamed_border(s0, s1, dev):
    """Phase 2g: the strip kernel on a streamed left border at a slab's
    shape: the first 8192 rows of the 1M pair against the columns of
    ``--split 1,1``.  Slab 0 runs on the card (``run_part_stage1``) and
    writes its last column to a file:// stream; slab 1 reads it as its
    CUSTOM border, as the split does, and writes its own.  The kernel and
    the plain version on slab 1's inputs (the border as read), timed; the
    slab's best, last row, special rows and their column 0 equal the plain
    version's.  Returns (max |diff|, ms, plain_ms)."""
    import numpy as np
    import torch

    from masa_tpu_torch import InitType, ScoreParams
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.parallel import split

    h, flush = 8192, 2048
    a = np.ascontiguousarray(s0[:h])
    points = split.split_points(len(s1), [1.0, 1.0])
    params = ScoreParams()
    with tempfile.TemporaryDirectory() as tmp:
        urls = split.auto_urls(tmp, 3)
        split.run_part_stage1(a, s1, 0, points, params, flush_url=urls[0],
                              buffered=False, device=dev)
        p = split.run_part_stage1(a, s1, 1, points, params,
                                  load_url=urls[0], flush_url=urls[1],
                                  buffered=False, special_every=flush,
                                  device=dev)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        x, np.int32)).to(dev)
    slab = np.ascontiguousarray(s1[points[1]:points[2]])
    bus_h, bus_f = wf.init_bus(InitType.WITH_ZEROES, len(slab),
                               params.gap_open, params.gap_ext, dev)
    args = (torch.from_numpy(a).to(dev), torch.from_numpy(slab).to(dev),
            bus_h, bus_f, t(p.first_col[0][1:]), t(p.first_col[1][1:]), 0)
    kw = dict(match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext, sw=True,
              track_best=True, store_lastcol=True, flush_every=flush)
    timed(wf.strip, *args, **kw)  # warm
    got, ms = timed(wf.strip, *args, **kw)
    want, plain_ms = timed(wf.strip_plain, *args, **kw)
    err = compare(got, want, f"streamed border {h} x {len(slab)}")
    s, bi, bj = (int(v) for v in want.best.tolist())
    if (p.best, p.best_i, p.best_j - p.j0) != (s, bi + 1, bj + 1):
        raise AssertionError("streamed border: the slab's best differs")
    if not np.array_equal(p.last_h, want.bus_h.cpu().numpy()):
        raise AssertionError("streamed border: the slab's last row differs")
    rows = p.specials.rows()
    if rows != [flush * (k + 1) for k in range(len(want.rows_h))]:
        raise AssertionError(f"streamed border: special rows {rows}")
    for k, r in enumerate(rows):
        hr, _ = p.specials.get(r)
        if hr[0] != p.first_col[0][r] or not np.array_equal(
                hr[1:], want.rows_h[k].cpu().numpy()):
            raise AssertionError(f"streamed border: special row {r} differs")
    log(f"streamed border: slab 1 of --split 1,1 at {h} x {len(slab)}, its "
        f"border written by slab 0's launch: kernel {ms:.3f} ms "
        f"({h * len(slab) / ms / 1e6:.2f} GCUPS), plain {plain_ms:.3f} ms, "
        f"max |diff| {err}; the slab's best, last row and {len(rows)} "
        f"special rows equal")
    return err, ms, plain_ms


def prune_inputs(s0, s1, dev, i0, c0, h, nj):
    """A pruning launch of the strip kernel at rows [i0, i0 + h) and
    columns [c0, c0 + nj) of the partition s0[:i0 + h] x s1[:c0 + nj]: the
    row above from an unpruned launch, the zero border (a -INF wall right of
    a host window when c0 > 0), a best of 300 handed in when i0 > 0."""
    import numpy as np
    import torch

    from masa_tpu_torch import InitType, ScoreParams
    from masa_tpu_torch.ops import wavefront as wf

    params = ScoreParams()
    kw = dict(match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext, sw=True,
              track_best=True)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    a, b = t(s0[:i0 + h]), t(s1[:c0 + nj])
    bus_h, bus_f = wf.init_bus(InitType.WITH_ZEROES, c0 + nj,
                               params.gap_open, params.gap_ext, dev)
    neg = torch.full((h,), NEG, dtype=torch.int32, device=dev)
    if i0:
        up = wf.strip(a[:i0], b, bus_h, bus_f,
                      torch.zeros(i0, dtype=torch.int32, device=dev),
                      torch.full((i0,), NEG, dtype=torch.int32, device=dev),
                      0, **kw)
        bus_h, bus_f = up.bus_h, up.bus_f
    col_h = neg if c0 else torch.zeros(h, dtype=torch.int32, device=dev)
    args = (a[i0:], b[c0:], bus_h[c0:].contiguous(), bus_f[c0:].contiguous(),
            col_h, neg, NEG if c0 else 0)
    best = torch.tensor([300 if i0 else 0], device=dev)
    return args, wf.LaunchPrune(i0 + h, c0 + nj, i0, c0, best), kw


def prune_matrix(s0, s1, dev):
    """Phase 2h: the strip kernel's pruning instances against their plain
    twin (``wavefront.strip_plain_pruned``) at the launch's own geometry,
    byte for byte: every output (the per-row bests and the flushed rows
    with their -INF prefixes) and the record.  Shapes where the rule fires:
    the 1M pair's first 16384 x 16384 on 4 blocks (flushed every 2048),
    and a launch below and right of a partition's corner with a best
    handed in, on 3 blocks.  Returns the largest |difference|."""
    import torch

    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf

    saved = kernels.strip_cuda.launches
    worst, line = 0, []
    for i0, c0, h, nj, flush, ctas in ((0, 0, 16384, 16384, 2048, 4),
                                       (8192, 1024, 6001, 7000, 777, 3)):
        args, lp, kw = prune_inputs(s0, s1, dev, i0, c0, h, nj)
        got, ms = timed(kernels.strip_cuda, *args, **kw, flush_every=flush,
                        max_ctas=ctas, prune=lp)
        rec = got[8]
        want, plain_ms = timed(wf.strip_plain_pruned, *args, lp,
                               (rec.rows, rec.blocks), **kw,
                               flush_every=flush)
        what = f"pruning launch {h} x {nj} at ({i0}, {c0}) on {ctas} blocks"
        for k, (x, y) in enumerate(zip(got[:8], want[:8])):
            if (x is None) != (y is None):
                raise AssertionError(f"{what}: output {k} on one side only")
            if x is not None:
                d = int((x.long() - y.long()).abs().max())
                worst = max(worst, d)
                if d:
                    raise AssertionError(f"{what}: output {k} differs (max "
                                         f"|diff| {d})")
        if not torch.equal(rec.record, want[8].record):
            raise AssertionError(f"{what}: the record differs")
        skipped = rec.pruned_cells(h)
        if skipped <= 0:
            raise AssertionError(f"{what}: the rule pruned nothing")
        line.append(f"{h} x {nj} at ({i0}, {c0}), {rec.rows}-row sub-strips "
                    f"on {rec.blocks} blocks: {skipped} cells pruned "
                    f"({100 * skipped / (h * nj):.1f}%), kernel {ms:.3f} ms, "
                    f"twin {plain_ms:.1f} ms")
    kernels.strip_cuda.launches = saved  # checks, no main path
    log("pruning kernel vs its plain twin, outputs and record equal (max "
        f"|diff| {worst}, tolerance 0): " + "; ".join(line))
    return worst


def prune_waves(dev):
    """Phase 2i: the pruning instances at the main path's block geometries
    (8 rows a thread, stage 1's on the 1M pair, and 4) on launches of more
    sub-strips than the grid, so that ``B_g`` comes from the chain of
    prefix bests: 8 rows a thread on the full grid and on 4 blocks with no
    best handed in, 4 rows a thread on 64 blocks with a best of 2000
    handed in, below the launch's optimum (and on the full grid, which at
    4 rows a thread holds every sub-strip at once).  Sampled sub-strips (the first
    two, those around the grid's size, and every one of the last 8192
    rows, where the rule skips a part of the columns) are held against
    the twin byte for byte, from the launch's own flushed rows
    (``tools/strip_tune.pruned_waves``).  Returns the largest |difference|
    (0: any difference raises)."""
    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.tools import strip_tune

    saved = kernels.strip_cuda.launches
    line = []
    for alpha, ctas, best_in in strip_tune.PRUNED_WAVES:
        t0 = time.time()
        r = strip_tune.pruned_waves(dev, alpha, ctas, best_in)
        line.append(f"{r['what']}, best {best_in} handed in: "
                    f"{r['checked']} of {r['sub_strips']} sub-strips equal "
                    f"({r['partial']} skipping a part of their columns, "
                    f"{r['chained']} against a best from above), "
                    f"{100 * r['pruned_cells'] / r['cells']:.3f}% pruned, "
                    f"{time.time() - t0:.1f} s")
    kernels.strip_cuda.launches = saved  # checks, no main path
    log("pruning kernel vs its twin on launches taller than the grid "
        "(tolerance 0): " + "; ".join(line))
    return 0


def prune_stage1(s0, s1, dev):
    """Phase 7b: the CLI's stage-1 launch on the 1M pair (SW, best tracked,
    a row flushed every 8192, zero borders) with pruning inside the launch
    and without it, each warmed then timed twice by events around the
    launch alone; the two pruning runs must write the same rows, record and
    best, the best must be the unpruned one's, and two flush intervals of
    the pruning launch must equal the twin's (``strip_tune.
    check_pruned_span``, from the launch's own flushed rows and per-row
    bests: the main path's own instance, 2048-row sub-strips on the full
    grid).  Returns a dict of the
    times, the cells computed and pruned, and the blocks."""
    import numpy as np
    import torch

    from masa_tpu_torch import InitType, ScoreParams
    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf

    params = ScoreParams()
    m, n, flush = len(s0), len(s1), 8192
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    a, b = t(s0), t(s1)
    bus_h, bus_f = wf.init_bus(InitType.WITH_ZEROES, n, params.gap_open,
                               params.gap_ext, dev)
    args = (a, b, bus_h, bus_f, torch.zeros(m, dtype=torch.int32, device=dev),
            torch.full((m,), NEG, dtype=torch.int32, device=dev), 0)
    kw = dict(match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext, sw=True,
              track_best=True, flush_every=flush)
    lp = wf.LaunchPrune(m, n, 0, 0, torch.zeros(1, dtype=torch.int64,
                                                device=dev))
    saved = kernels.strip_cuda.launches
    runs = {}
    for name, extra in (("unpruned", {}), ("pruned", {"prune": lp}),
                        ("pruned", {"prune": lp}), ("unpruned", {})):
        out, _, ms = timed_launch(1, kernels.strip_cuda, *args, **kw, **extra)
        runs.setdefault(name, []).append((ms, out))
    kernels.strip_cuda.launches = saved  # a measurement, no main path
    (ms_p1, one), (ms_p2, two) = runs["pruned"]
    for k, (x, y) in enumerate(zip(one[:8], two[:8])):
        if x is not None and not torch.equal(x, y):
            raise AssertionError(f"pruned stage-1 launch: output {k} differs "
                                 f"between two runs")
    if not torch.equal(one[8].record, two[8].record):
        raise AssertionError("pruned stage-1 launch: the records differ")
    full = runs["unpruned"][0][1]
    best_p = wf.merge_best(one[2], one[3])
    if not torch.equal(best_p, wf.merge_best(full[2], full[3])):
        raise AssertionError("pruned stage-1 launch: the best differs from "
                             "the unpruned launch's")
    # the twin on sampled flush intervals of this launch (4 sub-strips
    # each), from its own flushed rows: the last, and the one whose first
    # columns kept lie nearest the middle of the columns
    from masa_tpu_torch.tools import strip_tune

    rec = one[8]
    first = rec.record[:, 0].tolist()
    per = flush // rec.rows
    n_sub = len(first)
    mid = min(range(0, n_sub - per, per),
              key=lambda g: abs(first[g] - n // 2))
    kw.pop("flush_every")
    t0 = time.time()
    for g0 in (mid, n_sub - per):
        strip_tune.check_pruned_span(args, one, lp, flush, g0, g0 + per, kw)
    twin_s = time.time() - t0
    pruned = rec.pruned_cells(m)
    res = dict(pruned_ms=[ms_p1, ms_p2],
               unpruned_ms=[ms for ms, _ in runs["unpruned"]],
               cells=m * n - pruned, pruned_cells=pruned,
               blocks=one[8].blocks, rows=one[8].rows,
               bytes=nbytes(*args[:6], *one[:8]))
    log(f"pruned stage-1 launch, 1M pair ({m} x {n}, rows flushed every "
        f"{flush}): {pruned} cells pruned ({100 * pruned / (m * n):.2f}%) by "
        f"{one[8].rows}-row sub-strips on {one[8].blocks} blocks; kernel "
        f"{ms_p1:.1f} and {ms_p2:.1f} ms pruned, "
        f"{res['unpruned_ms'][0]:.1f} and {res['unpruned_ms'][1]:.1f} ms "
        f"unpruned; best {best_p.tolist()} both ways; the two pruned runs' "
        f"rows, record and outputs equal; sub-strips {mid}-{mid + per - 1} "
        f"(first columns kept {first[mid:mid + per]}) and "
        f"{n_sub - per}-{n_sub - 1} ({first[n_sub - per:]}) equal the twin's "
        f"from the launch's own rows ({twin_s:.1f} s)")
    return res


def golden_pairs():
    """Phase 3: the frozen real-genomic scores through align()."""
    import masa_tpu_torch

    g = os.path.join(REPO, "tests", "golden")
    for name, score, end in (("real1", 11367, [16384, 15805]),
                             ("real2", 32466, None)):
        t0 = time.time()
        aln = masa_tpu_torch.align(os.path.join(g, f"{name}_a.fa"),
                                   os.path.join(g, f"{name}_b.fa"),
                                   device="cuda")
        got_end = [int(x) for x in aln.end]
        log(f"{name}: score {aln.raw_score} end {got_end} in "
            f"{time.time() - t0:.2f} s")
        if aln.raw_score != score or (end and got_end != end):
            raise AssertionError(f"{name}: expected {score} at {end}")


def traceback_phase(dev):
    """Phase 2m: stage 5's batched traceback (csrc/traceback.cu).  The
    kernel against its plain version and the native call on partitions of
    every degenerate and main-path shape in all nine start and end states;
    then the 1M self-pair (2^20 random bases against themselves, the
    benchmark's pair) through stages 1, 2 and 4 on the card as the CLI runs
    them (stage 3 passed through, stage 4 down to 512 a side), and its
    stage 5 on the card and on the host: every partition must go to the
    card and both must give the same score, statistics, gap lists and
    CGFF bytes, and the port's ``partitions.card`` counter must count
    every partition.  The kernel is timed alone at those partitions (the
    least of four calls by its launch events) against its bound: seven
    INT32-lane instructions a cell (three add-max and a max, three
    compares for the cell's bits) over the card's int32 peak (132 SMs x 64
    lanes x 1980 MHz); then the kernel and the plain version on a wave of
    them (a partition an SM).  Returns (max abs err, (ms, plain ms, cells,
    bytes)) of the wave."""
    import numpy as np
    import torch

    from masa_tpu_torch.biology import alignment as balign
    from masa_tpu_torch.native import bindings
    from masa_tpu_torch.ops import kernels, smallsw
    from masa_tpu_torch.ops import myers_miller as mm
    from masa_tpu_torch.stages import pipeline
    from masa_tpu_torch.types import ScoreParams

    params = ScoreParams()
    rng = np.random.default_rng(23)
    bases = np.frombuffer(b"ACGT", np.uint8)
    err = 0
    for h, w in ((0, 9), (9, 0), (1, 300), (300, 1), (137, 136), (512, 512),
                 (64, 4096), (4096, 64)):
        s0 = rng.choice(bases, h).astype(np.uint8)
        s1 = np.resize(s0, w) if h else rng.choice(bases, w)
        s1 = s1.astype(np.uint8)
        flip = rng.random(w) < 0.15
        s1[flip] = rng.choice(bases, int(flip.sum()))
        items = np.array([(0, h, 0, w, ts, te) for ts in range(3)
                          for te in range(3)], np.int64)
        got = smallsw.traceback_decode(smallsw.traceback_batch(
            torch.from_numpy(s0).to(dev), torch.from_numpy(s1).to(dev),
            items, params).cpu().numpy(), items[:, 1:4:2])
        plain = smallsw.traceback_decode(smallsw.traceback_plain(
            torch.from_numpy(s0), torch.from_numpy(s1), items,
            params).numpy(), items[:, 1:4:2])
        for (_, _, _, _, ts, te), (seg, ops), (pseg, pops) in zip(
                items, got, plain):
            try:
                want = bindings.traceback_ops(s0, s1, ts, te, params)
            except RuntimeError:
                want = None
            same = (seg == pseg and (ops is None) == (pops is None)
                    == (want is None) and (ops is None or (
                        np.array_equal(ops, pops) and seg == want[0]
                        and np.array_equal(ops, want[1]))))
            if not same:
                err = max(err, abs(seg - pseg), 1)
                log(f"traceback: {h} x {w} states {ts}{te}: kernel {seg}, "
                    f"plain {pseg}, native {want and want[0]}")
    log(f"traceback: kernel, plain version and native call agree on 8 "
        f"shapes x 9 states: max abs err {err}")

    s0 = np.random.default_rng(1 << 20).choice(bases, 1 << 20).astype(
        np.uint8)
    pcfg = pipeline.PipelineConfig(device="cuda")
    res, end = pipeline.stage1_pass(s0, s0, pcfg)
    cps = pipeline.stage2_march(s0, s0, pcfg, end, res.specials,
                                res.dev_cache)
    res = None
    cps = mm.stage4_reduce(s0, s0, cps, params, pcfg.max_partition,
                           stage5_max_cells=pcfg.max_cells_stage5,
                           device="cuda")
    times, alns = {}, {}
    saved, kernels.event_log = kernels.event_log, []
    try:
        parts0 = stage5_partitions()
        for where in ("cuda", "cpu"):
            t0 = time.time()
            alns[where] = pipeline.stage5_emit(
                s0, s0, pipeline.PipelineConfig(device=where), cps)
            times[where] = time.time() - t0
            if where == "cuda":
                parts, taken = (x - y for x, y in zip(stage5_partitions(),
                                                      parts0))
    finally:
        kernels.event_log = saved
    files = {}
    with tempfile.TemporaryDirectory() as tmp:
        for where, aln in alns.items():
            balign.write_cgff(os.path.join(tmp, where), aln)
            with open(os.path.join(tmp, where), "rb") as fh:
                files[where] = fh.read()
    card, host = alns["cuda"], alns["cpu"]
    hw = np.array([(b.i - a.i, b.j - a.j) for a, b in zip(cps, cps[1:])])
    log(f"traceback: the 1M self-pair's stage 5, {parts} partitions "
        f"({taken} on the card by the port's partitions.card), "
        f"{int((hw[:, 0] * hw[:, 1]).sum())} cells: {times['cuda']:.3f} s "
        f"on the card, {times['cpu']:.3f} s on the host; score "
        f"{card.raw_score}")
    if files["cuda"] != files["cpu"] or card.gaps != host.gaps \
            or card.raw_score != host.raw_score \
            or not parts == taken == len(hw):
        raise AssertionError("stage 5 on the card differs from the host's, "
                             "or left partitions to the host")
    ci = np.array([c.i for c in cps], np.int64)
    cj = np.array([c.j for c in cps], np.int64)
    ct = np.array([int(c.type) for c in cps], np.int64)
    items = np.stack([ci[:-1], hw[:, 0], cj[:-1], hw[:, 1], ct[:-1],
                      ct[1:]], 1)
    a = torch.from_numpy(s0).to(dev)

    def timed(batch):
        """The least of four calls by their launch events, the cells and
        the bytes moved: the partitions' characters, items and output."""
        saved, kernels.event_log = kernels.event_log, []
        try:
            best = None
            for _ in range(4):
                out = kernels.traceback_cuda(a, a, batch, match=1,
                                             mismatch=-3, gap_open=3,
                                             gap_ext=2)
                ms = kernels.drain_events()["traceback"]
                best = ms if best is None else min(best, ms)
        finally:
            kernels.event_log = saved
        cells = int((batch[:, 1] * batch[:, 3]).sum())
        return best, cells, int((batch[:, 1] + batch[:, 3]).sum()) + 4 * (
            out.numel() + 8 * len(batch))

    ms, cells, moved = timed(items)
    bound = 1e3 * 7 * cells / (132 * 64 * 1.98e9)
    log(f"traceback: kernel {ms:.4f} ms over all {len(items)} partitions "
        f"({cells} cells), bound {bound:.4f} ms by operations = "
        f"{100 * bound / ms:.1f}% of it")
    # the kernels line's row: a wave of the card (a partition an SM),
    # the kernel and the plain version on the same partitions
    wave = items[:torch.cuda.get_device_properties(dev).multi_processor_count]
    ms, cells, moved = timed(wave)
    t0 = time.time()
    for k in range(0, len(wave), 16):
        smallsw.traceback_plain(torch.from_numpy(s0), torch.from_numpy(s0),
                                wave[k:k + 16], params)
    plain_ms = 1e3 * (time.time() - t0)
    log(f"traceback: a wave of {len(wave)} partitions ({cells} cells): "
        f"kernel {ms:.4f} ms, the plain version {plain_ms:.0f} ms")
    return err, (ms, plain_ms, cells, moved)


def full_run(s0, s1):
    """Phase 4: the six stages on the 1M pair through align_pair, timed
    and counted per stage.  Stage 3 densifies to max_cells_stage5 and
    stage 4 stops at isqrt(max_cells_stage5), as masa_tpu's does on its
    device, so stage 4 may find nothing left to split here; the CLI run
    (phase 5) is where stage 4 splits whole stage-2 bands."""
    import torch

    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.stages import core, pipeline, stage6

    wrappers = counters()
    pcfg = pipeline.PipelineConfig(device="cuda")
    secs, launches, ncps = {}, {}, {}
    seen = {k: 0 for k in wrappers}
    stats = core.MarchStats()

    def on_stage(name, seconds, out):
        secs[name] = seconds
        launches[name] = {k: c.launches - seen[k]
                          for k, c in wrappers.items()}
        seen.update({k: c.launches for k, c in wrappers.items()})
        if isinstance(out, list):
            ncps[name] = len(out)
        log(f"  {name}: {seconds:.2f} s, launches "
            + ", ".join(f"{k} {v}" for k, v in launches[name].items())
            + "; kernel ms " + kernel_ms_text(kernels.drain_events()))
        if name == "stage1":
            log("  " + cache_text(out[0].dev_cache))
        elif name == "stage2":
            log(f"  stage2: {stats.text()}")

    for c in wrappers.values():
        c.launches = 0
    kernels.drain_events()
    torch.cuda.reset_peak_memory_stats()
    parts0 = stage5_partitions()
    aln = pipeline.align_pair(s0, s1, pcfg, on_stage=on_stage, stats=stats)
    parts, card = (x - y for x, y in zip(stage5_partitions(), parts0))
    t0 = time.time()
    rc = stage6.recheck(aln, s0, s1, pcfg.params)
    secs["stage6"] = time.time() - t0
    total = sum(secs.values())
    log(f"1M pair: score {aln.raw_score} (stage-6 re-score {rc.score}), "
        f"start {list(aln.start)} end {list(aln.end)}, crosspoints "
        + ", ".join(f"{v} after {k}" for k, v in ncps.items())
        + f"; stage 5's partitions {parts}, on the card {card}")
    log(f"1M pair: {total:.2f} s in all, "
        f"{len(s0) * len(s1) / total / 1e9:.2f} GCUPS whole run; per stage "
        + json.dumps({k: round(v, 3) for k, v in secs.items()}))
    if aln.raw_score != SCORE_1M or rc.score != SCORE_1M:
        raise AssertionError(f"1M pair scored {aln.raw_score} (re-score "
                             f"{rc.score}), expected {SCORE_1M}")
    for s in ("stage1", "stage2", "stage3"):
        if launches[s]["strip"] <= 0:
            raise AssertionError(f"{s} launched no strip kernel")
    if launches["stage5"]["traceback"] <= 0 or not 0 < card == parts:
        raise AssertionError(f"align_pair's stage 5 gave the card {card} "
                             f"of {parts} partitions in "
                             f"{launches['stage5']['traceback']} launches")
    if stats.dev_matches <= 0 or stats.chained <= 0:
        raise AssertionError("align_pair's stage 2 matched no hop on the "
                             "card, or chained none")


def cache_text(cache):
    """The row cache after stage 1, and the card's peak memory so far."""
    import torch

    return (f"stage 1 kept {len(cache)} rows on the card, "
            f"{cache.nbytes} bytes (budget {cache.budget}); peak device "
            f"memory "
            f"{torch.cuda.max_memory_allocated()} bytes")


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` is ``value`` inside the block: how this script takes a
    path that the port keeps no option for (the eager rows, the host
    match), to hold it against the one the port takes."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def march_paths(s0, s1):
    """Phase 4b: stage 1 of align_pair on the 1M pair with its rows handed
    to the store eagerly (each pulled to the host as int32 as it comes)
    and lazily (kept on the card); then stage 2 four ways
    over the lazy run's rows: on the host (each hop's whole row), from cut
    windows (no cache), from the row cache hop by hop and from the row
    cache with chained hops.  The four crosspoint lists must be equal, the
    cache's marches must match on the card and copy no sequence from the
    host, the windows' must read windows, the chained one must chain.
    Each march's sequence uploads and flips are printed."""
    import torch

    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.stages import core, pipeline

    pcfg = pipeline.PipelineConfig(device="cuda")
    secs = {}

    def stage1(name):
        t0 = time.time()
        out = pipeline.stage1_pass(s0, s1, pcfg)
        torch.cuda.synchronize()
        secs.setdefault(name, []).append(round(time.time() - t0, 3))
        return out

    with patched(core, "lazy_rows_fit", lambda *a: False):
        _, ep_eager = stage1("stage1 eager")
    res, endpoint = stage1("stage1 lazy")
    if endpoint != ep_eager:
        raise AssertionError(f"eager and lazy stage 1 ended apart: "
                             f"{ep_eager} against {endpoint}")
    chains, stats, moved = {}, {}, {}
    for name, cache, windows, chain in (
            ("host", None, False, False), ("windows", None, True, False),
            ("cache", res.dev_cache.copy(), True, False),
            ("chain", res.dev_cache, True, True)):
        stats[name] = core.MarchStats()
        before = dict(wf.dev_seq_counts)
        t0 = time.time()
        with patched(core, "_windowed_cut_ok", core._windowed_cut_ok
                     if windows else lambda *a, **k: False):
            chains[name] = pipeline.stage2_march(
                s0, s1, pcfg, endpoint, res.specials.copy(), cache,
                stats[name], chain=chain)
        torch.cuda.synchronize()
        secs[f"stage2 {name}"] = round(time.time() - t0, 3)
        moved[name] = {k: v - before[k] for k, v in wf.dev_seq_counts.items()}
        log(f"  stage 2 {name}: {len(chains[name])} crosspoints in "
            f"{secs[f'stage2 {name}']:.2f} s; {stats[name].text()}; "
            f"sequences copied to the card {moved[name]['uploads']}, "
            f"flipped there {moved[name]['flips']}")
    log("1M pair, stage 1 and stage 2 by path (align_pair's passes): "
        + json.dumps(secs))
    if not (chains["host"] == chains["windows"] == chains["cache"]
            == chains["chain"]):
        raise AssertionError("stage 2's paths found other crosspoints")
    if stats["cache"].dev_matches <= 0 or stats["host"].dev_matches:
        raise AssertionError(f"the cache's march matched no hop on the "
                             f"card, or the host's did: {stats}")
    if stats["windows"].window_reads <= 0:
        raise AssertionError("the march without a cache read no window")
    if stats["chain"].chained <= 0 or stats["cache"].chained:
        raise AssertionError(f"the chained march chained no hop, or the "
                             f"hop-by-hop one did: {stats}")
    if moved["cache"]["uploads"] or moved["chain"]["uploads"]:
        raise AssertionError(f"a march over stage 1's rows copied a "
                             f"sequence to the card: {moved}")
    return secs


def kernel_ms_text(ms):
    return json.dumps({k: round(v, 3) for k, v in ms.items()}) if ms \
        else "{}"


class StageTap(io.StringIO):
    """The CLI's stdout: at each stage's completion line
    (``bench.stage_done``) the kernels' milliseconds since the line before
    are read off the launch events."""

    def __init__(self):
        from masa_tpu_torch.ops import wavefront as wf

        super().__init__()
        self.kernel_ms = {}
        self.seq_moves = {}  # sequence uploads and flips by stage
        self._seq = dict(wf.dev_seq_counts)

    def write(self, text):
        from masa_tpu_torch.bench import stage_done
        from masa_tpu_torch.ops import kernels
        from masa_tpu_torch.ops import wavefront as wf

        done = stage_done(text)
        if done:
            got = kernels.drain_events()
            mine = self.kernel_ms.setdefault(done[0], {})
            for k, v in got.items():
                mine[k] = mine.get(k, 0.0) + v
            now = dict(wf.dev_seq_counts)
            moves = self.seq_moves.setdefault(done[0], dict.fromkeys(
                now, 0))
            for k, v in now.items():
                moves[k] += v - self._seq[k]
            self._seq = now
        return super().write(text)


def write_fasta(path, desc, seq):
    with open(path, "wb") as fh:
        fh.write(b">" + desc.encode() + b"\n")
        for k in range(0, len(seq), 70):
            fh.write(seq[k:k + 70].tobytes() + b"\n")


def run_cli(argv, quiet=("stage1: ... flushed",)):
    """``masa_tpu_torch.cli.main(argv)`` in-process with the kernel counts
    set to 0 just before: its stdout (echoed, less the lines starting with
    ``quiet``), seconds and launches of the COUNTED kernels.  A non-zero
    exit raises.  ``run_cli.last_tap`` keeps the call's StageTap,
    ``run_cli.partitions`` its stage 5's partitions and those the card
    took (``stage5_partitions``)."""
    from masa_tpu_torch import cli
    from masa_tpu_torch.ops import kernels

    wrappers = counters()
    for c in wrappers.values():
        c.launches = 0
    kernels.drain_events()
    buf = run_cli.last_tap = StageTap()
    parts0 = stage5_partitions()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    secs = time.time() - t0
    run_cli.partitions = tuple(
        x - y for x, y in zip(stage5_partitions(), parts0))
    rest = kernels.drain_events()
    out = buf.getvalue()
    for line in out.splitlines():
        if not line.startswith(quiet):
            log(f"  cli> {line}")
    log("  kernel ms per stage: " + json.dumps(
        {st: {k: round(v, 3) for k, v in ms.items()}
         for st, ms in buf.kernel_ms.items()})
        + (f"; after the last stage line {kernel_ms_text(rest)}"
           if rest else "")
        + "; stage 5's partitions %d, on the card %d" % run_cli.partitions)
    if rc != 0:
        raise AssertionError(f"the CLI exited {rc}")
    return out, secs, {k: c.launches for k, c in wrappers.items()}


def stage_seconds(out):
    """The CLI's per-stage seconds, as its stages' completion lines state
    them (``bench.stage_done``)."""
    from masa_tpu_torch.bench import stage_done

    done = [stage_done(line) for line in out.splitlines()]
    return {d[0]: d[1] for d in done if d and d[1] is not None}


def tree_digests(top):
    """Every file under ``top``: its path below ``top`` -> (its size, the
    SHA-256 of its bytes)."""
    import hashlib

    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            path = os.path.join(d, f)
            sha = hashlib.sha256()
            with open(path, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 24), b""):
                    sha.update(block)
            out[os.path.relpath(path, top)] = (os.path.getsize(path),
                                               sha.hexdigest())
    return out


def pruned_cells_of(work):
    with open(os.path.join(work, "statistics_01.00")) as fh:
        return int(re.search(r"pruned_cells: (\d+)", fh.read()).group(1))


def stats_of(work, stage):
    """The integer lines of a statistics file of the CLI's work dir."""
    with open(os.path.join(work, f"statistics_0{stage}.00")) as fh:
        return {k.strip(): int(v) for k, v in re.findall(
            r"^\s*(\w+): (-?\d+)$", fh.read(), re.M)}


def outputs_of(work):
    """Digests of a work dir's crosspoint files and alignments."""
    import hashlib

    out = tree_digests(os.path.join(work, "crosspoints"))
    for name in sorted(os.listdir(work)):
        if name.startswith("alignment."):
            with open(os.path.join(work, name), "rb") as fh:
                out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def cli_run(fa, fb, tmp, cells):
    """Phase 5: the pair through the CLI in-process, every special row on
    disk.  First one full call (stage 1's rows stay on the card, so stage
    2 matches there, chained); then --stage-1 (block pruning on, the CLI's
    default: it must prune; lazy rows, written packed), the same
    --stage-1 again in another work directory with its rows handed over
    eagerly (every row reads back equal through the special-rows area,
    the crosspoint and pruned cells the first one's), then the
    full run resuming the first (no cache: stage 2 reads cut windows off
    the disk rows) and the full run resuming the second with the window
    reads off (the host match, a whole row read a hop).  The three full
    runs write the same crosspoints and alignment.  Then a full call with
    sparse special rows (a row every 131072: hops taller than a cluster
    of hop CTAs) must take the three launches for each hop.  Returns the
    strip
    launches of the first two calls and the batched launches of the
    first and the resumed one, its stage-3 crosspoints (the stage-2 bands:
    stage 3 passes them through on the card), the seconds per stage and
    the pruned cells."""
    import torch

    from masa_tpu_torch.core.job import CrosspointsFile
    from masa_tpu_torch.stages import core

    flags = ["--ram-size", "0", "--disk-size", "1G"]  # 1 GiB, all on disk
    single = os.path.join(tmp, "single")
    torch.cuda.reset_peak_memory_stats()
    one, secs_1, launches_1 = run_cli([fa, fb, "--work-dir", single] + flags)
    parts_1 = run_cli.partitions
    peak = torch.cuda.max_memory_allocated()
    st1, st2 = stats_of(single, 1), stats_of(single, 2)
    moves = run_cli.last_tap.seq_moves
    log(f"CLI 1M pair, one full call: {secs_1:.2f} s; stage 1 kept "
        f"{st1['dev_rows']} rows on the card ({st1['dev_row_bytes']} "
        f"bytes, budget {st1['dev_row_budget']}, lazy {st1['lazy_rows']})"
        f", peak device memory {peak} bytes; stage 2 "
        + json.dumps({k: st2[k] for k in (
            "dev_matches", "host_matches", "window_reads", "window_bytes",
            "chained", "segments", "chain_breaks")})
        + f" (a verdict pull a segment: {st2['segments']} pulls); "
        f"sequences copied to the card and flipped there by stage "
        + json.dumps(moves))
    if st2["dev_matches"] <= 0 or not st1["lazy_rows"]:
        raise AssertionError("the single CLI call's stage 2 matched no hop "
                             "on the card, or its rows were not lazy")
    if st2["chained"] <= 0 or moves.get("stage2", {}).get("uploads", 1):
        raise AssertionError("the single CLI call's stage 2 chained no hop, "
                             "or copied a sequence to the card")
    one_launch(launches_1, st2, "the single CLI call")
    work = os.path.join(tmp, "w")
    argv = [fa, fb, "--work-dir", work] + flags
    first, secs0, launches0 = run_cli(argv + ["--stage-1"])
    pruned = pruned_cells_of(work)
    if pruned <= 0:
        raise AssertionError("the CLI's stage 1 pruned nothing with block "
                             "pruning on")
    again = os.path.join(tmp, "again")
    with patched(core, "lazy_rows_fit", lambda *a: False):
        repeat, secs_r, launches_r = run_cli(
            [fa, fb, "--work-dir", again, "--stage-1"] + flags)
    if stats_of(again, 1)["lazy_rows"] or not stats_of(work, 1)["lazy_rows"]:
        raise AssertionError("the eager and lazy stage 1 were not so")
    # lazy rows are masa_tpu's packed form on disk, eager rows the area's
    # codec: the values read back must agree, not the bytes
    lazy, eager = (tree_digests(os.path.join(w, "crosspoints"))
                   for w in (work, again))
    if lazy != eager:
        raise AssertionError("the eager stage 1 wrote another crosspoint "
                             "than the lazy one")
    n_rows = same_rows(work, again)
    disk = {w: sum(size for size, _ in tree_digests(
        os.path.join(w, "special_rows")).values()) for w in (work, again)}
    if pruned_cells_of(again) != pruned:
        raise AssertionError("a repeated stage 1 pruned other cells")
    log(f"CLI 1M pair, --stage-1 lazy {secs0:.2f} s, again eager in "
        f"another work directory {secs_r:.2f} s: the same {n_rows} special "
        f"rows read back, on disk {disk[work]} bytes lazy (packed) and "
        f"{disk[again]} eager; the same crosspoint and {pruned} pruned "
        f"cells")
    second, secs1, launches1 = run_cli(argv)
    st2w = stats_of(work, 2)
    with patched(core, "_windowed_cut_ok", lambda *a, **k: False):
        host, secs_h, _ = run_cli([fa, fb, "--work-dir", again] + flags)
    st2h = stats_of(again, 2)
    log("CLI 1M pair, stage 2 of the resumed call from windows "
        + json.dumps({k: st2w[k] for k in st2})
        + ", and of the resumed call on the host "
        + json.dumps({k: st2h[k] for k in st2}))
    if st2w["window_reads"] <= 0 or st2w["dev_matches"] <= 0:
        raise AssertionError("the resumed call's stage 2 read no window")
    if st2h["dev_matches"] or st2h["window_reads"]:
        raise AssertionError("the host path matched on the card")
    shutil.rmtree(os.path.join(again, "special_rows"))
    for w in (work, again):
        if outputs_of(w) != outputs_of(single):
            raise AssertionError(f"{w} holds other crosspoints or "
                                 f"alignments than the single call")
    cps3 = CrosspointsFile(os.path.join(work, "crosspoints",
                                        "crosspoint_03.00")).load()
    if f"best score: {SCORE_1M} at" not in first:
        raise AssertionError(f"the CLI's stage 1 did not find {SCORE_1M}")
    for out, what in ((one, "single"), (second, "resumed"),
                      (host, "host-matched")):
        for want in (f"stage5: score={SCORE_1M} verified",
                     f"alignment score: {SCORE_1M}  (matches="):
            if want not in out:
                raise AssertionError(f"the CLI's {what} run lacks {want!r}")
    if "stage1: already executed (resume)" not in second:
        raise AssertionError("the resumed call ran stage 1 again")
    log(f"CLI 1M pair: --stage-1 call {secs0:.2f} s, resumed full call "
        f"{secs1:.2f} s (host-matched {secs_h:.2f} s); per stage "
        + json.dumps(stage_seconds(first + second))
        + "; the single call per stage " + json.dumps(stage_seconds(one))
        + "; the host-matched call " + json.dumps(stage_seconds(host))
        + f"; pruned_cells {pruned} ({100 * pruned / cells:.2f}% of m n); "
        f"strip launches {launches0['strip']} (--stage-1 call), batched "
        f"launches {launches1['batched_strip']} (resumed call)")
    # sparse special rows: hops taller than a cluster, three launches each
    sparse = os.path.join(tmp, "sparse")
    few, secs_s, launches_s = run_cli([fa, fb, "--work-dir", sparse,
                                       "--ram-size", "0", "--disk-size",
                                       "64M"])
    st1s, st2s = stats_of(sparse, 1), stats_of(sparse, 2)
    log(f"CLI 1M pair, sparse special rows (every "
        f"{st1s['flush_interval']} rows): {secs_s:.2f} s; stage 2 "
        + json.dumps({k: st2s[k] for k in ("chained", "segments",
                                           "issued")})
        + "; launches " + json.dumps(launches_s) + "; per stage "
        + json.dumps(stage_seconds(few)))
    if f"alignment score: {SCORE_1M}  (matches=" not in few:
        raise AssertionError("the sparse-row call did not score "
                             f"{SCORE_1M}")
    if st2s["issued"] <= 0 or launches_s["hop"] or any(
            launches_s[k] != st2s["issued"] for k in THREE):
        raise AssertionError(f"the sparse-row call's hops did not take the "
                             f"three launches each: {st2s}, {launches_s}")
    need_launches("the single CLI call", launches_1)
    if not 0 < parts_1[1] == parts_1[0]:
        raise AssertionError("the single CLI call's stage 5 gave the card "
                             "%d of %d partitions" % parts_1[::-1])
    if launches0["strip"] <= 0:
        raise AssertionError("the CLI's stage 1 launched no strip kernel")
    if launches1["batched_strip"] <= 0:
        raise AssertionError("the CLI's traceback launched no batched "
                             "strip kernel")
    return ({k: launches_1[k] + launches0[k] + launches_r[k]
             + launches1[k] + launches_s[k] for k in COUNTED}, cps3,
            stage_seconds(first + second), pruned)


def same_rows(work, other):
    """Every special row of two CLI work directories, read back through
    the port's special-rows area, equal (raises otherwise); returns the
    number of rows."""
    import numpy as np

    from masa_tpu_torch.core.sra import SpecialRowsArea

    parts = [SpecialRowsArea(os.path.join(w, "special_rows",
                                          "stage.01.00")).partitions()
             for w in (work, other)]
    if [p.rows() for p in parts[0]] != [p.rows() for p in parts[1]]:
        raise AssertionError("the two stage-1 runs kept other rows")
    n = 0
    for a, b in zip(*parts):
        for r in a.rows():
            for x, y in zip(a.get(r), b.get(r)):
                if not np.array_equal(x, y):
                    raise AssertionError(f"special row {r} reads back "
                                         f"other values")
            n += 1
    return n


def one_launch(launches, stage2, what):
    """Every hop a run's stage 2 issued went through the hop kernel, one
    launch each, and none through the three-launch route (``launches``:
    the run's, by COUNTED wrapper; ``stage2``: its statistics_02.00)."""
    if stage2["issued"] <= 0 or launches["hop"] != stage2["issued"] or any(
            launches[k] for k in THREE):
        raise AssertionError(f"{what}: the hops issued ({stage2['issued']}) "
                             f"were not one hop launch each: {launches}")


def need_launches(what, launches,
                  names=("strip", "batched_strip", "traceback")):
    for k in names:
        if launches[k] <= 0:
            raise AssertionError(f"{what} launched no {k} kernel")


def split_cli(fa, fb, tmp, score, extra, what):
    """Phases 8 and 10: the weighted column split through the CLI
    (``--split W1,..,Wn``): slab stage 1 one after another with file://
    border handoff, the slab traceback, stages 3-6.  The score line, stage
    5 verified, per-stage seconds and launches."""
    argv = [fa, fb, "--work-dir", os.path.join(tmp, "w"), *extra]
    out, secs, launches = run_cli(argv, quiet=())
    for want in (f"stage5: score={score} verified",
                 f"alignment score: {score}  (weighted column split"):
        if want not in out:
            raise AssertionError(f"{what} lacks {want!r}")
    log(f"{what}: score {score} in {secs:.2f} s; per stage "
        + json.dumps(stage_seconds(out)) + "; launches "
        + json.dumps(launches))
    need_launches(what, launches)
    return launches


def fork_cli(fa, fb, tmp):
    """Phase 9: ``--fork 2`` through the CLI on the 1M pair: two worker
    processes on the one card, the border over a localhost socket, the
    pool's score and crosspoint relay; node 0 runs stages 5 and 6.  Each
    worker's seconds per stage and launches come from its worker.KK.json
    (counted in the worker, where the kernels launch)."""
    work = os.path.join(tmp, "w")
    out, secs, _ = run_cli([fa, fb, "--work-dir", work, "--fork", "2"],
                           quiet=())
    if f"alignment score: {SCORE_1M}  (2 forked processes" not in out:
        raise AssertionError(f"--fork 2 did not score {SCORE_1M}")
    launches = {"strip": 0, "batched_strip": 0, "traceback": 0}
    for k in range(2):
        with open(os.path.join(work, "shared", f"worker.{k:02d}.json")) as fh:
            w = json.load(fh)
        log(f"  fork worker {k} on {w['device']}, columns {w['columns']}, "
            f"special rows every {w['special_every']}: seconds "
            + json.dumps({n: round(v, 3) for n, v in w["seconds"].items()})
            + "; launches " + json.dumps(w["launches"]))
        if w["launches"]["strip"] <= 0:
            raise AssertionError(f"fork worker {k} launched no strip kernel")
        for n in launches:
            launches[n] += w["launches"].get(n, 0)
    log(f"--fork 2 1M pair: score {SCORE_1M} in {secs:.2f} s; launches "
        + json.dumps(launches))
    need_launches("--fork 2", launches)
    return launches


def oversize_real2(tmp):
    """Phase 11: real2 through ``parallel.split.align_oversize`` with
    16384-column slabs (the CLI's branch for a seq1 wider than one run
    may be): score 32466, stage 6 re-scored, per-stage seconds and
    launches."""
    import masa_tpu_torch
    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.parallel import split

    g = os.path.join(REPO, "tests", "golden")
    a, b = (masa_tpu_torch.load_sequence(os.path.join(g, f"real2_{x}.fa"))
            for x in "ab")
    counters = {"strip": kernels.strip_cuda,
                "batched_strip": kernels.batched_strip_cuda,
                "traceback": kernels.traceback_cuda}
    for c in counters.values():
        c.launches = 0
    secs, kms = {}, {}

    def on_stage(name, s, _):
        secs[name] = round(s, 3)
        kms[name] = {k: round(v, 3)
                     for k, v in kernels.drain_events().items()}

    kernels.drain_events()
    best, aln = split.align_oversize(a, b, 16384, tmp, device="cuda",
                                     on_stage=on_stage)
    launches = {k: c.launches for k, c in counters.items()}
    log(f"real2 oversize ({len(a)} x {len(b)}, 16384-column slabs): best "
        f"{best}, score {aln.raw_score}; per stage " + json.dumps(secs)
        + "; kernel ms per stage " + json.dumps(kms)
        + "; launches " + json.dumps(launches))
    if best != 32466 or aln.raw_score != 32466:
        raise AssertionError("real2 through align_oversize: expected 32466")
    need_launches("align_oversize", launches, ("strip", "traceback"))
    return launches


def sharded_stage1_phase(s0, s1):
    """Phase 12: the sharded mode's stage 1 on the 1M pair at the strip
    height the sweep chose (``sharded.CUDA_ROWS``), score only, pruning
    off, over 1 and 2 slabs on the card: seconds, launches and the strip
    kernel's summed ms.  Returns the launches and, per slab count, (kernel
    ms, launches, cells a launch, bytes a launch) for the bound."""
    import torch

    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.parallel import sharded
    from masa_tpu_torch.parallel.mesh import make_mesh

    R = sharded.CUDA_ROWS
    launches, rounds, line = 0, {}, []
    for D in (1, 2):
        kernels.strip_cuda.launches = 0
        kernels.drain_events()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sharded.sharded_stage1(s0, s1, make_mesh(D))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = kernels.strip_cuda.launches
        ms = kernels.drain_events().get("strip", 0.0)
        if res.best != SCORE_1M:
            raise AssertionError(f"sharded stage 1 over {D}: best "
                                 f"{res.best}, expected {SCORE_1M}")
        if n <= 0:
            raise AssertionError(f"sharded stage 1 over {D} launched no "
                                 f"strip kernel")
        launches += n
        W = -(-len(s1) // D)
        # a strip reads its rows of a, its columns of b, the bus and the
        # border, and writes the bus, the last column and its row bests
        rounds[D] = (ms, n, R * W, R + W + 16 * W + 16 * R + 8 * R)
        line.append(f"D={D} {secs:.2f} s ({n} launches, kernel "
                    f"{ms:.1f} ms, {ms / n:.2f} ms a launch)")
    log(f"sharded stage 1, 1M pair, R={R} (the sweep's choice, "
        f"tools/sharded_tune.py): " + "; ".join(line))
    return launches, rounds


def sharded_cli(fa, fb, tmp, score, extra, what, mono_secs=None):
    """Phases 13-15: the sharded mode through the CLI (``--split N``):
    the pipeline's stage 1 on the card, the slab traceback, stages 3-6.
    The score line, stage 5 verified, per-stage seconds (beside the
    monolithic CLI run of this call), pruned strips per slab and
    launches."""
    argv = [fa, fb, "--work-dir", os.path.join(tmp, "w"), *extra]
    out, secs, launches = run_cli(argv, quiet=())
    nsh = extra[extra.index("--split") + 1]
    for want in (f"stage5: score={score} verified",
                 f"alignment score: {score}  (sharded over {nsh} devices"):
        if want not in out:
            raise AssertionError(f"{what} lacks {want!r}")
    pruned = re.search(r"pruned strips (\[[\d, ]*\])", out).group(1)
    log(f"{what}: score {score} in {secs:.2f} s; per stage "
        + json.dumps(stage_seconds(out))
        + (f" (monolithic CLI run: {json.dumps(mono_secs)})"
           if mono_secs else "")
        + f"; pruned strips per slab {pruned}; launches "
        + json.dumps(launches))
    need_launches(what, launches)
    return launches


def two_process_phase(tmp):
    """Phase 16: two processes on the card, each running
    ``python -m masa_tpu_torch.tools.multihost_worker`` over gloo on
    localhost with ``--device cuda`` on a 2^15 pair (512-row strips, one
    slab a process): the best and the final row equal one process running
    the same two slabs.  The workers count their own launches and report
    the modules they imported."""
    import socket

    import numpy as np

    from masa_tpu_torch import ScoreParams
    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.parallel.mesh import make_mesh
    from masa_tpu_torch.parallel.sharded import sharded_stage1
    from masa_tpu_torch.tools import multihost_worker

    size = 1 << 15
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sk.getsockname()[1]}"
    out = os.path.join(tmp, "mh.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "masa_tpu_torch.tools.multihost_worker",
         coord, "2", str(pid), out, str(size), "--device", "cuda"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    errs = []
    try:
        for p in procs:
            _, se = p.communicate(timeout=300)
            errs.append((p.returncode, se[-2000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.time() - t0
    if any(rc for rc, _ in errs):
        raise AssertionError(f"a multihost worker failed: {errs}")
    with open(out) as fh:
        res = json.load(fh)
    s0, s1 = multihost_worker.pair(size)
    saved = kernels.strip_cuda.launches
    one = sharded_stage1(s0, s1, make_mesh(2), wf.StripConfig(rows=512),
                         ScoreParams())
    kernels.strip_cuda.launches = saved  # the reference run is no main path
    if res["best"] != one.best or res["last_h"] != [int(x)
                                                    for x in one.last_h]:
        raise AssertionError(f"two processes: best {res['best']}, one "
                             f"process {one.best}")
    if res["foreign_modules"]:
        raise AssertionError(f"a worker imported {res['foreign_modules']}")
    if res["launches"]["strip"] <= 0:
        raise AssertionError("the workers launched no strip kernel")
    log(f"two processes x 1 slab on {res['device']} over gloo, {size} x "
        f"{size}: best {res['best']} = one process's {one.best}, final "
        f"rows equal, in {secs:.1f} s (process start included); launches "
        + json.dumps(res["launches"]))
    return {"strip": res["launches"]["strip"], "batched_strip": 0}


def handoff_phase(s0, s1, dev):
    """Phase 17: the strip kernel on a round's hand-off.  A 2-slab
    pipeline on the card runs round 0; the column slab 1 holds for round 1
    equals slab 0's last column of its strip 0, launched again alone
    (device tensors, exact).  Then the kernel against ``strip_plain`` on the
    first 8192 rows of slab 1's first strip with that border, every
    output.  Returns (max |diff|, ms, plain ms)."""
    import torch

    from masa_tpu_torch import ScoreParams
    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.parallel import sharded
    from masa_tpu_torch.parallel.mesh import make_mesh

    params = ScoreParams()
    saved = kernels.strip_cuda.launches
    pipe = sharded.ShardedPipeline(s0, s1, make_mesh(2), None, params)
    pipe.run_round(0)
    slab0, slab1 = pipe.slabs
    R, W = pipe.R, pipe.W
    kw = dict(match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext, sw=True,
              track_best=True, store_lastcol=True)
    bus_h, bus_f = wf.init_bus(0, W, params.gap_open, params.gap_ext, dev)
    zero = torch.zeros(R, dtype=torch.int32, device=dev)
    neg = torch.full((R,), NEG, dtype=torch.int32, device=dev)
    alone = wf.strip(pipe.a[slab0.dev][:R], slab0.b, bus_h, bus_f, zero,
                     neg, 0, **kw)
    got_h, got_e = slab1.col
    if not (got_h.is_cuda and torch.equal(got_h, alone.lastcol_h)
            and torch.equal(got_e, alone.lastcol_e)):
        raise AssertionError("hand-off: slab 1's border is not slab 0's "
                             "last column")
    h = 8192
    args = (pipe.a[slab1.dev][:h], slab1.b, bus_h, bus_f,
            got_h[:h].contiguous(), got_e[:h].contiguous(), 0)
    timed(wf.strip, *args, **kw)  # warm
    out_k, ms = timed(wf.strip, *args, **kw)
    out_p, plain_ms = timed(wf.strip_plain, *args, **kw)
    kernels.strip_cuda.launches = saved  # checks, no main path
    err = compare(out_k, out_p, f"hand-off {h} x {W}")
    log(f"hand-off: slab 1's round-1 border = slab 0's round-0 last column "
        f"({R} rows, exact); kernel on the first {h} rows of slab 1's "
        f"first strip ({h} x {W}) {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"max |diff| {err}")
    return err, ms, plain_ms


def module_entry():
    """Phase 6: the package's module entry as a user runs it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "masa_tpu_torch", "--test",
                        "--device", "cuda"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    for line in r.stdout.splitlines():
        log(f"  --test> {line}")
    if r.returncode != 0 or "self-test: PASS" not in r.stdout:
        raise AssertionError(f"python -m masa_tpu_torch --test exited "
                             f"{r.returncode}: {r.stderr[-2000:]}")
    log(f"module entry --test: exit 0 in {time.time() - t0:.1f} s")


SCORE_RANDOM_1M = 19  # the DP's best on bench.py's random 1M pair
PROBE_ROWS = 512  # the rows of the disk probe before the bench's child


def bench_py_keys():
    """Every key of the line the repository's ``bench.py`` prints: the
    string keys of the dictionaries inside its ``json.dumps`` call."""
    import ast

    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "dumps"):
            for d in ast.walk(node):
                if isinstance(d, ast.Dict):
                    keys |= {k.value for k in d.keys
                             if isinstance(k, ast.Constant)}
    return keys


def vm_rss_bytes():
    with open("/proc/self/status") as fh:
        return 1024 * int(re.search(r"^VmRSS:\s+(\d+) kB", fh.read(),
                                    re.M)[1])


def bench_phase(card):
    """Phase 10: ``python -m masa_tpu_torch.bench`` as a user runs it, in a
    child process at full size (``tools/bench_spread.run_child``): stage 1
    of bench.py's random 1M pair, the full run of the 1M homolog at
    JobConfig's defaults (a special row every 512 rows), twice each.
    Before it, what this process holds (host memory, the card's memory
    reserved and allocated, pinned host memory) and a probe of the
    temporary directory's files (``bench_spread.disk_probe``) are printed;
    beside it, its CPU seconds and this process's.  Its lines are echoed,
    its last line printed whole; it must carry every key of bench.py's
    line, best score 19, full score 796634 and this card.  Returns its
    launches by kernel (counted in the child, where the kernels launch)."""
    import torch

    from masa_tpu_torch.tools import bench_spread

    torch.cuda.empty_cache()  # the child's row cache takes half the free
    pinned = getattr(torch.cuda, "host_memory_stats", dict)().get(
        "reserved_bytes.current", "not read")
    probe = bench_spread.disk_probe(PROBE_ROWS)
    log(f"before the bench: this process holds {vm_rss_bytes()} bytes of "
        f"host memory ({pinned} pinned), "
        f"{torch.cuda.memory_reserved()} bytes reserved on the card "
        f"({torch.cuda.memory_allocated()} allocated); the temporary "
        f"directory's disk probe {json.dumps(probe)}")
    r = bench_spread.run_child(timeout=900)
    lines = r["lines"]
    for line in lines[:-1]:
        log(f"  bench> {line}")
    if r["rc"] != 0 or not lines:
        raise AssertionError(f"python -m masa_tpu_torch.bench exited "
                             f"{r['rc']}: {r['stderr']}")
    log(f"bench line: {lines[-1]}")
    got = bench_checked(lines[-1], torch.cuda.get_device_name(0), card)
    d = got["detail"]
    log(f"bench: exit 0 in {r['wall_s']:.1f} s, {got['value']} GCUPS "
        f"stage 1, full run {d['full_alignment_s']} s (cold "
        f"{d['full_alignment_cold_s']} s); its CPU seconds (user, system) "
        f"{json.dumps(r['child_cpu_s'])}, this process's meanwhile "
        f"{json.dumps(r['parent_cpu_s'])}, load average before "
        f"{json.dumps(r['loadavg'])}; launches " + json.dumps(d["launches"]))
    return d["launches"]


def bench_checked(line, kind, card):
    """The bench's last line as a dict, raising unless it carries every
    key of bench.py's line, names card ``kind`` and ``card`` (nvidia-smi's
    line), scores 19 on the random pair and 796634 in full over all six
    stages at 2^20 x 2^20, and launched the strip, batched and hop
    kernels, its stage 2 one hop launch a hop issued and none of the
    three-launch route's (its hops are one cluster's)."""
    got = json.loads(line)
    d = got["detail"]
    missing = bench_py_keys() - set(got) - set(d)
    if missing:
        raise AssertionError(f"the bench's line lacks {sorted(missing)}")
    want = {"best_score": SCORE_RANDOM_1M, "full_score": SCORE_1M,
            "m": M_1M, "n": M_1M, "device": kind, "card": card}
    wrong = {k: (d[k], v) for k, v in want.items() if d[k] != v}
    if wrong or set(d["full_stage_s"]) != {f"stage{k}" for k in range(1, 7)}:
        raise AssertionError(f"the bench's line is wrong: {wrong} "
                             f"{d['full_stage_s']}")
    for k in ("strip", "batched_strip", "hop"):
        if d["launches"][k] <= 0:
            raise AssertionError(f"the bench launched no {k} kernel")
    st2, at2 = d["full_stage2"], d["full_launches"]["stage2"]
    if at2["hop"] != st2["issued"] or any(at2[k] for k in THREE):
        raise AssertionError(f"the bench's hops were not one hop launch "
                             f"each: {st2}, {at2}")
    return got


def roofline_phase(dev):
    """Phase 7: the roofline tool's measurement; its filling launch (the
    k1 body on SMs x the blocks that fit an SM) against the plain version
    on the same inputs at the same iterations, both timed; and the strip
    kernel's rate on the stage-1 shape
    (one launch of 2^20 x 2^20, SW, best).  Returns the tool's launches,
    its line, the strip kernel's milliseconds on that launch, and the
    roofline kernel's (max |diff|, ms, plain ms, bound ms, bytes)."""
    import numpy as np

    from masa_tpu_torch import InitType, ScoreParams
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.tools import roofline as rl

    rl.run_cuda.launches = 0
    t0 = time.time()
    line = rl.measure()
    launches = rl.run_cuda.launches
    log(json.dumps(line))
    fill = line["filling_launch"]
    tool_s = time.time() - t0
    if launches <= 0:
        raise AssertionError("the roofline tool launched no kernel")
    # the launch the tool timed, again, against the plain version on the
    # same inputs at the same iterations (the tool seeds them the same way)
    xs = rl.full_inputs(fill["body"], fill["blocks"] * fill["threads"], dev)
    got = rl.run_cuda(fill["body"], xs, fill["iterations"], fill["threads"])
    want, plain_ms = timed(rl.run_plain, fill["body"], xs,
                           fill["iterations"], fill["threads"])
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"roofline {fill['body']} at the filling "
                             f"shape differs (max |diff| {err})")
    log(f"roofline kernel, filling launch: {fill['body']} on "
        f"{fill['blocks']} blocks x {fill['threads']} threads x "
        f"{fill['iterations']} iterations: {fill['ms']:.3f} ms (least of "
        f"{rl.REPS}, spread {100 * fill['spread']:.2f}%); plain "
        f"{plain_ms:.1f} ms at the same iterations, equal (max |diff| 0); "
        f"the tool took {tool_s:.1f} s")
    params = ScoreParams()
    args = strip_inputs(np.random.default_rng(23), M_1M, M_1M,
                        InitType.WITH_ZEROES, params, dev)
    kw = dict(match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext, sw=True,
              track_best=True)
    timed(wf.strip, *args, **kw)  # warm
    _, ms = timed_best(2, wf.strip, *args, **kw)
    gcups = M_1M * M_1M / ms / 1e6
    log(f"roofline: strip kernel {gcups:.1f} GCUPS on one launch of "
        f"{M_1M} x {M_1M} ({ms:.1f} ms) = "
        f"{100 * gcups / line['cell_floor_gcups']['tracked']:.1f}% of the "
        f"recurrence's floor ({line['cell_floor_gcups']['tracked']} GCUPS: "
        f"5 INT32-lane instructions a cell over the int32 peak), "
        f"{100 * gcups / line['k1_cell_gcups']:.1f}% of its own cell code "
        f"alone (k1, {line['k1_cell_gcups']} GCUPS); under the TPU tool's "
        f"bodies {100 * gcups / line['mix_bound_gcups']:.1f}% of mix "
        f"({line['mix_bound_gcups']}) and "
        f"{100 * gcups / line['mix_dpx_bound_gcups']:.1f}% of the DPX mix "
        f"({line['mix_dpx_bound_gcups']})")
    moved = nbytes(*xs) + 4 * xs[0].numel()
    return launches, line, ms, (err, fill["ms"], plain_ms,
                                fill["instruction_floor_ms"], moved)


def bound_of(what, ms, cells, moved, rate, old_rate, code_rate):
    """A kernel's bound from its cells and bytes: the larger of cells over
    ``rate`` (the card's int32 peak over the fewest INT32-lane instructions
    a cell needs) and bytes over the memory rate.  Logs it with two
    diagnostics beside the share: the share under ``old_rate`` (the ruler
    of earlier runs, a measured rate) and under ``code_rate`` (what the
    kernel's own cell code reaches alone).  Raises when the kernel beat
    its bound.  Returns (bound ms, "operations" or "bytes")."""
    by_ops = 1e3 * cells / rate
    by_bytes = 1e3 * moved / HBM_BYTES_PER_S
    bound = max(by_ops, by_bytes)
    by = "operations" if by_ops >= by_bytes else "bytes"
    old = max(1e3 * cells / old_rate, by_bytes)
    code = max(1e3 * cells / code_rate, by_bytes)
    log(f"bound: {what}: {bound:.4f} ms by {by} (operations {by_ops:.4f} "
        f"ms, bytes {by_bytes:.4f} ms); kernel {ms:.3f} ms = "
        f"{100 * bound / ms:.1f}% of the bound's rate [no bounds: under "
        f"the mix/DPX ruler {100 * old / ms:.1f}%, of its own cell code "
        f"alone {100 * code / ms:.1f}%]")
    if ms < bound:
        raise AssertionError(f"{what} ran in {ms:.4f} ms, under its bound "
                             f"of {bound:.4f} ms: the ruler is wrong")
    return bound, by


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "only on a machine with a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import masa_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: masa_tpu_torch not found beside chip_smoke.py "
              f"({e}); run it from the root of a checkout", file=sys.stderr)
        return 2
    # an optional argument: keep stage 4's launches for the tune tool
    save_stage4 = sys.argv[sys.argv.index("--save-stage4") + 1] \
        if "--save-stage4" in sys.argv else None
    t_start = time.time()
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    block_rows = build_kernels()
    from masa_tpu_torch.ops import kernels

    err = {"strip": kernel_matrix(dev, block_rows),
           "batched_strip": batched_matrix(dev),
           "batched_strip_fixed": fixed_matrix(dev)}
    # per kernel: (ms, plain ms, cells or operations, bytes moved) at the
    # shape timed
    times = {}
    err["roofline"] = roofline_matrix(dev)
    err_main, *times["strip"] = main_shape(dev)
    err_hop, *hop = hop_shape(dev)
    err["strip"] = max(err["strip"], err_main, err_hop)
    n_fixed, err_fixed, *times["batched_strip_fixed"] = fixed_main(dev)
    err["batched_strip_fixed"] = max(err["batched_strip_fixed"], err_fixed)
    err_three, err["hop"], hop_times, hop_shapes = hop_phase(dev)
    err_tall, hop_5m, tall = big_hop_phase(dev)
    hop_shapes[f"{hop_5m['shape']['hb']}x{hop_5m['shape']['W']}"] = hop_5m
    err["hop_prep"] = err["hop_match"] = max(err_three, err_tall)
    err["strip"] = max(err["strip"], err_tall, big_launch_phase(dev)[0])
    times.update(hop_times)
    err["traceback"], times["traceback"] = traceback_phase(dev)
    kernels.event_log = []  # time every launch of the main-path runs
    golden_pairs()
    from masa_tpu_torch.tools.pairs import bench_pair

    s0, s1 = bench_pair()
    log(f"1M pair: {len(s0)} x {len(s1)}")
    err_sb, _, _ = streamed_border(s0, s1, dev)
    err["strip"] = max(err["strip"], err_sb, prune_matrix(s0, s1, dev),
                       prune_waves(dev))
    full_run(s0, s1)
    march_paths(s0, s1)
    g = os.path.join(REPO, "tests", "golden")
    with tempfile.TemporaryDirectory() as tmp:
        fa, fb = os.path.join(tmp, "a.fa"), os.path.join(tmp, "b.fa")
        write_fasta(fa, "bench s0", s0)
        write_fasta(fb, "bench s1", s1)
        launches, cps3, mono_secs, _ = cli_run(
            fa, fb, os.path.join(tmp, "cli"), len(s0) * len(s1))
        err_lvl, levels = stage4_levels(s0, s1, cps3, dev, save_stage4)
        err["batched_strip"] = max(err["batched_strip"], err_lvl)
        more = [
            split_cli(fa, fb, os.path.join(tmp, "split"), SCORE_1M,
                      ["--split", "1,1", "--ram-size", "0", "--disk-size",
                       "1G"], "--split 1,1 1M pair"),
            fork_cli(fa, fb, os.path.join(tmp, "fork")),
            split_cli(os.path.join(g, "real2_a.fa"),
                      os.path.join(g, "real2_b.fa"), os.path.join(tmp, "r2"),
                      32466, ["--split", "1,2,1", "--traceback",
                              "speculative"],
                      "real2 --split 1,2,1 --traceback speculative"),
            oversize_real2(tmp),
        ]
        # the sharded mode (--split N): its stage 1 at the chosen R, the
        # CLI over 1, 2 and 3 slabs, two processes, a round's hand-off
        n_sh, sh_rounds = sharded_stage1_phase(s0, s1)
        more += [
            {"strip": n_sh, "batched_strip": 0},
            sharded_cli(fa, fb, os.path.join(tmp, "sh1"), SCORE_1M,
                        ["--split", "1"], "--split 1 1M pair", mono_secs),
            sharded_cli(fa, fb, os.path.join(tmp, "sh2"), SCORE_1M,
                        ["--split", "2"], "--split 2 1M pair", mono_secs),
            sharded_cli(os.path.join(g, "real2_a.fa"),
                        os.path.join(g, "real2_b.fa"),
                        os.path.join(tmp, "sh3"), 32466,
                        ["--split", "3", "--traceback", "speculative"],
                        "real2 --split 3 --traceback speculative"),
            two_process_phase(tmp),
        ]
        err_ho, _, _ = handoff_phase(s0, s1, dev)
        err["strip"] = max(err["strip"], err_ho)
    for m in more:
        for k in launches:
            launches[k] += m.get(k, 0)
    kernels.event_log = None
    module_entry()
    for k, v in bench_phase(card).items():
        launches[k] += v
    big_launches, cps3 = big_run_phase("5M")
    for k, v in big_launches.items():
        launches[k] += v
    err["batched_strip"] = max(err["batched_strip"],
                               big_stage4_level(dev, cps3)[0])
    for k, v in fuzz_phase().items():
        launches[k] += v
    launches["batched_strip_fixed"] = n_fixed
    launches["roofline"], roof, stage1_ms, (err_fill, *filling) = \
        roofline_phase(dev)
    err["roofline"] = max(err["roofline"], err_fill)
    pruned1 = prune_stage1(s0, s1, dev)
    # the bounds: cells over (the int32 peak at the clock read in this run
    # / the fewest INT32-lane instructions a cell needs: 5 where the best is
    # tracked, 4 where not), or bytes over the memory rate, whichever is
    # larger; beside each, as diagnostics, the share under the ruler of
    # earlier runs (the better of the mix and DPX rates) and of the rate
    # the kernel's own cell code reaches alone (k1 tracked, k1n not)
    rate = {k: 1e9 * v for k, v in roof["cell_floor_gcups"].items()}
    code_rate = {"tracked": 1e9 * roof["k1_cell_gcups"],
                 "untracked": 1e9 * roof["k1n_cell_gcups"]}
    old_rate = 1e9 * max(roof["mix_bound_gcups"],
                         roof["mix_dpx_bound_gcups"])
    # the batched kernel over every launch of stage 4: each launch against
    # its own bound, the kernels line takes the sums
    for lv in levels:
        lv["bound_ms"], lv["bound_by"] = bound_of(
            f"batched_strip at stage-4 level {lv['level']} {lv['way']}",
            lv["ms"], lv["cells"], lv["bytes"], rate["untracked"], old_rate,
            code_rate["untracked"])
    if len(levels) != launches["batched_strip"] - sum(
            m["batched_strip"] for m in more):
        log(f"note: stage 4 was rebuilt as {len(levels)} launches")
    gap = sum(lv["ms"] - lv["bound_ms"] for lv in levels)
    log(f"batched_strip over the {len(levels)} launches of the CLI run's "
        f"stage 4: kernel {sum(lv['ms'] for lv in levels):.3f} ms, bound "
        f"{sum(lv['bound_ms'] for lv in levels):.3f} ms, launches x (time "
        f"- bound) {gap:.3f} ms, plain "
        f"{sum(lv['plain_ms'] for lv in levels):.1f} ms")
    kernel_rows = []
    for name, (src, tpu) in KERNELS.items():
        if name == "batched_strip":
            ms, plain_ms, cells, moved = (sum(lv[k] for lv in levels)
                                          for k in ("ms", "plain_ms",
                                                    "cells", "bytes"))
            bound, by = bound_of(f"{name}, the {len(levels)} launches",
                                 ms, cells, moved, rate["untracked"],
                                 old_rate, code_rate["untracked"])
        elif name == "roofline":
            # the function it computes is its body's instructions: those
            # of its filling launch, counted in the SASS, over the INT32
            # lanes at the clock read
            ms, plain_ms, by_ops, moved = filling
            fill = roof["filling_launch"]
            cells = (fill["blocks"] * fill["threads"] * fill["iterations"]
                     * roof["mix_alpha"])
            bound, by = bound_of(
                f"{name}, the filling launch of {fill['body']}", ms, cells,
                moved, 1e3 * cells / by_ops, old_rate, code_rate["tracked"])
        elif name == "hop":
            # the NW cells to the first stop (k = hb, as a near-diagonal
            # path crosses) and the bytes: a, the window, the cut to the
            # stop, the state
            ms, plain_ms, cells, moved = times[name]
            bound, by = bound_of(f"{name} at the CLI's hop of the 1M pair, "
                                 f"its first stop at k = hb", ms, cells,
                                 moved, rate["untracked"], old_rate,
                                 code_rate["untracked"])
        elif name == "traceback":
            # seven INT32-lane instructions a cell, not four
            ms, plain_ms, cells, moved = times[name]
            bound, by = bound_of(f"{name} at a wave of the 1M self-pair's "
                                 f"stage 5 (a partition an SM)",
                                 ms, cells, moved, rate["untracked"] * 4 / 7,
                                 old_rate, code_rate["untracked"])
        elif name in THREE:
            # bytes alone: a few a column, so the bound is the bytes over
            # the memory rate, and a launch's latency sets the time
            ms, plain_ms, moved = times[name]
            bound, by = bound_of(f"{name} at a stage-2 hop of the 1M pair",
                                 ms, 0, moved, rate["untracked"], old_rate,
                                 code_rate["untracked"])
        else:
            # the strip kernel's timed shape tracks the best; the
            # equal-shape batched kernel tracks nothing
            ms, plain_ms, cells, moved = times[name]
            kind = "tracked" if name == "strip" else "untracked"
            bound, by = bound_of(f"{name} at the shape timed", ms, cells,
                                 moved, rate[kind], old_rate, code_rate[kind])
        kernel_rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None})
    for what, ms, cells, kind in (
            ("stage-2 hop 8192 x 16384, best tracked", hop[0], hop[2],
             "tracked"),
            ("stage-2 hop 8192 x 16384, nothing tracked", hop[4], hop[2],
             "untracked"),
            (f"stage-1 launch {M_1M} x {M_1M}, best tracked", stage1_ms,
             M_1M * M_1M, "tracked")):
        bound_of(f"strip at the {what}", ms, cells, 0, rate[kind], old_rate,
                 code_rate[kind])
    # the pruned stage-1 launch against the bound of the cells it computed
    pruned1["bound_ms"], pruned1["bound_by"] = bound_of(
        f"strip, the stage-1 launch pruned inside ({pruned1['cells']} cells "
        f"computed)", min(pruned1["pruned_ms"]), pruned1["cells"],
        pruned1["bytes"], rate["tracked"], old_rate, code_rate["tracked"])
    # the strip kernel a round of the sharded pipeline, against its bound
    for D, (ms, n, cells, moved) in sh_rounds.items():
        bound_of(f"strip, a sharded round over {D} slab(s) "
                 f"({cells} cells a launch, mean of {n})", ms / n, cells,
                 moved, rate["tracked"], old_rate, code_rate["tracked"])
    # the hop kernel at each main-path hop, to its stop and swept to the
    # end, against the bound of the cells each needs; beside it the latency
    # floor (no bound): the sweep's steps, (the columns + hb / alpha), times
    # 2 alpha dependent operations a step at the card's dependent latency
    hop_row = kernel_rows[list(KERNELS).index("hop")]
    hop_row["shapes"] = {}
    for shape, t in hop_shapes.items():
        alpha, hb, W = t["geometry"][0], t["shape"]["hb"], t["shape"]["W"]
        for form, cols in (("hop", hb), ("hop_full", W)):
            bound, by = bound_of(f"hop at {shape} ({form})", t["ms"][form],
                                 t["cells"][form], t["bytes"][form],
                                 rate["untracked"], old_rate,
                                 code_rate["untracked"])
            floor = (cols + hb / alpha) * 2 * alpha * roof["ser_latency_ns"]
            hop_row["shapes"][f"{shape}, {form}"] = {
                "ms": t["ms"][form], "bound_ms": bound, "bound_by": by,
                "latency_floor_ms": floor / 1e6,
                "three_launches_ms": t["ms"]["three"],
                "in_path_ms": t["in_path"], "issue_ms": t["issue_ms"]}
            log(f"hop at {shape} ({form}): latency floor {floor / 1e6:.4f} "
                f"ms (no bound: {cols} + {hb} / {alpha} steps x {2 * alpha} "
                f"dependent operations x {roof['ser_latency_ns']} ns); the "
                f"three launches {t['ms']['three']:.4f} ms")
    # the 23M run's hop, three launches past 2^31 cells, against the bound
    # of its cells (NW, nothing tracked) and bytes
    tall["bound_ms"], tall["bound_by"] = bound_of(
        f"hop_three at the 23M run's hop {tall['shape']['hb']} x "
        f"{tall['shape']['W']}", tall["ms"], tall["cells"], tall["bytes"],
        rate["untracked"], old_rate, code_rate["untracked"])
    for name in ("strip",) + THREE:
        kernel_rows[list(KERNELS).index(name)]["tall_hop"] = tall
    kernel_rows[1]["stage4_launches"] = levels
    kernel_rows[0]["pruned_stage1"] = pruned1
    kernel_rows[0]["shapes"] = {
        "8192x1048576": times["strip"][0], "8192x16384": hop[0],
        "8192x16384, nothing tracked": hop[4], f"{M_1M}x{M_1M}": stage1_ms,
        **{f"sharded round, {D} slab(s), {cells} cells": ms / n
           for D, (ms, n, cells, _) in sh_rounds.items()}}
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "masa_tpu"))
    if foreign:
        raise AssertionError(f"imported besides the port: {foreign[:8]}")
    for mod in ("masa_tpu_torch.parallel.sharded",
                "masa_tpu_torch.parallel.mesh"):
        if mod not in sys.modules:
            raise AssertionError(f"the sharded phases did not import {mod}")
    log(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s, "
        f"builds included; no module of jax or masa_tpu was imported")
    log(json.dumps({"kernels": kernel_rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
