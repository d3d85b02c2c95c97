"""masa_tpu_torch command-line interface: masa_tpu's CLI (the
libmasa_entry_point equivalent, libmasa.cpp:762) on the port's stages.

Usage:  python -m masa_tpu_torch [options] seq0.fasta seq1.fasta

The options, the work directory and the printed lines are masa_tpu's.
PyTorch has no platform switch in its environment, so the device is an
option: ``--device cuda`` (the default; raises when no GPU is present) or
``--device cpu``.  The multi-device modes run on it: weighted slabs
(``--split W1,..,Wn``), one worker process per slab (``--fork``), the
split of inputs wider than one run may be, and the sharded mode
(``--split N``: stage 1 as a diagonal pipeline over N column slabs, one
a card, several processes joined by ``--coordinator``, ``--num-hosts``
and ``--host-id`` over torch.distributed).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from masa_tpu_torch.core.capabilities import AlignerCapabilities
from masa_tpu_torch.types import AlignmentStart, ScoreParams

HEADER = "masa_tpu_torch: long-sequence alignment engine on PyTorch/CUDA"

_STARTS = {
    "*": AlignmentStart.ANYWHERE,
    "1": AlignmentStart.SEQUENCE_1,
    "2": AlignmentStart.SEQUENCE_2,
    "+": AlignmentStart.SEQUENCE_1_OR_2,
    "!": AlignmentStart.SEQUENCE_1_AND_2,
}


def _size(s: str) -> int:
    mult = 1
    s = s.strip().upper()
    for suffix, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30),
                      ("T", 1 << 40)):
        if s.endswith(suffix):
            mult, s = m, s[:-1]
            break
    return int(float(s) * mult)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="masa_tpu_torch", description=HEADER,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("fasta", nargs=2, help="the two FASTA files")
    # general
    p.add_argument("--work-dir", default="work.tmp")
    p.add_argument("--clear", action="store_true",
                   help="wipe the work directory before starting")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (a GPU; an error without one) or cpu")
    # input modifiers
    p.add_argument("--trim", default=None,
                   help="i0,i1,j0,j1 (1-based inclusive; 0 = no trim)")
    p.add_argument("--clear-n", action="store_true")
    p.add_argument("--reverse", default=None, choices=["1", "2", "both"])
    p.add_argument("--complement", default=None,
                   choices=["1", "2", "both"])
    p.add_argument("--reverse-complement", default=None,
                   choices=["1", "2", "both"])
    # alignment mode
    p.add_argument("--alignment-end", default=None,
                   choices=["*", "+", "1", "2", "!"],
                   help="where the alignment may end (default mirrors "
                        "--alignment-start)")
    p.add_argument("--alignment-start", default="*",
                   choices=list(_STARTS),
                   help="* local; ! global; +/1/2 semi-global")
    # scores
    p.add_argument("--match", type=int, default=1)
    p.add_argument("--mismatch", type=int, default=-3)
    p.add_argument("--gap-open", type=int, default=3)
    p.add_argument("--gap-ext", type=int, default=2)
    # execution
    p.add_argument("--stage-1", action="store_true",
                   help="run only stage 1 (score + endpoint)")
    p.add_argument("--no-flush", action="store_true",
                   help="do not save special rows (disables traceback)")
    p.add_argument("--ram-size", type=_size, default=1 << 30)
    p.add_argument("--disk-size", type=_size, default=16 << 30)
    p.add_argument("--no-block-pruning", action="store_true")
    p.add_argument("--dump-blocks", action="store_true",
                   help="dump per-block score maxima for the SVG "
                        "pruning plot")
    p.add_argument("--sra-compression", default="none",
                   choices=["none", "8bit", "4bit", "vlc"],
                   help="special-rows checkpoint compression")
    p.add_argument("--max-alignments", type=int, default=1)
    p.add_argument("--maximum-partition", type=int, default=16)
    p.add_argument("--stage-4-strategy", default="OPTIMIZED",
                   choices=["ORIGINAL_MM", "ORTHOGONAL", "OPTIMIZED"])
    p.add_argument("--output-format", default="text",
                   choices=["text", "svg", "histogram", "binary"],
                   help="stage-6 renderer (binary = CGFF only, which "
                        "stage 5 always writes)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "numpy", "kernel"],
                   help="numpy: the host oracle for every pass; kernel: "
                        "the strip engine for every pass; auto: the strip "
                        "engine on a GPU, masa_tpu's size gates on the "
                        "CPU")
    # multi-device
    p.add_argument("--split", default="0",
                   help="N: stage 1 sharded over N column slabs in a "
                        "diagonal pipeline (one a card; on the CPU, or "
                        "more slabs than cards, they share a device); "
                        "W1,..,Wn: stage 1 over weighted column slabs, "
                        "one after another on --device")
    p.add_argument("--fork", default=None,
                   help="N or W1,..,Wn: one worker process per weighted "
                        "column slab, wired by localhost sockets and the "
                        "shared-dir pool (fork_multi_process, "
                        "libmasa.cpp:540-642)")
    p.add_argument("--traceback", default="pipelined",
                   choices=["pipelined", "speculative"],
                   help="stage-2 strategy of --split/--fork: pipelined "
                        "right-to-left slab marching or speculative "
                        "per-slab prediction (libmasa.cpp:698-757)")
    # multi-process: join the torch.distributed group (gloo) before
    # building the mesh; the slabs split over the processes in order
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 for multi-process sharded "
                        "runs (--split N)")
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--test", action="store_true",
                   help="run a built-in self-check (pipeline vs oracle on "
                        "a random pair) on --device and exit")
    p.add_argument("--list-devices", action="store_true",
                   help="list devices and exit")
    p.add_argument("--config", default=None,
                   help="INI config file ([global]/[stageN])")
    return p


def _apply_modifiers(args, which: str, idx: int) -> dict:
    out = {}
    for flag, fields in (("reverse", ("reverse",)),
                         ("complement", ("complement",)),
                         ("reverse_complement", ("reverse", "complement"))):
        v = getattr(args, flag)
        if v in (which, "both"):
            for f in fields:
                out[f] = True
    if args.clear_n:
        out["clear_n"] = True
    return out


def _early_device(argv) -> str:
    """--device of a command line that has no FASTA files (--test)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    return p.parse_known_args(argv)[0].device


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if "--test" in argv:
        return _self_test(_early_device(argv))
    if "--list-devices" in argv:
        from masa_tpu_torch.utils.devices import format_device_list

        print(format_device_list())
        return 0
    parser = build_parser()
    args = parser.parse_args(argv)
    # --split N shards over N devices; --split W1,..,Wn gives weighted
    # column slabs (the reference's fork-weight syntax, libmasa.cpp:497)
    try:
        split_weights = [float(x) for x in str(args.split).split(",")]
    except ValueError:
        parser.error(f"--split: expected N or W1,..,Wn, got {args.split!r}")
    fork_weights = None
    if args.fork:
        try:
            fork_weights = [float(x) for x in str(args.fork).split(",")]
        except ValueError:
            parser.error(f"--fork: expected N or W1,..,Wn, "
                         f"got {args.fork!r}")
        if len(fork_weights) == 1:
            fork_weights = [1.0] * int(fork_weights[0])
    # --split N shards over N slabs (masa_tpu: int(N), so --split 0.5 is off)
    n_sharded = 0 if fork_weights or len(split_weights) > 1 \
        else int(split_weights[0])
    print(HEADER)

    from masa_tpu_torch.biology.sequence import Sequence, SequenceModifiers
    from masa_tpu_torch.core.job import Job, JobConfig
    from masa_tpu_torch.stages import runner

    params = ScoreParams(args.match, args.mismatch, args.gap_open,
                         args.gap_ext)
    seqs = []
    for k, path in enumerate(args.fasta):
        mods = SequenceModifiers(**_apply_modifiers(args, str(k + 1), k))
        seqs.append(Sequence.from_file(path, mods))
    if args.trim:
        t = [int(x) for x in args.trim.split(",")]
        if t[0] or t[1]:
            seqs[0] = seqs[0].trimmed_view(t[0] or 1, t[1] or len(seqs[0]))
        if len(t) >= 4 and (t[2] or t[3]):
            seqs[1] = seqs[1].trimmed_view(t[2] or 1, t[3] or len(seqs[1]))

    seq0 = seqs[0].data()
    seq1 = seqs[1].data()
    print(f"seq0: {seqs[0].info.description} ({len(seq0)} bp)")
    print(f"seq1: {seqs[1].info.description} ({len(seq1)} bp)")

    jcfg = JobConfig(
        work_dir=args.work_dir,
        ram_limit=args.ram_size,
        disk_limit=args.disk_size,
        alignment_start=_STARTS[args.alignment_start],
        alignment_end=(_STARTS[args.alignment_end]
                       if args.alignment_end else None),
        params=params,
        max_alignments=args.max_alignments,
        clear=args.clear,
        stage4_max_partition=args.maximum_partition,
        stage4_strategy=args.stage_4_strategy.upper(),
        backend=args.backend,
        block_pruning=not args.no_block_pruning,
        sra_compression=args.sra_compression,
        dump_blocks=args.dump_blocks,
    )
    if args.config:
        # the INI file overrides execution resources and strategy
        from masa_tpu_torch.utils.config import (
            apply_to_job_config,
            load_config,
        )

        apply_to_job_config(load_config(args.config), jcfg)
    job = Job(jcfg, seqs[0].info.hash or str(len(seq0)),
              seqs[1].info.hash or str(len(seq1)), device=args.device)

    log = print if args.verbose else (lambda *a, **k: None)
    fmt = args.output_format if args.output_format != "binary" else "text"
    local = args.alignment_start == "*" and args.alignment_end is None
    caps = AlignerCapabilities()
    column_split = (fork_weights or len(split_weights) > 1 or (
        not n_sharded and len(seq1) > caps.maximum_seq1_len))
    if n_sharded and not local:
        parser.error("--split only supports local alignment "
                     "(--alignment-start '*' and no --alignment-end)")
    if column_split and not local:
        parser.error("--fork, weighted --split and inputs wider than "
                     f"{caps.maximum_seq1_len} bp (the column split) only "
                     "support local alignment (--alignment-start '*' and "
                     "no --alignment-end)")
    if (fork_weights or len(split_weights) > 1) and args.backend == "numpy":
        print("warning: --backend numpy has no streamed-border path; "
              "--fork and weighted --split run the strip engine",
              file=sys.stderr)
    if fork_weights:
        return _fork(args, job, seq0, seq1, fork_weights, fmt)
    if len(split_weights) > 1:
        return _weighted_split(args, job, seq0, seq1, split_weights, fmt,
                               log)
    if n_sharded:
        return _sharded(args, job, seq0, seq1, n_sharded, fmt, log)
    if len(seq1) > caps.maximum_seq1_len:
        from masa_tpu_torch.parallel.split import align_oversize

        # chained column slabs with file:// border handoff
        # (sw_stage1.cpp:362-375 ni x nj splitting)
        log(f"seq1 exceeds per-run capability "
            f"({caps.maximum_seq1_len} bp): splitting columns")
        _, aln = align_oversize(
            seq0, seq1, caps.maximum_seq1_len, jcfg.work_dir, params,
            backend="kernel" if args.backend == "auto" else args.backend,
            max_cells_stage5=jcfg.stage5_max_cells, device=job.device,
            limit=jcfg.ram_limit)
        runner.finish_alignment(job, seq0, seq1, aln, fmt=fmt, log=log)
        print(f"alignment score: {aln.raw_score}  "
              f"(matches={aln.matches} mismatches={aln.mismatches} "
              f"gaps={aln.gap_opens}/{aln.gap_extensions})")
        return 0

    best = runner.stage1(job, seq0, seq1, log=log)
    if args.stage_1 or args.no_flush:
        b = best.best
        print(f"best score: {b.score} at ({b.i},{b.j})")
        return 0

    aln = runner.execute_traceback(job, seq0, seq1, seqs, fmt=fmt, log=log)
    print(f"alignment score: {aln.raw_score}  "
          f"(matches={aln.matches} mismatches={aln.mismatches} "
          f"gaps={aln.gap_opens}/{aln.gap_extensions})")
    return 0


def _fork(args, job, seq0, seq1, weights, fmt) -> int:
    """--fork: one worker process per weighted slab on job.device."""
    from masa_tpu_torch.parallel.fork import run_fork

    res = run_fork(seq0, seq1, weights, job.cfg.work_dir, job.cfg.params,
                   max_partition=args.maximum_partition, device=job.device,
                   traceback=args.traceback, output_format=fmt,
                   ram_limit=job.cfg.ram_limit,
                   max_cells_stage5=job.cfg.stage5_max_cells)
    print(f"alignment score: {res['score']}  "
          f"({len(weights)} forked processes; matches={res['matches']} "
          f"mismatches={res['mismatches']} "
          f"gaps={res['gap_opens']}/{res['gap_extensions']})")
    return 0


def _weighted_split(args, job, seq0, seq1, weights, fmt, log) -> int:
    """--split W1,..,Wn: the weighted slabs one after another on
    job.device with file:// border handoff, then the split traceback
    (--traceback) and stages 3-6 with the work directory's artifacts."""
    import time

    import torch

    from masa_tpu_torch.ops import myers_miller as mm
    from masa_tpu_torch.parallel import split
    from masa_tpu_torch.stages import core, pipeline, runner

    params, dev = job.cfg.params, job.device
    m, n = len(seq0), len(seq1)
    points = split.split_points(n, weights)
    urls = split.auto_urls(job.cfg.work_dir, len(weights))
    score_only = args.stage_1 or args.no_flush
    iv = 0 if score_only else job.calculate_flush_intervals(
        m, n, align_to=pipeline.FLUSH_GRAIN)[0]
    widths = [b - a for a, b in zip(points, points[1:])]
    secs = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        secs[name] = now - t
        t = now
        return secs[name]

    parts = [split.run_part_stage1(
        seq0, seq1, k, points, params, core.default_config(dev),
        load_url=urls[k - 1] if k > 0 else None,
        flush_url=urls[k] if k < len(weights) - 1 else None,
        buffered=False, special_every=iv, device=dev,
    ) for k in range(len(weights))]
    b = max(p.best for p in parts)
    if score_only:
        print(f"stage1 (weighted column split {widths}): best={b}")
        return 0
    log(f"stage1: weighted column split {widths}, special rows every {iv}: "
        f"best={b} in {lap('stage1'):.2f}s")
    # the strip engine for every pass, as masa_tpu's kernel backends
    if args.traceback == "speculative":
        cps, reused = split.speculative_traceback(
            seq0, seq1, parts, params, backend="kernel", device=dev)
    else:
        cps, reused = split.pipelined_traceback(
            seq0, seq1, parts, params, backend="kernel", device=dev), 0
    log(f"stage2: {len(cps)} crosspoints ({args.traceback}, {reused} "
        f"reused) in {lap('stage2'):.2f}s")
    pcfg = pipeline.PipelineConfig(
        params=params, max_cells_stage5=job.cfg.stage5_max_cells,
        device=dev)
    cps = pipeline.stage3_densify(
        seq0, seq1, pcfg, cps,
        max_cells=split.densify_limit(args.maximum_partition, dev))
    log(f"stage3: {len(cps)} crosspoints in {lap('stage3'):.2f}s")
    if args.maximum_partition:
        cps = mm.stage4_reduce(seq0, seq1, cps, params,
                               args.maximum_partition,
                               stage5_max_cells=job.cfg.stage5_max_cells,
                               device=dev)
    log(f"stage4: {len(cps)} crosspoints in {lap('stage4'):.2f}s")
    aln = pipeline.stage5_emit(seq0, seq1, pcfg, cps)
    log(f"stage5: score={aln.raw_score} verified in {lap('stage5'):.2f}s")
    runner.finish_alignment(job, seq0, seq1, aln, cps=cps, fmt=fmt,
                            log=log, elapsed=secs)
    print(f"alignment score: {aln.raw_score}  "
          f"(weighted column split {widths}; "
          f"matches={aln.matches} mismatches={aln.mismatches} "
          f"gaps={aln.gap_opens}/{aln.gap_extensions})")
    return 0


def _sharded(args, job, seq0, seq1, nsh, fmt, log) -> int:
    """--split N: join the process group (--coordinator, --num-hosts,
    --host-id), shard stage 1 over an N-slab mesh on job.device, then the
    slab traceback (--traceback) and stages 3-6 with the work directory's
    artifacts (masa_tpu/cli.py's sharded branch)."""
    from masa_tpu_torch.parallel import sharded
    from masa_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from masa_tpu_torch.stages import runner

    initialize_distributed(args.coordinator, args.num_hosts, args.host_id)
    mesh = make_mesh(nsh, device=job.device)
    params, prune = job.cfg.params, not args.no_block_pruning
    if args.stage_1 or args.no_flush:
        res = sharded.sharded_stage1(seq0, seq1, mesh, params=params,
                                     prune=prune)
        print(f"stage1 (sharded over {nsh} devices): best={res.best}")
        return 0
    secs = {}
    rows = sharded.default_config(mesh.devices[0]).rows

    def on_stage(name, seconds, out):
        secs[name] = seconds
        if name == "stage1":
            log(f"stage1: sharded over {nsh} devices, {rows}-row strips: "
                f"best={out.best}, pruned strips "
                f"{[int(x) for x in out.pruned_strips]} in {seconds:.2f}s")
        elif name == "stage2":
            log(f"stage2: {len(out)} crosspoints ({args.traceback}) in "
                f"{seconds:.2f}s")
        elif name in ("stage3", "stage4"):
            log(f"{name}: {len(out)} crosspoints in {seconds:.2f}s")
        elif name == "stage5":
            log(f"stage5: score={out.raw_score} verified in {seconds:.2f}s")

    _, aln = sharded.sharded_align(
        seq0, seq1, mesh, params=params, prune=prune,
        traceback=args.traceback, max_cells_stage5=job.cfg.stage5_max_cells,
        state_dir=job.path("sharded"), max_partition=args.maximum_partition,
        on_stage=on_stage)
    runner.finish_alignment(job, seq0, seq1, aln, fmt=fmt, log=log,
                            elapsed=secs)
    print(f"alignment score: {aln.raw_score}  "
          f"(sharded over {nsh} devices; matches={aln.matches} "
          f"mismatches={aln.mismatches} "
          f"gaps={aln.gap_opens}/{aln.gap_extensions})")
    return 0


def _self_test(device: str) -> int:
    """The built-in self-check (--test): align a random homologous pair
    end to end in memory on ``device`` and cross-check the score against
    the oracle (masa_tpu's --test, on the port's pipeline)."""
    from masa_tpu_torch.ops import oracle
    from masa_tpu_torch.ops import myers_miller as mm
    from masa_tpu_torch.stages import pipeline, stage6
    from masa_tpu_torch.utils.devices import resolve_device

    rng = np.random.default_rng(12345)
    bases = np.frombuffer(b"ACGT", np.uint8)
    m = 2000
    s0 = rng.choice(bases, m).astype(np.uint8)
    s1 = s0.copy()
    idx = rng.random(m) < 0.08
    s1[idx] = rng.choice(bases, int(idx.sum())).astype(np.uint8)
    s1 = np.delete(s1, np.arange(900, 930))
    params = ScoreParams()
    ref = oracle.dp_rows(s0, s1, params)
    pcfg = pipeline.PipelineConfig(params=params, max_cells_stage5=1 << 14,
                                   device=str(resolve_device(device)))
    res, endpoint = pipeline.stage1_pass(s0, s1, pcfg)
    ok = endpoint.score == ref.best
    print(f"stage1 best: {endpoint.score} (oracle {ref.best})"
          f" {'OK' if ok else 'FAIL'}")
    cps = pipeline.stage2_march(s0, s1, pcfg, endpoint, res.specials,
                                res.dev_cache)
    cps = pipeline.stage3_densify(s0, s1, pcfg, cps)
    cps = mm.stage4_reduce(s0, s1, cps, params, 16,
                           stage5_max_cells=pcfg.max_cells_stage5,
                           device=pcfg.device)
    aln = pipeline.stage5_emit(s0, s1, pcfg, cps)
    stage6.recheck(aln, s0, s1, params)
    ok2 = aln.raw_score == ref.best
    print(f"traceback score: {aln.raw_score} "
          f"(matches={aln.matches} mismatches={aln.mismatches} "
          f"gaps={aln.gap_opens}/{aln.gap_extensions})"
          f" {'OK' if ok2 else 'FAIL'}")
    print("self-test:", "PASS" if ok and ok2 else "FAIL")
    return 0 if ok and ok2 else 1


if __name__ == "__main__":
    sys.exit(main())
