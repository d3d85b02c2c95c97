"""Where the host time of stages 1 and 2 goes on the 1M pair.

    python -m masa_tpu_torch.tools.stage_profile [--top 18] [--rows N]
                                                 [--device cuda]

Runs six parts under cProfile, each timed on the host clock up to a
device sync: align_pair's stage 1 (``pipeline.stage1_pass``: lazy rows and
the row cache) and its stage 2 from the cache (``pipeline.stage2_march``),
then the CLI in-process with every special row on disk: ``--stage-1`` (the
rows written as their copies land) and the call resuming it (stage 2 from
cut windows read off the disk rows); then ``runner.stage1`` and
``runner.stage2`` of one ``Job`` at ``JobConfig``'s defaults, the path of
the CLI with no resource flags and of ``python -m masa_tpu_torch.bench``'s
full run (a special row every 512 rows of the 1M pair, 1 GiB of them in
RAM, the rest on disk, all kept on the device for stage 2).  The pair is
``tools/pairs``' 1M
pair (its first N bases of each sequence with ``--rows``); the kernels
are built before the first part.  Prints each part's seconds and the
functions with the most own time, then one JSON line of the seconds,
stage 2's counts and the card's name and power limit.  ``--device cpu``
runs the plain strips (a rehearsal at a small size).
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import tempfile
import time


def profiled(name: str, top: int, sync, fn, *args):
    """fn(*args) under cProfile: prints its seconds and top functions by
    own time; returns (result, seconds)."""
    prof = cProfile.Profile()
    sync()
    t0 = time.perf_counter()
    prof.enable()
    out = fn(*args)
    sync()
    prof.disable()
    secs = time.perf_counter() - t0
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(top)
    print(f"==== {name}: {secs:.3f} s (profiled)")
    print("\n".join(line for line in buf.getvalue().splitlines()[6:]
                    if line.strip()), flush=True)
    return out, secs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--top", type=int, default=18)
    p.add_argument("--rows", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from masa_tpu_torch import cli
    from masa_tpu_torch.core.job import Job, JobConfig
    from masa_tpu_torch.stages import core, pipeline, runner
    from masa_tpu_torch.tools.pairs import bench_pair

    cuda = args.device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    s0, s1 = bench_pair()
    if args.rows:
        s0, s1 = s0[:args.rows], s1[:args.rows]
    pcfg = pipeline.PipelineConfig(device=args.device)
    pipeline.stage1_pass(s0[:4096], s1[:4096], pcfg)  # builds the kernels
    secs = {}
    (res, endpoint), secs["align_pair stage 1"] = profiled(
        "align_pair stage 1 (lazy rows, the row cache)", args.top, sync,
        pipeline.stage1_pass, s0, s1, pcfg)
    stats = core.MarchStats()
    _, secs["align_pair stage 2"] = profiled(
        "align_pair stage 2 from the row cache", args.top, sync,
        pipeline.stage2_march, s0, s1, pcfg, endpoint, res.specials,
        res.dev_cache, stats)
    res = None
    with tempfile.TemporaryDirectory() as tmp:
        fa, fb = os.path.join(tmp, "a.fa"), os.path.join(tmp, "b.fa")
        for path, seq in ((fa, s0), (fb, s1)):
            with open(path, "wb") as fh:
                fh.write(b">pair\n" + seq.tobytes() + b"\n")
        argv = [fa, fb, "--work-dir", os.path.join(tmp, "w"), "--device",
                args.device, "--ram-size", "0", "--disk-size", "1G"]
        for name, extra in (("CLI --stage-1", ["--stage-1"]),
                            ("CLI resumed", [])):
            rc, secs[name] = profiled(name, args.top, sync, cli.main,
                                      argv + extra)
            if rc != 0:
                raise SystemExit(f"the CLI exited {rc}")
        job = Job(JobConfig(work_dir=os.path.join(tmp, "defaults")),
                  device=args.device)
        lines = []
        _, secs["runner stage 1, JobConfig defaults"] = profiled(
            "runner.stage1 at JobConfig's defaults", args.top, sync,
            runner.stage1, job, s0, s1, None, lines.append)
        _, secs["runner stage 2, JobConfig defaults"] = profiled(
            "runner.stage2 from the rows kept on the device", args.top,
            sync, runner.stage2, job, s0, s1, 0, None, lines.append)
        print("\n".join(x for x in lines
                        if not x.startswith("stage1: ... flushed")))
    card = None
    if cuda:
        from masa_tpu_torch.tools import roofline

        card = roofline.card()
    print(json.dumps({"seconds": {k: round(v, 3) for k, v in secs.items()},
                      "align_pair stage 2": stats.text(), "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
