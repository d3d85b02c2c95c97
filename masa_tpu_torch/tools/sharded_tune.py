"""Time the sharded mode's stage 1 on the 1M pair by strip height R and
slab count D: what ``parallel/sharded.CUDA_ROWS`` is chosen from.

    python -m masa_tpu_torch.tools.sharded_tune [--rows 16,17,18,19]
                                                [--slabs 1,2] [--repeat 2]

Needs a CUDA card and ``nvcc``.  For each D and each R = 2^k:
``sharded_stage1`` of the pair (``tools/pairs``: score only, pruning off)
over a D-slab mesh on the card, timed on the host clock up to a device
sync (the least of ``--repeat`` runs after a warm run at that R), with the
strip kernel's summed milliseconds (CUDA events around every launch) and
its launches; the best must be 796634's stage-1 best.  Beside them, one
monolithic launch of the whole pair (``ops/strips.run_partition`` with
2^20-row strips, the single-device stage 1's launch).  One JSON line a
configuration, with the card's name and power limit, then a summary line
naming the R of the least stage-1 seconds summed over the slab counts.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def run(s0, s1, D: int, R: int) -> dict:
    import torch

    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.parallel.mesh import make_mesh
    from masa_tpu_torch.parallel.sharded import sharded_stage1

    mesh = make_mesh(D, device="cuda")
    kernels.strip_cuda.launches = 0
    kernels.event_log = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sharded_stage1(s0, s1, mesh, wf.StripConfig(rows=R))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ms = kernels.drain_events().get("strip", 0.0)
    kernels.event_log = None
    return dict(best=res.best, seconds=secs, kernel_ms=ms,
                launches=kernels.strip_cuda.launches)


def monolithic(s0, s1) -> dict:
    """The single-device stage 1: one launch over the whole pair."""
    import torch

    from masa_tpu_torch.ops import kernels, strips
    from masa_tpu_torch.ops import wavefront as wf

    kernels.event_log = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = strips.run_partition(
        wf.StripConfig(rows=1 << 22), torch.from_numpy(s0).cuda(),
        torch.from_numpy(s1).cuda(), pad_rows=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ms = kernels.drain_events().get("strip", 0.0)
    kernels.event_log = None
    return dict(best=res.best, seconds=secs, kernel_ms=ms)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", default="16,17,18,19",
                   help="log2 of the strip heights to time")
    p.add_argument("--slabs", default="1,2")
    p.add_argument("--repeat", type=int, default=2)
    args = p.parse_args(argv)

    import torch

    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.tools.pairs import SCORE_1M, bench_pair
    from masa_tpu_torch.tools.strip_tune import card_line

    if not torch.cuda.is_available():
        print("sharded_tune: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    kernels.build("strip")
    s0, s1 = bench_pair()
    mono = monolithic(s0, s1)
    print(json.dumps(dict(card=card, config="monolithic", **mono)),
          flush=True)
    total: dict = {}
    for k in (int(x) for x in args.rows.split(",")):
        R = 1 << k
        for D in (int(x) for x in args.slabs.split(",")):
            run(s0[:R], s1[:R], D, R)  # warm: the allocations at this R
            best = None
            for _ in range(args.repeat):
                got = run(s0, s1, D, R)
                if best is None or got["seconds"] < best["seconds"]:
                    best = got
            if best["best"] != mono["best"]:
                raise AssertionError(f"R={R} D={D}: best {best['best']}, "
                                     f"monolithic {mono['best']}")
            cells = len(s0) * len(s1)
            rounds = -(-len(s0) // R) + D - 1
            print(json.dumps(dict(
                card=card, rows=R, slabs=D, rounds=rounds, **best,
                kernel_ms_per_launch=best["kernel_ms"] / best["launches"],
                gcups=cells / best["seconds"] / 1e9,
                efficiency=(rounds - D + 1) / rounds)), flush=True)
            total[R] = total.get(R, 0.0) + best["seconds"]
    chosen = min(total, key=total.get)
    print(json.dumps(dict(card=card, chosen_rows=chosen,
                          seconds_by_rows=total,
                          score_1m=SCORE_1M, stage1_best=mono["best"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
