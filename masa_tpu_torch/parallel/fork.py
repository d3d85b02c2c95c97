"""Multi-process column split for the port: masa_tpu's ``--fork`` (the
reference's fork_multi_process, libmasa.cpp:540-642) with one OS process
per weighted slab (counterpart of masa_tpu/parallel/fork.py).

Each worker (``python -m masa_tpu_torch.parallel.fork cfg.json``) runs on
the torch device its config names.  Neighbours stream the stage-1 border
column over localhost sockets; masa_tpu's AlignerPool carries best scores
rightward during stage 1 (sw_stage1.cpp:421-478), crosspoints leftward
during the pipelined stage 2 with "Not me!" pass-through
(sw_stage2.cpp:133-235), and whole stage-4 crosspoint files leftward
(sw_stage4.cpp:854-881).  Node 0 runs stages 5 and 6 on the spliced chain
and writes the result.  Files and messages are masa_tpu's.

The parent builds the kernels before it spawns the workers (otherwise each
would run nvcc).  Workers that share a card each hold a CUDA context and
time-slice it; a slab's stage 1 is one launch that waits for the whole
border of the slab before it, so their stage 1s run one after another.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from masa_tpu_torch.types import (
    BestScore,
    Crosspoint,
    CrosspointType,
    ScoreParams,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _merge_best(a: tuple, b: tuple) -> tuple:
    """(i, j, score) with the engine tie-break (score desc, i asc, j asc)."""
    ka = (a[2], -a[0], -a[1])
    kb = (b[2], -b[0], -b[1])
    return a if ka >= kb else b


def worker_main(config_path: str) -> int:
    """One slab worker (the forked child, libmasa.cpp:556-577).  Besides
    masa_tpu's outputs it writes ``worker.KK.json`` into the shared
    directory: its device, special-row interval, seconds per stage and
    kernel launches."""
    t_start = time.perf_counter()
    with open(config_path) as f:
        cfg = json.load(f)
    k = cfg["part"]
    os.environ["MASA_FORK_ID"] = str(k)

    import torch

    from masa_tpu_torch.biology import alignment as balign
    from masa_tpu_torch.core.crosspoints import CrosspointsFile
    from masa_tpu_torch.parallel.pool import AlignerPool
    from masa_tpu_torch.stages.stage6 import FORMATS, render_text
    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import myers_miller as mm
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.parallel import split
    from masa_tpu_torch.stages import core, pipeline, stage6
    from masa_tpu_torch.utils.devices import resolve_device

    dev = resolve_device(cfg["device"])  # raises on "cuda" without a GPU
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    device = str(dev)
    seq0 = np.load(cfg["seq0"])
    seq1 = np.load(cfg["seq1"])
    params = ScoreParams(*cfg["params"])
    points = cfg["points"]
    urls = cfg["urls"]
    N = cfg["nparts"]
    j0, j1 = points[k], points[k + 1]
    kcfg = (wf.StripConfig(rows=cfg["rows"]) if cfg.get("rows")
            else core.default_config(dev))
    pool = AlignerPool(cfg["shared_dir"], k, N,
                       timeout=cfg.get("timeout", 300.0))
    secs: dict[str, float] = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return out

    # ---- stage 1: the slab, its border streamed over sockets -----------
    special_every = split.slab_interval(len(seq0), j1 - j0, dev, kcfg,
                                        cfg["ram_limit"])
    part = timed("stage1", split.run_part_stage1,
                 seq0, seq1, k, points, params, kcfg,
                 load_url=urls[k - 1] if k > 0 else None,
                 flush_url=urls[k] if k < N - 1 else None,
                 special_every=special_every, device=device)

    # best scores flow rightward; the last node knows the global best
    my_best = (part.best_i, part.best_j, part.best)
    if k > 0:
        left = pool.receive_score()
        my_best = _merge_best((left.i, left.j, left.score), my_best)
    pool.dispatch_score(BestScore(*my_best))

    # ---- stage 2: traceback, right to left ------------------------------
    slab = np.ascontiguousarray(seq1[j0:j1])
    first_col = part.first_col if k > 0 else None
    # speculative mode (TPDS2016, libmasa.cpp:698-757): march from the
    # slab's own best before the pipeline reaches this node
    spec = None
    if cfg.get("traceback") == "speculative" and not pool.is_last_node():
        spec = timed("stage2", split.speculate_slab,
                     seq0, slab, params, (part.best_i, part.best_j,
                                          part.best),
                     j0, j1, part.specials, first_col, cfg=kcfg,
                     device=device)

    my_cps: list[Crosspoint] = []
    if pool.is_last_node():
        gi, gj, gs = my_best
        cp, final = Crosspoint(gi, gj, gs, CrosspointType.MATCH), False
    else:
        cp, final = pool.receive_crosspoint()
    if not final and j0 < cp.j <= j1:
        local = timed("stage2", split.march_slab,
                      seq0, slab, params,
                      Crosspoint(cp.i, cp.j - j0, cp.score, cp.type),
                      part.specials, first_col, sw_anywhere=True, cfg=kcfg,
                      known={tuple(c) for c in spec} if spec else None,
                      device=device)
        local, _ = split.splice_speculation(local, spec)
        my_cps = split._global(local, j0)
        first = my_cps[0]
        if k > 0:
            pool.dispatch_crosspoint(
                first, final=first.j > j0 or first.score <= 0)
    elif k > 0:
        # "Not me!": route the message onward unchanged
        pool.dispatch_crosspoint(cp, final=final)

    # ---- stages 3/4 on this slab's chain, then splice leftward ---------
    pcfg = pipeline.PipelineConfig(
        params=params, max_cells_stage5=cfg["max_cells_stage5"],
        device=device)
    mps = cfg["max_partition"]
    my4 = my_cps
    if len(my_cps) >= 2:
        my4 = timed("stage3", pipeline.stage3_densify, seq0, seq1, pcfg,
                    my_cps, max_cells=split.densify_limit(mps, dev))
        if mps:
            my4 = timed("stage4", mm.stage4_reduce, seq0, seq1, my4, params,
                        mps, stage5_max_cells=pcfg.max_cells_stage5,
                        device=device)

    shared = cfg["shared_dir"]
    node_dir = os.path.join(shared, f"node.{k:02d}")
    os.makedirs(node_dir, exist_ok=True)
    chain = my4
    if not pool.is_last_node():
        # stage4_pool_wait: splice the right node's crosspoint file
        right = CrosspointsFile(pool.receive_file("cps4", node_dir)).load()
        if chain and right and tuple(chain[-1]) == tuple(right[0]):
            right = right[1:]
        chain = chain + right

    def report():
        with open(os.path.join(shared, f"worker.{k:02d}.json"), "w") as f:
            json.dump({
                "part": k, "device": device, "columns": [j0, j1],
                "special_every": special_every,
                "seconds": {**secs,
                            "total": time.perf_counter() - t_start},
                "launches": {"strip": kernels.strip_cuda.launches,
                             "batched_strip":
                                 kernels.batched_strip_cuda.launches,
                             "traceback": kernels.traceback_cuda.launches},
            }, f)

    if not pool.is_first_node():
        cf = CrosspointsFile(os.path.join(node_dir,
                                          f"crosspoint_04.{k:02d}"))
        cf.crosspoints = chain
        cf.save()
        pool.dispatch_file(cf.path, "cps4")
        report()
        return 0

    # ---- node 0: stages 5/6 on the whole spliced chain ------------------
    if not chain:
        raise RuntimeError("fork: empty crosspoint chain at node 0")
    aln = timed("stage5", pipeline.stage5_emit, seq0, seq1, pcfg, chain)
    timed("stage6", stage6.recheck, aln, seq0, seq1, params)
    out = {
        "score": int(aln.raw_score),
        "matches": int(aln.matches),
        "mismatches": int(aln.mismatches),
        "gap_opens": int(aln.gap_opens),
        "gap_extensions": int(aln.gap_extensions),
        "start": [int(x) for x in aln.start],
        "end": [int(x) for x in aln.end],
        "crosspoints": [[int(x) for x in c] for c in chain],
    }
    with open(os.path.join(shared, "result.json"), "w") as f:
        json.dump(out, f)
    with open(os.path.join(shared, "alignment.txt"), "w") as f:
        f.write(render_text(aln, seq0, seq1))

    # the work directory's artifact set, as in every other CLI mode (CGFF,
    # the requested rendering, the final crosspoint file;
    # libmasa.cpp:1351-1394)
    wd = os.path.dirname(shared) or "."
    balign.write_cgff(os.path.join(wd, "alignment.00.cgff"), aln)
    cps_dir = os.path.join(wd, "crosspoints")
    os.makedirs(cps_dir, exist_ok=True)
    cf0 = CrosspointsFile(os.path.join(cps_dir, "crosspoint_04.00"))
    cf0.crosspoints = chain
    cf0.save()
    render = FORMATS.get(cfg["output_format"], FORMATS["text"])
    text, ext = render(aln, seq0, seq1)
    with open(os.path.join(wd, f"alignment.00.{ext}"), "w") as f:
        f.write(text)
    report()
    return 0


def run_fork(
    seq0: np.ndarray,
    seq1: np.ndarray,
    weights: list[float],
    work_dir: str,
    params: ScoreParams = ScoreParams(),
    kernel_cfg=None,
    base_port: int = 7300,
    max_partition: int = 16,
    timeout: float = 600.0,
    device="cuda",
    devices: list[int] | None = None,
    extra_env: dict | None = None,
    traceback: str = "pipelined",
    output_format: str = "text",
    ram_limit: int = 1 << 30,
    max_cells_stage5: int = 1 << 18,
):
    """Spawn one worker process per slab and reap them
    (fork_multi_process + its wait loop, libmasa.cpp:540-642); any
    worker's failure stops the others and raises.

    ``device`` "cpu" puts every worker on the CPU; "cuda" puts worker k on
    ``cuda:{devices[k]}``, or ``cuda:{k % device_count}`` without
    ``devices``.  ``ram_limit`` bounds each CUDA worker's special rows
    (``split.slab_interval``).  Returns node 0's result dict (score,
    statistics, crosspoints) plus ``workers``: each worker's
    ``worker.KK.json``."""
    import torch

    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.parallel.split import auto_urls, split_points
    from masa_tpu_torch.utils.devices import resolve_device

    cuda = resolve_device(device).type == "cuda"
    if cuda:
        for name in ("strip", "batched_strip"):
            kernels.build(name)
        count = torch.cuda.device_count()
    N = len(weights)
    os.makedirs(work_dir, exist_ok=True)
    shared = os.path.join(work_dir, "shared")
    os.makedirs(shared, exist_ok=True)
    s0p = os.path.join(work_dir, "seq0.npy")
    s1p = os.path.join(work_dir, "seq1.npy")
    np.save(s0p, np.asarray(seq0, np.uint8))
    np.save(s1p, np.asarray(seq1, np.uint8))
    points = split_points(len(seq1), weights)
    urls = auto_urls("", N, use_sockets=True, base_port=base_port)
    env = dict(os.environ)
    env.update(extra_env or {})
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)

    procs = []
    try:
        for k in range(N):
            cfg = {
                "part": k,
                "nparts": N,
                "seq0": s0p,
                "seq1": s1p,
                "points": points,
                "urls": urls,
                "shared_dir": shared,
                "params": [params.match, params.mismatch, params.gap_open,
                           params.gap_ext],
                "max_partition": max_partition,
                "max_cells_stage5": max_cells_stage5,
                "timeout": timeout,
                "device": (f"cuda:{devices[k] if devices else k % count}"
                           if cuda else "cpu"),
                "rows": kernel_cfg.rows if kernel_cfg is not None else None,
                "ram_limit": ram_limit,
                "traceback": traceback,
                "output_format": output_format,
            }
            cpath = os.path.join(work_dir, f"fork.{k:02d}.json")
            with open(cpath, "w") as f:
                json.dump(cfg, f)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "masa_tpu_torch.parallel.fork",
                 cpath], env=env))
        # the wait()-reaper (libmasa.cpp:605-630): the first failure ends
        # the run
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.time() > deadline:
                raise TimeoutError(f"fork workers still running after "
                                   f"{timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failed = [(k, p.returncode) for k, p in enumerate(procs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"fork workers failed: {failed}")

    with open(os.path.join(shared, "result.json")) as f:
        out = json.load(f)
    out["workers"] = []
    for k in range(N):
        with open(os.path.join(shared, f"worker.{k:02d}.json")) as f:
            out["workers"].append(json.load(f))
    return out


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1]))
