"""One process of a multi-process sharded stage-1 run (counterpart of
tools/multihost_worker.py, the reference's single-machine stand-in for
several nodes, libmasa.cpp:516-527).

    python -m masa_tpu_torch.tools.multihost_worker <coordinator> \\
        <num_procs> <proc_id> <out.json> [size] [--device cuda|cpu] \\
        [--slabs N] [--rows R] [--prune] [--state-dir DIR]

Every process builds the same deterministic pair (``rng(7)``, size x size,
10% substitutions), joins the gloo group whose process 0 listens at
<coordinator> (host:port), runs ``sharded_stage1`` over a mesh of N slabs
(default: one a process) with R-row strips (default 512, the reference
worker's), and process 0 writes to <out.json> the best score, the number
of processes, the slabs, the final row (``last_h``), the pruned strips
per slab, the strip kernel's launches summed over the processes and any
module of JAX or of the JAX package a process imported (none).  With
``--state-dir`` it runs ``sharded_stage1_full`` there instead (the
processes may share the directory), resuming from a carry left in it,
and also writes the endpoint ``[best, i, j]`` and ``parts_digest``
(``parts_digest``: every slab's last row, special rows and border).
Start one per process id, from the root of a checkout.
"""

from __future__ import annotations

import argparse
import json
import sys


def pair(size: int):
    """The reference worker's pair."""
    import numpy as np

    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, size).astype(np.uint8)
    s1 = s0.copy()
    idx = rng.random(size) < 0.1
    s1[idx] = rng.choice(bases, int(idx.sum())).astype(np.uint8)
    return s0, s1


def parts_digest(parts) -> str:
    """A digest of every slab's last row, special rows and received border
    (``split.PartResult``s): equal digests, equal traceback inputs."""
    import hashlib

    import numpy as np

    sha = hashlib.sha1()
    for p in parts:
        arrays = [p.last_h, p.last_f]
        for r in p.specials.rows():
            arrays += [np.asarray([r]), *p.specials.get(r)]
        arrays += list(p.first_col or ())
        for a in arrays:
            sha.update(np.ascontiguousarray(a, np.int64).tobytes())
    return sha.hexdigest()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("coordinator")
    p.add_argument("num_procs", type=int)
    p.add_argument("proc_id", type=int)
    p.add_argument("out")
    p.add_argument("size", type=int, nargs="?", default=768)
    p.add_argument("--device", default="cuda")
    p.add_argument("--slabs", type=int, default=0)
    p.add_argument("--rows", type=int, default=512)
    p.add_argument("--prune", action="store_true")
    p.add_argument("--state-dir", default=None)
    args = p.parse_args(argv)

    import torch.distributed as dist

    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.parallel.mesh import (
        gather_objects, initialize_distributed, make_mesh, world)
    from masa_tpu_torch.parallel.sharded import (
        sharded_stage1, sharded_stage1_full)
    from masa_tpu_torch.types import ScoreParams

    initialize_distributed(args.coordinator, args.num_procs, args.proc_id,
                           timeout=120.0)
    try:
        if world() != (args.proc_id, args.num_procs):
            raise RuntimeError(f"joined as {world()}, expected "
                               f"({args.proc_id}, {args.num_procs})")
        s0, s1 = pair(args.size)
        mesh = make_mesh(args.slabs or args.num_procs, device=args.device)
        cfg = wf.StripConfig(rows=args.rows)
        endpoint = digest = None
        if args.state_dir:
            full = sharded_stage1_full(s0, s1, mesh, cfg, ScoreParams(),
                                       prune=args.prune,
                                       state_dir=args.state_dir)
            endpoint = [full.best, full.best_i, full.best_j]
            digest = parts_digest(full.parts)
        res = sharded_stage1(s0, s1, mesh, cfg, ScoreParams(),
                             prune=args.prune)
        launches = sum(gather_objects(kernels.strip_cuda.launches))
        foreign = sorted({m for got in gather_objects(sorted(sys.modules))
                          for m in got if m.split(".")[0] in
                          ("jax", "jaxlib", "masa_tpu")})
        if args.proc_id == 0:
            with open(args.out, "w") as f:
                json.dump({"best": int(res.best),
                           "processes": world()[1],
                           "slabs": mesh.size,
                           "device": str(mesh.devices[0]),
                           "last_h": [int(x) for x in res.last_h],
                           "pruned_strips": [int(x)
                                             for x in res.pruned_strips],
                           "launches": {"strip": launches},
                           "foreign_modules": foreign,
                           "endpoint": endpoint,
                           "parts_digest": digest}, f)
    finally:
        # every process leaves the group (the reference's wait() reaper,
        # libmasa.cpp:605-630)
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
