"""A full sharded alignment over an n-slab mesh, held against the
single-device pipeline (counterpart of ``dryrun_multichip`` in
__graft_entry__.py).

    python -m masa_tpu_torch.tools.dryrun_multichip [N] [--device cuda|cpu]

The pair: 600 random bases, and the same bases behind 32 x N others, so
that the optimal path crosses several slabs.  With the stage-4 ladder on
(the default), the score must be the oracle's; with it off
(``max_partition=0``), the gaps, the start and the end must also equal
``pipeline.align_pair``'s (special rows every 512 rows on both sides).
Prints one line and exits 0, or raises."""

from __future__ import annotations

import argparse
import sys

import numpy as np


def dryrun_multichip(n_devices: int, device: str = "cuda") -> int:
    """Run the check; returns the score."""
    from masa_tpu_torch.ops import oracle
    from masa_tpu_torch.ops import wavefront as wf
    from masa_tpu_torch.parallel.mesh import make_mesh
    from masa_tpu_torch.parallel.sharded import sharded_align
    from masa_tpu_torch.stages import pipeline
    from masa_tpu_torch.types import ScoreParams

    mesh = make_mesh(n_devices, device=device)
    cfg = wf.StripConfig(rows=512)
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, size=600).astype(np.uint8)
    s1 = np.concatenate([
        rng.choice(bases, size=32 * n_devices).astype(np.uint8), s0])
    params = ScoreParams()
    ref = oracle.dp_rows(s0, s1, params)
    best, aln = sharded_align(s0, s1, mesh, cfg, params)
    if not best == aln.raw_score == ref.best:
        raise AssertionError(f"sharded score {best}/{aln.raw_score}, oracle "
                             f"{ref.best}")
    best0, aln0 = sharded_align(s0, s1, mesh, cfg, params, max_partition=0)
    mono = pipeline.align_pair(s0, s1, pipeline.PipelineConfig(
        params=params, max_partition=0, flush_interval=512,
        device=str(mesh.devices[0])))
    if not best0 == aln0.raw_score == ref.best:
        raise AssertionError(f"sharded score {best0} without stage 4, "
                             f"oracle {ref.best}")
    if (aln0.gaps, aln0.start, aln0.end) != (mono.gaps, mono.start,
                                             mono.end):
        raise AssertionError("sharded alignment != single-device alignment")
    print(f"dryrun_multichip({n_devices}) on {mesh.devices[0]}: full "
          f"alignment score={best} ({aln.matches} matches) OK")
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
