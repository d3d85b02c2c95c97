"""Block pruning and the blocks sink of the port's strips against masa_tpu's,
on the CPU (the plain strips, 512-row strips, 512-column chunks).

Pruning skips cells that cannot beat the best, so the best score and its
cell are masa_tpu's and the unpruned run's exactly, while the count of
pruned cells follows each package's window policy (masa_tpu rounds its
windows to powers of two for its compiler; the port does not), so it is
only required to be positive.  NW never prunes."""

import numpy as np
import pytest
import torch

from masa_tpu.core.blocks_file import BlocksFile
from masa_tpu.ops import wavefront as jwf
from masa_tpu.stages import core as jcore
from masa_tpu.types import InitType, Recurrence, ScoreParams
from masa_tpu_torch.core.job import Job, JobConfig
from masa_tpu_torch.ops import strips
from masa_tpu_torch import convert
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import core, runner

P = ScoreParams()
Z = InitType.WITH_ZEROES
port = convert.to_port  # the port takes its own types


def forward(seq0, seq1, prune, rec=Recurrence.SMITH_WATERMAN,
            init=(Z, Z), **kw):
    return core.forward_pass(seq0, seq1, port(P), port(rec), *port(init),
                             prune=prune,
                             backend="kernel", cfg=wf.StripConfig(rows=512),
                             device="cpu", **kw)


@pytest.fixture(params=["homolog", "identical"])
def pair(request, dna, homolog):
    s0 = dna(3000, seed=301)
    if request.param == "identical":
        return s0, s0.copy()
    return s0, homolog(s0, seed=302, sub_rate=0.08, indel_rate=0.02)


def test_pruning_keeps_the_best(pair):
    s0, s1 = pair
    got = forward(s0, s1, True)
    full = forward(s0, s1, False)
    ref = jcore.forward_pass(
        s0, s1, P, Recurrence.SMITH_WATERMAN, Z, Z, prune=True,
        backend="kernel",
        cfg=jwf.WavefrontConfig(alpha=4, rs=1, chunk=512))
    want = (ref.best, ref.best_i, ref.best_j)
    assert (got.best, got.best_i, got.best_j) == want
    assert (full.best, full.best_i, full.best_j) == want
    assert got.pruned_cells > 0 and full.pruned_cells == 0
    assert got.cells + got.pruned_cells == full.cells == s0.size * s1.size


def test_pruned_special_rows(pair):
    """A pruned run's flushed rows (also those flushed inside a strip)
    are the DP of the matrix whose pruned cells are -INF: -INF where a
    strip skipped columns, never above the unpruned values where it ran,
    and equal to them away from the window's walls."""
    s0, s1 = pair
    pruned, full = core.SpecialRowStore(), core.SpecialRowStore()
    forward(s0, s1, True, special_every=256, store=pruned)
    forward(s0, s1, False, special_every=256, store=full)
    assert pruned.rows() == full.rows()
    skipped = equal = ran_cells = 0
    for r in pruned.rows():
        (ph, pf), (fh, ff) = pruned.get(r), full.get(r)
        assert (ph <= fh).all() and (pf <= ff).all()
        ran = ph[1:] > -wf.INF
        skipped += int((~ran).sum())
        ran_cells += int(ran.sum())
        equal += int((ph[1:][ran] == fh[1:][ran]).sum())
    assert skipped > 0 and equal > 0.9 * ran_cells


@pytest.mark.parametrize("init", [(Z, Z), (InitType.WITH_GAPS,
                                           InitType.WITH_GAPS)])
def test_nw_never_prunes(dna, homolog, init):
    s0 = dna(1500, seed=303)
    s1 = homolog(s0, seed=304)
    got = forward(s0, s1, True, rec=Recurrence.NEEDLEMAN_WUNSCH, init=init)
    full = forward(s0, s1, False, rec=Recurrence.NEEDLEMAN_WUNSCH,
                   init=init)
    assert got.pruned_cells == 0
    np.testing.assert_array_equal(got.last_h, full.last_h)
    np.testing.assert_array_equal(got.last_f, full.last_f)


def test_chunk_maxima():
    """Per-chunk bus maxima, the last chunk padded with -INF."""
    bus = np.full(1300, -wf.INF, np.int64)
    bus[600:700] = 50
    maxima = strips.chunk_maxima(torch.from_numpy(bus), 3)
    assert maxima.tolist() == [-wf.INF, 50, -wf.INF]


def test_blocks_sink_and_svg(dna, homolog, tmp_path):
    """--dump-blocks: one row of per-chunk bus maxima per strip, and the
    SVG renderer reads it (masa_tpu's BlocksFile and stage 6)."""
    s0 = dna(1400, seed=306)
    s1 = homolog(s0, seed=307)
    job = Job(JobConfig(work_dir=str(tmp_path / "w"), dump_blocks=True,
                        backend="kernel", stage4_max_partition=0),
              device="cpu")
    runner.align_job(job, s0, s1, fmt="svg", log=lambda *a: None)
    grid = BlocksFile.load(job.path("blocks.00.bin"))
    assert grid.shape == (-(-len(s0) // 512), -(-len(s1) // 512))
    assert grid.max() > 0
    with open(job.path("alignment.00.svg")) as fh:
        assert "<svg" in fh.read()
