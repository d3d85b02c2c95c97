"""The randomized differential lanes 1-4 of tests/test_fuzz_modes.py on
the port (masa_tpu_torch/tools/fuzz_soak.py), on the CPU.

Each case runs the port's lane at the reference's seed: the lane draws the
reference's case and holds the port's result to the port's oracle (it
raises otherwise).  Here the same case also goes through masa_tpu as
test_fuzz_modes.py runs it (its numpy backend, the conftest's 8-device
CPU mesh), and the two results must be equal, tolerance 0 (integer DP):
the score, start and end, the gap lists where the special rows are the
same on both sides (the pipeline, the oversize split), the crosspoints
of stage 2 and of each stage-4 strategy."""

import tempfile

import numpy as np
import pytest

import masa_tpu.biology.alignment
import masa_tpu.biology.sequence
import masa_tpu.types
from masa_tpu.ops import batched_mm as jbmm
from masa_tpu.ops import myers_miller as jmm
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.parallel import mesh as jmesh
from masa_tpu.parallel import sharded as jsh
from masa_tpu.parallel import split as jsplit
from masa_tpu.stages import pipeline as jpipe
from masa_tpu.types import Crosspoint as JCrosspoint
from masa_tpu_torch import convert
from masa_tpu_torch.ops import oracle
from masa_tpu_torch.stages import pipeline
from masa_tpu_torch.tools import fuzz_soak as fz
from masa_tpu_torch.types import (
    Crosspoint,
    CrosspointType,
    InitType,
    Recurrence,
    ScoreParams,
)

REF = (masa_tpu.types, masa_tpu.biology.sequence, masa_tpu.biology.alignment)


def ref(value):
    """A port value as masa_tpu's."""
    return convert.to_ref(value, *REF)


def ends(aln) -> tuple:
    return list(aln.start), list(aln.end)


def cps_of(cps) -> list:
    return [tuple(int(x) for x in c) for c in cps]


@pytest.mark.parametrize("backend", ["auto", "kernel"])
@pytest.mark.parametrize("seed", range(10))
def test_pipeline_vs_oracle(seed, backend):
    """Lane 1 (test_fuzz_modes.py:58); "kernel" takes the plain strips
    where "auto" takes the port's numpy engine at these sizes."""
    rec = fz.pipeline_vs_oracle(seed, "cpu", backend=backend)
    c = rec["case"]
    want = jpipe.align_pair(c["s0"], c["s1"], jpipe.PipelineConfig(
        params=ref(c["params"]), alignment_start=ref(c["start"]),
        alignment_end=ref(c["end"]), backend="numpy",
        max_cells_stage5=1 << 12, flush_interval=c["flush"]))
    got = c["aln"]
    assert got.raw_score == want.raw_score == rec["score"]
    assert ends(got) == ends(want)
    assert fz.gaps(got) == fz.gaps(want)


@pytest.mark.parametrize("seed", range(6))
def test_sharded_vs_oracle(seed):
    """Lane 3 (:103): the score, start and end of masa_tpu's sharded
    alignment over the same slab count, pruning, stride and traceback,
    its strip config without the caller's scores as well."""
    rec = fz.sharded_vs_oracle(seed, "cpu")
    c = rec["case"]
    if "skipped" in rec:
        return  # degenerate local alignment, as the reference skips it
    cfg = WavefrontConfig(alpha=4, rs=1, chunk=512, track_best=True,
                          store_lastcol=True)
    best, want = jsh.sharded_align(
        c["s0"], c["s1"], jmesh.make_mesh(c["D"]), cfg, ref(c["params"]),
        prune=c["prune"], flush_stride=c["flush_stride"],
        traceback=c["traceback"])
    assert c["best"] == best == c["aln"].raw_score == want.raw_score
    assert ends(c["aln"]) == ends(want)


@pytest.mark.parametrize("seed", range(6))
def test_stage4_strategies_differential(seed):
    """Lane 2 (:145): masa_tpu's stage 2 gives the same crosspoints, and
    each strategy and the batched reducer split them as masa_tpu's do."""
    rec = fz.stage4_differential(seed, "cpu")
    c = rec["case"]
    s0, s1, params = c["s0"], c["s1"], ref(c["params"])
    pcfg = jpipe.PipelineConfig(params=params, backend="numpy",
                                max_cells_stage5=1 << 18)
    res, ep = jpipe.stage1_pass(s0, s1, pcfg)
    cps = jpipe.stage2_march(s0, s1, pcfg, ep, res.specials)
    assert cps_of(c["stage2"]) == cps_of(cps)
    for strat in jmm.SplitStrategy:
        want = jmm.reduce_partitions(s0, s1, cps, params, c["mps"], strat)
        assert cps_of(c["out"][strat.name]) == cps_of(want), strat
    want = jbmm.reduce_partitions_batched(s0, s1, cps, params, c["mps"])
    assert cps_of(c["out"]["batched"]) == cps_of(want)


@pytest.mark.parametrize("seed", range(3))
def test_oversize_and_weighted_split(seed):
    """Lane 4 (:179): masa_tpu's oversize split at the same width, with
    the port's strip height (512 rows, masa_tpu's CPU strips)."""
    rec = fz.oversize_weighted(seed, "cpu")
    c = rec["case"]
    if "skipped" in rec:
        return
    cfg = WavefrontConfig(alpha=4, rs=1, chunk=128, track_best=True)
    with tempfile.TemporaryDirectory() as td:
        best, want = jsplit.align_oversize(
            c["s0"], c["s1"], c["width"], td, ref(c["params"]), cfg=cfg,
            max_cells_stage5=1 << 12)
    got = c["aln"]
    assert c["best"] == best == got.raw_score == want.raw_score
    assert ends(got) == ends(want)
    assert fz.gaps(got) == fz.gaps(want)


def test_large_lane_one_takes_the_row_oracle():
    """Past DENSE_CELLS lane 1 checks against dp_rows: a semi-global end
    at a special-row interval past one strip; a global start with the
    end anywhere has no row-oracle value and raises before it runs."""
    S = fz.S
    rec = fz.pipeline_vs_oracle(3, "cpu", sizes=(600, 700), flush=(512, 600),
                                modes=(S.SEQUENCE_1, S.SEQUENCE_1_OR_2))
    assert rec["m"] * rec["n"] > fz.DENSE_CELLS
    assert rec["modes"] == ["SEQUENCE_1", "SEQUENCE_1_OR_2"]
    with pytest.raises(ValueError, match="no global maximum"):
        fz.pipeline_vs_oracle(3, "cpu", sizes=(600, 700),
                              modes=(S.SEQUENCE_2, S.ANYWHERE))


def test_lanes_draw_the_reference_cases():
    """The lanes draw test_fuzz_modes.py's inputs: its first pipeline
    case, rebuilt here as the reference builds it."""
    rng = np.random.default_rng(5000)
    bases = np.frombuffer(b"ACGT", np.uint8)
    m, n = int(rng.integers(40, 320)), int(rng.integers(40, 320))
    s0 = rng.choice(bases, m).astype(np.uint8)
    if rng.random() < 0.6:
        s1 = s0[: n].copy() if n <= m else np.concatenate(
            [s0, rng.choice(bases, n - m)]).astype(np.uint8)
        idx = rng.random(len(s1)) < 0.1
        s1[idx] = rng.choice(bases, int(idx.sum())).astype(np.uint8)
    else:
        s1 = rng.choice(bases, n).astype(np.uint8)
    params = [int(rng.integers(1, 4)), -int(rng.integers(1, 5)),
              int(rng.integers(1, 5)), int(rng.integers(1, 4))]
    start = fz.STARTS[rng.integers(len(fz.STARTS))]
    end = fz.ENDS[rng.integers(len(fz.ENDS))]
    flush = int(rng.integers(32, 128))
    rec = fz.pipeline_vs_oracle(0, "cpu")
    c = rec["case"]
    np.testing.assert_array_equal(c["s0"], s0)
    np.testing.assert_array_equal(c["s1"], s1)
    assert (rec["params"], c["start"], c["end"], c["flush"]) == (
        params, start, end, flush)


def test_gap2_start_opens_the_corner():
    """A partition entered in a vertical gap (a GAP_2 crosspoint: the
    column border continues the open gap) whose path runs down column 0
    for fewer rows than the first special row: the match at virtual row
    0 needs the open gap's F at the corner.  Without it the march was
    lost ("Backtrace lost: no match at special row 0"), as masa_tpu's
    still is; found by lane 1 on a 4096 x 4096 global pair (below)."""
    x = np.random.default_rng(3).choice(fz.BASES, 60).astype(np.uint8)
    s0, s1 = np.concatenate([np.frombuffer(b"A", np.uint8), x]), x
    params = ScoreParams(1, -3, 3, 2)
    want = int(oracle.dp_matrix(s0, s1, params, Recurrence.NEEDLEMAN_WUNSCH,
                                InitType.WITH_GAPS,
                                InitType.WITH_GAPS_OPENED).h[-1, -1])
    assert want == 58
    c0 = Crosspoint(0, 0, 0, CrosspointType.GAP_2)
    c1 = Crosspoint(61, 60, want, CrosspointType.MATCH)
    pcfg = pipeline.PipelineConfig(params=params, backend="numpy",
                                   device="cpu")
    # 61 x 60 cells over 64: special rows every 61 // 8 = 7
    cps = pipeline._densify_segment(s0, s1, pcfg, c0, c1, 64, 0)
    assert cps[-1] == c1
    assert pipeline.stage5_emit(s0, s1, pcfg, [c0] + cps).raw_score == 58
    with pytest.raises(RuntimeError, match="Backtrace lost"):
        jpipe._densify_segment(
            s0, s1, jpipe.PipelineConfig(params=ref(params),
                                         backend="numpy"),
            ref(c0), JCrosspoint(61, 60, want, ref(c1).type), 64, 0)


def test_lane_one_global_pair_at_4096():
    """The lane-1 case that found it: a global (NW) 4096 x 4096 pair, a
    special row every 3960; stage 3's transposed sub-march entered a
    GAP_2 partition."""
    S = fz.S
    rec = fz.pipeline_vs_oracle(20000, "cpu", sizes=(4096, 4097),
                                flush=(512, 4097),
                                modes=(S.SEQUENCE_1_AND_2, None))
    assert (rec["m"], rec["n"], rec["flush"], rec["score"]) == (
        4096, 4096, 3960, 2156)
