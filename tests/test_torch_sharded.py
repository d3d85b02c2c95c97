"""The port's sharded mode (masa_tpu_torch/parallel/{mesh,sharded}.py)
against masa_tpu's, on the CPU: the counterparts of the non-slow cases of
tests/test_multichip.py.  masa_tpu runs as its tests run it (the scan
backend on the conftest's 8-device CPU mesh, 512-row strips: alpha 4 x
rs 1); the port runs the plain strips on a one-process mesh of virtual
slabs with ``StripConfig(rows=512)``.  Inputs from numpy seeds;
tolerance: exact equality (integer DP)."""

import os

import numpy as np
import pytest

from masa_tpu.ops import oracle
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.parallel import mesh as jmesh
from masa_tpu.parallel import sharded as jsh
from masa_tpu.types import Recurrence, ScoreParams
from masa_tpu_torch import convert
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.parallel import mesh, sharded
from masa_tpu_torch.stages import pipeline

P = ScoreParams()
PP = convert.to_port(P)
CFG = wf.StripConfig(rows=512)


def jcfg(alpha=4, chunk=512, **kw):
    """masa_tpu's config of alpha x 128 rows (rs 1)."""
    return WavefrontConfig(alpha=alpha, rs=1, chunk=chunk,
                           recurrence=Recurrence.SMITH_WATERMAN,
                           track_best=True, store_lastcol=True, **kw)


def pmesh(n):
    return mesh.make_mesh(n, device="cpu")


def assert_parts_equal(got, ref):
    """Every slab's endpoint, last row, special rows and border column."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.best, g.best_i, g.best_j, g.cells, g.j0, g.j1) == (
            r.best, r.best_i, r.best_j, r.cells, r.j0, r.j1)
        np.testing.assert_array_equal(g.last_h, r.last_h)
        np.testing.assert_array_equal(g.last_f, r.last_f)
        assert g.specials.rows() == r.specials.rows()
        for row in r.specials.rows():
            for x, y in zip(g.specials.get(row), r.specials.get(row)):
                np.testing.assert_array_equal(x, y)
        assert (g.first_col is None) == (r.first_col is None)
        if r.first_col is not None:
            np.testing.assert_array_equal(g.first_col[0], r.first_col[0])
            np.testing.assert_array_equal(g.first_col[1], r.first_col[1])


def full_equal(got, ref):
    assert (got.best, got.best_i, got.best_j, got.cells) == (
        ref.best, ref.best_i, ref.best_j, ref.cells)
    np.testing.assert_array_equal(got.pruned_strips, ref.pruned_strips)
    assert_parts_equal(got.parts, ref.parts)


def test_mesh_places_and_owns_slabs():
    m = pmesh(3)
    assert m.size == 3 and m.owners == (0, 0, 0)
    assert all(d.type == "cpu" for d in m.devices)
    assert list(m.owned(0)) == [0, 1, 2] and list(m.owned(1)) == []
    # without a process group: one virtual slab on the CPU by default
    assert pmesh(None).size == 1
    sharded.ShardedPipeline(np.zeros(4, np.uint8), np.zeros(4, np.uint8),
                            m, CFG, PP)
    with pytest.raises(ValueError, match="empty sequence"):
        sharded.ShardedPipeline(np.zeros(0, np.uint8),
                                np.zeros(4, np.uint8), m, CFG, PP)


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_best_score_and_last_row_parity(dna, homolog, ndev):
    s0 = dna(700, seed=71)
    s1 = homolog(s0, seed=72)
    res = sharded.sharded_stage1(s0, s1, pmesh(ndev), CFG, PP)
    want = jsh.sharded_stage1(s0, s1, jmesh.make_mesh(ndev), jcfg(), P)
    ref = oracle.dp_rows(s0, s1, P)
    n = len(s1)
    assert res.best == want.best == ref.best
    assert res.cells == want.cells and res.last_h.shape == want.last_h.shape
    np.testing.assert_array_equal(res.last_h[:n], want.last_h[:n])
    np.testing.assert_array_equal(res.last_f[:n], want.last_f[:n])
    np.testing.assert_array_equal(res.pruned_strips, want.pruned_strips)


@pytest.mark.parametrize("m", [512, 300], ids=["one-strip", "partial-tail"])
def test_last_row_parity(dna, homolog, m):
    """The slabs' last rows in a row equal the monolithic DP's last row:
    boundary columns crossed the mesh exactly; a tail strip (m % 512)
    stops at the true last row."""
    s0 = dna(m, seed=73 if m == 512 else 75)
    s1 = homolog(s0, seed=74 if m == 512 else 76)
    ndev = 4 if m == 512 else 2
    res = sharded.sharded_stage1(s0, s1, pmesh(ndev), CFG, PP)
    want = jsh.sharded_stage1(s0, s1, jmesh.make_mesh(ndev), jcfg(), P)
    ref = oracle.dp_rows(s0, s1, P)
    n = len(s1)
    assert res.best == want.best == ref.best
    np.testing.assert_array_equal(res.last_h[:n], ref.last_h[1:])
    np.testing.assert_array_equal(res.last_f[:n], want.last_f[:n])
    np.testing.assert_array_equal(res.last_h[:n], want.last_h[:n])


@pytest.fixture(scope="module")
def pair700():
    """tests/test_multichip.py's 700-row pair (seeds 81/82) and masa_tpu's
    full stage 1 of it over 8 devices."""
    r0, r1 = np.random.default_rng(81), np.random.default_rng(82)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = r0.choice(bases, size=700).astype(np.uint8)
    from conftest import mutate

    s1 = mutate(r1, s0)
    want = jsh.sharded_stage1_full(s0, s1, jmesh.make_mesh(8), jcfg(), P)
    return s0, s1, want


def test_stage1_full_parity(pair700):
    """Every slab's endpoint, last row, special rows and received border
    column equal masa_tpu's; the global endpoint is the oracle's."""
    s0, s1, want = pair700
    got = sharded.sharded_stage1_full(s0, s1, pmesh(8), CFG, PP)
    full_equal(got, want)
    ref = oracle.dp_rows(s0, s1, P)
    assert (got.best, got.best_i, got.best_j) == (ref.best, ref.best_i,
                                                  ref.best_j)
    assert len(got.parts) >= 2 and all(len(p.specials) for p in got.parts)


@pytest.mark.parametrize("case", ["similar", "random"])
def test_score_share_pruning(dna, homolog, case):
    """Pruning on: the exact best, and the same strips skipped on every
    slab as masa_tpu (256-row strips, 8 slabs); a similar pair prunes."""
    if case == "similar":
        s0 = dna(2048, seed=61)
        s1 = homolog(s0, seed=62)
    else:
        s0, s1 = dna(1500, seed=63), dna(1700, seed=64)
    res = sharded.sharded_stage1(s0, s1, pmesh(8), wf.StripConfig(rows=256),
                                 PP, prune=True)
    want = jsh.sharded_stage1(s0, s1, jmesh.make_mesh(8),
                              jcfg(alpha=2, chunk=256), P, prune=True)
    assert res.best == want.best == oracle.dp_rows(s0, s1, P).best
    np.testing.assert_array_equal(res.pruned_strips, want.pruned_strips)
    if case == "similar":
        assert int(res.pruned_strips.sum()) > 0


@pytest.mark.parametrize("ndev", [2, 8])
def test_full_alignment_matches_single_device(pair700, ndev):
    """With stage 4 off, the alignment's gaps, start and end equal the
    port's monolithic align_pair and masa_tpu's sharded_align; with the
    stage-4 ladder on, the score."""
    s0, s1, _ = pair700
    pm = pmesh(ndev)
    best, aln = sharded.sharded_align(s0, s1, pm, CFG, PP, max_partition=0)
    jbest, jaln = jsh.sharded_align(s0, s1, jmesh.make_mesh(ndev), jcfg(),
                                    P, max_partition=0)
    mono = pipeline.align_pair(s0, s1, pipeline.PipelineConfig(
        params=PP, max_partition=0, device="cpu"))
    assert best == jbest == aln.raw_score == oracle.dp_rows(s0, s1, P).best
    assert gaps(aln) == gaps(jaln) == gaps(mono)
    assert (aln.start, aln.end) == (jaln.start, jaln.end) == (mono.start,
                                                              mono.end)
    best4, aln4 = sharded.sharded_align(s0, s1, pm, CFG, PP)
    assert best4 == aln4.raw_score == best


@pytest.mark.parametrize("case", ["speculative", "stride8", "left-slab",
                                  "three", "pruned"])
def test_full_alignment_cases(dna, homolog, case):
    """The reference's other full-alignment cases: the speculative
    traceback, a special row every 8 strips, an endpoint in the leftmost
    slab (slabs to its right hold the pad's state), 3 slabs over 470
    columns (a width not divisible by 3), and score-share pruning."""
    kw, ndev = {}, 8
    if case == "speculative":
        s0 = dna(700, seed=85)
        s1 = homolog(s0, seed=86)
        kw = dict(traceback="speculative")
    elif case == "stride8":
        s0 = dna(700, seed=89)
        s1 = homolog(s0, seed=90)
        kw, ndev = dict(flush_stride=8), 4
    elif case == "left-slab":
        s0 = dna(300, seed=91)
        s1 = np.concatenate([homolog(s0, seed=92), dna(800, seed=93)])
    elif case == "three":
        s0 = dna(500, seed=95)
        s1 = homolog(s0, seed=96)[:470]
        ndev = 3
    else:
        s0 = dna(1024, seed=87)
        s1 = homolog(s0, seed=88)
        kw = dict(prune=True)
    best, aln = sharded.sharded_align(s0, s1, pmesh(ndev), CFG, PP, **kw)
    jbest, jaln = jsh.sharded_align(s0, s1, jmesh.make_mesh(ndev), jcfg(),
                                    P, **kw)
    assert best == jbest == aln.raw_score == oracle.dp_rows(s0, s1, P).best
    assert (aln.start, aln.end) == (jaln.start, jaln.end)


def gaps(aln) -> list:
    """An alignment's gap runs as plain tuples (each package has its own
    GapRun type)."""
    return [[(int(g.pos), int(g.len)) for g in side] for side in aln.gaps]


def rounds_run(monkeypatch) -> list:
    """The rounds every ShardedPipeline runs from here on, in order."""
    ran = []
    orig = sharded.ShardedPipeline.run_round

    def run_round(self, r):
        ran.append(r)
        return orig(self, r)

    monkeypatch.setattr(sharded.ShardedPipeline, "run_round", run_round)
    return ran


def _dir_bytes(path):
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".dat"):
            with open(os.path.join(path, name), "rb") as fh:
                out[name] = fh.read()
    return out


class TestResume:
    def test_interrupted_chunk_resumes_identical(self, dna, homolog,
                                                 tmp_path, monkeypatch):
        """A crash after the first chunk's checkpoint; the rerun resumes
        from it and its slab artifacts equal an uninterrupted run's."""
        s0 = dna(4096, seed=181)
        s1 = homolog(s0, seed=182)
        pm = pmesh(4)
        ref = sharded.sharded_stage1_full(s0, s1, pm, CFG, PP)
        state = str(tmp_path / "state")
        calls = {"n": 0, "rounds": []}
        orig = sharded.ShardedStateSink.chunk_done

        def dying(self, round0):
            orig(self, round0)
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("simulated crash")

        monkeypatch.setattr(sharded.ShardedStateSink, "chunk_done", dying)
        with pytest.raises(RuntimeError, match="simulated crash"):
            sharded.sharded_stage1_full(s0, s1, pm, CFG, PP,
                                        state_dir=state)
        monkeypatch.setattr(sharded.ShardedStateSink, "chunk_done", orig)
        assert os.path.exists(os.path.join(state, "sharded_carry.npz"))
        ran = rounds_run(monkeypatch)
        res = sharded.sharded_stage1_full(s0, s1, pm, CFG, PP,
                                          state_dir=state)
        full_equal(res, ref)
        # 8 strips on 4 slabs: 11 rounds in chunks of 4; the rerun ran
        # the two chunks after the checkpoint
        assert ran == list(range(4, 11))

    def test_stale_carry_invalidated_on_param_change(self, dna, homolog,
                                                     tmp_path):
        """A completed run's carry does not satisfy a rerun with other
        scores in the same directory: it recomputes."""
        s0 = dna(2048, seed=191)
        s1 = homolog(s0, seed=192)
        pm = pmesh(4)
        state = str(tmp_path / "state")
        r1 = sharded.sharded_stage1_full(s0, s1, pm, CFG, PP,
                                         state_dir=state)
        p2 = convert.to_port(ScoreParams(match=2, mismatch=-1, gap_open=4,
                                         gap_ext=2))
        r2 = sharded.sharded_stage1_full(s0, s1, pm, CFG, p2,
                                         state_dir=state)
        ref2 = sharded.sharded_stage1_full(s0, s1, pm, CFG, p2)
        full_equal(r2, ref2)
        assert r2.best != r1.best

    def test_masa_tpu_carry_refused(self, dna, homolog, tmp_path,
                                    monkeypatch):
        """masa_tpu's carry and files in the same state directory: the
        port refuses the carry and recomputes; its files are then byte for
        byte the ones masa_tpu writes for the run."""
        s0 = dna(1100, seed=193)
        s1 = homolog(s0, seed=194)
        state, alone = str(tmp_path / "state"), str(tmp_path / "alone")
        jsh.sharded_stage1_full(s0, s1, jmesh.make_mesh(2), jcfg(), P,
                                state_dir=alone)
        jsh.sharded_stage1_full(s0, s1, jmesh.make_mesh(2), jcfg(), P,
                                state_dir=state)
        ref = sharded.sharded_stage1_full(s0, s1, pmesh(2), CFG, PP)
        ran = rounds_run(monkeypatch)
        got = sharded.sharded_stage1_full(s0, s1, pmesh(2), CFG, PP,
                                          state_dir=state)
        full_equal(got, ref)
        # masa_tpu's run had finished; the port ran every round again
        assert ran == list(range(4))
        assert _dir_bytes(state) == _dir_bytes(alone)
