"""The port's six-stage pipeline against masa_tpu's, on the CPU.

The port runs its strip engine (the plain PyTorch strips, backend
"kernel") where masa_tpu runs its NumPy oracle or scan twin; with the
special-row interval pinned on both sides the crosspoints, and hence the
emitted co-optimal path, must be identical: score, start, end and both gap
lists.  Also: real1's frozen oracle result, and special rows carried from
one package's stage 1 into the other's stage 2."""

import dataclasses
import os

import numpy as np
import pytest

import masa_tpu
import masa_tpu_torch
from masa_tpu.biology.sequence import Sequence
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.stages import pipeline as jpipe
from masa_tpu.stages.core import SpecialRowStore as JaxRowStore
from masa_tpu.types import AlignmentStart, Recurrence, ScoreParams
from masa_tpu_torch import convert
from masa_tpu_torch.stages import pipeline, stage6
import masa_tpu.biology.alignment

# masa_tpu's value-type modules, handed to convert.to_ref
REF = (masa_tpu.types, masa_tpu.biology.sequence, masa_tpu.biology.alignment)

G = os.path.join(os.path.dirname(__file__), "golden")
S = AlignmentStart


def same_alignment(a, b):
    assert a.raw_score == b.raw_score
    assert list(a.start) == list(b.start)
    assert list(a.end) == list(b.end)
    for k in (0, 1):
        assert [(g.pos, g.len) for g in a.sorted_gaps(k)] == \
            [(g.pos, g.len) for g in b.sorted_gaps(k)]


def configs(flush, **kw):
    ref = jpipe.PipelineConfig(flush_interval=flush, **kw)
    # the same values, as the port's own types
    port = pipeline.PipelineConfig(flush_interval=flush, backend="kernel",
                                   device="cpu", **convert.to_port(kw))
    return ref, port


def load(name):
    return Sequence.from_file(os.path.join(G, name)).data()


@pytest.mark.parametrize("flush", [128, 512])
@pytest.mark.parametrize("name", ["pair1", "pair2"])
def test_golden_pairs_match_masa_tpu(name, flush):
    s0, s1 = load(f"{name}_a.fa"), load(f"{name}_b.fa")
    ref, port = configs(flush)
    want = jpipe.align_pair(s0, s1, ref)
    got = pipeline.align_pair(s0, s1, port)
    same_alignment(got, want)
    assert stage6.recheck(got, s0, s1, port.params).score == got.raw_score


def test_align_entry_point_matches_masa_tpu():
    a, b = os.path.join(G, "pair1_a.fa"), os.path.join(G, "pair1_b.fa")
    same_alignment(masa_tpu_torch.align(a, b, device="cpu"),
                   masa_tpu.align(a, b))


STARTS = [S.ANYWHERE, S.SEQUENCE_1_AND_2, S.SEQUENCE_1, S.SEQUENCE_2,
          S.SEQUENCE_1_OR_2]
ENDS = [None, S.ANYWHERE, S.SEQUENCE_1_AND_2, S.SEQUENCE_1, S.SEQUENCE_2,
        S.SEQUENCE_1_OR_2]


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_modes_match_masa_tpu(seed):
    """Random shapes, scores and start/end modes (the test_fuzz_modes
    pattern)."""
    rng = np.random.default_rng(9000 + seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    m, n = int(rng.integers(60, 320)), int(rng.integers(60, 320))
    s0 = rng.choice(bases, m).astype(np.uint8)
    s1 = np.resize(s0, n).copy()
    idx = rng.random(n) < 0.12
    s1[idx] = rng.choice(bases, int(idx.sum())).astype(np.uint8)
    params = ScoreParams(match=int(rng.integers(1, 4)),
                         mismatch=-int(rng.integers(1, 5)),
                         gap_open=int(rng.integers(1, 5)),
                         gap_ext=int(rng.integers(1, 4)))
    ref, port = configs(int(rng.integers(32, 128)), params=params,
                        alignment_start=STARTS[rng.integers(len(STARTS))],
                        alignment_end=ENDS[rng.integers(len(ENDS))],
                        max_cells_stage5=1 << 12)
    want = jpipe.align_pair(s0, s1, ref)
    got = pipeline.align_pair(s0, s1, port)
    same_alignment(got, want)


def test_real1_frozen_result():
    """16 KBP real-genomic fixture: the frozen oracle score and endpoint
    (tests/test_golden_real.py), through the port's plain strips."""
    aln = masa_tpu_torch.align(os.path.join(G, "real1_a.fa"),
                               os.path.join(G, "real1_b.fa"), device="cpu")
    assert aln.raw_score == 11367
    assert list(aln.end) == [16384, 15805]


def _pair(seed, m, n):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, m).astype(np.uint8)
    s1 = np.resize(s0[5:], n).copy()
    idx = rng.random(n) < 0.1
    s1[idx] = rng.choice(bases, int(idx.sum())).astype(np.uint8)
    return s0, s1


def test_jax_stage1_feeds_port_stage2():
    s0, s1 = _pair(11, 700, 650)
    ref, port = configs(128)
    ref = dataclasses.replace(ref, backend="numpy")
    res, endpoint = jpipe.stage1_pass(s0, s1, ref)
    rows = convert.special_rows_to_numpy(res.specials)
    assert len(rows) >= 4
    got = pipeline.stage2_march(s0, s1, port, convert.to_port(endpoint),
                                convert.special_rows_from_numpy(rows))
    want = jpipe.stage2_march(s0, s1, ref, endpoint, res.specials)
    assert got == want and len(got) >= 4


def test_port_stage1_feeds_jax_stage2():
    s0, s1 = _pair(12, 650, 700)
    ref, port = configs(128, alignment_start=S.SEQUENCE_1_AND_2)
    res, endpoint = pipeline.stage1_pass(s0, s1, port)
    jstore = JaxRowStore()
    for r, (h, f) in convert.special_rows_to_numpy(res.specials).items():
        jstore.put(r, h, f)
    want_res, want_end = jpipe.stage1_pass(s0, s1, ref)
    assert want_end == endpoint
    assert jstore.rows() == want_res.specials.rows()
    got = jpipe.stage2_march(s0, s1, ref,
                             convert.to_ref(endpoint, *REF), jstore)
    assert got == pipeline.stage2_march(s0, s1, port, endpoint, res.specials)


def test_strip_config_from_jax():
    cfg = WavefrontConfig(alpha=4, rs=1, chunk=512,
                          recurrence=Recurrence.NEEDLEMAN_WUNSCH,
                          store_lastcol=True)
    fields = {**dataclasses.asdict(cfg),
              **dataclasses.asdict(ScoreParams(2, -1, 3, 1))}
    got = convert.strip_config_from_jax(fields)
    assert got.rows == 512
    assert got.recurrence is masa_tpu_torch.Recurrence.NEEDLEMAN_WUNSCH
    assert (got.match, got.mismatch, got.gap_open, got.gap_ext) == (
        2, -1, 3, 1)
    assert got.store_lastcol and got.track_best
    with pytest.raises(KeyError):
        convert.strip_config_from_jax({"lanes": 4})
