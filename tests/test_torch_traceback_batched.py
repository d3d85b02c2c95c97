"""Stage 5's batched traceback (the card's kernel, ``csrc/traceback.cu``)
through its plain version, on the CPU.

``smallsw.traceback_plain`` computes what the kernel computes: every
partition's constrained DP and walk over the kernel's 4-bit table, the
output laid out by ``kernels.traceback_layout``.  It must equal the native
call (``bindings.traceback_ops``: score, runs, failures) and
``constrained_dp``'s score, for every start and end state, at the
degenerate and the main paths' shapes, under the default and random
scores.  ``stage5_emit`` routed through it must give the host route's
alignment byte for byte; on the CPU it takes the host route alone.
Tolerance: 0 (integer DP).  The kernel itself is held to the plain
version on the card (``tests/test_torch_cuda.py``)."""

import dataclasses
import itertools
import math
import os
import tempfile

import numpy as np
import pytest
import torch

from masa_tpu_torch.biology import alignment as balign
from masa_tpu_torch.native import bindings
from masa_tpu_torch.ops import kernels, smallsw
from masa_tpu_torch.ops import myers_miller as mm
from masa_tpu_torch.stages import pipeline
from masa_tpu_torch.tools import fuzz_soak
from masa_tpu_torch.types import Crosspoint, ScoreParams
from masa_tpu_torch.utils import trace

BASES = np.frombuffer(b"ACGT", np.uint8)
H100_SHARED = 232448  # what a block may ask for on an H100
STATES = list(itertools.product(range(3), range(3)))
# the fuzz lanes' scores, drawn as tools/fuzz_soak draws them
SCORES = [ScoreParams()] + [fuzz_soak._params(np.random.default_rng(s))
                            for s in (5, 11)]


def pair(h, w, seed):
    """A partition's two stretches: ``w`` columns copied from the ``h``
    rows with substitutions, insertions and deletions."""
    r = np.random.default_rng(seed)
    s0 = r.choice(BASES, h).astype(np.uint8)
    out = []
    for c in s0:
        x = r.random()
        if x < 0.04:
            continue
        out.append(c if x > 0.12 else r.choice(BASES))
        if x > 0.96:
            out.extend(r.choice(BASES, int(r.integers(1, 4))))
    s1 = np.array(out[:w], np.uint8)
    if len(s1) < w:
        s1 = np.concatenate([s1, r.choice(BASES, w - len(s1))])
    return s0, s1.astype(np.uint8)


def native(s0, s1, ts, te, params):
    """``bindings.traceback_ops``, None where it fails."""
    try:
        return bindings.traceback_ops(s0, s1, ts, te, params)
    except RuntimeError as e:
        assert str(e) == "native traceback failed"
        return None


def batch(parts):
    """Sequence views and items for ``(s0, s1, ts, te)`` partitions laid
    end to end."""
    a = np.concatenate([np.zeros(0, np.uint8)] + [p[0] for p in parts])
    b = np.concatenate([np.zeros(0, np.uint8)] + [p[1] for p in parts])
    i0 = np.cumsum([0] + [len(p[0]) for p in parts])[:-1]
    j0 = np.cumsum([0] + [len(p[1]) for p in parts])[:-1]
    items = np.array([(x, len(p[0]), y, len(p[1]), p[2], p[3])
                      for x, y, p in zip(i0, j0, parts)], np.int64)
    return torch.from_numpy(a), torch.from_numpy(b), items


needs_native = pytest.mark.skipif(not bindings.available(),
                                  reason="the native library needs g++")


@needs_native
@pytest.mark.parametrize("shape", [(0, 9), (9, 0), (1, 300), (300, 1),
                                   (137, 136), (512, 512), (64, 4096)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("k", range(len(SCORES)),
                         ids=["default", "fuzz5", "fuzz11"])
def test_plain_matches_native(shape, k):
    """All nine start and end states of one shape in one batch: the
    score, the runs (int32, forward order) and the failures of the native
    call, and constrained_dp's score of the end state."""
    params = SCORES[k]
    h, w = shape
    s0, s1 = pair(h, w, seed=h * 7919 + w + k)
    a, b, items = batch([(s0, s1, ts, te) for ts, te in STATES])
    got = smallsw.traceback_decode(
        smallsw.traceback_plain(a, b, items, params).numpy(),
        items[:, 1:4:2])
    fails = 0
    for (ts, te), (seg, ops) in zip(STATES, got):
        want = native(s0, s1, ts, te, params)
        dp = smallsw.constrained_dp(s0, s1, ts, params)
        assert seg == int(dp[te][h, w]), (ts, te)
        if want is None:
            assert ops is None, (ts, te)
            fails += 1
            continue
        assert ops is not None, (ts, te)
        assert seg == want[0], (ts, te)
        assert ops.dtype == want[1].dtype == np.int32
        assert np.array_equal(ops, want[1]), (ts, te)
    # row 0 cannot end in F, nor column 0 in E
    assert fails == (3 if 0 in shape else 0)


@needs_native
@pytest.mark.parametrize("case", [
    (0, 0, 0, 1), (0, 0, 0, 2), (0, 0, 1, 2), (0, 7, 0, 2), (7, 0, 0, 1),
    (0, 7, 2, 2), (7, 0, 1, 1)], ids=lambda c: "%dx%d-%d%d" % c)
def test_failures_fail_alike(case):
    """Where the native walk fails (a gap off the border, a wrong end
    state) the plain one flags it, and stage 5 routed through it raises the
    native call's error."""
    h, w, ts, te = case
    s0, s1 = pair(h, w, seed=3)
    assert native(s0, s1, ts, te, ScoreParams()) is None
    a, b, items = batch([(s0, s1, ts, te)])
    (_, ops), = smallsw.traceback_decode(
        smallsw.traceback_plain(a, b, items, ScoreParams()).numpy(),
        items[:, 1:4:2])
    assert ops is None
    cps = [Crosspoint(0, 0, 0, ts), Crosspoint(h, w, 0, te)]
    pcfg = pipeline.PipelineConfig(device="cpu")
    for route in (None, on_cpu(H100_SHARED)):
        with routed(route), pytest.raises(RuntimeError,
                                           match="native traceback failed"):
            pipeline.stage5_emit(s0, s1, pcfg, cps)


def on_cpu(limit):
    """``smallsw.traceback_on_card`` as it runs on a card with ``limit``
    bytes of shared memory, on the CPU through the plain version."""
    def route(seq0, seq1, cps, params, device):
        return smallsw.traceback_partitions(seq0, seq1, cps, params,
                                            torch.device("cpu"), limit)
    return route


class routed:
    """Stage 5's card route replaced by ``route`` (None: as it is)."""

    def __init__(self, route):
        self.route = route

    def __enter__(self):
        self.saved = smallsw.traceback_on_card
        if self.route is not None:
            smallsw.traceback_on_card = self.route

    def __exit__(self, *exc):
        smallsw.traceback_on_card = self.saved


def cgff(aln) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "a.cgff")
        balign.write_cgff(path, aln)
        with open(path, "rb") as fh:
            return fh.read()


def same_alignment(x, y):
    assert x.raw_score == y.raw_score
    for f in ("matches", "mismatches", "gap_opens", "gap_extensions",
              "start", "end"):
        assert getattr(x, f) == getattr(y, f), f
    assert [[dataclasses.astuple(g) for g in s] for s in x.gaps] == \
        [[dataclasses.astuple(g) for g in s] for s in y.gaps]
    assert cgff(x) == cgff(y)


def crosspoints(m, n, seed, params, cells):
    """The path of a homologous pair cut into partitions of at most
    ``cells`` cells, as a card's stage 4 leaves them (stages 1, 2 and 4 on
    the CPU, split down to isqrt(cells) a side)."""
    s0, s1 = pair(m, n, seed)
    pcfg = pipeline.PipelineConfig(params=params, device="cpu",
                                   backend="numpy")
    res, end = pipeline.stage1_pass(s0, s1, pcfg)
    cps = pipeline.stage2_march(s0, s1, pcfg, end, res.specials)
    cps = mm.stage4_reduce(s0, s1, cps, params, math.isqrt(cells),
                           stage5_max_cells=cells, device="cpu")
    return s0, s1, pcfg, cps


@needs_native
@pytest.mark.parametrize("seed,k,limit", [
    (1, 0, H100_SHARED), (2, 1, H100_SHARED), (3, 2, H100_SHARED),
    (4, 0, 2500)], ids=["default", "fuzz5", "fuzz11", "mixed"])
def test_stage5_card_route_matches_host(seed, k, limit):
    """Stage 5 through the batched route gives the host route's alignment:
    scores, statistics, gap lists and the CGFF file, byte for byte; the
    ``partitions.card`` counter counts the partitions it took (all of
    them, or those that fit 2500 bytes, the rest on the host)."""
    params = SCORES[k]
    s0, s1, pcfg, cps = crosspoints(700, 690, seed, params, 1 << 12)
    host = pipeline.stage5_emit(s0, s1, pcfg, cps)
    fits = sum(kernels.traceback_fits(b.i - a.i, b.j - a.j, params, limit)
               for a, b in zip(cps, cps[1:]))
    assert fits == len(cps) - 1 if limit == H100_SHARED else \
        0 < fits < len(cps) - 1
    saved, kernels.event_log = kernels.event_log, []
    trace.reset()
    try:
        with routed(on_cpu(limit)):
            card = pipeline.stage5_emit(s0, s1, pcfg, cps)
        counts = dict(trace.counts)
    finally:
        kernels.event_log = saved
        trace.reset()
    same_alignment(card, host)
    assert counts[(None, "partitions")] == len(cps) - 1
    assert counts[(None, "partitions.card")] == fits


@pytest.mark.parametrize("seed", [5, 6])
def test_stage5_on_the_cpu_takes_the_host_route(seed):
    """On the CPU stage 5 takes every partition one at a time, as it
    always did (the same alignment as traceback_segment partition by
    partition), and the card's counter stays at 0."""
    s0, s1, pcfg, cps = crosspoints(500, 520, seed, ScoreParams(), 1 << 12)
    saved, kernels.event_log = kernels.event_log, []
    trace.reset()
    try:
        aln = pipeline.stage5_emit(s0, s1, pcfg, cps)
        counts = dict(trace.counts)
    finally:
        kernels.event_log = saved
        trace.reset()
    assert counts.get((None, "partitions.card"), 0) == 0
    assert counts[(None, "partitions")] == len(cps) - 1
    ref = balign.Alignment(
        sequences=[], method=aln.method, match=1, mismatch=-3, gap_open=3,
        gap_ext=2)
    ref.start, ref.end = aln.start, aln.end
    ref.raw_score = sum(
        smallsw.traceback_segment(
            np.ascontiguousarray(s0[a.i:b.i]),
            np.ascontiguousarray(s1[a.j:b.j]), a.i, a.j, a.type, b.type,
            ScoreParams(), ref)
        for a, b in zip(cps, cps[1:]))
    same_alignment(aln, ref)


@pytest.mark.parametrize("h,w,scores,fits", [
    (512, 512, (1, -3, 3, 2), True),      # the CLI's partitions
    (137, 136, (1, -3, 3, 2), True),      # the library's
    (64, 4096, (1, -3, 3, 2), True),
    (4096, 64, (1, -3, 3, 2), True),
    (0, 0, (1, -3, 3, 2), True),
    (700, 700, (1, -3, 3, 2), False),     # its table passes 227 KB
    (1, 65535, (1, -3, 3, 2), False),     # its row passes 227 KB
    (512, 512, (1, -3, 1 << 17, 1), False),   # gaps near the int32 edge
    (512, 512, (1 << 18, -3, 3, 2), False),   # matches near the edge
    (-1, 4, (1, -3, 3, 2), False)])
def test_traceback_fits(h, w, scores, fits):
    assert bool(kernels.traceback_fits(h, w, ScoreParams(*scores),
                                       H100_SHARED)) is fits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_launches_take_every_partition_once(seed):
    """Every partition in one launch; each launch's block (its largest
    warps, table and row) within the limit; partitions of one launch need
    shared memory within a factor of two of one another."""
    r = np.random.default_rng(seed)
    hw = np.stack([r.integers(0, 520, 300), r.integers(0, 520, 300)], 1)
    hw = hw[kernels.traceback_fits(hw[:, 0], hw[:, 1], ScoreParams(),
                                   H100_SHARED)]
    launches = kernels.traceback_launches(hw, H100_SHARED)
    taken = np.concatenate([idx for idx, *_ in launches])
    assert sorted(taken.tolist()) == list(range(len(hw)))
    for idx, warps, words, cols in launches:
        h, w = hw[idx].T
        assert warps == max(kernels.traceback_warps(int(x)) for x in h)
        assert words == max(kernels.traceback_table_words(int(x), int(y))
                            for x, y in zip(h, w))
        assert cols == w.max() + 1
        assert kernels.traceback_smem(warps, words, cols) <= H100_SHARED
        need = [kernels.traceback_smem(kernels.traceback_warps(int(x)),
                                       kernels.traceback_table_words(
                                           int(x), int(y)), int(y) + 1)
                for x, y in zip(h, w)]
        assert max(need) <= 2 * min(need)


def test_layout():
    hdr, ops, total = kernels.traceback_layout([[3, 4], [0, 0], [2, 0]])
    assert hdr.tolist() == [0, 2, 4]
    assert ops.tolist() == [6, 20, 20]
    assert total == 24


def test_traceback_cuda_refuses_cpu_tensors():
    a = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.traceback_cuda(a, a, np.zeros((1, 6), np.int64), match=1,
                               mismatch=-3, gap_open=3, gap_ext=2)
