"""The port's chained stage-2 hops against masa_tpu, on the CPU.

``wavefront.hop_step`` (``hop_plain`` on CPU tensors: the plain
prologue, strip and epilogue, standing for the card's hop kernel) is held
hop by hop against masa_tpu's host ``reverse_pass_and_match`` (its NumPy
oracle) on the same seeded inputs: every crosspoint type, SW and NW, a
hit, a miss, an overshoot, a window that reaches column 0 (cj < W + 1), a
goal within reach under SW and a state entering with ok = 0.  Then whole
marches: ``reverse_march(chain=True)`` (``_run_hop_chain``,
``_run_arb_hop``) against the port's host march and masa_tpu's host march
(masa_tpu's own chain tests are slow); an endpoint hop off the spacing; a
segment broken by a poisoned cached row, replayed on the host; and a
failing hop or a set error flag, which must raise, not fall back.
Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from masa_tpu.ops import wavefront as jwf
from masa_tpu.stages import core as jcore
from masa_tpu.stages import pipeline as jpipeline
from masa_tpu.types import (AlignmentStart as JStart,
                            Crosspoint as JCrosspoint,
                            CrosspointType as JType, InitType as JInit,
                            Recurrence as JRec, ScoreParams)
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import core, pipeline
from masa_tpu_torch.types import (AlignmentStart, Crosspoint,
                                  CrosspointType, InitType)

P = ScoreParams()
GO, GE = P.gap_open, P.gap_ext
PREFIX = 3000   # unrelated bases before the homolog: windows clear column 0
CUT = 1024      # the stored row a single hop matches against
HB = 200        # that hop's height


def as_tuples(cps):
    return [tuple(int(x) for x in c) for c in cps]


@pytest.fixture(scope="module")
def hop_inputs():
    """s0, s1 and the cut at row CUT of an SW and an NW forward pass
    (masa_tpu's oracle), as (n+1,) int64 rows."""
    rng = np.random.default_rng(901)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, 1400).astype(np.uint8)
    s1 = s0.copy()
    flip = rng.random(len(s1)) < 0.08
    s1[flip] = rng.choice(bases, int(flip.sum()))
    s1 = np.concatenate([rng.choice(bases, PREFIX).astype(np.uint8), s1])
    cuts = {}
    for rec, init in ((JRec.SMITH_WATERMAN, JInit.WITH_ZEROES),
                      (JRec.NEEDLEMAN_WUNSCH, JInit.WITH_GAPS)):
        res = jcore.forward_pass(s0, s1, P, rec, init, init,
                                 special_every=CUT, backend="numpy")
        cuts[rec == JRec.SMITH_WATERMAN] = res.specials.get(CUT)
    return s0, s1, cuts


def port_hop(s0, s1, cut, cj, score, typ, W, sw, ok=1):
    """One plain hop from (CUT + HB, cj) to row CUT: the state it
    writes."""
    m = len(s0)
    s0r = torch.from_numpy(s0[::-1].copy())
    s1r = torch.from_numpy(s1[::-1].copy())
    st = torch.tensor([[cj, score, typ, ok], [0, 0, 0, 0]],
                      dtype=torch.int32)
    cut_h, cut_f = (torch.from_numpy(x[1:].astype(np.int32)) for x in cut)
    wf.hop_step(s0r[m - CUT - HB:m - CUT], s1r, cut_h, cut_f, st[0], st[1],
                W, match=P.match, mismatch=P.mismatch, gap_open=GO,
                gap_ext=GE, sw=sw)
    return st[1].tolist()


def sums(s0, s1, cut, cj, typ, W):
    """The match sums of the hop's window (the port's plain reverse row
    against the cut), int64: what the goal is chosen from."""
    s1r = torch.from_numpy(s1[::-1].copy())
    m = len(s0)
    st = torch.tensor([cj, 0, typ, 1], dtype=torch.int32)
    b, bh, bf, ch, ce = wf.hop_prep_plain(s1r, st, W, HB, GO, GE)
    a = torch.from_numpy(s0[::-1].copy())[m - CUT - HB:m - CUT]
    out = wf.strip_plain(a, b, bh, bf, ch, ce, 0, match=P.match,
                         mismatch=P.mismatch, gap_open=GO, gap_ext=GE,
                         sw=False)
    edge = -HB * GE - (0 if typ == CrosspointType.GAP_2 else GO)
    rh = np.concatenate([[edge], out.bus_h.numpy()]).astype(np.int64)
    rf = np.concatenate([[edge], out.bus_f.numpy()]).astype(np.int64)
    fh = cut[0][cj - np.arange(W + 1)].astype(np.int64)
    ff = cut[1][cj - np.arange(W + 1)].astype(np.int64)
    return fh + rh, ff + rf + GO


def overshoot(sm, sg, top):
    """The highest goal below ``top`` whose first stop passes it without
    an equal sum there (an error-sum stop, no hit)."""
    for goal in range(top - 1, top - 400, -1):
        k = np.nonzero((sm >= goal) | (sg >= goal))[0][0]
        if sm[k] != goal and sg[k] != goal:
            return goal
    raise AssertionError("no overshooting goal near the top")


CASES = ["hit", "miss", "overshoot", "narrow", "ok0"]


@pytest.mark.parametrize("typ", list(CrosspointType), ids=lambda t: t.name)
@pytest.mark.parametrize("sw,case", [(True, c) for c in CASES + ["reach"]]
                         + [(False, c) for c in CASES],
                         ids=lambda x: x if isinstance(x, str)
                         else ("sw" if x else "nw"))
def test_hop_step_matches_the_host_pass(hop_inputs, sw, typ, case):
    """A plain hop gives masa_tpu's host pass's crosspoint where the host
    would take its window, and hands the hop back (ok = 0, the state
    carried through) where the host would not (cj < W + 1; under SW a
    goal within reach) or the match does not hit."""
    s0, s1, cuts = hop_inputs
    cut = cuts[sw]
    ci = CUT + HB
    cj = PREFIX + ci + 37
    cp0 = Crosspoint(ci, cj, 10 ** 6, typ)
    W = core._hop_window(cp0, CUT, "auto")
    assert W == 512 and cj >= W + 1
    sm, sg = sums(s0, s1, cut, cj, typ, W)
    top = int(max(sm.max(), sg.max()))
    offset = GO if typ != CrosspointType.MATCH else 0
    score = {"hit": top, "miss": top + 1,
             "overshoot": overshoot(sm, sg, top)}.get(case, top) - offset
    ok = 0 if case == "ok0" else 1
    if case == "narrow":
        cj = W          # the window would reach column 0
    if case == "reach":
        score = min(HB, cj) * P.match  # the start may lie inside the hop
    if sw and case != "reach":
        assert score > min(HB, cj) * P.match  # the premise: out of reach
    got = port_hop(s0, s1, cut, cj, score, int(typ), W, sw, ok)
    if case in ("narrow", "reach", "ok0"):
        assert got == [cj, score, int(typ), 0]
        return
    rm = jcore.reverse_pass_and_match(
        s0, s1, P, JCrosspoint(ci, cj, score, JType(int(typ))), CUT,
        cut[0], cut[1], cj - W, False, backend="numpy")
    if case == "hit":
        assert rm.crosspoint is not None
        assert got == [rm.crosspoint.j, rm.crosspoint.score,
                       int(rm.crosspoint.type), 1]
        assert rm.crosspoint.i == CUT
    else:
        assert rm.crosspoint is None and not rm.start_found
        assert got == [cj, score, int(typ), 0]


@pytest.mark.parametrize("typ", list(CrosspointType), ids=lambda t: t.name)
def test_hop_prep_is_masa_tpus_border_synthesis(hop_inputs, typ):
    """The prologue's window, entering bus and left border are masa_tpu's
    (``_sliced_prep``'s window of the reversed seq1, ``hop_bus_init``,
    ``border_h_traced``), the codes ``init_types_for``'s, and the corner
    border_h(code, 0) = 0 for both codes."""
    s0, s1, _ = hop_inputs
    W, cj = 512, 2000
    s1r = torch.from_numpy(s1[::-1].copy())
    st = torch.tensor([cj, 5, int(typ), 1], dtype=torch.int32)
    b, bh, bf, ch, ce = wf.hop_prep_plain(s1r, st, W, HB, GO, GE)
    ri, ci = jcore.init_types_for(JType(int(typ)))
    want_h, want_f = jwf.hop_bus_init(int(ri), W, W, GO, GE)
    assert bh.tolist() == np.asarray(want_h).tolist()
    assert bf.tolist() == np.asarray(want_f).tolist()
    k = np.arange(1, HB + 1, dtype=np.int32)
    assert ch.tolist() == np.asarray(
        jwf.border_h_traced(int(ci), k, GO, GE)).tolist()
    assert (ce == wf.NEG).all()
    assert b.tolist() == s1[::-1][len(s1) - cj:len(s1) - cj + W].tolist()
    codes = [int(c) for c in wf.hop_codes(st[2])]
    assert codes == [int(ri), int(ci)]
    for code in (InitType.WITH_GAPS, InitType.WITH_GAPS_OPENED):
        assert wf.border_h(code, torch.tensor([0]), GO, GE).item() \
            == wf.HOP_CORNER == 0


def test_the_card_checks_cases_through_the_plain_epilogue():
    """The cases the card check holds the kernel to
    (``tools/hop_tune.match_cases``) come out as labelled through the
    plain epilogue, and each eligible one is masa_tpu's
    ``goal_match_device`` verdict with its state update."""
    import jax.numpy as jnp

    from masa_tpu_torch.tools import hop_tune

    n, W, hb = 1 << 13, 1024, 128
    cut_h, cut_f, rev_h, rev_f, cases = hop_tune.match_cases(
        np.random.default_rng(3), n, W, hb)
    args = [torch.from_numpy(x) for x in (cut_h, cut_f, rev_h, rev_f)]
    jargs = [jnp.asarray(x) for x in (cut_h, cut_f, rev_h, rev_f)]
    labels = set()
    for label, cj, score, typ, ok, sw in cases:
        labels.add(label)
        out = torch.empty(4, dtype=torch.int32)
        wf.hop_match_plain(*args, torch.tensor([cj, score, typ, ok],
                                               dtype=torch.int32), out, W,
                           hb, match=P.match, gap_open=GO, gap_ext=GE, sw=sw)
        got = out.tolist()
        if label != "random":
            assert got[3] == label.startswith("hit"), (label, got)
        if not (ok and cj >= W + 1
                and not (sw and score <= min(hb, cj) * P.match)):
            assert got == [cj, score, typ, 0]
            continue
        edge = jnp.int32(-hb * GE - (0 if typ == 2 else GO))
        status, k, val = (int(x) for x in jwf.goal_match_device(
            *jargs, jnp.int32(cj), jnp.int32(score + (GO if typ else 0)),
            edge, edge, W1=W + 1, go=GO))
        assert got == ([cj - k, val, 0 if status == 0 else 2, 1]
                       if status in (0, 1) else [cj, score, typ, 0])
    assert labels == {"hit at 0", "hit", "no stop", "overshoot", "ok 0",
                      "cj < W + 1", "reachable", "random"}


# --- whole marches ------------------------------------------------------


def stage1(s0, s1, start):
    """Stage 1 of both packages at a special row every 512: the port's on
    the plain strips with its rows kept (CPU tensors stand for the card),
    masa_tpu's through its oracle."""
    pcfg = pipeline.PipelineConfig(alignment_start=start, backend="kernel",
                                   flush_interval=512, device="cpu")
    jpcfg = jpipeline.PipelineConfig(alignment_start=JStart(int(start)),
                                     backend="numpy", flush_interval=512)
    res, ep = pipeline.stage1_pass(s0, s1, pcfg)
    jres, jep = jpipeline.stage1_pass(s0, s1, jpcfg)
    assert tuple(ep) == tuple(jep)
    return res, ep, jres, jep


def march(s0, s1, res, ep, start, chain, cache=None, stats=None):
    ri, ci = pipeline._mode_inits(start)
    cache = cache if cache is not None else res.dev_cache
    return as_tuples(core.reverse_march(
        s0, s1, P, ep, res.specials.copy(), ri, ci, start, device="cpu",
        dev_cache=cache.copy(), stats=stats, chain=chain))


def jmarch(s0, s1, jres, jep, start):
    import copy

    ri, ci = jpipeline._mode_inits(JStart(int(start)))
    return as_tuples(jcore.reverse_march(
        s0, s1, P, jep, copy.deepcopy(jres.specials), ri, ci,
        JStart(int(start)), backend="numpy"))


@pytest.fixture(scope="module")
def homologs():
    rng = np.random.default_rng(907)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, 3000).astype(np.uint8)
    keep = rng.random(len(s0)) > 0.01          # deletions
    s1 = s0[keep].copy()
    flip = rng.random(len(s1)) < 0.08          # substitutions
    s1[flip] = rng.choice(bases, int(flip.sum()))
    return s0, np.concatenate([rng.choice(bases, 1200).astype(np.uint8),
                               s1])


@pytest.mark.parametrize("start", [AlignmentStart.ANYWHERE,
                                   AlignmentStart.SEQUENCE_1_AND_2],
                         ids=["sw", "global"])
def test_chained_march_matches_both_host_marches(homologs, start):
    """reverse_march(chain=True) gives the port's host march and
    masa_tpu's host march crosspoint for crosspoint, with hops chained."""
    s0, s1 = homologs
    res, ep, jres, jep = stage1(s0, s1, start)
    stats = core.MarchStats()
    chained = march(s0, s1, res, ep, start, True, stats=stats)
    host_stats = core.MarchStats()
    host = march(s0, s1, res, ep, start, False, stats=host_stats)
    assert chained == host == jmarch(s0, s1, jres, jep, start)
    assert stats.chained >= 3 and stats.segments >= 1, stats
    assert stats.dev_matches >= stats.chained
    assert host_stats.chained == host_stats.segments == 0


def test_chain_is_off_on_the_cpu_unless_asked(homologs):
    """chain=None: on a card with the row cache and min_dist 1 only; a
    chain without the cache, or with min_dist > 1, is refused."""
    s0, s1 = homologs
    start = AlignmentStart.ANYWHERE
    res, ep, _, _ = stage1(s0, s1, start)
    stats = core.MarchStats()
    march(s0, s1, res, ep, start, None, stats=stats)
    assert stats.segments == 0
    ri, ci = pipeline._mode_inits(start)
    for kw in (dict(dev_cache=None), dict(dev_cache=res.dev_cache,
                                          min_dist=2)):
        with pytest.raises(ValueError, match="chained march"):
            core.reverse_march(s0, s1, P, ep, res.specials.copy(), ri, ci,
                               start, device="cpu", chain=True, **kw)


def test_endpoint_hop_off_the_spacing_runs_on_the_device(homologs,
                                                         monkeypatch):
    """A global march whose endpoint row is not on the 512-row spacing
    (3000 = 5 x 512 + 440): the endpoint hop runs as a hop of its own
    height on the device (_run_arb_hop), as masa_tpu's test_pipeline
    case does, with the host march's crosspoints."""
    s0, s1 = homologs
    start = AlignmentStart.SEQUENCE_1_AND_2
    res, ep, jres, jep = stage1(s0, s1, start)
    assert ep.i % 512 == 440
    fired = {"n": 0, "hit": 0}
    orig = core._run_arb_hop

    def spy(*a, **k):
        fired["n"] += 1
        got = orig(*a, **k)
        fired["hit"] += bool(got and got[0])
        return got

    monkeypatch.setattr(core, "_run_arb_hop", spy)
    host = march(s0, s1, res, ep, start, False)
    assert fired["n"] == 0
    chained = march(s0, s1, res, ep, start, True)
    assert fired["hit"] >= 1, fired
    assert chained == host == jmarch(s0, s1, jres, jep, start)


def test_broken_segment_replays_on_the_host(homologs):
    """A cached row poisoned to -INF (the store's row stays true): the
    segment's hop there does not hit, the segment hands on the hops before
    it, and the host replays that hop (its window widened to the store's
    row) to the same crosspoints; the chain then goes on."""
    s0, s1 = homologs
    start = AlignmentStart.SEQUENCE_1_AND_2
    res, ep, _, _ = stage1(s0, s1, start)
    want = march(s0, s1, res, ep, start, False)
    rows = sorted(res.dev_cache._rows)
    bad = rows[len(rows) // 2]
    poisoned = res.dev_cache.copy()
    h, f = poisoned._rows[bad]
    poisoned._rows[bad] = (torch.full_like(h, wf.NEG), f)
    stats = core.MarchStats()
    got = march(s0, s1, res, ep, start, True, cache=poisoned, stats=stats)
    assert got == want
    assert stats.chain_breaks >= 1 and stats.chained >= 3, stats
    assert stats.host_matches >= 1


def test_failing_hop_raises_and_does_not_fall_back(homologs, monkeypatch):
    """No fallback: a hop step that raises, or a hop whose error flag comes
    back set (on the card the hop kernel's, or the strip kernel's on the
    three-launch route), makes the march raise."""
    s0, s1 = homologs
    start = AlignmentStart.SEQUENCE_1_AND_2
    res, ep, _, _ = stage1(s0, s1, start)

    def broken(*a, **k):
        raise RuntimeError("hop kernel launch failed")

    with monkeypatch.context() as mp:
        mp.setattr(wf, "hop_step", broken)
        with pytest.raises(RuntimeError, match="hop kernel launch failed"):
            march(s0, s1, res, ep, start, True)
    orig = wf.hop_step

    def flagged(*a, flags=None, **k):
        if flags is not None:
            flags.append(torch.ones(1, dtype=torch.int32))
        return orig(*a, flags=flags, **k)

    monkeypatch.setattr(wf, "hop_step", flagged)
    with pytest.raises(RuntimeError, match="hop kernel"):
        march(s0, s1, res, ep, start, True)
