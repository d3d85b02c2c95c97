"""The one-launch stage-2 hop's plain version and its host-side rules,
against masa_tpu, on the CPU.

``wavefront.hop_plain`` (the contract of the card's ``kernels.hop_cuda``)
is held against masa_tpu's ``hop_step_device`` (its Pallas strip in
interpret mode, as ``tests/test_pipeline.py`` runs it) at a small hop: hb
= 128 rows (``WavefrontConfig(alpha=1, rs=1)``: a hop there is as tall as
the config's rows), W = 256 columns, in every state case of
``tests/test_torch_hop_chain.py`` (a hit, a miss, an overshoot, a window
reaching column 0, a state entering with ok = 0, and under SW a goal
within reach) x CrosspointType x SW/NW.  Then: ``hop_plain``'s state and
last row are the three plain steps it composes; ``kernels.hop_geometry``'s
shapes; the route ``hop_step`` takes; ``kernels.hop_cuda`` refuses CPU
tensors; a chained march gives the crosspoints, counts and hops of the
three plain steps.  Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masa_tpu.core.aligner import dev_pads
from masa_tpu.ops import wavefront as jwf
from masa_tpu.stages import core as jcore
from masa_tpu.types import InitType as JInit, Recurrence as JRec, ScoreParams
from masa_tpu_torch.ops import kernels
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import core, pipeline
from masa_tpu_torch.types import AlignmentStart, CrosspointType

P = ScoreParams()
KW = dict(match=P.match, mismatch=P.mismatch, gap_open=P.gap_open,
          gap_ext=P.gap_ext)
PREFIX = 700   # unrelated bases before the homolog: windows clear column 0
CUT = 256      # the stored row the hop matches against
HB = 128       # the hop's height: WavefrontConfig(alpha=1, rs=1).rows
W = 256        # its window (stages/core._hop_window at that height)
CASES = ["hit", "miss", "overshoot", "narrow", "ok0"]


@pytest.fixture(scope="module")
def hop():
    """The pair, its reversed views for both packages, and the cut at row
    CUT of an SW and an NW forward pass (masa_tpu's oracle), as (n,)
    int32 buses (index j - 1 -> column j)."""
    rng = np.random.default_rng(1201)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, 600).astype(np.uint8)
    s1 = s0.copy()
    flip = rng.random(len(s1)) < 0.08
    s1[flip] = rng.choice(bases, int(flip.sum()))
    s1 = np.concatenate([rng.choice(bases, PREFIX).astype(np.uint8), s1])
    m, n = len(s0), len(s1)
    cuts = {}
    for sw, rec, init in ((True, JRec.SMITH_WATERMAN, JInit.WITH_ZEROES),
                          (False, JRec.NEEDLEMAN_WUNSCH, JInit.WITH_GAPS)):
        res = jcore.forward_pass(s0, s1, P, rec, init, init,
                                 special_every=CUT, backend="numpy")
        cuts[sw] = tuple(x[1:].astype(np.int32)
                         for x in res.specials.get(CUT))
    pad0, pad1 = dev_pads(n)
    j0r = np.full(m + pad0, jwf.A_SENTINEL, np.int32)
    j0r[:m] = s0[::-1]
    j1r = np.full(n + pad1, jwf.B_SENTINEL, np.int32)
    j1r[:n] = s1[::-1]
    return dict(s0=s0, s1=s1, cuts=cuts, j0r=jnp.asarray(j0r),
                j1r=jnp.asarray(j1r))


def port_args(hop, sw):
    """(a, s1r, cut_h, cut_f) of the hop from row CUT + HB to CUT, as CPU
    tensors."""
    s0, s1 = hop["s0"], hop["s1"]
    m = len(s0)
    s0r = torch.from_numpy(s0[::-1].copy())
    return (s0r[m - CUT - HB:m - CUT], torch.from_numpy(s1[::-1].copy()),
            *(torch.from_numpy(x) for x in hop["cuts"][sw]))


def plain(hop, sw, cj, score, typ, ok=1, last_row=False):
    st = torch.tensor([cj, score, typ, ok], dtype=torch.int32)
    out = torch.full((4,), -7, dtype=torch.int32)
    got = wf.hop_plain(*port_args(hop, sw), st, out, W, sw=sw,
                       last_row=last_row, **KW)
    assert got[0] is out
    return got


def reference(hop, sw, cj, score, typ, ok):
    """masa_tpu's hop_step_device on the same hop, interpret mode."""
    cfg = jwf.WavefrontConfig(alpha=1, rs=1, chunk=256,
                              recurrence=JRec.NEEDLEMAN_WUNSCH,
                              track_best=False, store_lastcol=False,
                              interpret=True, **KW)
    assert cfg.rows == HB
    m, n = len(hop["s0"]), len(hop["s1"])
    i32 = jnp.int32
    out = jwf.hop_step_device(
        cfg, hop["j0r"], hop["j1r"], *(jnp.asarray(x)
                                       for x in hop["cuts"][sw]),
        i32(m - CUT - HB), i32(n), i32(cj), i32(score), i32(typ), i32(ok),
        W=W, sw=sw)
    return [int(x) for x in out]


def goals(hop, sw, cj, typ):
    """The match sums of the hop's window at cj (the plain last row
    against the cut), int64, and their top."""
    _, rh, rf = plain(hop, sw, cj, 0, typ, 0, last_row=True)
    edge = -HB * P.gap_ext - (0 if typ == CrosspointType.GAP_2
                              else P.gap_open)
    k = np.arange(W + 1)
    cut_h, cut_f = hop["cuts"][sw]
    sm = cut_h[cj - 1 - k].astype(np.int64) + np.concatenate(
        [[edge], rh.numpy()])
    sg = cut_f[cj - 1 - k].astype(np.int64) + np.concatenate(
        [[edge], rf.numpy()]) + P.gap_open
    return sm, sg, int(max(sm.max(), sg.max()))


def overshoot(sm, sg, top):
    for goal in range(top - 1, top - 400, -1):
        k = np.nonzero((sm >= goal) | (sg >= goal))[0][0]
        if sm[k] != goal and sg[k] != goal:
            return goal
    raise AssertionError("no overshooting goal near the top")


@pytest.mark.parametrize("typ", list(CrosspointType), ids=lambda t: t.name)
@pytest.mark.parametrize("sw,case", [(True, c) for c in CASES + ["reach"]]
                         + [(False, c) for c in CASES],
                         ids=lambda x: x if isinstance(x, str)
                         else ("sw" if x else "nw"))
def test_hop_plain_is_masa_tpus_hop_step_device(hop, sw, case, typ):
    """hop_plain writes masa_tpu's next state, whatever the case: a hit
    moves (ok = 1), every other case carries the state through with ok =
    0."""
    cj = PREFIX + CUT + HB + 37
    assert core._hop_window(core.Crosspoint(CUT + HB, cj, 10 ** 6, typ),
                            CUT, "auto") == W
    sm, sg, top = goals(hop, sw, cj, int(typ))
    offset = P.gap_open if typ != CrosspointType.MATCH else 0
    score = {"hit": top, "miss": top + 1,
             "overshoot": overshoot(sm, sg, top)}.get(case, top) - offset
    ok = 0 if case == "ok0" else 1
    if case == "narrow":
        cj = W  # the window would reach column 0
    if case == "reach":
        score = min(HB, cj) * P.match
    if sw and case != "reach":
        assert score > min(HB, cj) * P.match  # the premise: out of reach
    got = plain(hop, sw, cj, score, int(typ), ok)[0].tolist()
    assert got == reference(hop, sw, cj, score, int(typ), ok)
    assert got[3] == (case == "hit")
    if case != "hit":
        assert got == [cj, score, int(typ), 0]


@pytest.mark.parametrize("typ", list(CrosspointType), ids=lambda t: t.name)
@pytest.mark.parametrize("cj,ok", [(PREFIX + CUT + HB + 37, 1), (W, 1),
                                   (PREFIX + 400, 0)],
                         ids=["eligible", "narrow", "ok0"])
def test_hop_plain_is_the_three_plain_steps(hop, typ, cj, ok):
    """hop_plain's state and last row are hop_prep_plain, strip_plain and
    hop_match_plain composed (the three launches' plain versions), the
    row swept on the clamped window where the hop is not eligible."""
    sm, sg, top = goals(hop, True, cj if cj > W else PREFIX + 400, int(typ))
    score = top - (P.gap_open if typ != CrosspointType.MATCH else 0)
    st = torch.tensor([cj, score, int(typ), ok], dtype=torch.int32)
    a, s1r, cut_h, cut_f = port_args(hop, True)
    b, bh, bf, ch, ce = wf.hop_prep_plain(s1r, st, W, HB, P.gap_open,
                                          P.gap_ext)
    row = wf.strip_plain(a, b, bh, bf, ch, ce, wf.HOP_CORNER, sw=False,
                         **KW)
    want = torch.empty(4, dtype=torch.int32)
    wf.hop_match_plain(cut_h, cut_f, row.bus_h, row.bus_f, st, want, W, HB,
                       match=P.match, gap_open=P.gap_open,
                       gap_ext=P.gap_ext, sw=True)
    got, rh, rf = plain(hop, True, cj, score, int(typ), ok, last_row=True)
    assert got.tolist() == want.tolist()
    assert torch.equal(rh, row.bus_h) and torch.equal(rf, row.bus_f)
    alone, none_h, none_f = plain(hop, True, cj, score, int(typ), ok)
    assert alone.tolist() == want.tolist() and none_h is none_f is None


@pytest.mark.parametrize("hb,max_cluster,want", [
    (1, 16, (4, 1, 1)), (100, 16, (4, 1, 1)), (512, 16, (4, 4, 1)),
    (512, 8, (4, 4, 1)), (513, 16, (4, 4, 2)), (1000, 16, (4, 4, 2)),
    (8192, 16, (4, 4, 16)), (8192, 8, (8, 4, 8)), (16384, 16, (8, 4, 16)),
    (32768, 16, (8, 8, 16)), (32768, 8, (8, 16, 8)),
    (65536, 16, (8, 16, 16)), (65536, 8, None), (65537, 16, None),
    (131072, 16, None)])
def test_hop_geometry_pins(hb, max_cluster, want):
    """512 rows are one CTA; the CLI's 8192 a cluster; a hop taller than
    a cluster holds takes the three launches (None); every CTA of a
    cluster has rows."""
    geo = kernels.hop_geometry(hb, 2 * hb, 132, max_cluster)
    assert (None if geo is None else tuple(geo)) == want
    if geo is not None:
        assert geo.warps <= kernels.HOP_MAX_WARPS
        assert (geo.cluster - 1) * geo.rows < hb <= geo.cluster * geo.rows
        assert geo.cluster <= max_cluster


def test_hop_geometry_is_bounded_by_the_card():
    assert kernels.hop_geometry(8192, 16384, 4, 16).cluster == 4
    assert kernels.hop_geometry(8192, 16384, 4, 16).rows == 2048


@pytest.mark.parametrize("args", [(0, 16, 132, 8), (16, 0, 132, 8),
                                  (16, 16, 0, 8), (16, 16, 132, 12)])
def test_hop_geometry_refuses_bad_shapes(args):
    with pytest.raises(ValueError):
        kernels.hop_geometry(*args)


def test_hop_cuda_refuses_cpu_tensors(hop):
    st = torch.tensor([PREFIX + 500, 10, 0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.hop_cuda(*port_args(hop, True), st, torch.empty_like(st),
                         W, sw=True, **KW)


def test_hop_step_on_the_cpu_runs_hop_plain(hop, monkeypatch):
    """CPU tensors go to hop_plain, never to the card's route."""
    calls = []
    orig = wf.hop_plain

    def spy(*a, **k):
        calls.append(k.get("last_row", False))
        return orig(*a, **k)

    def no_card(*a, **k):
        raise AssertionError("the card's route was asked")

    monkeypatch.setattr(wf, "hop_plain", spy)
    monkeypatch.setattr(kernels, "hop_route", no_card)
    monkeypatch.setattr(kernels, "hop_cuda", no_card)
    st = torch.tensor([PREFIX + CUT + HB + 37, 10 ** 6, 0, 1],
                      dtype=torch.int32)
    out = torch.empty(4, dtype=torch.int32)
    assert wf.hop_step(*port_args(hop, True), st, out, W, sw=True,
                       **KW) is out
    assert calls == [False]
    with pytest.raises(ValueError, match="W"):
        wf.hop_step(*port_args(hop, True), st, out, len(hop["s1"]),
                    sw=True, **KW)


def three_steps(a, s1r, cut_h, cut_f, st_in, st_out, W, *, match, mismatch,
                gap_open, gap_ext, sw, flags=None):
    """A hop as the three plain steps, always swept: what hop_step ran on
    the CPU before the one launch."""
    hb = a.numel()
    b, bh, bf, ch, ce = wf.hop_prep_plain(s1r, st_in, W, hb, gap_open,
                                          gap_ext)
    out = wf.strip(a, b, bh, bf, ch, ce, wf.HOP_CORNER, match=match,
                   mismatch=mismatch, gap_open=gap_open, gap_ext=gap_ext,
                   sw=False, flags=flags)
    return wf.hop_match_plain(cut_h, cut_f, out.bus_h, out.bus_f, st_in,
                              st_out, W, hb, match=match, gap_open=gap_open,
                              gap_ext=gap_ext, sw=sw)


@pytest.mark.parametrize("start", [AlignmentStart.ANYWHERE,
                                   AlignmentStart.SEQUENCE_1_AND_2],
                         ids=["sw", "global"])
def test_chained_march_is_unchanged_on_the_cpu(start, monkeypatch):
    """A chained march on the CPU gives the same crosspoints, counts and
    hops issued through hop_plain as through the three plain steps."""
    rng = np.random.default_rng(1203)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, 2600).astype(np.uint8)
    s1 = s0.copy()
    flip = rng.random(len(s1)) < 0.08
    s1[flip] = rng.choice(bases, int(flip.sum()))
    s1 = np.concatenate([rng.choice(bases, 1100).astype(np.uint8), s1])
    pcfg = pipeline.PipelineConfig(alignment_start=start, backend="kernel",
                                   flush_interval=512, device="cpu")
    res, ep = pipeline.stage1_pass(s0, s1, pcfg)
    ri, ci = pipeline._mode_inits(start)

    def march():
        stats = core.MarchStats()
        cps = core.reverse_march(
            s0, s1, P, ep, res.specials.copy(), ri, ci, start, device="cpu",
            dev_cache=res.dev_cache.copy(), stats=stats, chain=True)
        return [tuple(int(x) for x in c) for c in cps], stats

    got, stats = march()
    monkeypatch.setattr(wf, "hop_step", three_steps)
    want, want_stats = march()
    assert got == want and stats == want_stats
    assert stats.chained >= 3 and stats.issued >= stats.chained, stats
