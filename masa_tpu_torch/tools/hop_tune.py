"""Check and time the stage-2 hop kernels (``csrc/hop.cu``) on a card.

    python -m masa_tpu_torch.tools.hop_tune [--variants] [--check-only]

``check`` holds the three-launch route's prologue and epilogue
(``kernels.hop_prep_cuda``, ``kernels.hop_match_cuda``) against their
plain versions (``wavefront.hop_prep_plain``, ``hop_match_plain``) on the
same inputs on the card, byte for byte: every crosspoint type, SW and NW,
a hit at k = 0 and further on, no stop, an overshoot, a state entering
with ok = 0, a window that reaches column 0 (cj < W + 1), a goal within
reach under SW, and random states.  ``check_fused`` holds the one-launch
hop (``kernels.hop_cuda``) against ``wavefront.hop_plain`` in the same
cases, its state with and without the last row asked for, and the whole
last row.

``timed`` times, at one hop's shape, the three launches back to back
(kernel 1 as the hop runs it, ``hop_prep``, ``hop_match``, and the whole
three-launch ``wavefront.hop_three``) against the one launch (its stop
planted at k = hb, where a near-diagonal path crosses, and swept to the
end), by CUDA events around launches queued behind a wait on the card;
then a segment's worth of hops issued as ``stages/core._run_segment``
issues them, with events around each launch (the in-path figure, which
also holds the host's gaps between launches when the card waits on the
host) and the host's issue time a hop.  ``variants`` times the one
launch at every CTA shape and cluster that covers the hop.

``main`` checks at a small shape and at the main paths' hops (a cut of
2^20; the bench's W 1024, hb 512, the CLI's W 16384, hb 8192, and one hop
past a CTA), then times those and a tall hop (W 65536, hb 32768); prints
one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from masa_tpu_torch.ops import kernels
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.types import ScoreParams

P = ScoreParams()
GO, GE = P.gap_open, P.gap_ext
# the epilogue's cases, each built at every shape ``check`` is given
LABELS = ("hit at 0", "hit", "no stop", "overshoot", "ok 0", "cj < W + 1",
          "reachable", "random")


def match_sums(cut_h, cut_f, rev_h, rev_f, cj, typ, W, hb):
    """The epilogue's sums over k = 0..W, int64 on the host."""
    edge = -hb * GE - (0 if typ == 2 else GO)
    k = np.arange(W + 1)
    rh = np.concatenate([[edge], rev_h[:W]]).astype(np.int64)
    rf = np.concatenate([[edge], rev_f[:W]]).astype(np.int64)
    return (cut_h[cj - 1 - k].astype(np.int64) + rh,
            cut_f[cj - 1 - k].astype(np.int64) + rf + GO)


def first_stop(sm, sg, goal) -> int:
    hit = np.nonzero((sm >= goal) | (sg >= goal))[0]
    return int(hit[0]) if len(hit) else len(sm)


def match_cases(rng, n: int, W: int, hb: int):
    """cut_h, cut_f, rev_h, rev_f (host arrays) and the epilogue's cases
    (label, cj, score, type, ok, sw); the cut's values lie well above the reachable bound
    hb * match, so the SW cases are eligible unless built not to be."""
    cut_h = rng.integers(3 * hb, 3 * hb + 400, n).astype(np.int32)
    cut_f = (cut_h - rng.integers(0, 6, n)).astype(np.int32)
    rev_h = rng.integers(-200, 0, W).astype(np.int32)
    rev_f = (rev_h - rng.integers(0, 6, W)).astype(np.int32)
    out = []
    for sw in (True, False):
        for typ in (0, 1, 2):
            off = GO if typ else 0
            cj = int(rng.integers(W + 1, n + 1))
            sm, sg = match_sums(cut_h, cut_f, rev_h, rev_f, cj, typ, W, hb)
            top = int(max(sm.max(), sg.max()))
            goals = {"hit at 0": int(max(sm[0], sg[0])), "hit": top,
                     "no stop": top + 1}
            for g in range(top - 1, top - 2000, -1):
                k = first_stop(sm, sg, g)
                if sm[k] != g and sg[k] != g:
                    goals["overshoot"] = g
                    break
            for label, goal in goals.items():
                out.append((label, cj, goal - off, typ, 1, sw))
            out.append(("ok 0", cj, top - off, typ, 0, sw))
            out.append(("cj < W + 1", int(rng.integers(1, W + 1)), top - off,
                        typ, 1, sw))
            if sw:
                out.append(("reachable", cj, min(hb, cj) * P.match, typ, 1,
                            sw))
            for _ in range(3):
                out.append(("random", int(rng.integers(1, n + 1)),
                            int(rng.integers(-10 ** 6, 10 ** 6)), typ,
                            int(rng.integers(0, 2)), sw))
    return cut_h, cut_f, rev_h, rev_f, out


def check(dev, n: int = 1 << 16, W: int = 4096, hb: int = 512,
          seed: int = 0) -> tuple[int, dict]:
    """Both kernels against their plain versions on the card; returns the
    largest |difference| (0, or it raises) and the cases by label."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    cut_h, cut_f, rev_h, rev_f, cases = match_cases(rng, n, W, hb)
    args = [t(x) for x in (cut_h, cut_f, rev_h, rev_f)]
    s1r = t(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))
    seen: dict = {}
    for label, cj, score, typ, ok, sw in cases:
        seen[label] = seen.get(label, 0) + 1
        st = t(np.array([cj, score, typ, ok], np.int32))
        outs = []
        for fn in (kernels.hop_match_cuda, wf.hop_match_plain):
            o = torch.empty(4, dtype=torch.int32, device=dev)
            fn(*args, st, o, W, hb, match=P.match, gap_open=GO, gap_ext=GE,
               sw=sw)
            outs.append(o.tolist())
        if outs[0] != outs[1]:
            raise AssertionError(f"hop_match, {label} (cj {cj}, score "
                                 f"{score}, type {typ}, ok {ok}, sw {sw}): "
                                 f"kernel {outs[0]}, plain {outs[1]}")
        hit = outs[1][3] == 1
        if label.startswith("hit") != hit and label != "random":
            raise AssertionError(f"the case {label} came out ok = "
                                 f"{outs[1][3]}")
        # the prologue from the same state, and at the ends of the sequence
        for h, w in ((hb, W), (1, 1), (W + 7, 3)):
            k = kernels.hop_prep_cuda(s1r, st, w, h, GO, GE)
            p = wf.hop_prep_plain(s1r, st, w, h, GO, GE)
            for x, y in zip(k, p):
                if not torch.equal(x, y):
                    raise AssertionError(f"hop_prep at {h} x {w}, state "
                                         f"{st.tolist()}")
    torch.cuda.synchronize(dev)
    missing = set(LABELS) - set(seen)
    if missing:
        raise AssertionError(f"hop_tune.check at n {n}, W {W}, hb {hb} "
                             f"built no case {sorted(missing)}")
    return 0, seen


def _events_ms(fn, iters: int, queued: bool = True) -> float:
    """Milliseconds a call by events around ``iters`` calls.  ``queued``:
    the calls are issued behind a wait on the card, so that the events
    see the kernels back to back and not the host's time to issue them
    (a kernel's time); the plain versions read the state on the host and
    are timed as they run."""
    fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(200_000_000)  # ~0.1 s: the calls queue behind it
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _input(rng, n: int, W: int, hb: int, cj: int):
    """s1r (n random bases) and the hop's rows a: the window at n - cj
    read down its diagonal, a tenth of it changed, so that the reverse
    pass has a near-diagonal path."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    s1r = rng.choice(bases, n).astype(np.uint8)
    j0 = min(max(n - cj, 0), n - W)
    a = np.resize(s1r[j0:j0 + min(hb, W)], hb).copy()
    flip = rng.random(hb) < 0.1
    a[flip] = rng.choice(bases, int(flip.sum()))
    return s1r, a


def _t(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _state(cj, score, typ, ok, dev):
    return _t(np.array([cj, score, typ, ok], np.int32), dev)


def fused_cases(rng, n: int, W: int, hb: int):
    """The one-launch hop's inputs and cases at one shape: per crosspoint
    type a column cj (a "window" case, whose label cases ``check_fused``
    finds from that window's plain last row), a column cj < W + 1 (whose
    window is clamped to the sequence's end) and random states at either.
    Returns (s1r, a, cut_h, cut_f, cases); a case is (label, cj, score,
    type, ok, sw)."""
    cj0 = int(rng.integers(W + 1 + hb, n + 1))
    s1r, a = _input(rng, n, W, hb, cj0)
    # the cut well above the reverse row's reach: every label but
    # "reachable" is out of reach under SW
    cut_h = rng.integers(8 * (hb + W), 8 * (hb + W) + 400, n).astype(np.int32)
    cut_f = (cut_h - rng.integers(0, 6, n)).astype(np.int32)
    cases = []
    for typ in (0, 1, 2):
        cj = cj0 if typ == 0 else int(rng.integers(W + 1, n + 1))
        narrow = int(rng.integers(1, W + 1))
        for sw in (True, False):
            cases.append(("window", cj, 0, typ, 1, sw))
            cases.append(("cj < W + 1", narrow, 10 ** 6, typ, 1, sw))
            for _ in range(2):
                cases.append(("random", (cj, narrow)[int(rng.integers(2))],
                              int(rng.integers(-10 ** 6, 10 ** 6)), typ,
                              int(rng.integers(0, 2)), sw))
    return s1r, a, cut_h, cut_f, cases


def _labelled(cut_h, cut_f, rev_h, rev_f, cj, typ, W, hb, sw):
    """The label cases of one window from its plain last row: (label,
    score, ok)."""
    off = GO if typ else 0
    sm, sg = match_sums(cut_h, cut_f, rev_h, rev_f, cj, typ, W, hb)
    top = int(max(sm.max(), sg.max()))
    goals = {"hit at 0": int(max(sm[0], sg[0])), "hit": top,
             "no stop": top + 1}
    for g in range(top - 1, top - 2000, -1):
        k = first_stop(sm, sg, g)
        if sm[k] != g and sg[k] != g:
            goals["overshoot"] = g
            break
    out = [(label, goal - off, 1) for label, goal in goals.items()]
    out.append(("ok 0", top - off, 0))
    if sw:
        out.append(("reachable", min(hb, cj) * P.match, 1))
    return out


def check_fused(dev, n: int = 1 << 16, W: int = 1024, hb: int = 512,
                seed: int = 0) -> tuple[int, dict]:
    """``kernels.hop_cuda`` against ``wavefront.hop_plain`` on the card in
    every label case of ``LABELS``: the state with the last row asked for
    and without (the sweep then ends at the first stop), and the whole
    last row.  The plain hop sweeps each window once (``hop_plain`` with
    its last row); the states of that window are its epilogue
    (``hop_match_plain``) on that row, as ``hop_plain`` composes them.
    Returns the largest |difference| (0, or it raises) and the cases by
    label."""
    rng = np.random.default_rng(seed)
    s1r, a, cut_h, cut_f, cases = fused_cases(rng, n, W, hb)
    d_s1r, d_a, d_ch, d_cf = (_t(x, dev) for x in (s1r, a, cut_h, cut_f))
    kw = dict(match=P.match, mismatch=P.mismatch, gap_open=GO, gap_ext=GE)
    rows: dict = {}  # j0, type -> the plain last row (host arrays)

    def plain(cj, score, typ, ok, sw):
        j0 = min(max(n - cj, 0), n - W)
        st = _state(cj, score, typ, ok, dev)
        out = torch.empty(4, dtype=torch.int32, device=dev)
        if (j0, typ) not in rows:
            _, rh, rf = wf.hop_plain(d_a, d_s1r, d_ch, d_cf, st, out, W,
                                     sw=sw, last_row=True, **kw)
            rows[j0, typ] = rh, rf
        else:
            wf.hop_match_plain(d_ch, d_cf, *rows[j0, typ], st, out, W, hb,
                               match=P.match, gap_open=GO, gap_ext=GE,
                               sw=sw)
        return st, out.tolist(), rows[j0, typ]

    todo = []
    for label, cj, score, typ, ok, sw in cases:
        if label != "window":
            todo.append((label, cj, score, typ, ok, sw))
            continue
        _, _, (rh, rf) = plain(cj, 0, typ, 0, sw)
        for lab, sc, k in _labelled(cut_h, cut_f, rh.cpu().numpy(),
                                    rf.cpu().numpy(), cj, typ, W, hb, sw):
            todo.append((lab, cj, sc, typ, k, sw))
    seen: dict = {}
    for label, cj, score, typ, ok, sw in todo:
        seen[label] = seen.get(label, 0) + 1
        st, want, (rh, rf) = plain(cj, score, typ, ok, sw)
        for last_row in (True, False):
            out = torch.full((4,), -7, dtype=torch.int32, device=dev)
            _, kh, kf = kernels.hop_cuda(d_a, d_s1r, d_ch, d_cf, st, out, W,
                                         sw=sw, last_row=last_row, **kw)
            what = (f"hop_kernel {label} at {hb} x {W} (cj {cj}, score "
                    f"{score}, type {typ}, ok {ok}, sw {sw}, last row "
                    f"{last_row})")
            if out.tolist() != want:
                raise AssertionError(f"{what}: kernel {out.tolist()}, "
                                     f"plain {want}")
            if last_row and not (torch.equal(kh, rh) and torch.equal(kf, rf)):
                d = max(int((kh.long() - rh.long()).abs().max()),
                        int((kf.long() - rf.long()).abs().max()))
                raise AssertionError(f"{what}: the last row differs (max "
                                     f"|diff| {d})")
        if label not in ("random", "window") \
                and label.startswith("hit") != (want[3] == 1):
            raise AssertionError(f"the case {label} came out {want}")
    torch.cuda.synchronize(dev)
    missing = set(LABELS) - set(seen)
    if missing:
        raise AssertionError(f"check_fused at n {n}, W {W}, hb {hb} built "
                             f"no case {sorted(missing)}")
    return 0, seen


def planted(dev, n: int, W: int, hb: int, seed: int = 1):
    """A hop's inputs on the card whose match first stops at k = hb, a hit
    (the cut built from the window's plain last row: every sum before k =
    hb one below the goal), as a near-diagonal path crosses.  Returns
    (args, state): ``args`` = (a, s1r, cut_h, cut_f) on the card,
    ``state`` the eligible SW entering state."""
    rng = np.random.default_rng(seed)
    cj = n // 2 + W
    s1r, a = _input(rng, n, W, hb, cj)
    args = [_t(x, dev) for x in (a, s1r)]
    st = _state(cj, 0, 0, 0, dev)
    out = torch.empty(4, dtype=torch.int32, device=dev)
    dummy = torch.zeros(n, dtype=torch.int32, device=dev)
    _, rh, _ = wf.hop_plain(*args, dummy, dummy, st, out, W, sw=False,
                             last_row=True, match=P.match,
                             mismatch=P.mismatch, gap_open=GO, gap_ext=GE)
    goal = 10 ** 6
    rev = np.concatenate([[-hb * GE - GO], rh.cpu().numpy()]).astype(np.int64)
    k = np.arange(W + 1)
    cut_h = rng.integers(0, 1000, n).astype(np.int64)
    cut_h[cj - 1 - k] = goal - rev - (k < hb)
    cut_f = cut_h - 100
    return (args + [_t(cut_h.astype(np.int32), dev),
                    _t(cut_f.astype(np.int32), dev)],
            _state(cj, goal, 0, 1, dev))


def timed(dev, n: int = 1 << 20, W: int = 16384, hb: int = 8192,
          iters: int = 50, seed: int = 1, segment: int = 32) -> dict:
    """Both forms of one hop at (n, W, hb) on the planted inputs
    (``planted``: the first stop at k = hb, a hit), by events around
    ``iters`` launches queued back to back behind a wait: the three
    launches (``hop_prep``, kernel 1 NW with nothing tracked, ``hop_match``,
    each alone, and ``wavefront.hop_three`` whole), the one launch
    (``hop``) and the one launch swept to the end (``hop_full``: no stop,
    as with the last row asked for); ``hop_plain``, ``hop_prep_plain``
    and ``hop_match_plain`` by the host clock around a call that ends in a
    synchronise (``plain_ms``).  Every form's state is held equal to
    ``hop_plain``'s.  Then
    ``segment`` hops issued as a chained segment issues them, with the
    state left on the card: events around each launch (``in_path``: ms a
    hop summed by kernel) and the host's issue time a hop (``issue_ms``:
    host clock around the issuing alone, no events, the card idle at its
    start).  Returns a dict of ms, the
    shape, the first stop, the launches' geometry and the bytes each
    form must move."""
    kw = dict(match=P.match, mismatch=P.mismatch, gap_open=GO, gap_ext=GE,
              sw=True)
    (a, s1r, cut_h, cut_f), st = planted(dev, n, W, hb, seed)
    no_stop = st.clone()
    no_stop[1] += 1  # the goal one above every sum: the sweep runs out
    outs = {k: torch.empty(4, dtype=torch.int32, device=dev)
            for k in ("plain", "three", "hop", "hop_full", "plain_full")}

    def clock(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3, got

    plain_ms = {"hop": clock(lambda: wf.hop_plain(
        a, s1r, cut_h, cut_f, st, outs["plain"], W, **kw))[0]}
    wf.hop_plain(a, s1r, cut_h, cut_f, no_stop, outs["plain_full"], W, **kw)
    want = outs["plain"].tolist()
    if want != [st[0].item() - hb, cut_h[st[0].item() - 1 - hb].item(), 0,
                1]:
        raise AssertionError(f"the planted hop did not hit at k = {hb}: "
                             f"{want}")
    prep = kernels.hop_prep_cuda(s1r, st, W, hb, GO, GE)
    strip_kw = dict(match=P.match, mismatch=P.mismatch, gap_open=GO,
                    gap_ext=GE, sw=False)
    bus = wf.strip(a, *prep, wf.HOP_CORNER, **strip_kw)
    plain_ms["hop_prep"], want_prep = clock(
        lambda: wf.hop_prep_plain(s1r, st, W, hb, GO, GE))
    plain_ms["hop_match"], _ = clock(lambda: wf.hop_match_plain(
        cut_h, cut_f, bus.bus_h, bus.bus_f, st, outs["plain_full"], W, hb,
        match=P.match, gap_open=GO, gap_ext=GE, sw=True))
    if not all(torch.equal(x, y) for x, y in zip(prep, want_prep)) \
            or outs["plain_full"].tolist() != want:
        raise AssertionError(f"hop_prep or hop_match at {hb} x {W} differs "
                             f"from its plain version")
    wf.hop_plain(a, s1r, cut_h, cut_f, no_stop, outs["plain_full"], W, **kw)
    sink: list = []  # error flags, read once at the end: no sync a launch
    forms = {
        "hop_prep": lambda: kernels.hop_prep_cuda(s1r, st, W, hb, GO, GE),
        "strip": lambda: wf.strip(a, *prep, wf.HOP_CORNER, flags=sink,
                                  **strip_kw),
        "hop_match": lambda: kernels.hop_match_cuda(
            cut_h, cut_f, bus.bus_h, bus.bus_f, st, outs["three"], W, hb,
            match=P.match, gap_open=GO, gap_ext=GE, sw=True),
        "three": lambda: wf.hop_three(a, s1r, cut_h, cut_f, st,
                                      outs["three"], W, flags=sink, **kw),
        "hop": lambda: kernels.hop_cuda(a, s1r, cut_h, cut_f, st,
                                        outs["hop"], W, flags=sink, **kw),
        "hop_full": lambda: kernels.hop_cuda(a, s1r, cut_h, cut_f, no_stop,
                                             outs["hop_full"], W, flags=sink,
                                             **kw),
    }
    before = {k: getattr(kernels, f"{k}_cuda").launches
              for k in ("strip", "hop_prep", "hop_match", "hop")}
    res = {"shape": {"n": n, "W": W, "hb": hb, "first_stop": hb},
           "geometry": kernels.hop_route(hb, W, dev),
           "plain_ms": plain_ms}
    res["ms"] = {name: _events_ms(fn, iters) for name, fn in forms.items()}
    kernels.check_flags(torch.cat(sink).tolist())
    for name in ("three", "hop"):
        if outs[name].tolist() != want:
            raise AssertionError(f"{name} at {hb} x {W}: "
                                 f"{outs[name].tolist()}, plain {want}")
    if outs["hop_full"].tolist() != outs["plain_full"].tolist():
        raise AssertionError(f"hop_full at {hb} x {W}: "
                             f"{outs['hop_full'].tolist()}, plain "
                             f"{outs['plain_full'].tolist()}")
    res["in_path"], res["issue_ms"] = {}, {}
    for name, step in (("three", wf.hop_three), ("hop", kernels.hop_cuda)):
        sts = torch.empty((segment + 1, 4), dtype=torch.int32, device=dev)
        sts[:] = st

        def issue():
            flags: list = []
            t0 = time.perf_counter()
            for t in range(segment):
                step(a, s1r, cut_h, cut_f, sts[0], sts[t + 1], W,
                     flags=flags, **kw)
            secs = time.perf_counter() - t0
            return torch.cat([sts[1:].reshape(-1)] + flags).cpu(), secs

        issue()
        torch.cuda.synchronize(dev)
        got, secs = issue()
        res["issue_ms"][name] = secs * 1e3 / segment
        kernels.event_log = []
        issue()
        res["in_path"][name] = {k: v / segment for k, v in
                                kernels.drain_events().items()}
        kernels.event_log = None
        if got[:4 * segment].view(segment, 4).tolist() != [want] * segment \
                or got[4 * segment:].any():
            raise AssertionError(f"a segment of {name} at {hb} x {W}")
    # measurements, not the main path's launches
    for k, v in before.items():
        getattr(kernels, f"{k}_cuda").launches = v
    # bytes: a, the window, the cut up to the first stop, the state in and
    # out (and the last row where the sweep runs to the end)
    res["bytes"] = {"hop": hb + W + 8 * (hb + 1) + 32,
                    "hop_full": hb + W + 8 * (W + 1) + 32,
                    "hop_prep": 10 * W + 8 * hb + 16,
                    "hop_match": 16 * (hb + 1) + 32}
    res["cells"] = {"hop": hb * hb, "hop_full": hb * W}
    return res


def geometries(hb: int, max_cluster: int):
    """Every (alpha, warps, cluster) that covers ``hb`` rows with rows in
    each CTA, by cluster 1, 2, 4, 8 (and 16)."""
    out = []
    for alpha in (2, 4, 8):
        for cluster in (1, 2, 4, 8, 16):
            if cluster > max_cluster:
                continue
            warps = -(-hb // (cluster * 32 * alpha))
            geo = kernels.HopGeometry(alpha, warps, cluster)
            if warps <= kernels.HOP_MAX_WARPS \
                    and -(-hb // geo.rows) == cluster:
                out.append(geo)
    return out


def variants(dev, n: int, W: int, hb: int, iters: int = 30) -> list:
    """The one launch at every geometry that covers the hop (planted
    inputs, least of 3 runs of ``iters`` queued launches), stopping at k =
    hb and swept to the end, each state held equal to the plain hop's.
    Returns [(geometry, ms to the stop, ms to the end)], fastest first."""
    kw = dict(match=P.match, mismatch=P.mismatch, gap_open=GO, gap_ext=GE,
              sw=True)
    (a, s1r, cut_h, cut_f), st = planted(dev, n, W, hb)
    no_stop = st.clone()
    no_stop[1] += 1
    want = {}
    for name, s in (("stop", st), ("end", no_stop)):
        want[name] = torch.empty(4, dtype=torch.int32, device=dev)
        wf.hop_plain(a, s1r, cut_h, cut_f, s, want[name], W, **kw)
    before = kernels.hop_cuda.launches
    out = []
    for geo in geometries(hb, kernels.hop_max_cluster(dev)):
        ms = []
        for name, s in (("stop", st), ("end", no_stop)):
            got = torch.empty(4, dtype=torch.int32, device=dev)
            sink: list = []

            def fn():
                kernels.hop_cuda(a, s1r, cut_h, cut_f, s, got, W,
                                 geometry=geo, flags=sink, **kw)

            ms.append(min(_events_ms(fn, iters) for _ in range(3)))
            kernels.check_flags(torch.cat(sink).tolist())
            if not torch.equal(got, want[name]):
                raise AssertionError(f"hop_kernel at {geo} ({name}): "
                                     f"{got.tolist()}, plain "
                                     f"{want[name].tolist()}")
        out.append((tuple(geo), *ms))
    kernels.hop_cuda.launches = before
    return sorted(out, key=lambda x: x[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true",
                    help="also time every geometry at each shape")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hop_tune needs a CUDA device")
    dev = torch.device("cuda")
    n = 1 << 20
    out = {"device": torch.cuda.get_device_name(0),
           "max_cluster": kernels.hop_max_cluster(dev)}
    check(dev)
    seen = {}
    # the main paths' hops (the bench's, the CLI's) and one past a CTA
    shapes = [(1024, 512), (2048, 1000), (16384, 8192)]
    for W, hb in shapes:
        check(dev, n, W, hb)
        _, got = check_fused(dev, n, W, hb)
        for k, v in got.items():
            seen[k] = seen.get(k, 0) + v
    out["check"] = {"max_abs_err": 0, "cases": seen, "shapes": shapes}
    if not args.check_only:
        out["timed"] = [timed(dev, n, W, hb) for W, hb in
                        ((1024, 512), (16384, 8192), (65536, 32768))]
    if args.variants:
        out["variants"] = {f"{hb}x{W}": variants(dev, n, W, hb)
                           for W, hb in ((1024, 512), (16384, 8192),
                                         (65536, 32768))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
