"""Check and time the stage-2 hop kernels (``csrc/hop.cu``) on a card.

    python -m masa_tpu_torch.tools.hop_tune [--n N] [--W W] [--hb HB]

``check`` holds ``kernels.hop_prep_cuda`` and ``kernels.hop_match_cuda``
against their plain versions (``wavefront.hop_prep_plain``,
``hop_match_plain``) on the same inputs on the card, byte for byte: every
crosspoint type, SW and NW, a hit at k = 0 and further on, no stop, an
overshoot, a state entering with ok = 0, a window that reaches column 0
(cj < W + 1), a goal within reach under SW, and random states; ``main``
runs it at a small shape and at a stage-2 hop's shape (the 1M pair's:
W = 16384 columns, hb = 8192 rows, a cut of 2^20).  ``timed`` times
each kernel and its plain version by CUDA events at the hop's shape,
holds their outputs equal there, and counts the bytes each moves for
its bound.  Prints one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

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


def timed(dev, n: int = 1 << 20, W: int = 16384, hb: int = 8192,
          iters: int = 200, seed: int = 1) -> dict:
    """Each kernel and its plain version at a hop's shape, by events over
    ``iters`` launches issued back to back behind a wait (the plain
    versions over a tenth of them, as they run), and the
    bytes each must move: the prologue reads W characters and the state
    and writes the window, the bus and the border (10 W + 8 hb + 16); the
    epilogue reads the state and 16 bytes a column up to the first stop,
    and writes the state.  The timed state is eligible and hits at k = hb,
    where a near-diagonal path crosses (the reverse row is lowered
    before it).  After the timing each kernel's outputs are held equal to
    its plain version's on the same inputs (it raises otherwise)."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    cut_h, cut_f, rev_h, rev_f, _ = match_cases(rng, n, W, hb)
    rev_h[:hb - 1] -= 1000
    rev_f[:hb - 1] -= 1000
    cj = n // 2
    sm, sg = match_sums(cut_h, cut_f, rev_h, rev_f, cj, 0, W, hb)
    goal = int(max(sm[hb], sg[hb]))
    stop = first_stop(sm, sg, goal)
    assert stop == hb
    st = t(np.array([cj, goal, 0, 1], np.int32))
    out_k = torch.empty(4, dtype=torch.int32, device=dev)
    out_p = torch.empty(4, dtype=torch.int32, device=dev)
    args = [t(x) for x in (cut_h, cut_f, rev_h, rev_f)]
    s1r = t(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))
    kw = dict(match=P.match, gap_open=GO, gap_ext=GE, sw=True)
    res = {"shape": {"n": n, "W": W, "hb": hb, "first_stop": stop}}
    for name, k, p, moved in (
            ("hop_prep",
             lambda: kernels.hop_prep_cuda(s1r, st, W, hb, GO, GE),
             lambda: wf.hop_prep_plain(s1r, st, W, hb, GO, GE),
             10 * W + 8 * hb + 16),
            ("hop_match",
             lambda: (kernels.hop_match_cuda(*args, st, out_k, W, hb,
                                             **kw), out_k)[1:],
             lambda: (wf.hop_match_plain(*args, st, out_p, W, hb, **kw),
                      out_p)[1:],
             16 * (stop + 1) + 32)):
        before = (kernels.hop_prep_cuda.launches,
                  kernels.hop_match_cuda.launches)
        res[name] = {"ms": _events_ms(k, iters),
                     "plain_ms": _events_ms(p, max(iters // 10, 1), False),
                     "bytes": moved}
        got, want = k(), p()
        if len(got) != len(want) or not all(
                torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{name} at the timed hop: the kernel's "
                                 f"outputs differ from the plain version's")
        if name == "hop_match" and (out_p[0] != cj - stop or out_p[3] != 1):
            raise AssertionError(f"hop_match at the timed hop gave "
                                 f"{out_p.tolist()}, not a hit at k = {stop}")
        # these launches are measurements, not the main path's
        kernels.hop_prep_cuda.launches, kernels.hop_match_cuda.launches = \
            before
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--W", type=int, default=16384)
    ap.add_argument("--hb", type=int, default=8192)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hop_tune needs a CUDA device")
    dev = torch.device("cuda")
    check(dev)
    err, seen = check(dev, args.n, args.W, args.hb)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "max_abs_err": err, "cases": seen,
                      **timed(dev, args.n, args.W, args.hb)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
