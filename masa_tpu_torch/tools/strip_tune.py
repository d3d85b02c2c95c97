"""Time the strip kernel (``csrc/strip.cu``) at the main path's shapes, and
its design factors one at a time.

    python -m masa_tpu_torch.tools.strip_tune [--variants] [--check]
                                              [--profile] [--each]
                                              [--shapes hop,band,stage1]

Needs a CUDA card and ``nvcc``.  Three shapes, each warmed, then the best
of ``--repeat`` launches by CUDA events:

  hop     8192 x 16384, NW, pinned (WITH_GAPS_OPENED) borders, best
          tracked: one stage-2 hop;
  band    8192 x 2^20, SW, best tracked, rows flushed every 2048;
  stage1  2^20 x 2^20, SW, best tracked: the stage-1 launch of a 1M pair.

``--check`` first holds the kernel against ``strip_plain`` (exact) on the
hop shape and on a few small odd shapes, then the pruning instances against
their twin on sampled sub-strips of launches taller than the grid
(``pruned_waves``).  ``--variants`` times, beside
the shipped configuration: every block geometry ``(alpha, warps)`` the
kernel takes, in place of ``kernels.strip_geometry``'s choice, and best
tracking off.  ``--shapes`` times only the shapes named; ``--each`` prints every timed
launch beside the least (a launch's time spreads widely on a card shared
with other work).  ``--profile`` builds the kernel with ``-DMASA_PROFILE``
and reports,
per shape, the share of the compute warps' cycles spent waiting for
another warp (the ring above empty, or the ring below full), the share of
chunks that began with such a wait, and the cycles per 32-column chunk of
a warp.

Every result is one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

NEG = -999999999
SHAPES = {
    "hop": dict(h=8192, nj=16384, sw=False, flush=0, border=2),
    "band": dict(h=8192, nj=1 << 20, sw=True, flush=2048, border=0),
    "stage1": dict(h=1 << 20, nj=1 << 20, sw=True, flush=0, border=0),
}
GEOMETRIES = [(a, w) for a in (8, 4, 2) for w in (8, 4, 2, 1)]
# pruned_waves cases: (rows a thread, max_ctas, best_in).  At 4 rows a
# thread the full grid holds every sub-strip at once (the instance fits two
# blocks an SM), so only a capped grid reaches the prefix chain there.
PRUNED_WAVES = ((8, 0, 0), (8, 4, 0), (4, 0, 2000), (4, 64, 2000))


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def inputs(seed, h, nj, border, dev):
    """A homologous pair of ``h`` and ``nj`` characters, the first row's
    bus and the left border synthesized for border code ``border`` (the
    InitType values 0-2), on ``dev``."""
    import numpy as np
    import torch

    from masa_tpu_torch.ops import wavefront as wf

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    a = rng.choice(bases, h).astype(np.uint8)
    b = np.resize(a, nj).copy()
    flip = rng.random(nj) < 0.25
    b[flip] = rng.choice(bases, int(flip.sum()))
    bus_h, bus_f = wf.init_bus(border, nj, 3, 2, dev)
    col = wf.border_h(border, torch.arange(0, h + 1, device=dev), 3, 2)
    col_e = torch.full((h,), NEG, dtype=torch.int32, device=dev)
    return (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), bus_h,
            bus_f, col[1:].contiguous(), col_e, int(col[0]))


def kwargs(shape, track=True):
    return dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=shape["sw"],
                track_best=track, store_lastcol=False,
                flush_every=shape["flush"])


def time_ms(fn, repeat, each=None):
    """The least of ``repeat`` timed launches after a warm one; each
    time is appended to ``each`` when it is a list."""
    import torch

    fn()  # warm (and build)
    best = None
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        best = ms if best is None else min(best, ms)
        if each is not None:
            each.append(round(ms, 4))
    return best


def same(got, want, what):
    for k, (x, y) in enumerate(zip(got, want)):
        if (x is None) != (y is None):
            raise AssertionError(f"{what}: output {k} on one side only")
        if x is not None and (x.shape != y.shape or not bool(
                (x.long() == y.long()).all())):
            raise AssertionError(f"{what}: output {k} differs")


PRUNE_KW = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=True,
                track_best=True)


def pruned_inputs(seed, h, nj, dev):
    """A tall pruning launch of ``h`` rows over ``nj`` columns (h >= 2 nj),
    zero borders, whose rows hold two copies of the columns (8%
    substitutions): at the top, whose best the rows below prune against,
    and in the last ``nj`` rows, where the entering bus rises to the right,
    so that a sub-strip there skips a part of its columns."""
    import numpy as np
    import torch

    from masa_tpu_torch.ops import wavefront as wf

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    b = rng.choice(bases, nj)
    a = rng.choice(bases, h)
    for top in (0, h - nj):
        copy = b.copy()
        flip = rng.random(nj) < 0.08
        copy[flip] = rng.choice(bases, int(flip.sum()))
        a[top:top + nj] = copy
    bus_h, bus_f = wf.init_bus(0, nj, 3, 2, dev)
    return (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), bus_h,
            bus_f, torch.zeros(h, dtype=torch.int32, device=dev),
            torch.full((h,), NEG, dtype=torch.int32, device=dev), 0)


def check_pruned_span(args, out, prune, flush_every, g0, g1, kw):
    """Hold sub-strips ``g0 .. g1 - 1`` of a pruning launch against the
    plain twin, byte for byte.  ``out`` is what ``kernels.strip_cuda(*args,
    **kw, flush_every=flush_every, prune=prune)`` returned (or
    ``wavefront.strip_plain_pruned`` at the same geometry); ``flush_every``
    divides the rows of a sub-strip or is a multiple of them, and the span
    starts and ends at a flushed row (or the launch's first or last).  The
    twin runs one sub-strip at a time from the launch's own row above
    ``g0``, each with ``B_g = max(best_in, the launch's per-row bests of
    sub-strips 0 .. g - blocks)``, and must give the record, the per-row
    bests, the flushed rows and the bus leaving each sub-strip wherever
    the launch flushed it.  Returns the first columns kept in the span."""
    import torch

    from masa_tpu_torch.ops import wavefront as wf

    a, b, _, _, col_h, col_e, corner = args
    rec = out[8]
    rows, blocks, fe = rec.rows, rec.blocks, flush_every
    h = a.numel()
    n_sub = -(-h // rows)
    if fe <= 0 or (rows % fe and fe % rows):
        raise ValueError(f"flush_every {fe} must divide {rows} or be a "
                         f"multiple of it")

    def edge(g):  # the rows the launch holds above sub-strip g, or None
        if g == 0:
            return args[2], args[3]
        if g == n_sub:
            return out[0], out[1]
        top = g * rows
        return None if top % fe else (out[6][top // fe - 1],
                                      out[7][top // fe - 1])

    if not 0 <= g0 < g1 <= n_sub or edge(g0) is None or edge(g1) is None:
        raise ValueError(f"sub-strips [{g0}, {g1}) do not start and end at "
                         f"flushed rows")
    hp, fp = edge(g0)
    record = rec.record.cpu().tolist()
    b_in = int(prune.best_in.reshape(-1)[0])
    firsts = []
    for g in range(g0, g1):
        top = g * rows
        hs = min(rows, h - top)
        done = (g - blocks + 1) * rows  # the rows of sub-strips <= g - blocks
        bg = max(b_in, int(out[2][:done].max())) if done > 0 else b_in
        lp = prune._replace(i0=prune.i0 + top, best_in=torch.tensor(
            [bg], dtype=torch.int64, device=b.device))
        want = wf.strip_plain_pruned(
            a[top:top + hs], b, hp, fp, col_h[top:top + hs],
            col_e[top:top + hs], corner if g == 0 else int(col_h[top - 1]),
            lp, (hs, 1), **kw, flush_every=fe)
        what = f"sub-strip {g} of {n_sub} ({rows} rows, {blocks} blocks)"
        if record[g] != want[8].record[0].tolist():
            raise AssertionError(f"{what}: record {record[g]}, the twin's "
                                 f"{want[8].record[0].tolist()}")
        n_in = (hs - 1) // fe  # rows flushed inside the sub-strip
        q = top // fe
        same([out[2][top:top + hs], out[3][top:top + hs]]
             + ([out[6][q:q + n_in], out[7][q:q + n_in]] if n_in else []),
             list(want[2:4]) + (list(want[6:8]) if n_in else []), what)
        hp, fp = want[0], want[1]
        below = edge(g + 1)
        if below is not None:
            same(below, (hp, fp), f"{what}: the bus leaving it")
        firsts.append(record[g][0])
    return firsts


def pruned_waves(dev, alpha, max_ctas=0, best_in=0, nj=8192, flush=1024):
    """The pruning kernel at a block geometry of the main path (``alpha``
    rows a thread, 8 warps: 8 is stage 1's on the 1M pair), on a launch of
    a few more sub-strips than the card's SMs and resident blocks of the
    unpruned instance, with a partial last one, on ``pruned_inputs``; the
    grid is the instance's resident blocks, or ``max_ctas``.  Sampled
    sub-strips (the first two, the three around the grid's size and every
    one of the last ``nj`` rows) are held against the twin by
    ``check_pruned_span``.  Raises unless a sampled sub-strip skipped a part
    of its columns and, where the grid is smaller than the sub-strips (so
    that ``B_g`` comes from the chain of prefix bests), one was pruned
    against a best of the sub-strips above it that passes ``best_in``.
    Returns a summary."""
    import torch

    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = 32 * alpha * 8
    h = (max(sms, kernels.resident_blocks()) + 3) * rows + 5
    if kernels.strip_geometry(h, sms) != (alpha, 8):
        raise ValueError(f"{h} rows do not take {alpha} rows a thread")
    args = pruned_inputs(alpha + max_ctas, h, nj, dev)
    lp = wf.LaunchPrune(h, nj, 0, 0, torch.tensor([best_in], device=dev))
    out = kernels.strip_cuda(*args, **PRUNE_KW, flush_every=flush,
                             max_ctas=max_ctas, prune=lp)
    rec = out[8]
    G, n_sub = rec.blocks, len(rec.record)
    picks = sorted(g for g in {0, 1, G - 1, G, G + 1}
                   | set(range(n_sub - nj // rows - 1, n_sub)) if g < n_sub)
    spans, g0 = [], picks[0]
    for x, y in zip(picks, picks[1:] + [None]):
        if y != x + 1:
            spans.append((g0, x + 1))
            g0 = y
    firsts = {}
    for s0, s1 in spans:
        firsts.update(zip(range(s0, s1), check_pruned_span(
            args, out, lp, flush, s0, s1, PRUNE_KW)))
    bgs = rec.record[:, 1].tolist()
    partial = [g for g, lo in firsts.items() if 0 < lo < nj]
    chained = [g for g, lo in firsts.items()
               if lo > 0 and g >= G and bgs[g] > best_in]
    what = f"pruning launch {h} x {nj}, {rows}-row sub-strips on {G} blocks"
    if not partial or (G < n_sub and not chained):
        raise AssertionError(f"{what}: the sampled sub-strips {sorted(firsts)}"
                             f" skipped {[firsts[g] for g in sorted(firsts)]}"
                             f" columns with B_g {[bgs[g] for g in sorted(firsts)]}"
                             f": none skipped a part of its columns, or none "
                             f"against a best of the sub-strips above it")
    return dict(what=what, best_in=best_in, sub_strips=n_sub,
                checked=len(firsts), partial=len(partial),
                chained=len(chained), pruned_cells=rec.pruned_cells(h),
                cells=h * nj)


def check(dev, emit):
    """The kernel equals the plain version: the hop shape and small odd
    shapes through every template instance's flags."""
    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf

    cases = [(8192, 16384, False, 0, 2, True), (1, 1, True, 0, 0, True),
             (31, 33, True, 7, 0, True), (257, 1000, False, 100, 1, False),
             (2049, 640, True, 1024, 0, True), (4500, 97, False, 0, 2, True),
             (600, 2501, True, 0, 0, False), (10257, 300, True, 777, 0, True)]
    failed = []
    for n, (h, nj, sw, flush, border, track) in enumerate(cases):
        args = inputs(100 + n, h, nj, border, dev)
        kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=sw,
                  track_best=track, store_lastcol=True, flush_every=flush)
        got = wf.strip_out(*kernels.strip_cuda(*args, **kw))
        want = wf.strip_plain(*args, **kw)
        fields = ("bus_h", "bus_f", "best", "lastcol_h", "lastcol_e",
                  "rows_h", "rows_f")
        try:
            same([getattr(got, f) for f in fields],
                 [getattr(want, f) for f in fields],
                 f"h={h} nj={nj} sw={sw} flush={flush} border={border}")
        except AssertionError as e:
            failed.append(str(e))
    if failed:
        raise AssertionError("; ".join(failed))
    emit({"check": "kernel equals strip_plain", "cases": len(cases)})
    for alpha, ctas, best_in in PRUNED_WAVES:
        emit({"check": "pruning kernel equals its twin on sampled "
                       "sub-strips", **pruned_waves(dev, alpha, ctas, best_in)})


def measure(dev, emit, repeat, variants, shapes=tuple(SHAPES), each=False):
    from masa_tpu_torch.ops import kernels

    data = {name: inputs(11, s["h"], s["nj"], s["border"], dev)
            for name, s in SHAPES.items()}

    def run(name, what, track=True, rep=repeat):
        s = SHAPES[name]
        times = [] if each else None
        ms = time_ms(lambda: kernels.strip_cuda(*data[name],
                                                **kwargs(s, track)), rep,
                     times)
        emit({"shape": name, "rows": s["h"], "columns": s["nj"],
              "variant": what, "ms": round(ms, 4),
              "gcups": round(s["h"] * s["nj"] / ms / 1e6, 2),
              **({"each_ms": times} if each else {})})

    for name in shapes:
        run(name, "shipped", rep=repeat if name != "stage1" else 2)
    if not variants:
        return
    for name in SHAPES:
        run(name, "no best tracking", track=False,
            rep=repeat if name != "stage1" else 2)
    rule = kernels.strip_geometry
    for name in ("hop", "band"):
        for geo in GEOMETRIES:
            kernels.strip_geometry = lambda h, sms, geo=geo: geo
            run(name, f"alpha {geo[0]} warps {geo[1]}")
    for geo in ((8, 8), (8, 4), (4, 8)):
        kernels.strip_geometry = lambda h, sms, geo=geo: geo
        run("stage1", f"alpha {geo[0]} warps {geo[1]}", rep=2)
    kernels.strip_geometry = rule


def profile(dev, emit):
    """Where the compute warps' cycles go, from the kernel's own
    counters (the ``MASA_PROFILE`` build)."""
    import ctypes

    import torch

    from masa_tpu_torch.ops import kernels

    shipped = kernels.load()
    lib = kernels.bind("strip", kernels.build("strip", ("MASA_PROFILE",)))
    lib.masa_strip_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    kernels._libs["strip"] = lib
    buf = (ctypes.c_ulonglong * 4)()
    for name, s in SHAPES.items():
        args = inputs(11, s["h"], s["nj"], s["border"], dev)

        def run():
            kernels.strip_cuda(*args, **kwargs(s))
            torch.cuda.synchronize()

        run()  # warm
        lib.masa_strip_profile(buf, 1)
        ms = time_ms(run, 2)
        lib.masa_strip_profile(buf, 1)
        wait, total, waits, chunks = (int(x) for x in buf)
        emit({"shape": name, "variant": "profile build", "ms": round(ms, 4),
              "wait_share": round(wait / max(total, 1), 4),
              "chunks_begun_waiting": round(waits / max(chunks, 1), 4),
              "cycles_per_chunk": round(total / max(chunks, 1))})
    kernels._libs["strip"] = shipped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--each", action="store_true")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args(argv)
    shapes = tuple(args.shapes.split(","))
    if not set(shapes) <= set(SHAPES):
        ap.error(f"--shapes takes {','.join(SHAPES)}")
    import torch

    if not torch.cuda.is_available():
        print("strip_tune: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()

    def emit(d):
        print(json.dumps({**d, "card": card}), flush=True)

    dev = torch.device("cuda")
    if args.check:
        check(dev, emit)
    measure(dev, emit, args.repeat, args.variants, shapes, args.each)
    if args.profile:
        profile(dev, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
