"""Time the batched strip kernels (``csrc/batched_strip.cu``) at the main
path's shapes, and their block geometry one choice at a time.

    python -m masa_tpu_torch.tools.batched_tune [--check] [--variants]
                                                [--shapes level1,fixed]

Needs a CUDA card and ``nvcc``.  Nine shapes, each warmed, then the best
of ``--repeat`` launches by CUDA events, around the wrapper (``ms``) and
around its launch alone (``kernel_ms``, which ``gcups`` is of):

  level1 .. level6  the forward halves of stage 4's levels on a 1M x 1M
          pair cut into bands of 8192 rows: 128 elements of 4096 rows x
          8192 columns at level 1, twice the elements of half the rows
          and half the columns at each level after it (level 4, 1024
          elements of 512 x 1024, is where stage 4's default stop at 512
          ends an even split; 5 and 6 are what uneven pairs go on to);
  straggler  level 1 with one element of 5120 rows, which is chained;
  tail    seven elements of 256 to 512 rows x 1536 columns: what a last
          level leaves, far fewer warps than the card has SMs;
  fixed   8192 equal-shape elements of 64 rows x 128 columns with given
          borders (``batched_strip_fixed_cuda``).

``--check`` first holds both kernels against their plain versions (exact)
on ``edge_cases()`` and ``fixed_cases()``: every height around a warp's, a
block's and a chained element's rows, mixed heights in one launch, widths
0, 1 and off the 32-column chunk, the three border codes, and each block
geometry forced in turn.  ``--variants`` times, beside the shipped rule
(``kernels.batched_geometry``), every geometry ``(alpha, warps,
per_block)`` that owns the shape's rows.

``--tables FILE.npz`` times instead the launches that ``chip_smoke.py
--save-stage4 FILE.npz`` kept: every forward and reverse launch of stage 4
on the 1M pair's own crosspoints, and their sum.  The tool calls only the
wrappers, so a copy of it runs unchanged inside an older checkout of the
package: that is how two versions of the kernels are timed in one call
on one card.

Every result is one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

import numpy as np

NEG = -999999999
SCORES = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2)
# name -> (heights, columns) of a launch of the batched kernel
LEVELS = {f"level{k + 1}": ([4096 >> k] * (128 << k), 8192 >> k)
          for k in range(6)}
LEVELS["straggler"] = ([5120] + [4096] * 127, 8192)  # level 1, one tall band
LEVELS["tail"] = ([512, 256, 509, 300, 256, 512, 400], 1536)  # a last level
FIXED = (8192, 64, 128)
# heights around a warp's rows (32 lanes x 2, 4 or 8), a block's and a
# chained element's, for every rows-per-thread the kernels take
HEIGHTS = (1, 31, 32, 33, 63, 64, 65, 255, 256, 257, 2047, 2048, 2049, 4096,
           4097, 9000)
# (alpha, warps, per_block) forced in turn by the checks: one warp, a
# chain of warps with an odd count, a whole block, elements side by side
FORCED = ((2, 1, 1), (2, 1, 8), (2, 3, 2), (2, 32, 1), (4, 1, 3), (4, 5, 1),
          (4, 32, 1), (8, 1, 2), (8, 3, 5), (8, 16, 1))


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def sequences(seed: int, n: int):
    """A homologous pair of ``n`` characters (a tenth substituted)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, n).astype(np.uint8)
    s1 = np.where(rng.random(n) < 0.1, rng.choice(bases, n), s0)
    return s0, s1.astype(np.uint8)


def table(rng, heights, widths, n: int) -> np.ndarray:
    """An element table for the given heights and widths: offsets near
    the diagonal of an ``n``-character pair, border codes drawn from
    0-2."""
    h, w = np.asarray(heights), np.asarray(widths)
    i0 = rng.integers(0, n - h + 1)
    j0 = np.clip(i0 + rng.integers(-50, 50, len(h)), 0, n - w)
    return np.stack([i0, h, j0, w, rng.integers(0, 3, len(h)),
                     rng.integers(0, 3, len(h))], 1).astype(np.int32)


def edge_cases(n: int = 1 << 15):
    """``(name, elems, width)`` launches for the batched kernel's checks:
    one launch per height of ``HEIGHTS`` (widths 0, 1, 33, 100 and 130,
    every border code), then mixed heights with tall stragglers, many
    one-row elements, and a width of one."""
    rng = np.random.default_rng(41)
    widths = (0, 1, 33, 100, 130, 64)
    for h in HEIGHTS:
        el = table(rng, [h] * len(widths), widths, n)
        el[:3, 4], el[:3, 5] = (0, 1, 2), (2, 0, 1)
        yield f"h={h}", el, 130
    B = 300
    h = rng.integers(1, 301, B)
    h[[5, 150, 299]] = (5000, 2049, 700)
    yield ("mixed 1-300 with stragglers",
           table(rng, h, rng.integers(0, 200, B), n), 199)
    yield "2000 of one row", table(rng, [1] * 2000, rng.integers(0, 3, 2000),
                                   n), 2
    yield "width 1", table(rng, rng.integers(1, 100, 50), [1] * 50, n), 1


def fixed_cases():
    """``(B, h, nj)`` shapes for the equal-shape kernel's checks: every
    height of ``HEIGHTS`` against widths off the 32-column chunk."""
    widths = (1, 33, 129, 64, 31, 77, 100)
    for k, h in enumerate(HEIGHTS):
        yield (1 if h > 4096 else 3), h, widths[k % len(widths)]
    yield 3000, 8, 33
    yield 64, 64, 129


def fixed_inputs(rng, B, h, nj, dev):
    """Equal-shape batch inputs with arbitrary borders: homologous
    characters, random border and bus values, -INF in a fifth of the gap
    cells, random corners."""
    import torch

    bases = np.frombuffer(b"ACGT", np.uint8)
    a = rng.choice(bases, (B, h))
    b = a[:, np.arange(nj) % h].copy()
    flip = rng.random((B, nj)) < 0.25
    b[flip] = rng.choice(bases, int(flip.sum()))

    def t(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x).astype(dt)).to(dev)

    def gaps(shape):
        return np.where(rng.random(shape) < 0.2, NEG,
                        rng.integers(-80, 20, shape))

    return (t(a, np.uint8), t(b, np.uint8),
            t(rng.integers(-60, 40, (B, h)), np.int32),
            t(gaps((B, h)), np.int32),
            t(rng.integers(-60, 40, (B, nj)), np.int32),
            t(gaps((B, nj)), np.int32),
            t(rng.integers(-60, 40, B), np.int32))


@contextlib.contextmanager
def forced(alpha: int, warps: int, per_block: int):
    """Every batched launch inside takes this block shape in place of
    ``kernels.batched_geometry``'s choice (its dispatch order stays)."""
    from masa_tpu_torch.ops import kernels

    rule = kernels.batched_geometry

    def fixed_rule(heights, sms):
        return rule(heights, sms)._replace(alpha=alpha, warps=warps,
                                           per_block=per_block)

    kernels.batched_geometry = fixed_rule
    try:
        yield
    finally:
        kernels.batched_geometry = rule


def same(got, want, what):
    """Exact equality of both buses (a difference raises)."""
    for name, x, y in zip(("bus_h", "bus_f"), got, want):
        if x.shape != y.shape:
            raise AssertionError(f"{what}: {name} shapes {tuple(x.shape)} "
                                 f"vs {tuple(y.shape)}")
        d = int((x.long() - y.long()).abs().max())
        if d:
            raise AssertionError(f"{what}: {name} differs (max |diff| {d})")


def check_batched(dev, geometries=FORCED) -> int:
    """The batched kernel equals ``batched_strip_plain`` on every launch
    of ``edge_cases`` under the shipped rule, and on the mixed launch and
    the chained heights under each forced geometry.  Returns the number
    of comparisons."""
    import torch

    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf

    n = 1 << 15
    a, b = (torch.from_numpy(x).to(dev) for x in sequences(43, n))
    count = 0
    cases = list(edge_cases(n))
    for k, (name, el, width) in enumerate(cases):
        kw = SCORES if k % 2 else dict(match=2, mismatch=-1, gap_open=2,
                                       gap_ext=1)
        want = wf.batched_strip_plain(a, b, el, width, **kw)
        same(kernels.batched_strip_cuda(a, b, el, width, **kw), want, name)
        count += 1
        if name in ("h=257", "h=2049", "h=9000") or name.startswith("mixed"):
            for geo in geometries:
                with forced(*geo):
                    same(kernels.batched_strip_cuda(a, b, el, width, **kw),
                         want, f"{name} at alpha, warps, per block {geo}")
                count += 1
    return count


def check_fixed(dev, geometries=FORCED) -> int:
    """The equal-shape kernel equals ``batched_strip_fixed_plain`` on
    ``fixed_cases`` under the shipped rule, and two shapes under each
    forced geometry.  Returns the number of comparisons."""
    from masa_tpu_torch.ops import kernels
    from masa_tpu_torch.ops import wavefront as wf

    rng = np.random.default_rng(47)
    count = 0
    for k, (B, h, nj) in enumerate(fixed_cases()):
        kw = SCORES if k % 2 else dict(match=2, mismatch=-1, gap_open=2,
                                       gap_ext=1)
        args = fixed_inputs(rng, B, h, nj, dev)
        want = wf.batched_strip_fixed_plain(*args, **kw)
        same(kernels.batched_strip_fixed_cuda(*args, **kw), want,
             f"fixed B={B} h={h} nj={nj}")
        count += 1
        if h in (257, 2049):
            for geo in geometries:
                with forced(*geo):
                    same(kernels.batched_strip_fixed_cuda(*args, **kw), want,
                         f"fixed B={B} h={h} nj={nj} at {geo}")
                count += 1
    return count


def level_inputs(name: str, dev):
    """The sequences and the element table of a ``LEVELS`` shape: the
    elements' rows follow one another, element k owns columns [k w,
    (k+1) w)."""
    import torch

    heights, w = LEVELS[name]
    h = np.asarray(heights)
    s0, s1 = sequences(11, 1 << 20)
    k = np.arange(len(h))
    el = np.stack([np.cumsum(h) - h, h, k * w, np.full(len(h), w), k % 3,
                   (k + 1) % 3], 1).astype(np.int32)
    return torch.from_numpy(s0).to(dev), torch.from_numpy(s1).to(dev), el, w


def time_ms(fn, repeat):
    """The least of ``repeat`` timings of ``fn`` after a warm call, twice:
    by events around the whole wrapper (its host work shows where the
    card waits for it) and by the wrapper's own events around the launch
    alone."""
    import torch

    from masa_tpu_torch.ops import kernels

    fn()  # warm (and build)
    best, best_kernel = None, None
    kernels.event_log = []
    try:
        for _ in range(repeat):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            kernel_ms = sum(kernels.drain_events().values())
            best = ms if best is None else min(best, ms)
            best_kernel = kernel_ms if best_kernel is None \
                else min(best_kernel, kernel_ms)
    finally:
        kernels.event_log = None
    return best, best_kernel


def geometries_for(h: int, B: int):
    """Every (alpha, warps, per_block) whose warps own ``h`` rows at once
    or chain at most four sub-strips, blocks of up to 8 warps for several
    elements."""
    from masa_tpu_torch.ops import kernels

    out = []
    for alpha in (8, 4, 2):
        cap = kernels.BATCHED_MAX_WARPS[alpha]
        need = -(-h // (32 * alpha))
        for warps in sorted({min(cap, need), min(cap, -(-need // 2)),
                             min(cap, -(-need // 4))}):
            for per_block in (1, 2, 4, 8):
                if per_block > 1 and (warps * per_block > 8 or per_block > B):
                    continue
                out.append((alpha, warps, per_block))
    return out


def measure(dev, emit, repeat, variants, shapes):
    from masa_tpu_torch.ops import kernels

    # the rule this package ships; a package from before it has none
    has_rule = hasattr(kernels, "batched_geometry")
    rng = np.random.default_rng(19)
    for name in shapes:
        if name == "fixed":
            B, h, w = FIXED
            args = fixed_inputs(rng, B, h, w, dev)

            def run(args=args):
                return kernels.batched_strip_fixed_cuda(*args, **SCORES)
        else:
            a, b, el, w = level_inputs(name, dev)
            B, h = len(el), int(np.median(el[:, 1]))

            def run(a=a, b=b, el=el, w=w):
                return kernels.batched_strip_cuda(a, b, el, w, **SCORES)

        cells = B * h * w if name == "fixed" else int(
            (el[:, 1].astype(np.int64) * el[:, 3]).sum())

        def report(what, run=run, B=B, h=h, w=w, name=name, cells=cells):
            ms, kernel_ms = time_ms(run, repeat)
            emit({"shape": name, "elements": B, "rows": h, "columns": w,
                  "variant": what, "ms": round(ms, 4),
                  "kernel_ms": round(kernel_ms, 4),
                  "gcups": round(cells / kernel_ms / 1e6, 2)})

        report("shipped")
        if variants and has_rule:
            for geo in geometries_for(h, B):
                with forced(*geo):
                    report(f"alpha {geo[0]} warps {geo[1]} per block "
                           f"{geo[2]}")
            report("shipped")  # again: the spread inside this process


def measure_tables(path, dev, emit, repeat):
    """Each launch kept in ``path``, timed as ``measure`` times a shape,
    then the sums over all of them."""
    import torch

    from masa_tpu_torch.ops import kernels

    kept = np.load(path)
    views = [(kept["s0"], kept["s1"]), (kept["s0"][::-1], kept["s1"][::-1])]
    views = [tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                   for x in v) for v in views]
    total = {"ms": 0.0, "kernel_ms": 0.0, "cells": 0}
    for k, (level, rev, width) in enumerate(kept["launches"].tolist()):
        el = kept[f"elems{k}"]
        a, b = views[rev]
        ms, kernel_ms = time_ms(lambda: kernels.batched_strip_cuda(
            a, b, el, width, **SCORES), repeat)
        cells = int((el[:, 1].astype(np.int64) * el[:, 3]).sum())
        emit({"shape": f"stage4 level {level} "
                       f"{'reverse' if rev else 'forward'}",
              "elements": len(el), "rows": [int(el[:, 1].min()),
                                            int(el[:, 1].max())],
              "columns": width, "variant": "shipped", "ms": round(ms, 4),
              "kernel_ms": round(kernel_ms, 4),
              "gcups": round(cells / kernel_ms / 1e6, 2)})
        total = {"ms": total["ms"] + ms,
                 "kernel_ms": total["kernel_ms"] + kernel_ms,
                 "cells": total["cells"] + cells}
    emit({"shape": "stage4, every launch", "launches": len(kept["launches"]),
          "ms": round(total["ms"], 4),
          "kernel_ms": round(total["kernel_ms"], 4),
          "gcups": round(total["cells"] / total["kernel_ms"] / 1e6, 2)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--shapes", default=",".join([*LEVELS, "fixed"]))
    ap.add_argument("--tables", help="launches kept by chip_smoke.py "
                    "--save-stage4, timed in place of the shapes")
    args = ap.parse_args(argv)
    shapes = [s for s in args.shapes.split(",") if s]
    for s in shapes:
        if s != "fixed" and s not in LEVELS:
            ap.error(f"unknown shape {s!r}")
    import torch

    if not torch.cuda.is_available():
        print("batched_tune: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()

    def emit(d):
        print(json.dumps({**d, "card": card}), flush=True)

    dev = torch.device("cuda")
    if args.check:
        emit({"check": "batched kernel equals batched_strip_plain",
              "comparisons": check_batched(dev)})
        emit({"check": "equal-shape kernel equals batched_strip_fixed_plain",
              "comparisons": check_fixed(dev)})
    if args.tables:
        measure_tables(args.tables, dev, emit, args.repeat)
    else:
        measure(dev, emit, args.repeat, args.variants, shapes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
