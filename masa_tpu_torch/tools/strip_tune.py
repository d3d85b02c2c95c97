"""Time the strip kernel (``csrc/strip.cu``) at the main path's shapes, and
its design factors one at a time.

    python -m masa_tpu_torch.tools.strip_tune [--variants] [--check]
                                              [--profile]

Needs a CUDA card and ``nvcc``.  Three shapes, each warmed, then the best
of ``--repeat`` launches by CUDA events:

  hop     8192 x 16384, NW, pinned (WITH_GAPS_OPENED) borders, best
          tracked: one stage-2 hop;
  band    8192 x 2^20, SW, best tracked, rows flushed every 2048;
  stage1  2^20 x 2^20, SW, best tracked: the stage-1 launch of a 1M pair.

``--check`` first holds the kernel against ``strip_plain`` (exact) on the
hop shape and on a few small odd shapes.  ``--variants`` times, beside
the shipped configuration: every block geometry ``(alpha, warps)`` the
kernel takes, in place of ``kernels.strip_geometry``'s choice, and best
tracking off.  ``--profile`` builds the kernel with ``-DMASA_PROFILE`` and reports,
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


def time_ms(fn, repeat):
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
    return best


def same(got, want, what):
    for k, (x, y) in enumerate(zip(got, want)):
        if (x is None) != (y is None):
            raise AssertionError(f"{what}: output {k} on one side only")
        if x is not None and (x.shape != y.shape or not bool(
                (x.long() == y.long()).all())):
            raise AssertionError(f"{what}: output {k} differs")


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


def measure(dev, emit, repeat, variants):
    from masa_tpu_torch.ops import kernels

    data = {name: inputs(11, s["h"], s["nj"], s["border"], dev)
            for name, s in SHAPES.items()}

    def run(name, what, track=True, rep=repeat):
        s = SHAPES[name]
        ms = time_ms(lambda: kernels.strip_cuda(*data[name],
                                                **kwargs(s, track)), rep)
        emit({"shape": name, "rows": s["h"], "columns": s["nj"],
              "variant": what, "ms": round(ms, 4),
              "gcups": round(s["h"] * s["nj"] / ms / 1e6, 2)})

    for name in SHAPES:
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
    args = ap.parse_args(argv)
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
    measure(dev, emit, args.repeat, args.variants)
    if args.profile:
        profile(dev, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
