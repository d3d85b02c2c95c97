"""Measure the card's integer issue rate, its dependent-op latency and the
rate of the kernels' own DP cell, and print the roofline every kernel of
the package is held against.

Port of ``tools/roofline.py``: its Pallas bodies become the CUDA kernels of
``csrc/roofline.cu`` (each thread one lane, the TPU's (RS, 128) vector
becoming 32 x 128 lanes), each with a plain PyTorch version here that
applies the same elementwise ops with int32 (or int16) wraparound.

The TPU tool's bodies:

  par  8 independent chains of max(v ^ it, v - 1)  -> issue rate
  ser  one chain of 8 such steps, on one warp       -> dependent-op latency
  mix  the TPU step's graph, 8 rows per thread      -> cells/s
  dpx  mix through Hopper's DPX instructions        -> cells/s
  m16  mix on packed int16 pairs                    -> cells/s

The bodies with this package's cell (``csrc/gotoh_cell.cuh``, the code
``csrc/strip.cu`` and ``csrc/batched_strip.cu`` sweep), 8 rows per thread,
one wavefront step per iteration:

  k1   the strip kernel's SW cell with best tracking; run-time scores, the
       column character read per step from shared memory, registers
       otherwise                       -> what the cell of the strip
                                          kernel's tracked launches costs
  k1n  the cell without tracking, plain max (NW): the cell of the strip
       kernel's other launches and of both batched kernels
  k1w  k1 plus one warp's exchange per step (two shuffles, lane 0's ring
       read, lane 31's ring write), nobody to wait for

These three are diagnostics of the code the kernels run today, not bounds:
another spelling of the cell (literal scores, the substitution off the
INT32 lanes) needs fewer instructions, and adding one to the header would
slow them.  The bound of a kernel that sweeps Gotoh cells is
``CELL_FLOOR`` INT32-lane instructions a cell, the fewest the recurrence
needs, over the card's int32 peak (``cell_floor_gcups``).  Times come from
CUDA events around the launch alone
(inputs stacked and the output allocated before), the least of ``REPS``
with the spread beside it, on SMs x the blocks the runtime says fit an SM,
at T and 2T iterations with T chosen so that a launch lasts ``FLOOR_MS``;
the slope cancels the launch and the loads.  Each body's loop instructions
are counted in the built library's SASS (``cuobjdump -sass``), by pipe, and
held against the card's int32 peak: SMs x lanes per clock per SM x the SM
clock that ``nvidia-smi`` reads while a body runs.

Usage: python -m masa_tpu_torch.tools.roofline   (needs a CUDA device)
       python -m masa_tpu_torch.tools.roofline --cell-loops LIB.so ...
(the second form prints, for each built library, its cell-sweeping
kernels' instructions per cell and a digest of their machine code: two
versions of a kernel source are compared by it.)
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import torch

from masa_tpu_torch.ops import kernels

W = 8          # par chains
ALPHA = 8      # rows per thread of mix and of the cell bodies
GO, GE = 3, 2  # the gap scores (the TPU tool's)
MATCH, MISMATCH = 1, -3  # the cell bodies' scores (csrc/roofline.cu)
NEG = -999999999
RS, LANES = 32, 128  # the TPU tool's vector shape, for the plain checks
BS, RING = 64, 128   # csrc/strip.cu: two chunks of b; a ring's columns
BODIES = ("par", "ser", "mix", "dpx", "m16", "k1", "k1n", "k1w")
_CODE = {name: k for k, name in enumerate(BODIES)}  # csrc/roofline.cu Body
# the cell bodies: (SW, best tracked, one warp's exchange)
CELL = {"k1": (True, True, False), "k1n": (False, False, False),
        "k1w": (True, True, True)}
N_IN = {"par": W, "ser": 1, "mix": 2 * ALPHA + 4, "dpx": 2 * ALPHA + 4,
        "m16": 2 * ALPHA + 4, **{b: 3 * ALPHA + 4 for b in CELL}}
# ops per lane per iteration, counted as the TPU tool counts them
OPS = {"par": 2 * W, "ser": 16, "mix": ALPHA * 12, "dpx": ALPHA * 12,
       "m16": ALPHA * 12}
# iterations per trip of each body's main loop (csrc/roofline.cu UNROLL_*)
UNROLL = {"par": 8, "ser": 4, "mix": 2, "dpx": 2, "m16": 2,
          **{b: 2 for b in CELL}}
# each body's kernel, as its mangled name spells it
SASS_NAME = {"par": "par_kernel", "ser": "ser_kernel",
             "mix": "mix_kernelILb0EE", "dpx": "mix_kernelILb1EE",
             "m16": "m16_kernel", "k1": "cell_kernelILb1ELb1ELb0EE",
             "k1n": "cell_kernelILb0ELb0ELb0EE",
             "k1w": "cell_kernelILb1ELb1ELb1EE"}
# the kernels' own inner loops: library, mangled-name part, what it is
KERNEL_LOOPS = (
    ("strip", "strip_kernelILi8ELb1ELb1ELb0ELb0EE",
     "strip kernel, 8 rows a thread, SW, best tracked"),
    ("strip", "strip_kernelILi8ELb0ELb0ELb0ELb0EE",
     "strip kernel, 8 rows a thread, NW, nothing tracked"),
    ("batched_strip", "batched_strip_kernelILi8EE",
     "batched strip kernel, 8 rows a thread"),
)
THREADS = 256
REPS = 5        # timings per reading; the least counts, the spread is kept
FLOOR_MS = 5.0  # a timed launch lasts at least this long
# Hopper's SM (NVIDIA H100 Tensor Core GPU Architecture white paper): four
# warp schedulers, each dispatching one instruction for 32 lanes a clock, each
# with 16 INT32 lanes.
SCHEDULER_LANES_PER_SM = 128
INT32_LANES_PER_SM = 64
# The fewest INT32-lane instructions a Gotoh cell needs on this card, whatever
# implements it: three fused add-max (E, F, the diagonal against E) and one
# max (with F; the SW clamp rides on it), and one more max where the best
# cell is asked for.  The plain adds beside them (E - ge, F - ge) can take
# the FMA pipe, and the substitution can be looked up off the lanes.
CELL_FLOOR = {"untracked": 4, "tracked": 5}


# --- the plain versions ------------------------------------------------------

def _par(vals, it):
    return [torch.maximum(v ^ it, v - 1) for v in vals]


def _ser(vals, it):
    (v,) = vals
    for _ in range(8):
        v = torch.maximum(v ^ it, v - 1)
    return [v]


def _mix(vals, it):
    """tools/roofline.py:133-153 (dpx computes the same values)."""
    dt = vals[0].dtype
    hh = list(vals[:ALPHA])
    ee = list(vals[ALPHA:2 * ALPHA])
    up_h, up_f, dg0 = vals[2 * ALPHA:2 * ALPHA + 3]
    # the loop index as the lanes' type (int16 wraps, as astype does)
    it_t = torch.tensor(it, dtype=torch.int64).to(dt)
    rb = vals[2 * ALPHA + 3] ^ it_t
    one, minus3, zero = (torch.tensor(x, dtype=dt) for x in (1, -3, 0))
    go, ge = torch.tensor(GO, dtype=dt), torch.tensor(GE, dtype=dt)
    hs, fs = [], []
    for k in range(ALPHA):
        e_k = torch.maximum(hh[k] - go, ee[k]) - ge
        uh = up_h if k == 0 else hs[k - 1]
        uf = up_f if k == 0 else fs[k - 1]
        f_k = torch.maximum(uh - go, uf) - ge
        dg = dg0 if k == 0 else hh[k - 1]
        sub = torch.where(rb == k, one, minus3)
        h_k = torch.maximum(torch.maximum(dg + sub, e_k), f_k)
        h_k = torch.maximum(h_k, zero)
        hs.append(h_k)
        fs.append(f_k)
        ee[k] = e_k
    return hs + ee + [up_h, up_f, dg0, vals[2 * ALPHA + 3]]


_PLAIN = {"par": _par, "ser": _ser, "mix": _mix, "dpx": _mix, "m16": _mix}


def gotoh_cell(h, e, dg, vh, vf, eq, sw: bool):
    """``csrc/gotoh_cell.cuh`` on int32 tensors: the cell's (H, E, F) from
    the cell to the left (``h``, ``e``), the cell above (``vh``, ``vf``),
    the diagonal ``dg`` and whether the characters match, at the cell
    bodies' scores."""
    gofirst = -(GO + GE)
    en = torch.maximum(h + gofirst, e - GE)
    f = torch.maximum(vh + gofirst, vf - GE)
    sub = eq.to(dg.dtype) * (MATCH - MISMATCH) + MISMATCH
    d = torch.maximum(dg + sub, en)
    hv = torch.maximum(d, f)
    return (hv.clamp(min=0) if sw else hv), en, f


def shift_lanes(v: torch.Tensor) -> torch.Tensor:
    """``__shfl_up_sync(all, v, 1)`` on a flat tensor of whole warps: lane
    l of each group of 32 takes lane l - 1's value, lane 0 keeps its
    own."""
    w = v.view(-1, 32)
    return torch.cat([w[:, :1], w[:, :-1]], 1).reshape(-1)


def _cell_plain(body: str, xs, iters: int, threads: int) -> torch.Tensor:
    """A cell body's plain version: ``cell_kernel`` of csrc/roofline.cu,
    step by step, on flat int32 tensors; thread g sits in block
    ``g // threads``."""
    sw, track, warp = CELL[body]
    v = [x.reshape(-1) for x in xs]
    n, dev = v[0].numel(), v[0].device
    threads = min(threads, n)
    i32 = torch.int32
    g = torch.arange(n, device=dev)
    lane = ((g % threads) % 32).to(i32)
    hl, el = list(v[:ALPHA]), list(v[ALPHA:2 * ALPHA])
    ch = [x & 3 for x in v[2 * ALPHA:3 * ALPHA]]
    dprev, ph, pf = v[3 * ALPHA:3 * ALPHA + 3]
    # bs[i] of a block: the column character of its thread i % threads
    cb = (v[3 * ALPHA + 3] & 3).view(-1, threads)
    bs = cb[:, torch.arange(BS, device=dev) % threads]
    block = g // threads
    bv = [torch.full((n,), NEG, dtype=i32, device=dev) for _ in range(ALPHA)]
    bj = [torch.zeros(n, dtype=i32, device=dev) for _ in range(ALPHA)]
    if warp:
        if threads % 32:
            raise ValueError("k1w takes whole warps")
        # a warp's ring above: lane l's (ph, pf) at slots l, l + 32, ...
        in_h = ph.view(-1, 32).repeat(1, RING // 32)
        in_f = pf.view(-1, 32).repeat(1, RING // 32)
        out_h = torch.full_like(in_h, NEG)
        out_f = torch.full_like(in_f, NEG)
    for it in range(iters):
        j = it - lane
        uh, uf = ph, pf
        if warp:  # lane 0 reads the ring, the others their shuffled values
            slot = it & (RING - 1)
            uh = torch.where(lane == 0, in_h[:, slot].repeat_interleave(32),
                             ph)
            uf = torch.where(lane == 0, in_f[:, slot].repeat_interleave(32),
                             pf)
        bc = bs[block, (j & (BS - 1)).long()]
        vh, vf, dg = uh, uf, dprev
        for k in range(ALPHA):
            left = hl[k]
            hl[k], el[k], vf = gotoh_cell(left, el[k], dg, vh, vf,
                                          ch[k] == bc, sw)
            vh, dg = hl[k], left
            if track:
                better = vh > bv[k]
                bv[k] = torch.where(better, vh, bv[k])
                bj[k] = torch.where(better, j, bj[k])
        dprev = uh
        if warp:  # lane 31 writes the ring below at its column
            slot = (it - 31) & (RING - 1)
            out_h[:, slot] = vh.view(-1, 32)[:, 31]
            out_f[:, slot] = vf.view(-1, 32)[:, 31]
            ph, pf = shift_lanes(vh), shift_lanes(vf)
        else:
            ph, pf = vh, vf
    acc = dprev + ph + pf
    for k in range(ALPHA):
        acc = acc + hl[k] + el[k]
        if track:
            acc = acc + bv[k] + bj[k]
    if warp:  # lane l folds slots l, l + 32, ... of the ring below
        acc = acc + (out_h + out_f).view(-1, RING // 32, 32).sum(
            1, dtype=i32).reshape(-1)
    return acc.reshape(xs[0].shape)


def inputs(body: str) -> list[np.ndarray]:
    """The TPU tool's inputs: ``default_rng(i).integers(-1000, 1000, (RS,
    lanes))`` for input i, int32 (RS, 128), or int16 (RS, 256) for m16."""
    lanes = 2 * LANES if body == "m16" else LANES
    dt = np.int16 if body == "m16" else np.int32
    return [np.random.default_rng(i).integers(-1000, 1000, (RS, lanes),
                                              dtype=np.int32).astype(dt)
            for i in range(N_IN[body])]


def run_plain(body: str, xs: list[torch.Tensor], iters: int,
              threads: int = THREADS) -> torch.Tensor:
    """The body's plain version: ``iters`` iterations of its elementwise
    ops, then the max over its values (the wrapping sum for a cell body),
    as int32.  ``threads`` is the block size the kernel would run with: a
    cell body's column characters are per block."""
    if body in CELL:
        return _cell_plain(body, xs, iters, threads)
    vals = list(xs)
    for it in range(iters):
        vals = _PLAIN[body](vals, it)
    acc = vals[0]
    for v in vals[1:]:
        acc = torch.maximum(acc, v)
    return acc.to(torch.int32)


# --- the kernels' wrappers ---------------------------------------------------

class Launch(NamedTuple):
    """One body's launch, ready: the inputs stacked as the kernel reads
    them and the output allocated, so that ``launch`` only launches."""

    body: str
    flat: torch.Tensor
    out: torch.Tensor
    blocks: int
    threads: int
    shape: tuple


def prepare(body: str, xs: list[torch.Tensor],
            threads: int = THREADS) -> Launch:
    """Check the inputs, stack them and allocate the output: one thread per
    lane (an int16 pair per thread for m16), ``threads`` per block."""
    dev = xs[0].device
    if dev.type != "cuda":
        raise ValueError(f"run_cuda needs CUDA tensors, got {dev}")
    want = torch.int16 if body == "m16" else torch.int32
    if len(xs) != N_IN[body] or any(x.dtype != want or x.shape != xs[0].shape
                                    or x.device != dev for x in xs):
        raise ValueError(f"{body} takes {N_IN[body]} equal {want} tensors "
                         f"on one device")
    flat = torch.stack([x.reshape(-1) for x in xs]).contiguous()
    if body == "m16":
        if flat.shape[1] % 2:
            raise ValueError("m16 needs an even number of int16 lanes")
        flat = flat.view(torch.int32)  # two int16 lanes per thread
    lanes = flat.shape[1]
    threads = min(threads, lanes)
    if lanes % threads:
        raise ValueError(f"{lanes} lanes do not fill blocks of {threads}")
    if body == "k1w" and (threads % 32 or threads > 256):
        raise ValueError("k1w takes blocks of 1 to 8 whole warps")
    out = torch.empty(xs[0].numel(), dtype=torch.int32, device=dev)
    return Launch(body, flat, out, lanes // threads, threads,
                  tuple(xs[0].shape))


def launch(p: Launch, iters: int) -> torch.Tensor:
    """Launch ``p``'s kernel for ``iters`` iterations on the current
    stream, and nothing else; the result is ``p``'s output buffer."""
    dev = p.flat.device
    lib = kernels.load("roofline")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.masa_roofline_launch(
            _CODE[p.body], int(iters), p.blocks, p.threads,
            ctypes.c_void_p(p.flat.data_ptr()),
            ctypes.c_void_p(p.out.data_ptr()), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"roofline {p.body} launch failed: CUDA error "
                           f"{rc}")
    run_cuda.launches += 1
    return p.out.view(p.shape)


def run_cuda(body: str, xs: list[torch.Tensor], iters: int,
             threads: int = THREADS) -> torch.Tensor:
    """The body's kernel on the card (``prepare``, then ``launch``).  Same
    result as ``run_plain``."""
    return launch(prepare(body, xs, threads), iters)


run_cuda.launches = 0  # counted in ``launch``, where the kernel starts


def run(body: str, xs: list[torch.Tensor], iters: int) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if xs[0].device.type == "cpu":
        return run_plain(body, xs, iters)
    return run_cuda(body, xs, iters)


def blocks_per_sm(body: str, threads: int = THREADS) -> int:
    """Blocks of ``threads`` threads of the body's kernel that the runtime
    says one SM of the current card holds at once."""
    n = int(kernels.load("roofline").masa_roofline_blocks_per_sm(
        _CODE[body], threads))
    if n < 1:
        raise RuntimeError(f"could not query the occupancy of {body}")
    return n


# --- the SASS: a body's instructions per iteration, by pipe ------------------

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                    r"([^;]*);")
_FUNCTION = re.compile(r"^\s*Function : (\S+)", re.M)
_PIPES = (  # first match wins; the rest is "other"
    ("control", ("BRA", "BSSY", "BSYNC", "EXIT", "NOP", "WARPSYNC", "BAR",
                 "NANOSLEEP", "CALL", "RET", "YIELD", "DEPBAR", "MEMBAR",
                 "ERRBAR", "BPT", "KILL", "BREAK", "JMP", "BRX")),
    ("lsu", ("LDS", "STS", "LDG", "STG", "LDL", "STL", "LD", "ST", "ATOM",
             "RED", "LDSM", "SHFL", "CCTL", "LDC")),
    ("fma", ("IMAD", "VIADD", "FFMA", "FMUL", "FADD", "HFMA2", "HADD2",
             "HMUL2", "IDP")),
    ("xu", ("MUFU", "POPC", "FLO", "BREV", "I2F", "F2I", "S2R", "CS2R",
            "I2I", "F2F")),
)


def pipe_of(opcode: str) -> str:
    """The SM pipe an opcode runs on, by its name: ``alu`` (the INT32
    lanes: IADD3, logic, compare, select, min/max and the DPX add-max),
    ``fma`` (the float pipe, which also takes IMAD and the plain integer
    add VIADD: the compiler spreads a body's adds over both pipes, and the
    cell bodies' rates pass 64 lanes a clock only because of it),
    ``lsu`` (shared and global memory, shuffles), ``xu``, ``uniform`` (the
    uniform datapath) or ``control``."""
    op = opcode.split(".")[0]
    if op.startswith("U"):
        return "uniform"
    for pipe, names in _PIPES:
        if op in names:
            return pipe
    return "alu"


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output cut into functions: mangled name ->
    [(address, opcode, operands)], in address order."""
    out = {}
    marks = list(_FUNCTION.finditer(text))
    for k, m in enumerate(marks):
        end = marks[k + 1].start() if k + 1 < len(marks) else len(text)
        out[m.group(1)] = [(int(a, 16), op, rest.strip()) for a, op, rest
                           in _INSTR.findall(text[m.end():end])]
    return out


def inner_loops(instrs: list) -> list:
    """The innermost loops of a function: (first, last) indices into
    ``instrs`` of every backward branch's span that holds no other."""
    index = {addr: k for k, (addr, _, _) in enumerate(instrs)}
    spans = []
    for k, (addr, op, rest) in enumerate(instrs):
        if not op.startswith("BRA"):
            continue
        targets = re.findall(r"0x[0-9a-f]+", rest)
        if targets and int(targets[-1], 16) <= addr \
                and int(targets[-1], 16) in index:
            spans.append((index[int(targets[-1], 16)], k))
    return [s for s in spans
            if not any(o != s and s[0] <= o[0] and o[1] <= s[1]
                       for o in spans)]


def loop_counts(instrs: list, span: tuple) -> dict:
    """A loop's instructions: the total and the count by pipe."""
    counts = {"total": span[1] - span[0] + 1}
    for _, op, _ in instrs[span[0]:span[1] + 1]:
        pipe = pipe_of(op)
        counts[pipe] = counts.get(pipe, 0) + 1
    return counts


def _count(instrs, span, prefix):
    return sum(op.startswith(prefix) for _, op, _ in
               instrs[span[0]:span[1] + 1])


def main_loop(instrs: list, cell: bool = False):
    """The loop that does a kernel's work.  Of a roofline body: the
    innermost loop of the most instructions (the unrolled one, not its
    remainder).  With ``cell``, of a kernel that sweeps the Gotoh cell: the
    loop of at least a step of cells (three DPX add-max each) with the
    fewest instructions per add-max: the interior chunk of a full block,
    not an edge chunk or a loop around one."""
    loops = inner_loops(instrs)
    if cell:
        loops = [s for s in loops
                 if _count(instrs, s, "VIADDMNMX") >= 3 * ALPHA]
        return min(loops, default=None, key=lambda s: (
            (s[1] - s[0] + 1) / _count(instrs, s, "VIADDMNMX")))
    return max(loops, default=None, key=lambda s: s[1] - s[0])


def disassembler() -> str:
    """``cuobjdump`` of the toolkit that built the kernels."""
    for c in (os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump"),
              shutil.which("cuobjdump")):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("no cuobjdump on this machine: the roofline counts "
                       "its bodies' instructions in the built SASS")


def sass(name: str) -> dict:
    """The functions of ``csrc/<name>.cu``'s built library, or of the
    library at the path ``name``."""
    path = name if os.path.exists(name) else kernels.build(name)
    r = subprocess.run([disassembler(), "-sass", path], capture_output=True,
                       text=True, timeout=300, check=True)
    return sass_functions(r.stdout)


def cell_loops(path: str) -> dict:
    """Every kernel of the library at ``path`` that sweeps the Gotoh cell:
    its name (without the hash of its unnamed namespace) -> its interior
    loop's instructions per cell by pipe, and a digest of all its
    instructions.  Two builds of one kernel with equal digests are the
    same machine code."""
    out = {}
    for name, instrs in sass(path).items():
        span = main_loop(instrs, cell=True)
        if span is None:
            continue
        cells = _count(instrs, span, "VIADDMNMX") / 3
        code = "\n".join(f"{op} {rest}" for _, op, rest in instrs)
        out[re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", name)] = {
            **{k: round(v / cells, 3)
               for k, v in loop_counts(instrs, span).items()},
            "instructions": len(instrs),
            "digest": hashlib.sha256(code.encode()).hexdigest()[:12]}
    return out


def _function(functions: dict, part: str) -> list:
    found = [v for k, v in functions.items() if part in k]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} functions named *{part}* in the "
                           f"SASS")
    return found[0]


def instructions() -> dict:
    """Instructions per iteration of every body's main loop, and per cell
    of the cell bodies and of the kernels' own inner loops, by pipe."""
    out = {}
    functions = sass("roofline")
    for body in BODIES:
        instrs = _function(functions, SASS_NAME[body])
        span = main_loop(instrs)
        if span is None:
            raise RuntimeError(f"no loop in the SASS of {body}")
        per = UNROLL[body] * {"par": 1, "ser": 1,
                              "m16": 2 * ALPHA}.get(body, ALPHA)
        out[body] = {"per": "cell" if per > UNROLL[body] else "iteration",
                     **{k: v / per for k, v in
                        loop_counts(instrs, span).items()}}
    libs = {}
    for lib, part, what in KERNEL_LOOPS:
        libs.setdefault(lib, None)
        if libs[lib] is None:
            libs[lib] = sass(lib)
        instrs = _function(libs[lib], part)
        span = main_loop(instrs, cell=True)
        cells = _count(instrs, span, "VIADDMNMX") / 3 if span else 0
        if not cells:
            raise RuntimeError(f"no cell loop in the SASS of {part}")
        out[what] = {"per": "cell", "cells_per_trip": cells,
                     **{k: v / cells for k, v in
                        loop_counts(instrs, span).items()}}
    return out


def floor_cycles(counts: dict) -> float:
    """The least SM cycles per lane for a loop's instructions: the INT32
    lanes take the ``alu`` ones, the schedulers dispatch them all."""
    return max(counts.get("alu", 0) / INT32_LANES_PER_SM,
               counts["total"] / SCHEDULER_LANES_PER_SM)


# --- timing ------------------------------------------------------------------

def full_inputs(body: str, lanes: int, dev) -> list[torch.Tensor]:
    """Random inputs for ``lanes`` threads of ``body``, made on the card
    from a seed."""
    n = lanes * (2 if body == "m16" else 1)
    g = torch.Generator(device=dev).manual_seed(0)
    dt = torch.int16 if body == "m16" else torch.int32
    return [torch.randint(-1000, 1000, (n,), generator=g, device=dev,
                          dtype=torch.int32).to(dt)
            for _ in range(N_IN[body])]


def time_launch(p: Launch, iters: int, reps: int = REPS):
    """``(least ms, spread)`` of ``reps`` launches of ``p`` by CUDA events
    around the launch alone, after a warm one; the spread is (most -
    least) / least."""
    launch(p, iters)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        launch(p, iters)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times), (max(times) - min(times)) / min(times)


def slope(body: str, blocks: int, threads: int = THREADS,
          floor_ms: float = FLOOR_MS) -> dict:
    """The card's time for T iterations of ``body`` on ``blocks`` x
    ``threads`` lanes as the T -> 2T difference of launch times, T doubled
    until a launch lasts ``floor_ms``."""
    p = prepare(body, full_inputs(body, blocks * threads,
                                  torch.device("cuda")), threads)
    T = 64
    while True:
        ms1, spread1 = time_launch(p, T)
        if ms1 >= floor_ms or T >= 1 << 24:
            break
        T *= 2
    ms2, spread2 = time_launch(p, 2 * T)
    return {"blocks": blocks, "threads": threads, "iterations": T,
            "ms": ms1, "spread": spread1, "ms_2T": ms2, "spread_2T": spread2,
            "seconds": max(ms2 - ms1, 1e-6) / 1e3, "launch": p}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def sm_clocks() -> tuple[float, float]:
    """The SM clock now and its maximum, in MHz."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    now, most = r.stdout.strip().splitlines()[0].split(",")
    return float(now), float(most)


def clocks_under_load(p: Launch, iters: int, ms: float):
    """Launch ``p`` for about a second and a half (``iters`` iterations
    last ``ms``) and read the SM clock while it runs, up to three times.
    Returns ([MHz read under load], the maximum MHz)."""
    done = torch.cuda.Event()
    launch(p, int(iters * 1500.0 / ms))
    done.record()
    read, most = [], 0.0
    while len(read) < 3 and not done.query():
        now, most = sm_clocks()
        if not done.query():
            read.append(now)
    done.synchronize()
    if not read:  # the launch ended before nvidia-smi answered
        now, most = sm_clocks()
        read.append(now)
    return read, most


def measure() -> dict:
    """The roofline of the current card: the TPU tool's keys, then the cell
    bodies' rates, every body's instructions, the clock and the peak."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline needs a CUDA device")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = {b: blocks_per_sm(b) for b in BODIES}
    runs = {b: slope(b, sms * per_sm[b]) for b in BODIES if b != "ser"}
    runs["ser"] = slope("ser", 1, 32)  # one warp: nothing hides it
    # the clock while the strip kernel's cell runs, for the peak
    k1 = runs["k1"]
    read, clock_max = clocks_under_load(k1["launch"], k1["iterations"],
                                        k1["ms"])
    clock = max(read)
    # INT32 lanes a clock an SM, measured: par on one SM, 1 to 16 warps
    instr = instructions()
    one_sm = {}
    for warps in (1, 2, 4, 8, 12, 16):
        r = slope("par", 1, 32 * warps, floor_ms=2.0)
        one_sm[warps] = (r["iterations"] * instr["par"]["alu"] * 32 * warps
                         / r["seconds"] / (clock * 1e6))
    peak = sms * INT32_LANES_PER_SM * clock * 1e6

    def rate(body, per_lane):  # per_lane things per second, all lanes
        r = runs[body]
        return (r["iterations"] * per_lane * r["blocks"] * r["threads"]
                / r["seconds"])

    cells = {b: rate(b, ALPHA * (2 if b == "m16" else 1))
             for b in ("mix", "dpx", "m16", *CELL)}
    share = {"par": rate("par", instr["par"]["alu"]) / peak}
    for b in ("mix", "dpx", *CELL):
        share[b] = cells[b] * floor_cycles(instr[b]) / (sms * clock * 1e6)
    name, _, limit = card().partition(",")
    return {
        "par_native_ops_per_s": round(rate("par", OPS["par"]) / 1e9, 2),
        "ser_latency_ns": round(runs["ser"]["seconds"] / (
            runs["ser"]["iterations"] * OPS["ser"]) * 1e9, 3),
        "mix_alpha": ALPHA,
        "mix_rs": THREADS,
        "mix_bound_gcups": round(cells["mix"] / 1e9, 1),
        "mix16_bound_gcups": round(cells["m16"] / 1e9, 1),
        "mix_dpx_bound_gcups": round(cells["dpx"] / 1e9, 1),
        "k1_cell_gcups": round(cells["k1"] / 1e9, 1),
        "k1n_cell_gcups": round(cells["k1n"] / 1e9, 1),
        "k1w_gcups": round(cells["k1w"] / 1e9, 1),
        "cell_floor_lane_instructions": dict(CELL_FLOOR),
        "cell_floor_gcups": {k: round(peak / n / 1e9, 1)
                             for k, n in CELL_FLOOR.items()},
        "instructions": {k: {f: (round(x, 3) if isinstance(x, float) else x)
                             for f, x in v.items()}
                         for k, v in instr.items()},
        "sm_clock_mhz": clock,
        "sm_clock_read_mhz": read,
        "sm_clock_max_mhz": clock_max,
        "int32_lanes_per_clock_per_sm": INT32_LANES_PER_SM,
        "par_alu_lanes_per_clock_on_one_sm": {
            str(w): round(v, 2) for w, v in one_sm.items()},
        "int32_peak_ops_per_s": round(peak / 1e9, 2),
        "share_of_instruction_floor": {b: round(v, 4)
                                       for b, v in share.items()},
        "timings": {b: {k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in r.items() if k != "launch"}
                    | {"blocks_per_sm": per_sm[b]}
                    for b, r in runs.items()},
        "filling_launch": {
            "body": "k1", "blocks": k1["blocks"], "threads": k1["threads"],
            "iterations": k1["iterations"], "ms": k1["ms"],
            "spread": k1["spread"],
            "instruction_floor_ms": 1e3 * k1["iterations"] * ALPHA
            * k1["blocks"] * k1["threads"] * floor_cycles(instr["k1"])
            / (sms * clock * 1e6)},
        "sms": sms,
        "card": name.strip(),
        "power_limit": limit.strip(),
        "note": "G ops/s counts 2 ops per chain step as the TPU tool does; "
                f"one thread is one lane, {THREADS} per block, SMs x the "
                "blocks the runtime fits on an SM; every time is the least "
                f"of {REPS} launches by events around the launch alone "
                "(spread = (most - least) / least), rates from the T -> 2T "
                "slope.  mix/dpx/m16 (the TPU tool's graph) compare with a "
                "loop constant, track no best and exchange nothing.  k1 is "
                "the strip kernel's SW cell with best tracking and k1n its "
                "NW cell without (also the batched kernels' cell), "
                "csrc/gotoh_cell.cuh itself: they omit the exchange "
                "between lanes and warps, the bus and every wait; k1w adds "
                "one warp's exchange (two shuffles, a ring read and a ring "
                "write per step).  k1, k1n and k1w say what today's cell "
                "code costs and are no bounds: a cell spelled with fewer "
                "INT32-lane instructions would pass them.  The bound of a "
                "kernel that sweeps cells is cell_floor_gcups: "
                "int32_peak_ops_per_s over the fewest INT32-lane "
                "instructions a cell needs (three add-max and a max, one "
                "more max for the best).  instructions: per cell (per "
                "iteration for par/ser) of each main loop in the SASS, by "
                "pipe (alu = the INT32 lanes; the fma pipe takes VIADD and "
                "IMAD); par_alu_lanes_per_clock_on_one_sm is par on one "
                "block of 1 to 16 warps, the measured lanes.  "
                "int32_peak_ops_per_s = SMs x 64 INT32 lanes x the "
                "clock nvidia-smi read while k1 ran; "
                "share_of_instruction_floor = a body's rate x max(its "
                "alu instructions / 64, all its instructions / 128) "
                "cycles, over SMs x that clock",
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--cell-loops"]:  # needs cuobjdump, no card
        for path in argv[1:]:
            print(json.dumps({"library": path, "kernels": cell_loops(path)}))
        return 0
    if not torch.cuda.is_available():
        print("roofline: no CUDA device is available", file=sys.stderr)
        return 2
    print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
