"""Measure the card's integer issue rate, its dependent-op latency and the
DP step's op-mix bound, and print a roofline for the strip kernel.

Port of ``tools/roofline.py``: its Pallas bodies become the CUDA kernels of
``csrc/roofline.cu`` (each thread one lane, the TPU's (RS, 128) vector
becoming 32 x 128 lanes), each with a plain PyTorch version here that
applies the same elementwise ops with int32 (or int16) wraparound.

  par  8 independent chains of max(v ^ it, v - 1)  -> issue rate
  ser  one chain of 8 such steps, on one warp       -> dependent-op latency
  mix  the DP step's graph, 8 rows per thread       -> cells/s bound
  dpx  mix through Hopper's DPX instructions        -> cells/s bound
  m16  mix on packed int16 pairs                    -> cells/s bound

Times come from CUDA events around T and 2T iterations; the slope cancels
the launch and the loads, as the TPU tool's T -> 2T slope does.

Usage: python -m masa_tpu_torch.tools.roofline   (needs a CUDA device)
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from masa_tpu_torch.ops import kernels

W = 8          # par chains
ALPHA = 8      # mix rows per thread (csrc/strip.cu's ALPHA)
GO, GE = 3, 2  # the mix's gap scores (the TPU tool's)
RS, LANES = 32, 128  # the TPU tool's vector shape, for the plain checks
BODIES = ("par", "ser", "mix", "dpx", "m16")
_CODE = {name: k for k, name in enumerate(BODIES)}  # csrc/roofline.cu Body
N_IN = {"par": W, "ser": 1, "mix": 2 * ALPHA + 4, "dpx": 2 * ALPHA + 4,
        "m16": 2 * ALPHA + 4}
# ops per lane per iteration, counted as the TPU tool counts them
OPS = {"par": 2 * W, "ser": 16, "mix": ALPHA * 12, "dpx": ALPHA * 12,
       "m16": ALPHA * 12}
THREADS = 256


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


def inputs(body: str) -> list[np.ndarray]:
    """The TPU tool's inputs: ``default_rng(i).integers(-1000, 1000, (RS,
    lanes))`` for input i, int32 (RS, 128), or int16 (RS, 256) for m16."""
    lanes = 2 * LANES if body == "m16" else LANES
    dt = np.int16 if body == "m16" else np.int32
    return [np.random.default_rng(i).integers(-1000, 1000, (RS, lanes),
                                              dtype=np.int32).astype(dt)
            for i in range(N_IN[body])]


def run_plain(body: str, xs: list[torch.Tensor], iters: int) -> torch.Tensor:
    """The body's plain version: ``iters`` iterations of its elementwise
    ops, then the max over its values, as int32."""
    vals = list(xs)
    for it in range(iters):
        vals = _PLAIN[body](vals, it)
    acc = vals[0]
    for v in vals[1:]:
        acc = torch.maximum(acc, v)
    return acc.to(torch.int32)


def run_cuda(body: str, xs: list[torch.Tensor], iters: int,
             threads: int = THREADS) -> torch.Tensor:
    """The body's kernel on the card: one thread per lane (an int16 pair
    per thread for m16), ``threads`` per block.  Same result as
    ``run_plain``."""
    dev = xs[0].device
    if dev.type != "cuda":
        raise ValueError(f"run_cuda needs CUDA tensors, got {dev}")
    want = torch.int16 if body == "m16" else torch.int32
    if len(xs) != N_IN[body] or any(x.dtype != want or x.shape != xs[0].shape
                                    or x.device != dev for x in xs):
        raise ValueError(f"{body} takes {N_IN[body]} equal {want} tensors "
                         f"on one device")
    shape = xs[0].shape
    flat = torch.stack([x.reshape(-1) for x in xs]).contiguous()
    if body == "m16":
        if flat.shape[1] % 2:
            raise ValueError("m16 needs an even number of int16 lanes")
        flat = flat.view(torch.int32)  # two int16 lanes per thread
    lanes = flat.shape[1]
    threads = min(threads, lanes)
    if lanes % threads:
        raise ValueError(f"{lanes} lanes do not fill blocks of {threads}")
    out = torch.empty(xs[0].numel(), dtype=torch.int32, device=dev)
    lib = kernels.load("roofline")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.masa_roofline_launch(
            _CODE[body], int(iters), lanes // threads, threads,
            ctypes.c_void_p(flat.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"roofline {body} launch failed: CUDA error {rc}")
    run_cuda.launches += 1
    return out.reshape(shape)


run_cuda.launches = 0


def run(body: str, xs: list[torch.Tensor], iters: int) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if xs[0].device.type == "cpu":
        return run_plain(body, xs, iters)
    return run_cuda(body, xs, iters)


def _slope(body: str, blocks: int, threads: int, T: int,
           reps: int = 3) -> float:
    """Seconds the card takes for T iterations of ``body`` on blocks x
    threads lanes: the best T -> 2T difference of CUDA-event times."""
    dev = torch.device("cuda")
    n = blocks * threads * (2 if body == "m16" else 1)
    g = torch.Generator(device=dev).manual_seed(0)
    dt = torch.int16 if body == "m16" else torch.int32
    xs = [torch.randint(-1000, 1000, (n,), generator=g, device=dev,
                        dtype=torch.int32).to(dt) for _ in range(N_IN[body])]

    def once(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_cuda(body, xs, iters, threads)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    once(T)  # warm
    d1 = min(once(T) for _ in range(reps))
    d2 = min(once(2 * T) for _ in range(reps))
    return max(d2 - d1, 1e-9)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def measure() -> dict:
    """The roofline of the current card, with the TPU tool's keys."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline needs a CUDA device")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    full = 8 * sms  # blocks of THREADS lanes filling the card
    lanes = full * THREADS
    T = {"par": 1 << 16, "ser": 1 << 18, "mix": 1 << 14, "dpx": 1 << 14,
         "m16": 1 << 14}
    par_dt = _slope("par", full, THREADS, T["par"])
    ser_dt = _slope("ser", 1, 32, T["ser"])  # one warp: nothing hides it
    cells = {}
    for body in ("mix", "dpx", "m16"):
        per_lane = ALPHA * (2 if body == "m16" else 1)
        cells[body] = T[body] * per_lane * lanes / _slope(
            body, full, THREADS, T[body])
    name, _, limit = card().partition(",")
    return {
        "par_native_ops_per_s": round(
            T["par"] * OPS["par"] * lanes / par_dt / 1e9, 2),
        "ser_latency_ns": round(ser_dt / (T["ser"] * OPS["ser"]) * 1e9, 3),
        "mix_alpha": ALPHA,
        "mix_rs": THREADS,
        "mix_bound_gcups": round(cells["mix"] / 1e9, 1),
        "mix16_bound_gcups": round(cells["m16"] / 1e9, 1),
        "mix_dpx_bound_gcups": round(cells["dpx"] / 1e9, 1),
        "card": name.strip(),
        "power_limit": limit.strip(),
        "note": "G ops/s counts 2 ops per chain step as the TPU tool does; "
                f"one thread is one lane, {THREADS} per block, {full} "
                "blocks; mix/dpx/m16 omit the strip kernel's bus, shared-"
                "memory exchange and barrier: an UPPER bound on its cells/s "
                "with 8 rows per thread; m16 runs two int16 cells per "
                "thread, dpx the same graph as mix through DPX",
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("roofline: no CUDA device is available", file=sys.stderr)
        return 2
    print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
