"""Taken from ``masa_tpu/native/bindings.py`` (the JAX reference).

ctypes bindings to the native C++ helpers (``masanative.cpp``, beside
this file).

The native library accelerates host-side hot paths — FASTA loading,
Myers-Miller splitting (stage 4), small-matrix traceback (stage 5) — the
parts the reference implements in C++/pthreads.  It is built with ``g++``
at first use into ``masa_tpu_torch/_build/``, named by the source's hash
(as ``ops/kernels.build`` names the CUDA libraries), never beside the
source.  `available()` gates usage: it is False where there is no ``g++``
(the callers then take their NumPy paths); a compiler that is present and
fails raises, so stage 4 never changes engine silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_LIB = None

_SRC = os.path.join(os.path.dirname(__file__), "masanative.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "_build")


def _build() -> str:
    """Compile ``masanative.cpp`` unless this source's library exists;
    returns the library path."""
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libmasanative_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", _SRC, "-o", tmp]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build())
        _configure(lib)
        _LIB = lib
    return _LIB


def _configure(lib):
    lib.masa_load_fasta.restype = ctypes.c_longlong
    lib.masa_load_fasta.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,
        ctypes.c_char_p, ctypes.c_longlong,
    ]
    lib.masa_traceback.restype = ctypes.c_longlong
    lib.masa_traceback.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,   # seq0
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,   # seq1
        ctypes.c_int, ctypes.c_int,                          # type_s/type_e
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # scores
        ctypes.POINTER(ctypes.c_int), ctypes.c_longlong,     # ops out
    ]
    lib.masa_reduce_partitions.restype = ctypes.c_longlong
    lib.masa_reduce_partitions.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,   # seq0
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,   # seq1
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,  # cps in
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # scores
        ctypes.c_longlong, ctypes.c_int,                     # mps, threads
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,  # cps out
    ]


_AVAILABLE = None


def available() -> bool:
    """Whether the native helpers are in use, decided once a process:
    stage 5 asks once a partition, and a ``shutil.which`` walk of PATH
    each time cost more than its traceback on small partitions.  A
    compiler that fails raises, and is asked again at the next call."""
    global _AVAILABLE
    if _AVAILABLE is None:
        _AVAILABLE = (not os.environ.get("MASA_TPU_NO_NATIVE")
                      and shutil.which("g++") is not None
                      and _load() is not None)
    return _AVAILABLE


def load_fasta(path: str) -> tuple[str, np.ndarray]:
    lib = _load()
    size = os.path.getsize(path)
    buf = np.empty(size, np.uint8)
    desc = ctypes.create_string_buffer(4096)
    n = lib.masa_load_fasta(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        size, desc, 4096,
    )
    if n < 0:
        raise IOError(f"native FASTA load failed for {path}")
    return desc.value.decode("ascii", "replace"), buf[:n].copy()


def traceback_ops(seq0: np.ndarray, seq1: np.ndarray, type_s: int,
                  type_e: int, params) -> tuple[int, np.ndarray]:
    """Native constrained DP + traceback.  Returns (segment_score, ops)
    where ops is an int32 array of (code, count) pairs: 0=diag, 1=up(gap
    in seq1), 2=left(gap in seq0); opened-flag in bit 2 of code."""
    lib = _load()
    h, w = len(seq0), len(seq1)
    out = np.empty(2 * (h + w + 2), np.int32)
    seg = lib.masa_traceback(
        np.ascontiguousarray(seq0, np.uint8).ctypes.data_as(
            ctypes.POINTER(ctypes.c_ubyte)), h,
        np.ascontiguousarray(seq1, np.uint8).ctypes.data_as(
            ctypes.POINTER(ctypes.c_ubyte)), w,
        type_s, type_e,
        params.match, params.mismatch, params.gap_open, params.gap_ext,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(out),
    )
    if seg == -(1 << 62):
        raise RuntimeError("native traceback failed")
    count = out[0]
    return int(seg), out[1 : 1 + 2 * count].reshape(-1, 2).copy()


def reduce_partitions(seq0, seq1, cps, params, mps: int,
                      nthreads: int | None = None) -> list:
    """Native stage-4 reduce: split every adjacent crosspoint pair until
    max(height, width) <= mps, fanned over a thread pool (the reference's
    4-pthread reduce_partitions, stage4/sw_stage4.cpp:806-852).

    `cps` is a list of Crosspoint; returns the densified list.  Raises
    RuntimeError on backtrace loss (same contract as the Python path).
    """
    from masa_tpu_torch.types import Crosspoint

    if nthreads is None:
        nthreads = min(8, os.cpu_count() or 4)
    lib = _load()
    seq0 = np.ascontiguousarray(seq0, np.uint8)
    seq1 = np.ascontiguousarray(seq1, np.uint8)
    arr = np.array([(c.i, c.j, c.score, int(c.type)) for c in cps],
                   np.int64).reshape(-1)
    # worst case one crosspoint per mps cells along the path + slack;
    # gap-dense paths can exceed the heuristic (leaf count approaches
    # H+W when splitting bottoms out at h<2), so grow on -2 and retry
    span = sum(max(b.i - a.i, b.j - a.j) for a, b in zip(cps, cps[1:]))
    cap = 2 * (span // max(mps, 1) + len(cps) + 16)
    hard_cap = 4 * (span + len(cps) + 16)  # true worst case
    while True:
        out = np.empty(4 * cap, np.int64)
        n = lib.masa_reduce_partitions(
            seq0.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), len(seq0),
            seq1.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), len(seq1),
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(cps),
            params.match, params.mismatch, params.gap_open, params.gap_ext,
            mps, nthreads,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), cap,
        )
        if n != -2:
            break
        if cap >= hard_cap:
            raise RuntimeError("native stage-4 output overflow")
        cap = min(4 * cap, hard_cap)
    if n < 0:
        raise RuntimeError("native stage-4 lost the backtrace")
    quads = out[: 4 * n].reshape(n, 4)
    return [Crosspoint(int(i), int(j), int(s), int(t))
            for i, j, s, t in quads]
