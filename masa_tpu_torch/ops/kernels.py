"""Build and bind the hand-written Hopper kernels (``csrc/*.cu``).

Each kernel source (``csrc/strip.cu``, ``csrc/batched_strip.cu``,
``csrc/roofline.cu`` and ``csrc/hop.cu``, which include
``csrc/gotoh_cell.cuh``, the DP cell, and ``csrc/traceback.cu``, stage
5's DP and walk) is compiled with ``nvcc`` for
``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``masa_tpu_torch/_build/`` (named by the source's hash, so an edited source
rebuilds), and bound with ``ctypes``.  Nothing here runs when the module is
imported: the CPU tests import it on hosts with no toolkit.

``strip_cuda``, ``batched_strip_cuda``, ``batched_strip_fixed_cuda``,
``hop_cuda`` (a stage-2 hop in one launch), ``hop_prep_cuda`` and
``hop_match_cuda`` (the prologue and epilogue of a hop taller than a
cluster holds) and ``traceback_cuda`` (stage 5's partitions) launch their
kernels on PyTorch's current stream and count
their launches in ``.launches``; the roofline tool's launcher lives in
``masa_tpu_torch/tools/roofline.py``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import NamedTuple

import numpy as np
import torch

from masa_tpu_torch.types import ScoreParams
from masa_tpu_torch.utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("strip", "batched_strip", "roofline", "hop",
                        "traceback")}
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
build_log: dict = {}  # name -> nvcc's stderr of this process's build
# Set to a list to time every launch: each wrapper then appends (name,
# start, end), two CUDA events around its kernel; ``drain_events`` sums them.
event_log: list | None = None


@contextlib.contextmanager
def _launch_events(name: str):
    if event_log is None:
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    event_log.append((name, start, end))


def drain_events() -> dict:
    """Kernel milliseconds by wrapper name since the last drain (waits for
    the card); empties ``event_log``."""
    out: dict = {}
    if event_log:
        torch.cuda.synchronize()
        for name, start, end in event_log:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        event_log.clear()
    return out


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found: the kernels are built from "
        "masa_tpu_torch/csrc/*.cu with the CUDA toolkit "
        "(set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(name: str) -> list[str]:
    """``csrc/<name>.cu`` and every file it includes by a quoted name,
    directly or through another, each once, the source first."""
    files, todo = [], [SOURCES[name]]
    while todo:
        path = os.path.normpath(todo.pop())
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as fh:
            text = fh.read()
        todo += [os.path.join(os.path.dirname(path), inc.decode())
                 for inc in _INCLUDE.findall(text)]
    return files


def source_digest(name: str, defines: tuple = ()) -> str:
    """What names a built library: the bytes of every file of
    ``source_files`` and the defines, so an edit to a shared header
    rebuilds every kernel that includes it."""
    sha = hashlib.sha256()
    for path in source_files(name):
        with open(path, "rb") as fh:
            sha.update(fh.read())
    sha.update(" ".join(defines).encode())
    return sha.hexdigest()[:16]


def build(name: str = "strip", defines: tuple = ()) -> str:
    """Compile ``csrc/<name>.cu`` unless this source's library exists;
    returns the library path.  ``defines`` are preprocessor names for a
    measurement build of the source (``MASA_PROFILE``, for
    ``tools/strip_tune.py --profile``); they are part of the library's
    name."""
    src = SOURCES[name]
    digest = source_digest(name, defines)
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp,
           src]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{r.stderr}")
    build_log[name] = r.stderr
    os.replace(tmp, out)
    return out


_SIGNATURES = {
    "strip": {
        "masa_strip_block_rows": [],
        "masa_strip_resident_blocks": [],
        "masa_strip_launch": (["p"] * 6 + ["i"] * 11 + ["p"] * 7
                              + ["i"] * 3 + ["p"] + ["i"] * 5 + ["p"] * 4),
    },
    "batched_strip": {
        "masa_batched_strip_max_warps": ["i"],
        "masa_batched_strip_launch": (["p"] * 3 + ["i"] * 4 + ["p"] * 2
                                      + ["i", "p"] + ["i"] * 4 + ["p"]),
        "masa_batched_strip_fixed_launch": (["p"] * 7 + ["i"] * 6
                                            + ["p"] * 3 + ["i"] * 4
                                            + ["p"]),
    },
    "roofline": {
        "masa_roofline_launch": ["i"] * 4 + ["p"] * 3,
        "masa_roofline_blocks_per_sm": ["i"] * 2,
    },
    "hop": {
        "masa_hop_prep_launch": ["p", "i", "p", "i", "i", "i", "i"]
        + ["p"] * 6,
        "masa_hop_match_launch": ["p", "p", "i", "p", "p", "p", "p"]
        + ["i"] * 6 + ["p"],
        "masa_hop_launch": (["p", "i", "p", "i", "p", "p", "i"] + ["p"] * 5
                            + ["i"] * 9 + ["p"]),
        "masa_hop_max_cluster": [],
        "masa_hop_max_warps": [],
    },
    "traceback": {
        "masa_traceback_max_shared": [],
        "masa_traceback_launch": ["p"] * 3 + ["i", "p"] + ["i"] * 8 + ["p"],
    },
}


def bind(name: str, path: str):
    """``path`` loaded as the library of ``csrc/<name>.cu``."""
    lib = ctypes.CDLL(path)
    types = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for fn, args in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = [types[x] for x in args]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def load(name: str = "strip"):
    """The bound library of ``csrc/<name>.cu``, built at first use."""
    if name not in _libs:
        _libs[name] = bind(name, build(name))
    return _libs[name]


def block_rows() -> int:
    """Rows of the strip kernel's tallest block (8 rows a thread x 32 lanes
    x 8 compute warps): what ``strip_geometry`` cuts a strip as tall as the
    card into."""
    return int(load().masa_strip_block_rows())


def resident_blocks() -> int:
    """Strip-kernel blocks of ``block_rows()`` rows the current card holds
    at once."""
    n = int(load().masa_strip_resident_blocks())
    if n < 1:
        raise RuntimeError("could not query the card's occupancy")
    return n


def _check(name: str, x: torch.Tensor, dtype, n: int, dev) -> None:
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != dtype or x.dim() != 1 or x.numel() != n:
        raise ValueError(f"{name} must be a ({n},) {dtype} tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def strip_geometry(h: int, sms: int) -> tuple[int, int]:
    """``(alpha, warps)``: rows per thread and compute warps per block of
    the strip kernel for a strip of ``h`` rows on a card of ``sms`` SMs; a
    block owns ``32 * alpha * warps`` rows.  The width plays no part: at
    the main path's widths (a 16384-column hop, a 2^20-column band) one
    rule by height was the best, or within a few percent of it, on the card.

    A strip tall enough to give every SM a block of 8 warps at 8 rows a
    thread takes that shape (2048 rows a block): it is bound by the SM's
    integer pipe, and 8 rows a thread pay the fewest shuffles and
    ring accesses per cell.  A shorter strip is bound by the latency of
    one wavefront step (alpha dependent cells and a shuffle) times the
    columns plus the pipeline's fill, about ``h / alpha`` steps: fewer
    rows a thread put more warps to work and shorten the step, so it takes
    4 rows a thread while that still fills the card's SMs with 8-warp
    blocks, and 2 below.  A strip of at most 8 warps is one block (no
    hand-off through global memory); otherwise blocks of 4 warps while
    there are fewer blocks than SMs, so that a stage-2 hop of 8192 rows
    spreads over 32 SMs."""
    for alpha in (8, 4):
        if h >= 32 * alpha * 8 * sms:
            return alpha, 8
    alpha = 2
    n_warps = -(-h // (32 * alpha))
    if n_warps <= 8:
        return alpha, n_warps
    return alpha, 8 if n_warps >= 8 * sms else 4


def strip_cuda(a, b, bus_h, bus_f, col_h, col_e, corner: int, *,
               match: int, mismatch: int, gap_open: int, gap_ext: int,
               sw: bool, track_best: bool = False,
               store_lastcol: bool = False, flush_every: int = 0,
               max_ctas: int = 0, flags: list | None = None,
               prune=None):
    """Launch the strip kernel (see ``csrc/strip.cu`` for the contract).

    ``a`` (h,) and ``b`` (nj,) are uint8; the buses (nj,) and the left
    border (h,) are int32, all on one CUDA device.  Returns the raw outputs
    ``(bus_h, bus_f, best_v, best_j, last_h, last_e, rows_h, rows_f)``;
    the unrequested ones are None.  ``max_ctas`` > 0 caps the persistent
    blocks (0: as many as the card holds).

    ``prune`` (a ``wavefront.LaunchPrune``; SW with the best tracked and no
    last column, else it raises) prunes inside the launch, and a
    ``wavefront.PruneRecord`` of its decisions follows the outputs.

    The kernel's error flag is read on the host after the launch, which
    waits for the card.  With ``flags`` (a list) the flag, a (1,) device
    tensor, is appended to it instead, so that a caller can issue more
    launches first; it must then pass the values to ``check_flags``."""
    from masa_tpu_torch.ops.wavefront import PruneRecord  # imports us

    if prune is not None and (not (sw and track_best) or store_lastcol):
        raise ValueError("pruning inside a launch needs SW, the best "
                         "tracked and no last column")
    dev = b.device
    if dev.type != "cuda":
        raise ValueError(f"strip_cuda needs CUDA tensors, got {dev}")
    h, nj = a.numel(), b.numel()
    if h < 1 or nj < 1:
        raise ValueError(f"empty strip ({h} rows x {nj} columns)")
    _check("a", a, torch.uint8, h, dev)
    _check("b", b, torch.uint8, nj, dev)
    for name, x, n in (("bus_h", bus_h, nj), ("bus_f", bus_f, nj),
                       ("col_h", col_h, h), ("col_e", col_e, h)):
        _check(name, x, torch.int32, n, dev)
    if flush_every < 0:
        raise ValueError(f"flush_every must be >= 0, got {flush_every}")
    if prune is not None:
        bi = prune.best_in
        if bi.device != dev or bi.dtype != torch.int64 or bi.numel() < 1 \
                or not bi.is_contiguous():
            raise ValueError(f"best_in must be a contiguous int64 tensor on "
                             f"{dev}")
        if not (0 <= prune.i0 and prune.i0 + h <= prune.m
                and 0 <= prune.col_off and prune.col_off + nj <= prune.n):
            raise ValueError(f"the launch ({h} x {nj} at {prune.i0}, "
                             f"{prune.col_off}) lies outside its partition "
                             f"({prune.m} x {prune.n})")
    lib = load()
    alpha, warps = strip_geometry(h, _sms(dev))
    rows = 32 * alpha * warps
    n_sub = -(-h // rows)
    n_int = (h - 1) // flush_every if flush_every else 0

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    # the kernel rewrites the bus in place, row block by row block
    out_h, out_f = bus_h.clone(), bus_f.clone()
    best_v, best_j = (empty(h), empty(h)) if track_best else (None, None)
    last_h, last_e = (empty(h), empty(h)) if store_lastcol else (None, None)
    rows_h, rows_f = (empty(n_int, nj), empty(n_int, nj)) if n_int \
        else (None, None)
    # per sub-strip progress, then the ticket and the error flag
    sync = torch.zeros(n_sub + 2, dtype=torch.int32, device=dev)
    record = prefix = None
    if prune is not None:
        record = empty(n_sub, 2)
        prefix = torch.zeros(2 * n_sub, dtype=torch.int32, device=dev)
    grid = ctypes.c_int(0)

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr() if x is not None else 0)

    with torch.cuda.device(dev), _launch_events("strip"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.masa_strip_launch(
            ptr(a), ptr(b), ptr(out_h), ptr(out_f), ptr(col_h), ptr(col_e),
            int(corner), h, nj, match, mismatch, gap_open, gap_ext,
            int(sw), int(track_best), int(store_lastcol), int(flush_every),
            ptr(best_v), ptr(best_j), ptr(last_h), ptr(last_e),
            ptr(rows_h), ptr(rows_f), ptr(sync), alpha, warps,
            int(max_ctas), ctypes.c_void_p(stream),
            *((1, prune.m, prune.n, prune.i0, prune.col_off)
              if prune is not None else (0, 0, 0, 0, 0)),
            ptr(None if prune is None else prune.best_in), ptr(record),
            ptr(prefix), ctypes.byref(grid))
    if rc != 0:
        raise RuntimeError(f"strip kernel launch failed: CUDA error {rc}")
    strip_cuda.launches += 1
    if flags is not None:
        flags.append(sync[-1:])
    else:
        with trace.span("wait"):
            flag = int(sync[-1].item())
        check_flags([flag])
    out = (out_h, out_f, best_v, best_j, last_h, last_e, rows_h, rows_f)
    if prune is None:
        return out
    return out + (PruneRecord(record, rows, grid.value),)


strip_cuda.launches = 0


def check_flags(values) -> None:
    """Raise if any error flag of the strip or hop kernel read back is
    set."""
    if any(int(v) for v in values):
        raise RuntimeError("strip or hop kernel: a wait for the rows above "
                           "saw nothing move for 10 s")


# batched_strip_cuda's per-element fields, in the kernel's order (the
# kernel's item table adds three: the element's output row, the item's
# sub-strip and its counter)
ELEM_FIELDS = ("i0", "h", "j0", "w", "row_code", "col_code")
# warps a block of csrc/batched_strip.cu may hold, by rows per thread
# (masa_batched_strip_max_warps)
BATCHED_MAX_WARPS = {8: 16, 4: 32, 2: 32}
_BLOCK_WARPS = 4   # warps of a block of short elements


class BatchedGeometry(NamedTuple):
    """How one launch of the batched strip kernels is cut: ``alpha`` rows
    per thread, ``warps`` per element (an element owns ``32 * alpha *
    warps`` rows at a time and chains sub-strips beyond), ``per_block``
    elements side by side in a block, and ``order``: the elements' indices
    in dispatch order, tallest first."""

    alpha: int
    warps: int
    per_block: int
    order: np.ndarray

    @property
    def rows(self) -> int:
        """Rows of one sub-strip: what an element's warps own at once."""
        return 32 * self.alpha * self.warps


def batched_geometry(heights, sms: int) -> BatchedGeometry:
    """The block shape of a batched launch from its elements' heights.

    The shape follows the height that holds the middle row when the
    elements are stacked tallest first, so a few stragglers, short or
    tall, do not size every block: a taller element chains sub-strips on
    its warps, a shorter one leaves warps idle.  Rows per thread are as
    many as still fill a warp's 32 lanes at that height (64 rows: 2; 128:
    4; 256 and up: 8) and still give each of the card's ``sms`` SMs a warp:
    on the card more rows a thread won at every level of stage 4 while the
    lanes stayed full (fewer shuffles and ring accesses per cell) and lost
    by half once they did not, and a launch of a few elements is bound by
    the latency of a wavefront step, which fewer rows a thread shorten.
    Warps per element cover that height, up to a whole block; a taller
    element is cut into sub-strips on warps of their own
    (``batched_items``); elements of few warps share a block of
    ``_BLOCK_WARPS`` (the block size of short elements moved their time by
    a few percent at most).  Tallest first, so that the long elements
    start in the first wave and like heights sit side by side in a
    block."""
    h = np.asarray(heights, np.int64).reshape(-1)
    if h.size < 1 or h.min() < 1:
        raise ValueError("heights must be a non-empty list of rows >= 1")
    if h.min() == h.max():
        order, middle = np.arange(h.size), int(h[0])
    else:
        order = np.argsort(-h, kind="stable")
        stacked = np.cumsum(h[order])
        middle = int(h[order[np.searchsorted(stacked,
                                             (int(stacked[-1]) + 1) // 2)]])
    total = int(h.sum())
    alpha = 2
    for cand in (8, 4):
        if 32 * cand <= middle and total >= 32 * cand * sms:
            alpha = cand
            break
    warps = min(BATCHED_MAX_WARPS[alpha], -(-middle // (32 * alpha)))
    return BatchedGeometry(alpha, warps, max(1, _BLOCK_WARPS // warps), order)


def batched_items(elems: np.ndarray, geo: BatchedGeometry
                  ) -> tuple[np.ndarray, int]:
    """The kernel's item table for a launch cut by ``geo``, and the number
    of counters it needs.  An item is one sub-strip of ``geo.rows`` rows
    of one element: ``ELEM_FIELDS``, then the element's index in ``elems``
    (its output row), the sub-strip's number and the index of its counter
    (-1 for an element of one sub-strip).  Elements come in ``geo.order``,
    the sub-strips of one after another, so that whoever takes an item
    finds the sub-strip above it taken already."""
    order = geo.order
    n_sub = -(-elems[order, 1].astype(np.int64) // geo.rows)
    if n_sub.max() == 1:  # nothing chained: an item per element
        items = np.empty((len(order), len(ELEM_FIELDS) + 3), np.int32)
        items[:, :6], items[:, 6], items[:, 7], items[:, 8] = \
            elems[order], order, 0, -1
        return items, 0
    first = np.cumsum(n_sub) - n_sub  # each element's first item
    of = np.repeat(np.arange(len(order)), n_sub)
    sub = np.arange(len(of)) - first[of]
    chained = (n_sub > 1)[of]
    ctr = np.where(chained, np.cumsum(chained) - 1, -1)
    items = np.concatenate([elems[order][of], order[of, None], sub[:, None],
                            ctr[:, None]], 1).astype(np.int32)
    return items, int(chained.sum())


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def batched_strip_cuda(a, b, elems, width: int, *, match: int,
                       mismatch: int, gap_open: int, gap_ext: int):
    """Launch the batched strip kernel (see ``csrc/batched_strip.cu`` for
    the contract).

    ``a`` and ``b`` are the uint8 sequence views on one CUDA device.
    ``elems`` is a host (B, 6) int array of ``ELEM_FIELDS`` per element:
    rows ``[i0, i0+h)`` of ``a`` (h >= 1) against columns ``[j0, j0+w)`` of
    ``b`` (w <= width), with InitType border codes 0-2.  Returns the last
    rows' ``(bus_h, bus_f)``, (B, width) int32, in the order of ``elems``;
    columns past an element's ``w`` hold -INF (the kernel writes them)."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"batched_strip_cuda needs CUDA tensors, got {dev}")
    for name, x in (("a", a), ("b", b)):
        if x.device != dev or x.dtype != torch.uint8 or x.dim() != 1 \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D uint8 tensor "
                             f"on {dev}")
    el = np.ascontiguousarray(elems, dtype=np.int32)
    if el.ndim != 2 or el.shape[1] != len(ELEM_FIELDS) or el.shape[0] < 1:
        raise ValueError(f"elems must be (B, {len(ELEM_FIELDS)}), got "
                         f"{el.shape}")
    i0, h, j0, w, rc, cc = el.T
    width = int(width)
    if width < 1 or w.min() < 0 or w.max() > width:
        raise ValueError(f"element widths must lie in [0, {width}]")
    if h.min() < 1 or i0.min() < 0 or j0.min() < 0:
        raise ValueError("element heights must be >= 1, offsets >= 0")
    if (i0.astype(np.int64) + h).max() > a.numel() \
            or (j0.astype(np.int64) + w).max() > b.numel():
        raise ValueError("an element reaches past its sequence view")
    if min(rc.min(), cc.min()) < 0 or max(rc.max(), cc.max()) > 2:
        raise ValueError("border codes must be 0, 1 or 2 (no CUSTOM)")
    lib = load("batched_strip")
    geo = batched_geometry(h, _sms(dev))
    B = el.shape[0]
    # the kernel's table, sent from pinned memory so that the copy is
    # queued like the launch; a ticket and the counters where sub-strips
    # wait for one another
    items, counters = batched_items(el, geo)
    items_d = torch.from_numpy(items).pin_memory().to(dev, non_blocking=True)
    sync = torch.zeros(1 + counters, dtype=torch.int32, device=dev) \
        if counters else None
    bus_h = torch.empty((B, width), dtype=torch.int32, device=dev)
    bus_f = torch.empty((B, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev), _launch_events("batched_strip"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc_ = lib.masa_batched_strip_launch(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(items_d.data_ptr()), len(items), geo.alpha,
            geo.warps, geo.per_block, ctypes.c_void_p(bus_h.data_ptr()),
            ctypes.c_void_p(bus_f.data_ptr()), width,
            ctypes.c_void_p(sync.data_ptr() if counters else 0), match,
            mismatch, gap_open, gap_ext, ctypes.c_void_p(stream))
    if rc_ != 0:
        raise RuntimeError(
            f"batched strip kernel launch failed: CUDA error {rc_} "
            f"({geo.alpha} rows a thread, {geo.warps} warps x "
            f"{geo.per_block} elements a block)")
    batched_strip_cuda.launches += 1
    return bus_h, bus_f


batched_strip_cuda.launches = 0


def batched_strip_fixed_cuda(a, b, col_h, col_e, bus_h, bus_f, corners, *,
                             match: int, mismatch: int, gap_open: int,
                             gap_ext: int):
    """Launch the equal-shape batched strip kernel (see
    ``csrc/batched_strip.cu``, ``batched_strip_fixed_kernel``).

    ``a`` (B, h) and ``b`` (B, nj) are uint8; the left border ``col_h``/
    ``col_e`` (B, h), the row above ``bus_h``/``bus_f`` (B, nj) and the
    ``corners`` (B,) are int32, all contiguous on one CUDA device.  Returns
    the last rows' ``(bus_h, bus_f)``, (B, nj) int32; the inputs are not
    changed."""
    dev = b.device
    if dev.type != "cuda":
        raise ValueError(
            f"batched_strip_fixed_cuda needs CUDA tensors, got {dev}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"a and b must be (B, h) and (B, nj), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    B, h = a.shape
    nj = b.shape[1]
    if B < 1 or h < 1 or nj < 1:
        raise ValueError(f"empty batch ({B} x {h} rows x {nj} columns)")
    for name, x, dtype, shape in (
            ("a", a, torch.uint8, (B, h)), ("b", b, torch.uint8, (B, nj)),
            ("col_h", col_h, torch.int32, (B, h)),
            ("col_e", col_e, torch.int32, (B, h)),
            ("bus_h", bus_h, torch.int32, (B, nj)),
            ("bus_f", bus_f, torch.int32, (B, nj)),
            ("corners", corners, torch.int32, (B,))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be a {shape} {dtype} tensor, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = load("batched_strip")
    geo = batched_geometry([h], _sms(dev))
    out_h, out_f = torch.empty_like(bus_h), torch.empty_like(bus_f)
    n_sub = -(-h // geo.rows)  # a chained element: a counter per sub-strip
    sync = torch.zeros(1 + B * n_sub, dtype=torch.int32, device=dev) \
        if n_sub > 1 else None

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr() if x is not None else 0)

    with torch.cuda.device(dev), _launch_events("batched_strip_fixed"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.masa_batched_strip_fixed_launch(
            ptr(a), ptr(b), ptr(col_h), ptr(col_e), ptr(corners), ptr(bus_h),
            ptr(bus_f), B, h, nj, geo.alpha, geo.warps, geo.per_block,
            ptr(out_h), ptr(out_f), ptr(sync), match, mismatch, gap_open,
            gap_ext, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"batched strip (fixed) kernel launch failed: CUDA error {rc} "
            f"({geo.alpha} rows a thread, {geo.warps} warps x "
            f"{geo.per_block} elements a block)")
    batched_strip_fixed_cuda.launches += 1
    return out_h, out_f


batched_strip_fixed_cuda.launches = 0


def _check_state(name: str, st, dev) -> None:
    if st.device != dev or st.dtype != torch.int32 or st.dim() != 1 \
            or st.numel() != 4 or not st.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (4,) int32 tensor on "
                         f"{dev}")


def hop_prep_cuda(s1r, st, W: int, hb: int, gap_open: int, gap_ext: int):
    """Launch a hop's prologue (``csrc/hop.cu``, ``hop_prep_kernel``; the
    contract of ``wavefront.hop_prep_plain``): from the state ``st`` (a
    (4,) int32 tensor on the card, read there), the window ``b`` of the
    reversed seq1 ``s1r`` (uint8), the entering bus and the left border.
    Returns ``(b, bus_h, bus_f, col_h, col_e)``."""
    dev = s1r.device
    if dev.type != "cuda":
        raise ValueError(f"hop_prep_cuda needs CUDA tensors, got {dev}")
    n = s1r.numel()
    _check("s1r", s1r, torch.uint8, n, dev)
    _check_state("st", st, dev)
    if not (1 <= W < n and hb >= 1) or n >= 1 << 31:
        raise ValueError(f"a hop of {hb} rows x {W} columns over a "
                         f"sequence of {n}")
    i32 = torch.int32
    b = torch.empty(W, dtype=torch.uint8, device=dev)
    bus_h, bus_f = (torch.empty(W, dtype=i32, device=dev) for _ in "hf")
    col_h, col_e = (torch.empty(hb, dtype=i32, device=dev) for _ in "he")
    lib = load("hop")

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr())

    with torch.cuda.device(dev), _launch_events("hop_prep"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.masa_hop_prep_launch(
            ptr(s1r), n, ptr(st), W, hb, gap_open, gap_ext, ptr(b),
            ptr(bus_h), ptr(bus_f), ptr(col_h), ptr(col_e),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"hop prologue launch failed: CUDA error {rc}")
    hop_prep_cuda.launches += 1
    return b, bus_h, bus_f, col_h, col_e


hop_prep_cuda.launches = 0


def hop_match_cuda(cut_h, cut_f, rev_h, rev_f, st_in, st_out, W: int,
                   hb: int, *, match: int, gap_open: int, gap_ext: int,
                   sw: bool):
    """Launch a hop's epilogue (``csrc/hop.cu``, ``hop_match_kernel``; the
    contract of ``wavefront.hop_match_plain``): one block matches the
    reverse row ``rev_h``/``rev_f`` (W columns) against the cut
    ``cut_h``/``cut_f`` at the column in ``st_in`` and writes the next
    state to ``st_out``, all on the card.  Returns ``st_out``."""
    dev = cut_h.device
    if dev.type != "cuda":
        raise ValueError(f"hop_match_cuda needs CUDA tensors, got {dev}")
    n = cut_h.numel()
    for name, x, k in (("cut_h", cut_h, n), ("cut_f", cut_f, n),
                       ("rev_h", rev_h, W), ("rev_f", rev_f, W)):
        _check(name, x, torch.int32, k, dev)
    _check_state("st_in", st_in, dev)
    _check_state("st_out", st_out, dev)
    if not (1 <= W and hb >= 1) or n >= 1 << 31:
        raise ValueError(f"a hop of {hb} rows x {W} columns against a cut "
                         f"of {n}")
    lib = load("hop")

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr())

    with torch.cuda.device(dev), _launch_events("hop_match"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.masa_hop_match_launch(
            ptr(cut_h), ptr(cut_f), n, ptr(rev_h), ptr(rev_f), ptr(st_in),
            ptr(st_out), W, hb, match, gap_open, gap_ext, int(sw),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"hop epilogue launch failed: CUDA error {rc}")
    hop_match_cuda.launches += 1
    return st_out


hop_match_cuda.launches = 0


# csrc/hop.cu: compute warps a CTA at most (MAXW), the portable cluster
# and the largest one the kernel asks for where the card allows it
HOP_MAX_WARPS = 16
HOP_PORTABLE_CLUSTER = 8
HOP_MAX_CLUSTER = 16
# compute warps of a hop's CTA (one a quarter-SM) while a cluster of them
# covers the hop
HOP_CTA_WARPS = 4
_hop_cluster: dict = {}  # device index -> masa_hop_max_cluster()


class HopGeometry(NamedTuple):
    """How ``hop_cuda`` cuts a hop: ``alpha`` rows a thread, ``warps``
    compute warps a CTA (a band of ``rows`` rows) and ``cluster`` CTAs,
    each with rows."""

    alpha: int
    warps: int
    cluster: int

    @property
    def rows(self) -> int:
        return 32 * self.alpha * self.warps


def hop_geometry(hb: int, W: int, sms: int,
                 max_cluster: int = HOP_PORTABLE_CLUSTER
                 ) -> HopGeometry | None:
    """The shape of one hop of ``hb`` rows x ``W`` columns on a card of
    ``sms`` SMs whose largest cluster of hop CTAs is ``max_cluster`` (8 or
    16), or None where the hop is taller than one cluster holds (it takes
    the three launches: ``hop_prep_cuda``, the strip kernel,
    ``hop_match_cuda``).  Needs no card.

    A hop's time is the latency of a wavefront step times its steps, so
    its rows spread over as many SMs as a cluster has, at ``HOP_CTA_WARPS``
    warps a CTA, one a quarter-SM: 4 rows a thread (512 rows a CTA; a hop
    of up to 512 rows is one CTA), then 8 (1024), then more warps (up to
    ``HOP_MAX_WARPS``: 4096 rows a CTA).  On an H100 (``tools/hop_tune.py
    --variants``) this shape was the fastest at 512 x 1024 and at 8192 x
    16384: fewer rows a thread put more warps in the chain, each of which
    adds its lag to the sweep, and more warps a quarter-SM slowed every
    step.  The width plays no part."""
    if hb < 1 or W < 1 or sms < 1:
        raise ValueError(f"a hop of {hb} rows x {W} columns on {sms} SMs")
    if max_cluster not in (HOP_PORTABLE_CLUSTER, HOP_MAX_CLUSTER):
        raise ValueError(f"a cluster of {max_cluster} CTAs: 8 or 16")
    cap = min(max_cluster, sms)
    w4 = HOP_CTA_WARPS
    if hb <= cap * 32 * 4 * w4:
        alpha, warps = 4, min(w4, -(-hb // (32 * 4)))
    elif hb <= cap * 32 * 8 * w4:
        alpha, warps = 8, w4
    else:
        alpha, warps = 8, -(-hb // (cap * 32 * 8))
        if warps > HOP_MAX_WARPS:
            return None
    return HopGeometry(alpha, warps, -(-hb // (32 * alpha * warps)))


def hop_max_cluster(dev) -> int:
    """The largest cluster of hop CTAs the card ``dev`` schedules: 16 where
    it holds one of that non-portable size, else 8 (read once a device)."""
    dev = torch.device(dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _hop_cluster:
        with torch.cuda.device(idx):
            n = int(load("hop").masa_hop_max_cluster())
        if n < 1:
            raise RuntimeError(f"could not query the card's clusters: CUDA "
                               f"error {-n}")
        _hop_cluster[idx] = n
    return _hop_cluster[idx]


def hop_route(hb: int, W: int, dev) -> HopGeometry | None:
    """``hop_geometry`` on the card ``dev``: the shape ``hop_cuda`` takes,
    or None for the three launches."""
    return hop_geometry(hb, W, _sms(dev), hop_max_cluster(dev))


def hop_cuda(a, s1r, cut_h, cut_f, st_in, st_out, W: int, *, match: int,
             mismatch: int, gap_open: int, gap_ext: int, sw: bool,
             last_row: bool = False, flags: list | None = None,
             geometry: HopGeometry | None = None):
    """Launch one stage-2 hop (``csrc/hop.cu``, ``hop_kernel``; the
    contract of ``wavefront.hop_plain``): the prologue, the NW sweep of
    the ``a`` rows (uint8, hb of them) against the window of W characters
    of ``s1r`` (uint8) that the state ``st_in`` picks, and the goal match
    against the cut ``cut_h``/``cut_f`` (int32), the next state written
    to ``st_out`` (both (4,) int32), all on the card.  ``last_row``: also
    the hop's last row, the sweep run to its end.  Returns ``(st_out,
    rev_h, rev_f)``, the last row None unless asked.

    ``geometry`` forces a shape (``hop_route``'s by default; a hop taller
    than a cluster raises).  The error flag is read on the host after the
    launch, or appended to ``flags`` as ``strip_cuda`` does."""
    dev = s1r.device
    if dev.type != "cuda":
        raise ValueError(f"hop_cuda needs CUDA tensors, got {dev}")
    hb, n, cn = a.numel(), s1r.numel(), cut_h.numel()
    for name, x, dtype, k in (("a", a, torch.uint8, hb),
                              ("s1r", s1r, torch.uint8, n),
                              ("cut_h", cut_h, torch.int32, cn),
                              ("cut_f", cut_f, torch.int32, cn)):
        _check(name, x, dtype, k, dev)
    _check_state("st_in", st_in, dev)
    _check_state("st_out", st_out, dev)
    if abs(st_in.data_ptr() - st_out.data_ptr()) < 16:
        raise ValueError("st_in and st_out overlap")
    if not (1 <= W < n and hb >= 1) or max(n, cn) >= 1 << 31:
        raise ValueError(f"a hop of {hb} rows x {W} columns over a "
                         f"sequence of {n}")
    geo = geometry if geometry is not None else hop_route(hb, W, dev)
    if geo is None:
        raise ValueError(f"a hop of {hb} rows is taller than a cluster "
                         f"holds: it takes the three launches")
    lib = load("hop")
    error = torch.empty(1, dtype=torch.int32, device=dev)  # the kernel zeroes
    rev_h = rev_f = None
    if last_row:
        rev_h, rev_f = (torch.empty(W, dtype=torch.int32, device=dev)
                        for _ in "hf")

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr() if x is not None else 0)

    with torch.cuda.device(dev), _launch_events("hop"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.masa_hop_launch(
            ptr(a), hb, ptr(s1r), n, ptr(cut_h), ptr(cut_f), cn, ptr(st_in),
            ptr(st_out), ptr(rev_h), ptr(rev_f), ptr(error), W, match,
            mismatch, gap_open, gap_ext, int(sw), geo.alpha, geo.warps,
            geo.cluster, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"hop kernel launch failed: CUDA error {rc} "
                           f"({geo.alpha} rows a thread, {geo.warps} warps "
                           f"x {geo.cluster} CTAs)")
    hop_cuda.launches += 1
    if flags is not None:
        flags.append(error)
    else:
        with trace.span("wait"):
            flag = int(error.item())
        check_flags([flag])
    return st_out, rev_h, rev_f


hop_cuda.launches = 0


# csrc/traceback.cu: an item's fields, in the kernel's order (the wrapper
# adds the last two: where in its output a partition's score and run count
# and its slot of runs lie), the warps of a block at most (the kernel's
# MAXW, which its launch checks) and the rows of a warp's strip (a row a
# thread)
TRACEBACK_FIELDS = ("i0", "h", "j0", "w", "type_s", "type_e")
TRACEBACK_MAX_WARPS = 16
TRACEBACK_STRIP_ROWS = 32
# partitions a call of traceback_cuda takes at most, so that its output
# (2 (h + w) ints a partition) stays bounded
TRACEBACK_BATCH = 1 << 14
# the magnitude every score of an admitted partition stays under: far from
# the int32 edge, and from -INF, so that int32 compares as int64 does
TRACEBACK_SCORE_LIMIT = 1 << 27
_traceback_shared: dict = {}  # device index -> masa_traceback_max_shared()


def traceback_warps(h):
    """Warps of a block for partitions of ``h`` rows (an int or an array):
    a strip of ``TRACEBACK_STRIP_ROWS`` rows each, at most
    ``TRACEBACK_MAX_WARPS`` (taller ones deal their strips round robin),
    and one for a partition of no rows (its walk)."""
    return np.minimum(TRACEBACK_MAX_WARPS,
                      np.maximum(1, -(-np.asarray(h) //
                                      TRACEBACK_STRIP_ROWS)))


def traceback_table_words(h, w):
    """Words of a partition's table: h + 1 rows of w + 1 cells, 4 bits a
    cell, a row padded to a word."""
    return (np.asarray(h) + 1) * ((np.asarray(w) >> 3) + 1)


def traceback_smem(warps, table_words, cols):
    """Bytes of shared memory a block of ``csrc/traceback.cu`` needs, in
    the kernel's order: a slot of ``cols`` (H, F) pairs a warp, the table,
    the end state's score and ``cols`` - 1 characters of the columns.
    Each launch asks for this much; the kernel refuses less."""
    return 8 * warps * cols + 4 * table_words + 4 + cols - 1


def traceback_fits(h, w, params, smem_limit: int):
    """Whether the kernel takes partitions of ``h`` x ``w`` (ints or
    arrays) under the scores ``params`` on a card whose blocks may ask
    ``smem_limit`` bytes of shared memory: its table fits alone, and its
    scores stay far from the int32 edge (the deepest gap, (h + w + 2)
    (|gap_open| + |gap_ext|), and the longest run of matches or
    mismatches, (h + w) max(|match|, |mismatch|))."""
    h, w = np.asarray(h, np.int64), np.asarray(w, np.int64)
    gap = (h + w + 2) * (abs(params.gap_open) + abs(params.gap_ext))
    sub = (h + w) * max(abs(params.match), abs(params.mismatch))
    hh, ww = np.maximum(h, 0), np.maximum(w, 0)
    need = traceback_smem(traceback_warps(hh),
                          traceback_table_words(hh, ww), ww + 1)
    return (h >= 0) & (w >= 0) & (np.maximum(gap, sub)
                                  <= TRACEBACK_SCORE_LIMIT) \
        & (need <= smem_limit)


def traceback_layout(hw) -> tuple[np.ndarray, np.ndarray, int]:
    """Where the partitions of ``hw`` ((B, 2) heights and widths) lie in
    the output of ``traceback_cuda`` and ``smallsw.traceback_plain``: each
    partition's score and run count at ``out[k], out[k] + 1`` (the first 2B
    ints), its slot of 2 (h + w) ints at ``ops[k]`` after them, its runs
    at the slot's end; and the output's length."""
    hw = np.asarray(hw, np.int64).reshape(-1, 2)
    B = len(hw)
    cap = 2 * hw.sum(1)
    ops = 2 * B + np.cumsum(cap) - cap
    return 2 * np.arange(B, dtype=np.int64), ops, int(2 * B + cap.sum())


def traceback_launches(hw, smem_limit: int) -> list:
    """The launches of one ``traceback_cuda`` call: ``(index, warps,
    table_words, cols)`` each, the partitions of ``hw`` it takes and the
    largest block among them.  Partitions go into buckets by the shared
    memory they need alone (a power of two each), so that small tables
    pack several blocks on an SM; a bucket whose largest block would pass
    ``smem_limit`` is cut where it would.  Every partition must fit alone
    (``traceback_fits``).  The library call's stage 5 on a 2^20-base
    sequence against itself mixes 7,688 partitions, most of them ~136 x
    136 and the largest 512 x 512: on an H100 its two launches took 1.43
    ms, one launch sized to the largest block 6.27 ms."""
    hw = np.asarray(hw, np.int64).reshape(-1, 2)
    if len(hw) == 0:
        return []
    h, w = hw[:, 0], hw[:, 1]
    warps = traceback_warps(h)
    words = traceback_table_words(h, w)
    need = traceback_smem(warps, words, w + 1)
    if need.max() > smem_limit:
        raise ValueError("a partition's table does not fit the card's "
                         "shared memory")
    order = np.argsort(need, kind="stable")
    bucket = np.ceil(np.log2(need[order])).astype(np.int64)
    out = []
    for b in np.unique(bucket):
        idx = order[bucket == b]
        while len(idx):
            big = [np.maximum.accumulate(x[idx]) for x in (warps, words,
                                                           w + 1)]
            ok = traceback_smem(*big) <= smem_limit
            n = len(idx) if ok.all() else int(np.argmin(ok))
            out.append((np.sort(idx[:n]), *(int(x[n - 1]) for x in big)))
            idx = idx[n:]
    return out


def traceback_max_shared(dev) -> int:
    """The shared memory a block of the traceback kernel may ask for on the
    card ``dev`` (read once a device)."""
    dev = torch.device(dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _traceback_shared:
        with torch.cuda.device(idx):
            n = int(load("traceback").masa_traceback_max_shared())
        if n < 1:
            raise RuntimeError(f"could not query the card's shared memory: "
                               f"CUDA error {-n}")
        _traceback_shared[idx] = n
    return _traceback_shared[idx]


def traceback_cuda(a, b, items, *, match: int, mismatch: int,
                   gap_open: int, gap_ext: int):
    """Stage 5's constrained DP and traceback of many partitions on the
    card (``csrc/traceback.cu``; the contract of
    ``smallsw.traceback_plain``), in a few launches by the shared memory
    each needs (``traceback_launches``).

    ``a`` and ``b`` are the uint8 sequence views on one CUDA device;
    ``items`` a host (B, 6) int array of ``TRACEBACK_FIELDS``: rows
    ``[i0, i0+h)`` of ``a`` against columns ``[j0, j0+w)`` of ``b``, from
    the start state ``type_s`` to the end state ``type_e`` (0 H, 1 E,
    2 F).  Every partition must pass ``traceback_fits``; at most
    ``TRACEBACK_BATCH`` a call.  Returns the int32 output on the card,
    laid out as ``traceback_layout`` says: each partition's end-state
    score and run count (-1 where the walk failed, as ``masa_traceback``
    fails), and its runs ``(code, length)`` in forward order at the end
    of its slot."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"traceback_cuda needs CUDA tensors, got {dev}")
    for name, x in (("a", a), ("b", b)):
        if x.device != dev or x.dtype != torch.uint8 or x.dim() != 1 \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D uint8 tensor "
                             f"on {dev}")
    it = np.asarray(items, np.int64)
    if it.ndim != 2 or it.shape[1] != len(TRACEBACK_FIELDS) \
            or not 1 <= len(it) <= TRACEBACK_BATCH:
        raise ValueError(f"items must be (B, {len(TRACEBACK_FIELDS)}) with "
                         f"1 <= B <= {TRACEBACK_BATCH}, got {it.shape}")
    i0, h, j0, w, ts, te = it.T
    if min(i0.min(), h.min(), j0.min(), w.min()) < 0 \
            or (i0 + h).max() > a.numel() or (j0 + w).max() > b.numel():
        raise ValueError("a partition reaches past its sequence view")
    if min(ts.min(), te.min()) < 0 or max(ts.max(), te.max()) > 2:
        raise ValueError("states must be 0, 1 or 2")
    params = ScoreParams(match, mismatch, gap_open, gap_ext)
    limit = traceback_max_shared(dev)
    if not traceback_fits(h, w, params, limit).all():
        raise ValueError("a partition does not fit the kernel "
                         "(traceback_fits)")
    hdr, ops, total = traceback_layout(it[:, 1:4:2])
    table = np.concatenate([it, hdr[:, None], ops[:, None]], 1)
    if total >= 1 << 31:
        raise ValueError(f"an output of {total} ints")
    lib = load("traceback")
    out = torch.zeros(total, dtype=torch.int32, device=dev)
    launches = traceback_launches(it[:, 1:4:2], limit)
    # every launch's items in one table, sent from pinned memory so that
    # the copy is queued like the launches
    table = np.concatenate([table[idx] for idx, *_ in launches]).astype(
        np.int32)
    items_d = torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)
    first = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for idx, warps, words, cols in launches:
            smem = traceback_smem(warps, words, cols)
            with _launch_events("traceback"):
                rc = lib.masa_traceback_launch(
                    ctypes.c_void_p(a.data_ptr()),
                    ctypes.c_void_p(b.data_ptr()),
                    ctypes.c_void_p(items_d[first].data_ptr()), len(idx),
                    ctypes.c_void_p(out.data_ptr()), match, mismatch,
                    gap_open, gap_ext, warps, words, cols, smem,
                    ctypes.c_void_p(stream))
            if rc != 0:
                raise RuntimeError(
                    f"traceback kernel launch failed: CUDA error {rc} "
                    f"({len(idx)} partitions, {warps} warps, {smem} bytes "
                    f"of shared memory a block)")
            traceback_cuda.launches += 1
            first += len(idx)
    return out


traceback_cuda.launches = 0
