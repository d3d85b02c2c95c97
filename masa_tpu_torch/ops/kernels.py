"""Build and bind the hand-written Hopper kernels (``csrc/*.cu``).

Each kernel source (``csrc/strip.cu``, ``csrc/batched_strip.cu``,
``csrc/roofline.cu``) is compiled with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``masa_tpu_torch/_build/`` (named by the source's hash, so an edited source
rebuilds), and bound with ``ctypes``.  Nothing here runs when the module is
imported: the CPU tests import it on hosts with no toolkit.

``strip_cuda``, ``batched_strip_cuda`` and ``batched_strip_fixed_cuda``
launch their kernels on PyTorch's current stream and count their launches
in ``.launches``; the roofline tool's launcher lives in
``masa_tpu_torch/tools/roofline.py``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("strip", "batched_strip", "roofline")}
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


def build(name: str = "strip", defines: tuple = ()) -> str:
    """Compile ``csrc/<name>.cu`` unless this source's library exists;
    returns the library path.  ``defines`` are preprocessor names for a
    measurement build of the source (``MASA_PROFILE``, for
    ``tools/strip_tune.py --profile``); they are part of the library's
    name."""
    src = SOURCES[name]
    with open(src, "rb") as fh:
        digest = hashlib.sha256(
            fh.read() + " ".join(defines).encode()).hexdigest()[:16]
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
                              + ["i"] * 3 + ["p"]),
    },
    "batched_strip": {
        "masa_batched_strip_max_threads": [],
        "masa_batched_strip_launch": (["p"] * 3 + ["i"] * 2 + ["p"] * 2
                                      + ["i"] * 5 + ["p"]),
        "masa_batched_strip_fixed_launch": (["p"] * 5 + ["i"] * 4
                                            + ["p"] * 2 + ["i"] * 4
                                            + ["p"]),
    },
    "roofline": {
        "masa_roofline_launch": ["i"] * 4 + ["p"] * 3,
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
               max_ctas: int = 0):
    """Launch the strip kernel (see ``csrc/strip.cu`` for the contract).

    ``a`` (h,) and ``b`` (nj,) are uint8; the buses (nj,) and the left
    border (h,) are int32, all on one CUDA device.  Returns the raw outputs
    ``(bus_h, bus_f, best_v, best_j, last_h, last_e, rows_h, rows_f)``;
    the unrequested ones are None.  ``max_ctas`` > 0 caps the persistent
    blocks (0: as many as the card holds)."""
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
    lib = load()
    alpha, warps = strip_geometry(
        h, torch.cuda.get_device_properties(dev).multi_processor_count)
    n_sub = -(-h // (32 * alpha * warps))
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
            int(max_ctas), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"strip kernel launch failed: CUDA error {rc}")
    strip_cuda.launches += 1
    if int(sync[-1].item()):
        raise RuntimeError("strip kernel: a sub-strip waited over 10 s for "
                           "the bus of the sub-strip above it")
    return out_h, out_f, best_v, best_j, last_h, last_e, rows_h, rows_f


strip_cuda.launches = 0


# batched_strip_cuda's per-element fields, in the kernel's order
ELEM_FIELDS = ("i0", "h", "j0", "w", "row_code", "col_code")
_ALPHA = 8  # rows per thread of csrc/batched_strip.cu


def batched_strip_cuda(a, b, elems, width: int, *, match: int,
                       mismatch: int, gap_open: int, gap_ext: int):
    """Launch the batched strip kernel (see ``csrc/batched_strip.cu`` for
    the contract).

    ``a`` and ``b`` are the uint8 sequence views on one CUDA device.
    ``elems`` is a host (B, 6) int array of ``ELEM_FIELDS`` per element:
    rows ``[i0, i0+h)`` of ``a`` (h >= 1) against columns ``[j0, j0+w)`` of
    ``b`` (w <= width), with InitType border codes 0-2.  Returns the last
    rows' ``(bus_h, bus_f)``, (B, width) int32; columns past an element's
    ``w`` hold -INF."""
    import numpy as np

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
    if width < 1 or (w < 0).any() or (w > width).any():
        raise ValueError(f"element widths must lie in [0, {width}]")
    if (h < 1).any() or (i0 < 0).any() or (j0 < 0).any():
        raise ValueError("element heights must be >= 1, offsets >= 0")
    if (i0.astype(np.int64) + h > a.numel()).any() \
            or (j0.astype(np.int64) + w > b.numel()).any():
        raise ValueError("an element reaches past its sequence view")
    if not (np.isin(rc, (0, 1, 2)).all() and np.isin(cc, (0, 1, 2)).all()):
        raise ValueError("border codes must be 0, 1 or 2 (no CUSTOM)")
    lib = load("batched_strip")
    threads = _threads_for(int(h.max()),
                           int(lib.masa_batched_strip_max_threads()))
    B = el.shape[0]
    elems_d = torch.from_numpy(el).to(dev)
    neg = -999999999
    bus_h = torch.full((B, width), neg, dtype=torch.int32, device=dev)
    bus_f = torch.full((B, width), neg, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev), _launch_events("batched_strip"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc_ = lib.masa_batched_strip_launch(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(elems_d.data_ptr()), B, threads,
            ctypes.c_void_p(bus_h.data_ptr()),
            ctypes.c_void_p(bus_f.data_ptr()), width, match, mismatch,
            gap_open, gap_ext, ctypes.c_void_p(stream))
    if rc_ != 0:
        raise RuntimeError(
            f"batched strip kernel launch failed: CUDA error {rc_}")
    batched_strip_cuda.launches += 1
    return bus_h, bus_f


batched_strip_cuda.launches = 0


def _threads_for(h: int, max_threads: int) -> int:
    """Threads per block of the batched kernels for elements of up to h
    rows: enough to own every row (ALPHA each), whole warps, capped."""
    need = -(-h // _ALPHA)
    return min(max_threads, max(32, -(-need // 32) * 32))


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
    threads = _threads_for(h, int(lib.masa_batched_strip_max_threads()))
    # the kernel rewrites the row above in place
    out_h, out_f = bus_h.clone(), bus_f.clone()

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr())

    with torch.cuda.device(dev), _launch_events("batched_strip_fixed"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.masa_batched_strip_fixed_launch(
            ptr(a), ptr(b), ptr(col_h), ptr(col_e), ptr(corners), B, h, nj,
            threads, ptr(out_h), ptr(out_f), match, mismatch, gap_open,
            gap_ext, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"batched strip (fixed) kernel launch failed: CUDA error {rc}")
    batched_strip_fixed_cuda.launches += 1
    return out_h, out_f


batched_strip_fixed_cuda.launches = 0
