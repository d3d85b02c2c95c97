"""Column-sharded stage 1 over a mesh of slabs, and the full alignment on
it (counterpart of masa_tpu/parallel/sharded.py; the reference's
multi-GPU mode, libmasa.cpp:497-757).

Sequence #1 is cut into D slabs of W = ceil(n / D) columns, one a mesh
device (``parallel/mesh``).  Stage 1 runs as a diagonal pipeline of
strips R rows tall: in round r every slab d runs its strip r - d, and the
strip's last column (H, E) becomes the left border of slab d + 1's strip
in round r + 1.  Pipeline efficiency is n_strips / (n_strips + D - 1).

* Inside a process a column passes as a tensor (``.to(device)``, nothing
  on one card); between processes (``torch.distributed``, gloo) it moves
  as a pinned host copy from the last slab of one process to the first of
  the next, and the global best is an ``all_reduce(MAX)`` every round.
* Each round issues every strip of the process before reading anything
  back: one host read a device a round gathers the strips' bests, bus
  maxima, border corners and error flags, so the cards of one process
  overlap.  Special rows (W x 8 bytes each) and captured border columns
  come to the host once a chunk of rounds.
* Score-share pruning (``prune``) is masa_tpu's whole-strip rule, not
  ``core/pruning``'s window: a strip is skipped when the best it could
  reach from its top-left corner to the matrix's far corner cannot beat
  the global best, and leaves -INF buses and a -INF column.
* Columns past n are a byte that occurs nowhere in seq0 (masa_tpu's
  B_SENTINEL): the last slab with columns runs them, as masa_tpu's does,
  so its pruning sees the same bus.  A slab with no column of seq1 runs
  nothing.  The tail strip (m % R rows) runs at its true height.
* ``sharded_stage1_full`` keeps every slab's best endpoint, its special
  rows every ``flush_stride`` strips and the border column it received;
  with ``state_dir`` they stream into memmaps (``ShardedStateSink``, masa_tpu's
  files and int32 layouts) and a fingerprinted carry checkpoints every
  chunk, so an interrupted run resumes.  The carry fingerprints R (not the
  TPU's alpha, rs and chunk) and holds W-long buses (not TPU-padded): a
  carry of one package is refused by the other, which recomputes.
* ``sharded_align`` traces back through the slab marchers of
  ``parallel/split`` and finishes with stages 3-6.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import zipfile

import numpy as np
import torch

from masa_tpu_torch.ops import kernels
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.parallel.mesh import Mesh, gather_objects, world
from masa_tpu_torch.types import INF, InitType, Recurrence, ScoreParams
from masa_tpu_torch.utils import trace

NEG = -INF
# Strip height R.  On the CPU masa_tpu's scan default (WavefrontConfig():
# alpha 4 x rs 8 x 128 lanes), so that --split N writes its files byte for
# byte; on CUDA the least stage-1 time of the sweep in PERF.md
# (tools/sharded_tune.py).
CPU_ROWS = 4096
CUDA_ROWS = 1 << 16
CARRY_NAMES = ("bus_h", "bus_f", "recv_h", "recv_e", "corner", "best3",
               "gbest", "npruned")


@dataclasses.dataclass
class ShardedResult:
    best: int
    last_h: np.ndarray  # (n_pad,) final-row H across all slabs
    last_f: np.ndarray
    cells: int
    pruned_strips: np.ndarray | None = None  # per-slab skip counts


@dataclasses.dataclass
class ShardedFullResult:
    best: int
    best_i: int
    best_j: int
    parts: list          # split.PartResult per non-empty slab
    cells: int
    pruned_strips: np.ndarray | None = None


def default_config(device) -> wf.StripConfig:
    """The strip height of the pipeline on ``device``."""
    cuda = torch.device(device).type == "cuda"
    return wf.StripConfig(rows=CUDA_ROWS if cuda else CPU_ROWS)


def _sentinel(seq0: np.ndarray) -> int:
    """The pad byte of the columns past n: one that occurs nowhere in
    seq0, so that it never matches."""
    free = np.flatnonzero(np.bincount(seq0, minlength=256) == 0)
    if not len(free):
        raise ValueError("seq0 holds all 256 byte values: no byte is left "
                         "to pad the last slab")
    return int(free[0])


@dataclasses.dataclass
class _Slab:
    """One slab's carry between rounds."""

    d: int
    dev: torch.device
    b: torch.Tensor          # (W,) uint8, its columns of seq1 and the pad
    width: int               # columns of seq1 in it (<= 0: none)
    bus_h: torch.Tensor      # (W,) int32, the last row run
    bus_f: torch.Tensor
    bus_max: int = 0
    col: tuple | None = None  # (H, E) border of its next strip; None: -INF
    col_max: int = NEG
    col_last: int = NEG
    corner: int = 0          # H(row above its next strip, its column 0)
    best: tuple = (0, 0, 0)  # (score, DP row, slab-local DP column)
    npruned: int = 0


class ShardedPipeline:
    """The lockstep rounds of this process over the slabs it owns
    (``mesh.owned(rank)``).  ``run_round(r)`` runs round r; ``take_emissions``
    hands over the special rows and border columns gathered since the last
    call, as host arrays.  Every process of a multi-process mesh must run
    the same rounds: each exchanges its border and best with its
    neighbours."""

    def __init__(self, seq0, seq1, mesh: Mesh, cfg: wf.StripConfig | None,
                 params: ScoreParams, prune: bool = False,
                 flush_stride: int = 0, capture_cols: bool = False):
        seq0 = np.ascontiguousarray(seq0, np.uint8)
        seq1 = np.ascontiguousarray(seq1, np.uint8)
        self.m, self.n = m, n = len(seq0), len(seq1)
        if m < 1 or n < 1:
            raise ValueError(f"empty sequence ({m} x {n})")
        self.rank, self.procs = world()
        if self.procs != max(mesh.owners) + 1:
            raise ValueError(f"the mesh spans {max(mesh.owners) + 1} "
                             f"processes, the group has {self.procs}")
        self.cfg = dataclasses.replace(
            cfg or default_config(mesh.devices[0]),
            recurrence=Recurrence.SMITH_WATERMAN, track_best=True,
            store_lastcol=True, match=params.match,
            mismatch=params.mismatch, gap_open=params.gap_open,
            gap_ext=params.gap_ext)
        self.params, self.prune = params, prune
        self.flush_stride, self.capture_cols = flush_stride, capture_cols
        self.R = R = self.cfg.rows
        self.D = D = mesh.size
        self.n_strips = -(-m // R)
        self.W = W = -(-n // D)
        self.rounds = self.n_strips + D - 1
        self.gbest = 0
        self.kw = dict(match=params.match, mismatch=params.mismatch,
                       gap_open=params.gap_open, gap_ext=params.gap_ext,
                       sw=True, track_best=True)
        b_pad = np.full(W * D, _sentinel(seq0), np.uint8)
        b_pad[:n] = seq1
        own = mesh.owned(self.rank)
        self.a = {dev: torch.from_numpy(seq0).to(dev)
                  for dev in {mesh.devices[d] for d in own}}
        self.slabs = []
        for d in own:
            dev = mesh.devices[d]
            bus_h, bus_f = wf.init_bus(InitType.WITH_ZEROES, W,
                                       params.gap_open, params.gap_ext, dev)
            self.slabs.append(_Slab(
                d, dev, torch.from_numpy(b_pad[d * W:(d + 1) * W]).to(dev),
                min(W, n - d * W), bus_h, bus_f))
        self._specials: list = []  # (d, s, bus_h, bus_f) since the last take
        self._captured: list = []  # (d, s, col_h, col_e)

    def height(self, s: int) -> int:
        """Rows of strip s: R, or what is left for the tail strip."""
        return min(self.R, self.m - s * self.R)

    def _neg(self, dev, *shape) -> torch.Tensor:
        return torch.full(shape, NEG, dtype=torch.int32, device=dev)

    def run_round(self, r: int) -> None:
        R, W = self.R, self.W
        launched, sent = [], {}
        for sl in self.slabs:
            s = r - sl.d
            if not 0 <= s < self.n_strips:
                continue
            h = self.height(s)
            if sl.d == 0:  # SW zero borders
                col = (torch.zeros(h, dtype=torch.int32, device=sl.dev),
                       self._neg(sl.dev, h))
                corner = c_max = c_last = 0
            else:
                col = sl.col or (self._neg(sl.dev, h), self._neg(sl.dev, h))
                corner, c_max, c_last = sl.corner, sl.col_max, sl.col_last
            if self.capture_cols and sl.d > 0:
                self._captured.append((sl.d, s) + col)
            run = sl.width > 0
            if self.prune:
                # the best this strip could reach: what enters it plus a
                # match on every cell of the diagonal left to the far
                # corner of the matrix
                entering = max(sl.bus_max, c_max, 0)
                gain = min(self.m - s * R, self.n - sl.d * W) \
                    * self.params.match
                if entering + gain <= self.gbest:
                    sl.npruned += 1
                    run = False
                    sl.bus_h = sl.bus_f = self._neg(sl.dev, W)
                    sl.bus_max = NEG
            if run:
                flags: list = []
                out = wf.strip(self.a[sl.dev][s * R:s * R + h], sl.b,
                               sl.bus_h, sl.bus_f, col[0], col[1], corner,
                               store_lastcol=sl.d < self.D - 1, flags=flags,
                               **self.kw)
                sl.bus_h, sl.bus_f = out.bus_h, out.bus_f
                launched.append((sl, s, out, flags))
                if out.lastcol_h is not None:
                    sent[sl.d] = [(out.lastcol_h, out.lastcol_e), 0, 0]
            elif sl.d < self.D - 1:
                sent[sl.d] = [None, NEG, NEG]
            sl.corner = c_last  # the next strip's corner
            if self.flush_stride and (s + 1) % self.flush_stride == 0:
                self._specials.append((sl.d, s, sl.bus_h, sl.bus_f))
        self._read_back(launched, sent)
        if self.prune:
            local = max([self.gbest] + [sl.best[0] for sl in self.slabs])
            self.gbest = self._all_max(local)
        self._exchange(r, sent)

    def _read_back(self, launched, sent) -> None:
        """One host read a device for the round's launches: each strip's
        best, bus maximum, last column's maximum and last H, error flag."""
        rows: dict = {}
        for sl, _, out, flags in launched:
            zero = torch.zeros(1, dtype=torch.int64, device=sl.dev)
            lc = out.lastcol_h
            rows.setdefault(sl.dev, []).append(torch.cat([
                out.best.long(), out.bus_h.max().long().view(1),
                lc.max().long().view(1) if lc is not None else zero,
                lc[-1:].long() if lc is not None else zero,
                flags[0].long() if flags else zero]))
        values = {dev: iter(torch.stack(v).tolist())
                  for dev, v in rows.items()}
        for sl, s, out, _ in launched:
            bv, bi, bj, bus_max, lc_max, lc_last, flag = next(values[sl.dev])
            kernels.check_flags([flag])
            # the earlier strip wins ties (strict >), then the strip's
            # smallest i and j
            if bv > sl.best[0]:
                sl.best = (bv, s * self.R + bi + 1, bj + 1)
            sl.bus_max = bus_max
            if sl.d in sent and sent[sl.d][0] is not None:
                sent[sl.d][1:] = lc_max, lc_last

    def _all_max(self, v: int) -> int:
        if self.procs == 1:
            return v
        import torch.distributed as dist

        t = torch.tensor([v], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t[0])

    def _exchange(self, r: int, sent: dict) -> None:
        """Each column sent this round becomes the border of the next
        slab's strip in round r + 1."""
        for sl in self.slabs:
            if sl.d - 1 in sent:
                col, sl.col_max, sl.col_last = sent[sl.d - 1]
                sl.col = None if col is None else tuple(
                    x.to(sl.dev) for x in col)
        if self.procs == 1:
            return
        import torch.distributed as dist

        first, last = self.slabs[0], self.slabs[-1]
        s = r - last.d
        req = None
        if last.d < self.D - 1 and 0 <= s < self.n_strips:
            col = sent[last.d][0]
            h = self.height(s)
            buf = torch.full((2, h), NEG, dtype=torch.int32,
                             pin_memory=last.dev.type == "cuda")
            if col is not None:
                buf[0].copy_(col[0], non_blocking=True)
                buf[1].copy_(col[1], non_blocking=True)
                if last.dev.type == "cuda":
                    torch.cuda.current_stream(last.dev).synchronize()
            req = dist.isend(buf, self.rank + 1)
        s = r + 1 - first.d
        if first.d > 0 and 0 <= s < self.n_strips:
            buf = torch.empty((2, self.height(s)), dtype=torch.int32)
            dist.recv(buf, self.rank - 1)
            first.col = (buf[0].to(first.dev), buf[1].to(first.dev))
            first.col_max, first.col_last = int(buf[0].max()), int(buf[0, -1])
        if req is not None:
            req.wait()

    def take_emissions(self):
        """The special rows ``(d, DP row, H, F)`` (W int32 each) and the
        captured border columns ``(d, s, H, E)`` (R int32 each, -INF past a
        tail strip's rows) since the last call."""
        rows = [(d, (s + 1) * self.R, h.cpu().numpy(), f.cpu().numpy())
                for d, s, h, f in self._specials]
        cols = []
        for d, s, ch, ce in self._captured:
            fill = np.full((2, self.R), NEG, np.int32)
            fill[0, :len(ch)] = ch.cpu().numpy()
            fill[1, :len(ce)] = ce.cpu().numpy()
            cols.append((d, s, fill[0], fill[1]))
        self._specials, self._captured = [], []
        return rows, cols

    # ---- the carry checkpoint ---------------------------------------------

    def carry(self) -> dict:
        """This process's slabs' carry as host arrays, by slab."""
        out = {}
        for sl in self.slabs:
            recv = np.zeros((2, self.R), np.int32)
            if sl.col is not None:
                recv[:] = NEG
                recv[0, :len(sl.col[0])] = sl.col[0].cpu().numpy()
                recv[1, :len(sl.col[1])] = sl.col[1].cpu().numpy()
            out[sl.d] = dict(
                bus_h=sl.bus_h.cpu().numpy(), bus_f=sl.bus_f.cpu().numpy(),
                recv_h=recv[0], recv_e=recv[1], corner=sl.corner,
                best3=np.asarray(sl.best, np.int64), gbest=self.gbest,
                npruned=sl.npruned)
        return out

    def restore(self, z, r_start: int) -> None:
        """Load the carry arrays ``z`` (by name, D rows each) of a run
        stopped before round ``r_start``."""
        self.gbest = int(z["gbest"][0])
        for sl in self.slabs:
            d = sl.d
            sl.bus_h = torch.from_numpy(np.ascontiguousarray(
                z["bus_h"][d], np.int32)).to(sl.dev)
            sl.bus_f = torch.from_numpy(np.ascontiguousarray(
                z["bus_f"][d], np.int32)).to(sl.dev)
            sl.bus_max = int(z["bus_h"][d].max())
            sl.corner = int(z["corner"][d])
            sl.best = tuple(int(x) for x in z["best3"][d])
            sl.npruned = int(z["npruned"][d])
            s = r_start - d
            sl.col = None
            if d > 0 and 0 <= s < self.n_strips:
                h = self.height(s)
                ch = np.ascontiguousarray(z["recv_h"][d][:h], np.int32)
                ce = np.ascontiguousarray(z["recv_e"][d][:h], np.int32)
                sl.col = (torch.from_numpy(ch).to(sl.dev),
                          torch.from_numpy(ce).to(sl.dev))
                sl.col_max, sl.col_last = int(ch.max()), int(ch[-1])


def _by_slab(per_process: list) -> dict:
    out = {}
    for part in per_process:
        out.update(part)
    return out


def _sharded_run(
    seq0: np.ndarray,
    seq1: np.ndarray,
    mesh: Mesh,
    cfg: wf.StripConfig | None,
    params: ScoreParams,
    prune: bool,
    flush_stride: int,
    capture_cols: bool,
    state_dir: str | None = None,
    chunk_rounds: int = 0,
    sink=None,
):
    """The pipeline's rounds, in chunks of ``chunk_rounds`` (default: four
    flushes' worth).  flush_stride > 0 emits a special row every
    ``flush_stride`` strips; capture_cols keeps the border column each
    slab received.  After every chunk the emissions go to ``sink`` (or
    to host arrays without one), and with ``state_dir`` the carry is
    checkpointed, so an interrupted run resumes from its last chunk
    (Status-file semantics, common/Status.cpp:70-89).  In a multi-process
    run each process writes its own slabs' emissions, a barrier waits for
    all of them, and every process writes the whole carry; at the end
    every process gets every slab's results."""
    pipe = ShardedPipeline(seq0, seq1, mesh, cfg, params, prune,
                           flush_stride, capture_cols)
    R, W, D = pipe.R, pipe.W, mesh.size
    m, n, n_strips, rounds = pipe.m, pipe.n, pipe.n_strips, pipe.rounds
    m_pad, n_pad = n_strips * R, W * D
    n_sp = n_strips // flush_stride if flush_stride else 0
    c = chunk_rounds or min(rounds, max(flush_stride, 1) * 4)
    multi = pipe.procs > 1
    own = [sl.d for sl in pipe.slabs]

    # ---- carry init / resume --------------------------------------------
    # valid only for the SAME run: geometry, scores, pruning, cadence, the
    # strip height and both sequences (a rerun with other params in the
    # same work dir recomputes; Job.cpp:102-146)
    ck_path = os.path.join(state_dir, "sharded_carry.npz") \
        if state_dir else None
    fp_src = repr(("masa_tpu_torch", m, n, params.match, params.mismatch,
                   params.gap_open, params.gap_ext, prune, flush_stride,
                   capture_cols, R, int(Recurrence.SMITH_WATERMAN),
                   hashlib.sha1(np.ascontiguousarray(seq0)).hexdigest(),
                   hashlib.sha1(np.ascontiguousarray(seq1)).hexdigest()))
    run_fp = hashlib.sha1(fp_src.encode()).hexdigest()
    r_start, z = 0, None
    if ck_path and os.path.exists(ck_path):
        try:
            with np.load(ck_path) as f:
                if (int(f["W"]) == W and int(f["R"]) == R
                        and int(f["D"]) == D and int(f["c"]) == c
                        and str(f["fp"]) == run_fp):
                    z = {k: f[k] for k in CARRY_NAMES}
                    r_start = int(f["round0"])
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            r_start, z = 0, None
    if multi:
        starts = gather_objects(r_start)
        if min(starts) != max(starts):
            r_start = 0  # the processes disagree on where to resume
    if r_start:
        pipe.restore(z, r_start)

    if sink is None:
        acc_sp_h = np.zeros((D, max(n_sp, 1), W), np.int32)
        acc_sp_f = np.zeros((D, max(n_sp, 1), W), np.int32)
        fc_len = m_pad if capture_cols else 1
        acc_fc_h = np.zeros((D, fc_len), np.int32)
        acc_fc_e = np.zeros((D, fc_len), np.int32)

    for r0 in range(r_start, rounds, c):
        for r in range(r0, min(r0 + c, rounds)):
            pipe.run_round(r)
        rows, cols = pipe.take_emissions()
        for d, s, h, e in cols:
            if sink is None:
                acc_fc_h[d][s * R:(s + 1) * R] = h
                acc_fc_e[d][s * R:(s + 1) * R] = e
            else:
                sink.boundary_col(d, s, h, e)
        for d, row, h, f in rows:
            if sink is None:
                acc_sp_h[d][row // (R * flush_stride) - 1] = h
                acc_sp_f[d][row // (R * flush_stride) - 1] = f
            else:
                sink.special_row(d, row, h, f)
        if ck_path:
            if multi:
                import torch.distributed as dist

                if sink is not None:
                    sink.flush()
                dist.barrier()  # every process's part of the chunk is out
            carry = _by_slab(gather_objects(pipe.carry()))
            arrays = {k: np.stack([np.asarray(carry[d][k])
                                   for d in range(D)]) for k in CARRY_NAMES}
            tmp = f"{ck_path}.tmp{pipe.rank}.npz"
            np.savez(tmp, round0=r0 + c, W=W, R=R, D=D, c=c, fp=run_fp,
                     **arrays)
            os.replace(tmp, ck_path)
            if sink is not None:
                sink.chunk_done(r0 + c)

    mine = {sl.d: dict(best3=sl.best, last_h=sl.bus_h.cpu().numpy(),
                       last_f=sl.bus_f.cpu().numpy(), npruned=sl.npruned)
            for sl in pipe.slabs}
    if sink is None:
        emitted = dict(sp_h=acc_sp_h, sp_f=acc_sp_f, fc_h=acc_fc_h,
                       fc_e=acc_fc_e)
    else:
        emitted = dict(sp_h=sink.sp_h, sp_f=sink.sp_f, fc_h=sink.fc_h,
                       fc_e=sink.fc_e)
    if multi:
        for d in own:
            mine[d].update({k: np.asarray(v[d]) for k, v in emitted.items()})
        slabs = _by_slab(gather_objects(mine))
        emitted = {k: np.stack([slabs[d][k] for d in range(D)])
                   for k in emitted}
    else:
        slabs = mine
    host = {
        "best3": np.array([slabs[d]["best3"] for d in range(D)], np.int64),
        "last_h": np.stack([slabs[d]["last_h"] for d in range(D)]),
        "last_f": np.stack([slabs[d]["last_f"] for d in range(D)]),
        "npruned": np.array([slabs[d]["npruned"] for d in range(D)],
                            np.int32),
    }
    host.update(emitted)
    host.update(m=m, n=n, W=W, D=D, R=R, n_strips=n_strips, n_sp=n_sp,
                m_pad=m_pad, n_pad=n_pad, flush_stride=flush_stride)
    return host


class ShardedStateSink:
    """Disk persistence for the chunked sharded stage 1, the per-node SRA
    analogue (sw_stage1.cpp:168-196): slab special rows and boundary
    columns stream into memmaps as chunks complete, so an interrupted run
    resumes from the carry checkpoint with every earlier emission on disk.
    The files and their int32 layouts are masa_tpu's: ``sp_h.dat`` and
    ``sp_f.dat`` (D, n_sp, W), ``fc_h.dat`` and ``fc_e.dat`` (D, m_pad)."""

    def __init__(self, state_dir: str, D: int, W: int, R: int,
                 m_pad: int, n_sp: int):
        os.makedirs(state_dir, exist_ok=True)
        self.dir = state_dir
        self.D, self.W, self.R = D, W, R
        self.m_pad, self.n_sp = m_pad, n_sp
        shape_sp = (D, max(n_sp, 1), W)
        shape_fc = (D, m_pad)
        self.sp_h = self._mm("sp_h.dat", shape_sp)
        self.sp_f = self._mm("sp_f.dat", shape_sp)
        self.fc_h = self._mm("fc_h.dat", shape_fc)
        self.fc_e = self._mm("fc_e.dat", shape_fc)

    def _mm(self, name, shape):
        path = os.path.join(self.dir, name)
        mode = "r+" if (os.path.exists(path) and
                        os.path.getsize(path) ==
                        int(np.prod(shape)) * 4) else "w+"
        return np.memmap(path, dtype=np.int32, mode=mode, shape=shape)

    def set_stride(self, stride: int):
        self._stride = max(stride, 1)

    def special_row(self, d, row, h, f):
        # row = (s+1)*R with (s+1) % stride == 0 -> global slot
        slot = min(row // (self.R * self._stride) - 1,
                   self.sp_h.shape[1] - 1)
        self.sp_h[d][slot] = h
        self.sp_f[d][slot] = f

    def boundary_col(self, d, s, h, e):
        self.fc_h[d][s * self.R:(s + 1) * self.R] = h
        self.fc_e[d][s * self.R:(s + 1) * self.R] = e

    def flush(self):
        for mm in (self.sp_h, self.sp_f, self.fc_h, self.fc_e):
            mm.flush()

    def chunk_done(self, round0: int):
        self.flush()


def sharded_stage1(
    seq0: np.ndarray,
    seq1: np.ndarray,
    mesh: Mesh,
    cfg: wf.StripConfig | None = None,
    params: ScoreParams = ScoreParams(),
    prune: bool = False,
) -> ShardedResult:
    """Score-only SW forward pass, column-sharded over the mesh: the
    global best score and the final DP row (the slabs' buses in a row;
    columns past n are the pad's).

    ``prune=True`` enables **score-share block pruning across slabs**
    (the TPDS2021 distributed pruning the reference disables in
    multi-GPU runs, libmasa.cpp:1318-1323): the global best circulates
    every round, and a slab skips a strip when
        max(entering H, 0) + min(rows_left, global cols_right) * match
    cannot beat it (AbstractBlockPruning::isBlockPrunable over the whole
    remaining matrix).  Skipped strips write -INF buses and columns, which
    stays exact for SW: fresh alignments restart from 0 anywhere."""
    h = _sharded_run(seq0, seq1, mesh, cfg, params, prune,
                     flush_stride=0, capture_cols=False)
    return ShardedResult(
        best=int(h["best3"][:, 0].max()),
        last_h=h["last_h"].reshape(h["n_pad"]),
        last_f=h["last_f"].reshape(h["n_pad"]),
        cells=h["m_pad"] * h["n_pad"],
        pruned_strips=h["npruned"],
    )


def _make_sink(state_dir, D, W, R, m_pad, n_sp, stride):
    """The sink, created by process 0 first so that processes sharing a
    directory open its files rather than truncate them."""
    rank, procs = world()
    make = lambda: ShardedStateSink(state_dir, D, W, R, m_pad, n_sp)  # noqa
    sink = make() if rank == 0 else None
    if procs > 1:
        import torch.distributed as dist

        dist.barrier()
        sink = sink or make()
    sink.set_stride(stride)
    return sink


def sharded_stage1_full(
    seq0: np.ndarray,
    seq1: np.ndarray,
    mesh: Mesh,
    cfg: wf.StripConfig | None = None,
    params: ScoreParams = ScoreParams(),
    prune: bool = False,
    flush_stride: int = 1,
    state_dir: str | None = None,
) -> ShardedFullResult:
    """Stage 1 with everything traceback needs, per slab: the slab-local
    best endpoint, special rows every ``flush_stride`` strips, and the
    received boundary column (the multi-GPU stage 1 of
    sw_stage1.cpp:168-196).  The returned ``parts`` feed
    ``split.pipelined_traceback`` / ``speculative_traceback`` directly
    (libmasa.cpp:659-757)."""
    from masa_tpu_torch.parallel.split import PartResult
    from masa_tpu_torch.stages.core import SpecialRowStore

    stride = max(flush_stride, 1)
    sink = None
    if state_dir is not None:
        R_ = (cfg or default_config(mesh.devices[0])).rows
        D_ = mesh.size
        n_strips_ = -(-len(seq0) // R_)
        sink = _make_sink(state_dir, D_, -(-len(seq1) // D_), R_,
                          n_strips_ * R_, n_strips_ // stride, stride)
    h = _sharded_run(seq0, seq1, mesh, cfg, params, prune,
                     flush_stride=stride, capture_cols=True,
                     state_dir=state_dir, sink=sink)
    m, n, W, D, R = h["m"], h["n"], h["W"], h["D"], h["R"]

    parts: list[PartResult] = []
    for d in range(D):
        j0 = d * W
        if j0 >= n:
            break
        j1 = min(j0 + W, n)
        w_d = j1 - j0
        # boundary column (H, E) for rows 0..m at global column j0
        if d > 0:
            fch = np.empty(m + 1, np.int64)
            fce = np.empty(m + 1, np.int64)
            fch[0] = 0          # SW row-0 border
            fce[0] = NEG
            fch[1:] = h["fc_h"][d][:m]
            fce[1:] = h["fc_e"][d][:m]
            first_col = (fch, fce)
        else:
            first_col = None
        store = SpecialRowStore()
        for slot in range(h["n_sp"]):
            r = (slot + 1) * stride * R
            if r > m:
                break
            h_full = np.empty(w_d + 1, np.int64)
            f_full = np.empty(w_d + 1, np.int64)
            h_full[0] = first_col[0][r] if first_col is not None else 0
            f_full[0] = NEG
            h_full[1:] = h["sp_h"][d][slot][:w_d]
            f_full[1:] = h["sp_f"][d][slot][:w_d]
            store.put(r, h_full, f_full)
        bv, bi, bj = (int(x) for x in h["best3"][d])
        parts.append(PartResult(
            best=bv, best_i=bi, best_j=j0 + bj,
            last_h=h["last_h"][d][:w_d].astype(np.int64),
            last_f=h["last_f"][d][:w_d].astype(np.int64),
            cells=h["m_pad"] * w_d,
            specials=store, first_col=first_col, j0=j0, j1=j1,
        ))

    # global endpoint: max score, then smallest i, then smallest j
    gbest = max(((p.best, -p.best_i, -p.best_j, k)
                 for k, p in enumerate(parts)))
    k = gbest[3]
    return ShardedFullResult(
        best=parts[k].best, best_i=parts[k].best_i,
        best_j=parts[k].best_j, parts=parts,
        cells=h["m_pad"] * h["n_pad"], pruned_strips=h["npruned"],
    )


def sharded_align(
    seq0: np.ndarray,
    seq1: np.ndarray,
    mesh: Mesh,
    cfg: wf.StripConfig | None = None,
    params: ScoreParams = ScoreParams(),
    prune: bool = False,
    flush_stride: int = 1,
    traceback: str = "pipelined",
    max_cells_stage5: int = 1 << 18,
    state_dir: str | None = None,
    max_partition: int = 16,
    on_stage=None,
):
    """The full multi-device alignment: sharded stage 1 over the mesh, the
    pipelined or speculative slab traceback (stage 2) on the mesh's first
    device with the same strip height, densification (stage 3, as far as
    ``split.densify_limit``), the Myers-Miller stage-4 ladder down to
    ``max_partition``, the exact per-partition traceback with its score
    invariant (stage 5) and the independent stage-6 re-check.
    ``on_stage(name, seconds, result)``, when given, is called as each
    stage ends (synced on CUDA).

    Returns (best_score, Alignment); raises when the alignment's score is
    not stage 1's best.  The reference equivalent is the whole multi-GPU
    claim: executeTracebackPipelined / Predicted, libmasa.cpp:659-757."""
    from masa_tpu_torch.ops import myers_miller as mm
    from masa_tpu_torch.parallel import split
    from masa_tpu_torch.stages import pipeline, stage6

    dev = mesh.devices[0]
    cfg = cfg or default_config(dev)
    run = trace.stage_runner(dev, on_stage)

    full = run("stage1", sharded_stage1_full, seq0, seq1, mesh, cfg, params,
               prune, flush_stride, state_dir=state_dir)
    # the slab marchers: the host oracle on the CPU (masa_tpu's scan
    # backend), the strip kernel at this pipeline's strip height on CUDA
    kw = dict(backend="numpy" if dev.type == "cpu" else "auto", cfg=cfg,
              device=dev)

    def march():
        if traceback == "speculative":
            return split.speculative_traceback(seq0, seq1, full.parts,
                                               params, **kw)[0]
        return split.pipelined_traceback(seq0, seq1, full.parts, params,
                                         **kw)

    cps = run("stage2", march)
    pcfg = pipeline.PipelineConfig(
        params=params, max_cells_stage5=max_cells_stage5, device=str(dev))
    cps = run("stage3", pipeline.stage3_densify, seq0, seq1, pcfg, cps,
              max_cells=split.densify_limit(max_partition, dev))

    def reduce():
        if not max_partition:
            return cps
        return mm.stage4_reduce(seq0, seq1, cps, params, max_partition,
                                stage5_max_cells=max_cells_stage5,
                                device=dev)

    cps = run("stage4", reduce)
    aln = run("stage5", pipeline.stage5_emit, seq0, seq1, pcfg, cps)

    def recheck():
        stage6.recheck(aln, seq0, seq1, params)
        return aln

    run("stage6", recheck)
    if aln.raw_score != full.best:
        raise RuntimeError(
            f"sharded alignment score {aln.raw_score} != stage-1 best "
            f"{full.best}")
    return full.best, aln
