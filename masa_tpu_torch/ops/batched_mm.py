"""Stage 4 on the GPU: level-batched Myers-Miller (counterpart of
masa_tpu/ops/batched_mm.py, the TPU's stage-4 engine).

Every crosspoint pair still wider or taller than ``max_partition`` is
split at a middle row.  That needs one forward and one reverse NW
half-pass per pair; all the halves of a level run in one launch of the
batched strip kernel (``csrc/batched_strip.cu``; a half is a warp, a chain
of warps or a whole block, by the level's heights) on
sequence views uploaded once, and the Myers-Miller column match of every
pair runs on the device as tensor ops, so a level pulls four integers per
pair to the host.

Kept from masa_tpu: the split row (``_split_height``), the matching rule
and the order of the output, so on the same input the two engines give
the same crosspoints.  Dropped, being TPU layout: power-of-two width
buckets, lane-granular heights with row-sweep tails, batch tiles and the
engine cost model.  On the CPU ``wavefront.batched_strip`` runs the plain
row sweep instead of the kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from masa_tpu_torch.types import INF, Crosspoint, CrosspointType, InitType, \
    ScoreParams
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import core as score

NEG = -INF
# bus cells (pairs x widest width) of one launch: bounds device memory
CELL_CAP = 1 << 24


def _split_height(h: int) -> int:
    """Top-half height: ~h/2 rounded down to a multiple of 1024 (h/2 >=
    2048) or 512 (h/2 >= 512), else h//2; in [1, h-1].  masa_tpu's split
    row, kept so both engines cut the same rows."""
    t = h // 2
    if t >= 2048:
        return (t // 1024) * 1024
    if t >= 512:
        return (t // 512) * 512
    return max(t, 1)


@dataclasses.dataclass
class _Half:
    """One half-pass: rows [i0, i0+h) x columns [j0, j0+w) of the forward
    sequence views, or of the reversed ones for a reverse half."""

    i0: int
    h: int
    j0: int
    w: int
    row_code: int
    col_code: int


class _DevSeqs:
    """The forward and reversed sequence views on the device, from the
    device sequence cache (``wavefront.dev_seq``): the forward arrays are
    usually there from stage 1 and the reversed views are made by flips
    on the device, so a warm stage 4 copies nothing from the host."""

    def __init__(self, seq0: np.ndarray, seq1: np.ndarray, device):
        self.m, self.n = len(seq0), len(seq1)
        self._views = tuple(
            (wf.dev_seq(seq0, device, reverse=rev),
             wf.dev_seq(seq1, device, reverse=rev)) for rev in (False, True))

    def views(self, rev: bool):
        return self._views[rev]


def is_done(c0: Crosspoint, c1: Crosspoint, max_partition: int) -> bool:
    """A pair stage 4 leaves as it is: small enough, or one row."""
    return max(c1.i - c0.i, c1.j - c0.j) <= max_partition or c1.i - c0.i < 2


def level_halves(pending: list[tuple[Crosspoint, Crosspoint]], m: int,
                 n: int):
    """The split row of every pair of a level, and its forward and reverse
    halves: ``[(c0, c1, row)], [_Half], [_Half]``."""
    meta, fwd, rev = [], [], []
    for c0, c1 in pending:
        w = c1.j - c0.j
        rm = c0.i + _split_height(c1.i - c0.i)
        meta.append((c0, c1, rm))
        ri, ci = score.init_types_for(c0.type)
        fwd.append(_Half(c0.i, rm - c0.i, c0.j, w, int(ri), int(ci)))
        ri, ci = score.init_types_for(c1.type)
        rev.append(_Half(m - c1.i, c1.i - rm, n - c1.j, w, int(ri), int(ci)))
    return meta, fwd, rev


def elems_of(halves: list[_Half]) -> np.ndarray:
    """The batched strip kernel's (B, 6) element table of some halves."""
    return np.array([(x.i0, x.h, x.j0, x.w, x.row_code, x.col_code)
                     for x in halves], np.int32).reshape(-1, 6)


def _run_halves(dev: _DevSeqs, elems: np.ndarray, rev: bool,
                params: ScoreParams, width: int):
    """The last rows (B, width) of a batch of halves, on the device."""
    a, b = dev.views(rev)
    return wf.batched_strip(a, b, elems, width, match=params.match,
                            mismatch=params.mismatch,
                            gap_open=params.gap_open, gap_ext=params.gap_ext)


def _border_end(elems: torch.Tensor, params: ScoreParams) -> torch.Tensor:
    """Per half, the (H, F) of its left border at its last row h: the k = 0
    element of the row it matches with (``_border_f_value`` for F)."""
    h, code = elems[:, 1], elems[:, 5]
    go, ge = params.gap_open, params.gap_ext
    bh = wf.border_h_codes(code, h, go, ge)
    bf = torch.where(code == InitType.WITH_GAPS_OPENED, -h * ge,
                     -go - h * ge)
    return torch.stack([bh, bf], 1)


def _match(fh, ff, rh, rf, el_f, el_r, goals, params: ScoreParams
           ) -> np.ndarray:
    """Per pair, match the reverse half's last row against the forward
    half's, reversed, over k = 0..w (``models.scoring.match_column``, the
    vectorised engine of masa_tpu's ``_match_engine``).  ``el_f``/``el_r``
    are the halves' element tables.  Returns host int (4, B): found, k,
    score, type (0 aligned, 1 gapped, 2 and 3 the overshoot errors)."""
    dev = fh.device
    i64 = torch.int64
    W = fh.shape[1]
    go = params.gap_open
    el_f, el_r = (torch.from_numpy(x).to(dev, i64) for x in (el_f, el_r))
    fwd0, rev0 = _border_end(el_f, params), _border_end(el_r, params)
    ws = el_f[:, 3:4]
    goal = torch.as_tensor(goals, dtype=i64).to(dev)[:, None]
    k = torch.arange(W + 1, device=dev, dtype=i64)
    # full rows including the border element at k = 0
    rhs = torch.cat([rev0[:, :1], rh.to(i64)], 1)
    rfs = torch.cat([rev0[:, 1:], rf.to(i64)], 1)
    fhs = torch.cat([fwd0[:, :1], fh.to(i64)], 1)
    ffs = torch.cat([fwd0[:, 1:], ff.to(i64)], 1)
    at = (ws - k).clamp(min=0)  # index k reads the forward row at w - k
    fh_r, ff_r = fhs.gather(1, at), ffs.gather(1, at)
    valid = k <= ws
    sum_m = fh_r + rhs
    sum_g = ff_r + rfs + go
    hit = ((sum_m == goal) | (sum_g == goal)) & valid
    over = ((sum_m > goal) | (sum_g > goal)) & valid
    first = torch.where(hit | over, k, W + 1).min(1).values
    found = first <= W
    kc = first.clamp(max=W)[:, None]
    m_at = (sum_m.gather(1, kc) == goal)[:, 0]
    g_at = (sum_g.gather(1, kc) == goal)[:, 0]
    is_hit = found & (m_at | g_at)
    over_m = (sum_m.gather(1, kc) > goal)[:, 0]
    typ = torch.where(is_hit, torch.where(m_at, 0, 1),
                      torch.where(over_m, 2, 3))
    scr = torch.where(m_at, fh_r.gather(1, kc)[:, 0], ff_r.gather(1, kc)[:, 0])
    return torch.stack([is_hit.to(i64), kc[:, 0], scr, typ.to(i64)]).cpu() \
        .numpy()


def _chunks(widths: list[int], cell_cap: int):
    """Consecutive (lo, hi, widest) slices of a level whose count times
    widest width stays within ``cell_cap`` bus cells (a single pair may
    exceed it)."""
    out, start, wmax = [], 0, 1
    for k, w in enumerate(widths):
        wn = max(wmax, w, 1)
        if k > start and (k - start + 1) * wn > cell_cap:
            out.append((start, k, wmax))
            start, wn = k, max(w, 1)
        wmax = wn
    if widths:
        out.append((start, len(widths), wmax))
    return out


def reduce_partitions_batched(
    seq0: np.ndarray,
    seq1: np.ndarray,
    cps: list[Crosspoint],
    params: ScoreParams,
    max_partition: int = 16,
    device="cuda",
    on_launches=None,
    log=None,
) -> list[Crosspoint]:
    """Split every adjacent pair until max(height, width) <= max_partition,
    one batched launch per direction per level (per ``CELL_CAP`` bus cells
    of it).  ``on_launches(level, el_f, el_r, width)``, if given, sees the
    element tables of each forward and reverse launch pair before it runs
    (a measurement's tap).  ``log``, if given, gets masa_tpu's line after
    each level: ``stage4[batched]: level L: N pairs``."""
    seq0 = np.asarray(seq0, np.uint8)
    seq1 = np.asarray(seq1, np.uint8)
    go = params.gap_open
    dev = _DevSeqs(seq0, seq1, torch.device(device))
    m, n = dev.m, dev.n

    done: list[tuple[Crosspoint, Crosspoint]] = []
    work = list(zip(cps, cps[1:]))
    level = 0
    while True:
        pending = []
        for pair in work:
            (done if is_done(*pair, max_partition) else pending).append(pair)
        if not pending:
            break
        level += 1

        meta, fwd, rev = level_halves(pending, m, n)

        next_work = []
        for lo, hi, width in _chunks([x.w for x in fwd], CELL_CAP):
            el_f, el_r = elems_of(fwd[lo:hi]), elems_of(rev[lo:hi])
            if on_launches is not None:
                on_launches(level, el_f, el_r, width)
            fh, ff = _run_halves(dev, el_f, False, params, width)
            rh, rf = _run_halves(dev, el_r, True, params, width)
            goals = [c1.score - c0.score + (
                go if c1.type != CrosspointType.MATCH else 0)
                for c0, c1, _ in meta[lo:hi]]
            found, ks, scrs, typs = _match(fh, ff, rh, rf, el_f, el_r,
                                           goals, params)
            for r, (c0, c1, rm) in enumerate(meta[lo:hi]):
                if not found[r]:
                    raise RuntimeError(
                        f"batched Myers-Miller lost the path in {c0}->{c1} "
                        f"(err type {int(typs[r])})")
                t = (CrosspointType.MATCH if int(typs[r]) == 0
                     else CrosspointType.GAP_2)
                cm = Crosspoint(rm, c1.j - int(ks[r]),
                                c0.score + int(scrs[r]), t)
                next_work.append((c0, cm))
                next_work.append((cm, c1))
        if log:
            log(f"stage4[batched]: level {level}: {len(pending)} pairs")
        work = next_work

    # reassemble in path order: the c1 of every pair, sorted by position
    done.sort(key=lambda p: (p[0].i, p[0].j))
    return [cps[0]] + [c1 for _, c1 in done]
