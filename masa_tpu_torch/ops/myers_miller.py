"""Stage 4 of the port: Myers-Miller splitting of the crosspoint list
(counterpart of masa_tpu/ops/myers_miller.py).

Every adjacent crosspoint pair is split at its middle row until the
largest partition is small enough, with masa_tpu's three strategies
(sw_stage4.cpp:146-163 of the reference):

  * ORIGINAL_MM  -- full forward half + full reverse half, match the cut;
  * ORTHOGONAL   -- the same inside a column window that doubles until the
    cut matches;
  * OPTIMIZED    -- the banded ladder, run by an engine that follows the
    device.

The engines, chosen by ``stage4_engine`` as masa_tpu chooses on its
device and off it: on a CUDA device the level-batched engine
(``ops/batched_mm``, the batched strip kernel), which splits only down to
``max(max_partition, isqrt(stage5_max_cells))``, as masa_tpu's batched
engine does on a TPU; on the CPU the native C++ ladder
(``masa_tpu_torch.native``, the port's copy) where there is a ``g++`` to
build it; otherwise, and for the other two strategies, the Python splitter
below (a port of masa_tpu's, whose module imports JAX)."""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from masa_tpu_torch.models.scoring import match_column
from masa_tpu_torch.native import bindings
from masa_tpu_torch.ops import oracle
from masa_tpu_torch.types import (
    Crosspoint,
    CrosspointType,
    MatchType,
    Recurrence,
    ScoreParams,
)
from masa_tpu_torch.ops import batched_mm
from masa_tpu_torch.stages import core


class SplitStrategy(enum.IntEnum):
    ORIGINAL_MM = 0
    ORTHOGONAL = 1
    OPTIMIZED = 2


def _half_pass(seq0, seq1, params, row_init, col_init):
    """NW forward pass returning the last row (H, F) with the border gap
    value synthesized at k=0."""
    res = oracle.dp_rows(seq0, seq1, params, Recurrence.NEEDLEMAN_WUNSCH,
                         row_init, col_init)
    lf = res.last_f.copy()
    lf[0] = core._border_f_value(col_init, len(seq0), params)
    return res.last_h, lf


def split_partition(
    seq0: np.ndarray,
    seq1: np.ndarray,
    c0: Crosspoint,
    c1: Crosspoint,
    params: ScoreParams,
    strategy: SplitStrategy = SplitStrategy.OPTIMIZED,
) -> Crosspoint:
    """The crosspoint where the optimal c0->c1 path crosses the
    partition's middle row.  Coordinates are global; sequences are full."""
    h = c1.i - c0.i
    w = c1.j - c0.j
    if h < 2:
        raise ValueError(f"nothing to split in {c0}->{c1}")
    rm = c0.i + h // 2
    hb, ht = rm - c0.i, c1.i - rm
    sub0f = np.ascontiguousarray(seq0[c0.i:rm])
    sub0r = np.ascontiguousarray(seq0[rm:c1.i][::-1])
    # the constrained segment value plus one gap_open when the c1 pin is
    # gapped (the reverse pass's opened border omits exactly that open)
    goal = c1.score - c0.score + (
        params.gap_open if c1.type != CrosspointType.MATCH else 0)

    fr_init, fc_init = core.init_types_for(c0.type)
    rr_init, rc_init = core.init_types_for(c1.type)

    if strategy == SplitStrategy.ORIGINAL_MM:
        windows = [w]
    else:
        w0 = min(w, max(64, 2 * max(hb, ht)))
        windows = []
        while w0 < w:
            windows.append(w0)
            w0 *= 2
        windows.append(w)

    for win in windows:
        # monotone paths from c0 never leave [c0.j, c1.j]
        fw = np.ascontiguousarray(seq1[c0.j:min(c0.j + win, c1.j)])
        rw = np.ascontiguousarray(seq1[max(c1.j - win, c0.j):c1.j][::-1])
        fh, ff = _half_pass(sub0f, fw, params, fr_init, fc_init)
        rh, rf = _half_pass(sub0r, rw, params, rr_init, rc_init)
        j_lo = max(c0.j, c1.j - win)
        j_hi = min(c1.j, c0.j + win)
        if j_lo > j_hi:
            continue
        js = np.arange(j_lo, j_hi + 1)
        f_idx = js - c0.j
        r_idx = c1.j - js
        # scan from the c1 side (descending j), as stage 2 does
        mres = match_column(rh[r_idx][::-1], rf[r_idx][::-1],
                            fh[f_idx][::-1], ff[f_idx][::-1], goal,
                            params.gap_open)
        if mres.found:
            j_star = int(js[::-1][mres.k])
            t = (CrosspointType.MATCH if mres.type == MatchType.ALIGNED
                 else CrosspointType.GAP_2)
            return Crosspoint(rm, j_star, c0.score + int(mres.score), t)
    raise RuntimeError(f"Myers-Miller split lost the path in {c0}->{c1}")


def reduce_partitions(
    seq0: np.ndarray,
    seq1: np.ndarray,
    cps: list[Crosspoint],
    params: ScoreParams,
    max_partition: int = 16,
    strategy: SplitStrategy = SplitStrategy.OPTIMIZED,
) -> list[Crosspoint]:
    """Split every adjacent pair until max(height, width) <= max_partition
    (the stage-4 loop, sw_stage4.cpp:926-945), in path order."""
    out = [cps[0]]

    def emit(c0, c1):
        if max(c1.i - c0.i, c1.j - c0.j) <= max_partition or c1.i - c0.i < 2:
            out.append(c1)
            return
        cm = split_partition(seq0, seq1, c0, c1, params, strategy)
        emit(c0, cm)
        emit(cm, c1)

    for c0, c1 in zip(cps, cps[1:]):
        emit(c0, c1)
    return out


def stage4_engine(device, strategy: SplitStrategy) -> str:
    """The engine stage 4 runs: "batched" on a CUDA device with the
    OPTIMIZED ladder, "native" off it where the native library can be built,
    "python" otherwise."""
    if strategy != SplitStrategy.OPTIMIZED:
        return "python"
    if torch.device(device).type == "cuda":
        return "batched"
    return "native" if bindings.available() else "python"


def stage4_reduce(seq0: np.ndarray, seq1: np.ndarray,
                  cps: list[Crosspoint], params: ScoreParams,
                  max_partition: int = 16,
                  strategy: SplitStrategy = SplitStrategy.OPTIMIZED,
                  log=None,
                  stage5_max_cells: int | None = None,
                  device="cuda") -> list[Crosspoint]:
    """Split every adjacent crosspoint pair until max(height, width) <=
    max_partition; the batched engine stops at isqrt(stage5_max_cells)
    when that is larger (stage 5's DP takes any partition size) and
    hands ``log`` a line a level."""
    if not max_partition or len(cps) < 2:
        return cps
    engine = stage4_engine(device, strategy)
    if engine == "batched":
        mps = max_partition
        if stage5_max_cells:
            mps = max(mps, math.isqrt(stage5_max_cells))
        return batched_mm.reduce_partitions_batched(
            seq0, seq1, cps, params, mps, device=device, log=log)
    if engine == "native":
        # the OPTIMIZED ladder, bit-exact with masa_tpu's
        return bindings.reduce_partitions(seq0, seq1, cps, params,
                                          max_partition)
    return reduce_partitions(seq0, seq1, cps, params, max_partition,
                             strategy)
