"""The port's stage-4 engine and its batched strips against masa_tpu's, on
the CPU.

``wavefront.batched_strip`` (the contract of the batched strip kernel; on
the CPU its plain row sweep) against masa_tpu's batched Pallas kernel
``batched_strip_pallas_dyn`` in interpret mode and against the NumPy
oracle; ``batched_mm.reduce_partitions_batched`` against masa_tpu's level-
batched engine, crosspoint for crosspoint; and the slice as a whole with
the batched stage 4 in place of the native ladder.  Tolerance: exact
equality everywhere (integer DP)."""

import dataclasses

import numpy as np
import pytest
import torch

from masa_tpu.ops import batched_mm as jbm
from masa_tpu.ops import oracle, smallsw
from masa_tpu.ops import wavefront as jwf
from masa_tpu.types import (
    Crosspoint,
    CrosspointType,
    InitType,
    Recurrence,
    ScoreParams,
)
from masa_tpu_torch import convert
from masa_tpu_torch.ops import batched_mm, kernels, myers_miller
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import pipeline

P = ScoreParams()
PP = convert.to_port(P)  # the port takes its own types
port = convert.to_port
KW = dict(match=P.match, mismatch=P.mismatch, gap_open=P.gap_open,
          gap_ext=P.gap_ext)
BASES = np.frombuffer(b"ACGT", np.uint8)


def seqs(seed, m, n):
    rng = np.random.default_rng(seed)
    return (rng.choice(BASES, m).astype(np.uint8),
            rng.choice(BASES, n).astype(np.uint8))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("rev", [False, True])
def test_batched_strip_matches_jax_dyn_kernel(monkeypatch, rev):
    """A mixed batch (heights on and off the TPU kernel's 256-row grain,
    every border code, a 1-row and a 0-wide element) through masa_tpu's
    dynamic-height Pallas kernel in interpret mode, and through the port."""
    cfg0 = jwf.WavefrontConfig(alpha=2, rs=2, chunk=256, interpret=True)

    def small_cfg(h, njq, params, B=1, heights=None):
        return dataclasses.replace(
            cfg0, recurrence=Recurrence.NEEDLEMAN_WUNSCH, track_best=False,
            store_lastcol=False, **KW)

    monkeypatch.setattr(jbm, "_pallas_mm_cfg", small_cfg)
    s0, s1 = seqs(7, 1500, 1400)
    njq = 256
    dev = jbm._DevSeqs(s0, s1, pad0=4096, pad1=njq + 16384)
    halves = [jbm._Half(0, 512, 0, 250, 1, 1),
              jbm._Half(100, 256, 30, 200, 0, 2),
              jbm._Half(40, 300, 200, 64, 2, 0),
              jbm._Half(7, 1, 9, 0, 1, 2)]
    want_h, want_f = (np.asarray(x) for x in
                      jbm._halves_mosaic(dev, halves, rev, P, njq))
    a, b = (s0[::-1], s1[::-1]) if rev else (s0, s1)
    elems = [(x.i0, x.h, x.j0, x.w, x.row_code, x.col_code) for x in halves]
    got_h, got_f = wf.batched_strip(t(a), t(b), elems, njq, **KW)
    for k, x in enumerate(halves):
        w = x.w
        np.testing.assert_array_equal(got_h[k, :w].numpy(), want_h[k, :w])
        np.testing.assert_array_equal(got_f[k, :w].numpy(), want_f[k, :w])
        assert (got_h[k, w:] == -wf.INF).all()


@pytest.mark.parametrize("seed,B,h_max,w_max", [
    (1, 6, 40, 50), (2, 4, 300, 20), (3, 3, 2100, 9)])
def test_batched_strip_plain_matches_oracle(seed, B, h_max, w_max):
    """Every element's last row against ``oracle.dp_rows`` on its own
    sub-matrix, with the borders its codes name (the last case is taller
    than one block of the kernel, which chains there)."""
    rng = np.random.default_rng(seed)
    s0, s1 = seqs(seed, 3000, 3000)
    elems = []
    for _ in range(B):
        h, w = int(rng.integers(1, h_max + 1)), int(rng.integers(0, w_max + 1))
        elems.append((int(rng.integers(0, 3000 - h)), h,
                      int(rng.integers(0, 3000 - w)), w,
                      int(rng.integers(0, 3)), int(rng.integers(0, 3))))
    got_h, got_f = wf.batched_strip(t(s0), t(s1), elems, w_max, **KW)
    for k, (i0, h, j0, w, rc, cc) in enumerate(elems):
        ref = oracle.dp_rows(s0[i0:i0 + h], s1[j0:j0 + w], P,
                             Recurrence.NEEDLEMAN_WUNSCH, InitType(rc),
                             InitType(cc))
        np.testing.assert_array_equal(got_h[k, :w].numpy(), ref.last_h[1:])
        np.testing.assert_array_equal(got_f[k, :w].numpy(), ref.last_f[1:])


def test_batched_strip_cpu_routes_to_plain():
    before = kernels.batched_strip_cuda.launches
    s0, s1 = seqs(4, 100, 100)
    elems = [(0, 10, 0, 10, 1, 1)]
    got = wf.batched_strip(t(s0), t(s1), elems, 10, **KW)
    want = wf.batched_strip_plain(t(s0), t(s1), elems, 10, **KW)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert kernels.batched_strip_cuda.launches == before == 0
    with pytest.raises(ValueError, match="CUDA"):
        kernels.batched_strip_cuda(t(s0), t(s1), elems, 10, **KW)


def nw_pair(seed, m, cut):
    s0, _ = seqs(seed, m, 0)
    s1 = s0.copy()
    rng = np.random.default_rng(seed + 100)
    flip = rng.random(m) < 0.1
    s1[flip] = rng.choice(BASES, int(flip.sum()))
    s1 = np.concatenate([s1[:m // 3], s1[m // 3 + cut:]])
    ref = oracle.dp_rows(s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
                         InitType.WITH_GAPS, InitType.WITH_GAPS)
    cps = [Crosspoint(0, 0, 0, CrosspointType.MATCH),
           Crosspoint(m, len(s1), int(ref.last_h[-1]), CrosspointType.MATCH)]
    return s0, s1, cps


def check_chain(s0, s1, out, mps):
    """The stage-5 contract: each partition's constrained value equals its
    score delta, and every partition is split down to mps."""
    for c0, c1 in zip(out, out[1:]):
        assert max(c1.i - c0.i, c1.j - c0.j) <= mps or c1.i - c0.i < 2
        seg = smallsw.traceback_segment(
            np.ascontiguousarray(s0[c0.i:c1.i]),
            np.ascontiguousarray(s1[c0.j:c1.j]),
            c0.i, c0.j, int(c0.type), int(c1.type), P)
        assert seg == c1.score - c0.score, (c0, c1)


@pytest.mark.parametrize("seed,m,cut,mps", [
    (0, 600, 25, 8), (1, 900, 40, 64), (2, 700, 0, 16)])
def test_reduce_matches_jax_engine(seed, m, cut, mps):
    """Same crosspoints as masa_tpu's level-batched engine (which runs its
    row-sweep twin on the CPU), including gapped crosspoints."""
    s0, s1, cps = nw_pair(seed, m, cut)
    want = jbm.reduce_partitions_batched(s0, s1, cps, P, mps)
    got = batched_mm.reduce_partitions_batched(s0, s1, port(cps), PP, mps,
                                               device="cpu")
    assert got == want
    check_chain(s0, s1, got, mps)


def test_reduce_chunks_a_level_by_bus_cells(monkeypatch):
    """A cell cap far below one level's bus cuts the level into many
    launches; the crosspoints stay the same, from several input pairs."""
    s0, s1, cps = nw_pair(0, 600, 25)
    full = batched_mm.reduce_partitions_batched(s0, s1, port(cps), PP, 8,
                                                device="cpu")
    mid = full[len(full) // 2]
    three = [cps[0], mid, cps[1]]
    want = batched_mm.reduce_partitions_batched(s0, s1, port(three), PP, 8,
                                                device="cpu")
    monkeypatch.setattr(batched_mm, "CELL_CAP", 64)
    got = batched_mm.reduce_partitions_batched(s0, s1, port(three), PP, 8,
                                               device="cpu")
    assert got == want
    check_chain(s0, s1, got, 8)
    assert batched_mm._chunks([5, 0, 70, 3], 64) == [
        (0, 2, 5), (2, 3, 70), (3, 4, 3)]


def test_stage4_reduce_uses_native_ladder_on_cpu():
    """Stage 4 on the CPU takes the port's native ladder, equal to
    masa_tpu's native ladder (its library built apart from masa_tpu's own
    in-place build, ``reference_native``)."""
    from masa_tpu_torch.native import bindings

    from test_torch_hostcopy import reference_native

    if not bindings.available():
        pytest.skip("no C++ compiler for the native library here")
    s0, s1, cps = nw_pair(3, 500, 10)
    got = myers_miller.stage4_reduce(s0, s1, port(cps), PP, 16, device="cpu")
    assert got == bindings.reduce_partitions(s0, s1, port(cps), PP, 16)
    with reference_native() as jbindings:
        assert got == jbindings.reduce_partitions(s0, s1, cps, P, 16)


@pytest.mark.parametrize("start", ["*", "!"])
def test_slice_with_batched_stage4(start):
    """Stages 1-3 of the port, the batched stage 4 (plain strips on the
    CPU) and stage 5: the score masa_tpu reaches, and a valid path."""
    import masa_tpu
    from masa_tpu_torch.stages import stage6

    s0, s1, _ = nw_pair(5, 1500, 30)
    want = masa_tpu.align(s0, s1, alignment_start=start)
    pcfg = pipeline.PipelineConfig(
        alignment_start=pipeline.AlignmentStart.ANYWHERE if start == "*"
        else pipeline.AlignmentStart.SEQUENCE_1_AND_2,
        flush_interval=256, backend="kernel", device="cpu")
    res, endpoint = pipeline.stage1_pass(s0, s1, pcfg)
    cps = pipeline.stage2_march(s0, s1, pcfg, endpoint, res.specials)
    cps = pipeline.stage3_densify(s0, s1, pcfg, cps, max_cells=1 << 14)
    cps = batched_mm.reduce_partitions_batched(s0, s1, port(cps), PP, 16,
                                               device="cpu")
    aln = pipeline.stage5_emit(s0, s1, pcfg, cps)
    assert aln.raw_score == want.raw_score
    assert stage6.recheck(aln, s0, s1, PP).score == aln.raw_score


def fixed_inputs(seed, custom):
    """masa_tpu's batched-strip test inputs (tests/test_wavefront.py:
    test_batched_strip_pallas_interpret_parity: B=3, h=300, nj=256,
    widths 200/256/130, WITH_GAPS borders), or CUSTOM random borders and
    corners.  Returns per-element (s0, s1, w, bus_h, bus_f, col_h, col_e,
    corner), bus and border arrays holding the DP values of row 0 and of
    column 0 at rows 1..h."""
    from masa_tpu.models.scoring import border_cells

    rng = np.random.default_rng(seed)
    out = []
    for k, w in enumerate((200, 256, 130)):
        s0 = rng.choice(BASES, 300).astype(np.uint8)
        s1 = rng.choice(BASES, w).astype(np.uint8)
        if custom:
            rh = rng.integers(-60, 40, w + 1)
            rf = np.where(rng.random(w + 1) < 0.3, -wf.INF,
                          rng.integers(-80, 20, w + 1))
            ch = rng.integers(-60, 40, 301)
            ce = np.where(rng.random(301) < 0.3, -wf.INF,
                          rng.integers(-80, 20, 301))
            ch[0] = rh[0]
        else:
            rh, rf = border_cells(w + 1, InitType.WITH_GAPS, P)
            ch, ce = border_cells(301, InitType.WITH_GAPS, P)
        out.append((s0, s1, w, rh, rf, ch, ce))
    return out


@pytest.mark.parametrize("custom", [False, True], ids=["gaps", "custom"])
def test_batched_strip_fixed_matches_jax_kernel(custom):
    """Kernel 2's plain version against masa_tpu's equal-shape batched
    Pallas kernel in interpret mode and against the NumPy oracle, at that
    kernel's own test shapes.  Columns past an element's width are
    padding (masa_tpu's sentinels, the port's -INF buses); the first w
    are compared."""
    cfg = jwf.WavefrontConfig(alpha=4, rs=1, chunk=256,
                              recurrence=Recurrence.NEEDLEMAN_WUNSCH,
                              track_best=False, store_lastcol=False,
                              interpret=True)
    B, h, nj = 3, 300, 256
    plen = jwf.padded_len(cfg, nj)
    els = fixed_inputs(11, custom)
    a_all = np.empty((B, cfg.alpha, cfg.rs, 128), np.int32)
    ih_all, ie_all = np.empty_like(a_all), np.empty_like(a_all)
    b_all = np.full((B, plen), jwf.B_SENTINEL, np.int32)
    bh_all = np.full((B, plen), -jwf.INF, np.int32)
    bf_all = np.full((B, plen), -jwf.INF, np.int32)
    corners = np.zeros(B, np.int32)
    a = np.zeros((B, h), np.uint8)
    b = np.zeros((B, nj), np.uint8)
    col_h, col_e = np.zeros((B, h), np.int32), np.zeros((B, h), np.int32)
    bus_h = np.full((B, nj), -wf.INF, np.int32)
    bus_f = np.full((B, nj), -wf.INF, np.int32)
    for k, (s0, s1, w, rh, rf, ch, ce) in enumerate(els):
        a_all[k] = jwf.pack_strip_rows(cfg, s0.astype(np.int32))
        b_all[k, :w] = s1
        bh_all[k, :w], bf_all[k, :w] = rh[1:], rf[1:]
        ih_all[k], ie_all[k] = jwf.pack_border_cols(cfg, ch[1:], ce[1:])
        corners[k] = ch[0]
        a[k], b[k, :w] = s0, s1
        col_h[k], col_e[k] = ch[1:], ce[1:]
        bus_h[k, :w], bus_f[k, :w] = rh[1:], rf[1:]
    want_h, want_f = (np.asarray(x) for x in jwf.batched_strip_pallas(
        cfg, a_all, b_all, bh_all, bf_all, ih_all, ie_all, corners,
        nj=nj, h_true=h, B=B))
    got_h, got_f = wf.batched_strip_fixed(
        t(a), t(b), t(col_h), t(col_e), t(bus_h), t(bus_f), t(corners),
        **KW)
    lane = (h - 1) // cfg.alpha  # masa_tpu's physical bus offset
    for k, (s0, s1, w, rh, rf, ch, ce) in enumerate(els):
        np.testing.assert_array_equal(got_h[k, :w].numpy(),
                                      want_h[k, lane:lane + w])
        np.testing.assert_array_equal(got_f[k, :w].numpy(),
                                      want_f[k, lane:lane + w])
        ref = oracle.dp_rows(s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
                             InitType.CUSTOM, InitType.CUSTOM,
                             first_row=(rh, rf), first_col=(ch, ce))
        np.testing.assert_array_equal(got_h[k, :w].numpy(), ref.last_h[1:])
        np.testing.assert_array_equal(got_f[k, :w].numpy(), ref.last_f[1:])


def test_batched_strip_fixed_cpu_routes_to_plain():
    before = kernels.batched_strip_fixed_cuda.launches
    s0, s1 = seqs(8, 40, 30)
    args = (t(s0.reshape(2, 20)), t(s1.reshape(2, 15)),
            t(np.zeros((2, 20), np.int32)),
            t(np.full((2, 20), -wf.INF, np.int32)),
            t(np.zeros((2, 15), np.int32)),
            t(np.full((2, 15), -wf.INF, np.int32)),
            t(np.zeros(2, np.int32)))
    got = wf.batched_strip_fixed(*args, **KW)
    want = wf.batched_strip_fixed_plain(*args, **KW)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert kernels.batched_strip_fixed_cuda.launches == before == 0
    with pytest.raises(ValueError, match="CUDA"):
        kernels.batched_strip_fixed_cuda(*args, **KW)


@pytest.mark.parametrize("max_cells", [1 << 12, 1 << 14])
def test_stage4_card_branch_stops_at_sqrt_max_cells(monkeypatch, max_cells):
    """The card's stage 4 (the batched engine, reached here on CPU
    tensors) splits only down to max(16, isqrt(stage5_max_cells)), as
    masa_tpu's batched engine does on its device: the crosspoints are
    masa_tpu's at that stop, and coarser than the native ladder's."""
    import math

    s0, s1, cps = nw_pair(6, 900, 20)
    mps = max(16, math.isqrt(max_cells))
    assert mps > 16
    monkeypatch.setattr(myers_miller, "stage4_engine",
                        lambda device, strategy: "batched")
    got = myers_miller.stage4_reduce(s0, s1, port(cps), PP, 16,
                                     stage5_max_cells=max_cells,
                                     device="cpu")
    assert got == jbm.reduce_partitions_batched(s0, s1, cps, P, mps)
    check_chain(s0, s1, got, mps)
    assert len(got) < len(batched_mm.reduce_partitions_batched(
        s0, s1, port(cps), PP, 16, device="cpu"))


def test_stage4_engine_follows_the_device():
    from masa_tpu_torch.native import bindings

    S = myers_miller.SplitStrategy
    assert myers_miller.stage4_engine("cuda", S.OPTIMIZED) == "batched"
    assert myers_miller.stage4_engine("cuda", S.ORIGINAL_MM) == "python"
    assert myers_miller.stage4_engine("cpu", S.OPTIMIZED) == (
        "native" if bindings.available() else "python")
