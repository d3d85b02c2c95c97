"""The Hopper kernels (the strip kernel, the two batched strip kernels, the
roofline bodies, the one-launch stage-2 hop and the three-launch hop's
prologue and epilogue, stage 5's batched traceback) against their plain
PyTorch versions, on the card.

These need a CUDA GPU and nvcc and skip elsewhere, and import nothing of
masa_tpu.  The repo's conftest imports JAX, which a machine with only the
port's dependencies lacks, so run them there with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerance: exact equality (integer DP)."""

import numpy as np
import pytest
import torch

from masa_tpu_torch.ops import batched_mm, kernels, smallsw
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.tools import batched_tune, hop_tune
from masa_tpu_torch.types import INF, InitType, ScoreParams

pytestmark = pytest.mark.cuda
NEG = -INF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def inputs(seed, h, nj, dev, border=InitType.WITH_ZEROES, params=None):
    params = params or ScoreParams()
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    a = rng.choice(bases, h).astype(np.uint8)
    b = np.resize(a, nj).copy()
    flip = rng.random(nj) < 0.25
    b[flip] = rng.choice(bases, int(flip.sum()))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    bus_h, bus_f = wf.init_bus(border, nj, params.gap_open, params.gap_ext,
                               dev)
    k = torch.arange(0, h + 1, device=dev)
    col = wf.border_h(border, k, params.gap_open, params.gap_ext)
    col_e = torch.full((h,), NEG, dtype=torch.int32, device=dev)
    return (t(a), t(b), bus_h, bus_f, col[1:].contiguous(), col_e,
            int(col[0]))


def assert_equal(k, p):
    for f in ("bus_h", "bus_f", "best", "lastcol_h", "lastcol_e",
              "rows_h", "rows_f"):
        x, y = getattr(k, f), getattr(p, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x.long(), y.long()), f


@pytest.mark.parametrize("h,nj,flush", [
    (1, 1, 0), (77, 333, 10), (2048, 500, 512), (4097, 129, 1000),
    (6000, 64, 0)])
@pytest.mark.parametrize("border", [InitType.WITH_ZEROES, InitType.WITH_GAPS,
                                    InitType.WITH_GAPS_OPENED],
                         ids=lambda b: b.name)
@pytest.mark.parametrize("sw", [True, False], ids=["SW", "NW"])
def test_kernel_matches_plain(cuda, sw, border, h, nj, flush):
    args = inputs(h + nj, h, nj, cuda, border)
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=sw,
              track_best=True, store_lastcol=True, flush_every=flush)
    before = kernels.strip_cuda.launches
    got = wf.strip(*args, **kw)
    assert kernels.strip_cuda.launches == before + 1
    assert_equal(got, wf.strip_plain(*args, **kw))


def test_persistent_blocks_reuse(cuda):
    """More sub-strips than blocks: each block takes several in turn."""
    rows = kernels.block_rows()
    args = inputs(5, 4 * rows + 3, 200, cuda)
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=True,
              track_best=True, store_lastcol=True, flush_every=333)
    got = wf.strip_out(*kernels.strip_cuda(*args, **kw, max_ctas=1))
    assert_equal(got, wf.strip_plain(*args, **kw))


@pytest.mark.parametrize("alpha", [8, 4, 2])
@pytest.mark.parametrize("warps", [8, 5, 1])
def test_every_block_geometry_matches_plain(cuda, monkeypatch, alpha, warps):
    """Each (rows per thread, compute warps) the kernel takes, forced in
    place of ``strip_geometry``'s choice: full blocks, a partial last
    block whose last row sits mid-thread and mid-warp, several sub-strips
    on two persistent blocks, widths off the 32-column chunk."""
    monkeypatch.setattr(kernels, "strip_geometry",
                        lambda h, sms: (alpha, warps))
    rows = 32 * alpha * warps
    for n, (h, nj, sw, flush) in enumerate((
            (rows, 64, True, 0), (2 * rows + alpha * 17 + 1, 333, False, 100),
            (3 * rows - 1, 31, True, 7), (5, 1000, False, 2))):
        args = inputs(1000 + n, h, nj, cuda, InitType.WITH_GAPS)
        kw = dict(match=2, mismatch=-1, gap_open=2, gap_ext=1, sw=sw,
                  track_best=bool(n % 2), store_lastcol=True,
                  flush_every=flush)
        got = wf.strip_out(*kernels.strip_cuda(*args, **kw, max_ctas=2))
        assert_equal(got, wf.strip_plain(*args, **kw))


def test_stage2_hop_shape_matches_plain(cuda):
    """One stage-2 hop: 8192 x 16384, NW, best tracked, pinned borders."""
    args = inputs(77, 8192, 16384, cuda, InitType.WITH_GAPS_OPENED)
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=False,
              track_best=True)
    assert_equal(wf.strip(*args, **kw), wf.strip_plain(*args, **kw))


def test_wrapper_rejects_bad_inputs(cuda):
    a, b, bh, bf, ch, ce, corner = inputs(1, 10, 10, cuda)
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=True)
    with pytest.raises(ValueError, match="int32"):
        kernels.strip_cuda(a, b, bh.long(), bf, ch, ce, corner, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        kernels.strip_cuda(a, b, bh, bf, ch.cpu(), ce, corner, **kw)


def test_multi_wave_sampled_intervals(cuda):
    """More sub-strips than the card holds at once (no block cap), so
    blocks take sub-strips in a second wave: every flushed interval that a
    sampled sub-strip owns, recomputed by the plain version from the
    kernel's row above it, equals the kernel's rows, bests and last
    column there."""
    rows = kernels.block_rows()
    n_sub = kernels.resident_blocks() + 3
    h, nj = n_sub * rows + 5, 300
    args = inputs(9, h, nj, cuda)
    a, b, bus_h, bus_f, col_h, col_e, corner = args
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=True)
    out = kernels.strip_cuda(*args, **kw, track_best=True,
                             store_lastcol=True, flush_every=rows)
    _, _, best_v, best_j, last_h, last_e, rows_h, rows_f = out
    for g in (0, n_sub - 4, n_sub - 3, n_sub - 2, n_sub - 1, n_sub):
        lo, hi = g * rows, min((g + 1) * rows, h)
        above = ((bus_h, bus_f, corner) if g == 0 else
                 (rows_h[g - 1], rows_f[g - 1], int(col_h[lo - 1])))
        ref = wf.strip_plain(a[lo:hi], b, above[0], above[1], col_h[lo:hi],
                             col_e[lo:hi], above[2], **kw, track_best=True,
                             store_lastcol=True)
        got_bus = ((rows_h[g], rows_f[g]) if g < n_sub else out[:2])
        assert torch.equal(got_bus[0], ref.bus_h), g
        assert torch.equal(got_bus[1], ref.bus_f), g
        assert torch.equal(wf.merge_best(best_v[lo:hi], best_j[lo:hi]),
                           ref.best), g
        assert torch.equal(last_h[lo:hi], ref.lastcol_h), g
        assert torch.equal(last_e[lo:hi], ref.lastcol_e), g


def test_streamed_border_kernel_matches_plain(cuda, tmp_path):
    """The middle of three slabs on the card: its left border is the last
    column the first slab's launch wrote (file://), and it writes its own.
    The kernel equals the plain version on those inputs, and the slab's
    best, last row and written column are the plain version's."""
    from masa_tpu_torch.io import cells as cio
    from masa_tpu_torch.parallel import split

    rng = np.random.default_rng(31)
    bases = np.frombuffer(b"ACGT", np.uint8)
    m = 5000
    s0 = rng.choice(bases, m).astype(np.uint8)
    s1 = np.resize(s0, 2100).copy()
    flip = rng.random(2100) < 0.2
    s1[flip] = rng.choice(bases, int(flip.sum()))
    points = split.split_points(len(s1), [1.0] * 3)
    urls = split.auto_urls(str(tmp_path), 3)
    before = kernels.strip_cuda.launches
    parts = [split.run_part_stage1(
        s0, s1, k, points, load_url=urls[k - 1] if k else None,
        flush_url=urls[k] if k < 2 else None, buffered=False,
        special_every=1024, device=cuda) for k in range(3)]
    assert kernels.strip_cuda.launches == before + 3  # a launch per slab
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)  # noqa
    col_h, col_e = cio.FileCellsReader(urls[0][7:]).read(m)
    slab = s1[points[1]:points[2]]
    bus_h, bus_f = wf.init_bus(InitType.WITH_ZEROES, len(slab), 3, 2, cuda)
    args = (t(s0), t(slab), bus_h, bus_f, t(col_h), t(col_e), 0)
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=True,
              track_best=True, store_lastcol=True, flush_every=1024)
    want = wf.strip_plain(*args, **kw)
    assert_equal(wf.strip(*args, **kw), want)
    p = parts[1]
    np.testing.assert_array_equal(p.last_h, want.bus_h.cpu().numpy())
    wrote_h, _ = cio.FileCellsReader(urls[1][7:]).read(m)
    np.testing.assert_array_equal(wrote_h, want.lastcol_h.cpu().numpy())
    s, bi, bj = (int(v) for v in want.best.tolist())
    assert (p.best, p.best_i, p.best_j - p.j0) == (s, bi + 1, bj + 1)
    for r in p.specials.rows():
        assert p.specials.get(r)[0][0] == col_h[r - 1]


PKW = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=True,
           track_best=True)


def bench_homolog(seed, m, n):
    """A bench.py-style pair: ``n`` characters of ``m`` random ones with
    8% substituted."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, max(m, n)).astype(np.uint8)
    s1 = np.where(rng.random(len(s0)) < 0.08, rng.choice(bases, len(s0)),
                  s0)
    return s0[:m].copy(), s1[:n].copy()


def prune_inputs(seed, h, nj, dev, offset=False):
    """A pruning launch on the card: the whole pair from its corner, or
    (``offset``) rows below 512 others, right of a host window's -INF wall
    at column 512, with a best of 300 handed in."""
    i0, c0 = (512, 512) if offset else (0, 0)
    s0, s1 = bench_homolog(seed, h + i0, nj + c0)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    a, b = t(s0), t(s1)
    bus_h, bus_f = wf.init_bus(InitType.WITH_ZEROES, len(s1), 3, 2, dev)
    if i0:
        up = wf.strip(a[:i0], b, bus_h, bus_f,
                      torch.zeros(i0, dtype=torch.int32, device=dev),
                      torch.full((i0,), NEG, dtype=torch.int32, device=dev),
                      0, **PKW)
        bus_h, bus_f = up.bus_h, up.bus_f
    wall = torch.full((h,), NEG, dtype=torch.int32, device=dev)
    col_h = wall if offset else torch.zeros(h, dtype=torch.int32, device=dev)
    args = (a[i0:], b[c0:], bus_h[c0:].contiguous(), bus_f[c0:].contiguous(),
            col_h, wall, NEG if offset else 0)
    best = torch.tensor([300 if offset else 0], device=dev)
    return args, wf.LaunchPrune(h + i0, nj + c0, i0, c0, best)


@pytest.mark.parametrize("h,nj,flush,ctas,offset", [
    (4096, 4096, 0, 1, False), (4096, 3000, 512, 2, False),
    (16384, 8192, 2048, 4, False), (6001, 2500, 777, 3, True),
    (2048, 1000, 0, 0, False)])
def test_pruned_kernel_matches_twin(cuda, h, nj, flush, ctas, offset):
    """The PRUNE instances against ``strip_plain_pruned`` at the launch's
    own geometry: every raw output (the per-row bests too), the flushed
    rows with their -INF prefixes, and the record, byte for byte.  A capped
    grid makes the rule fire on a small strip; a full grid (ctas 0) has no
    sub-strip G below another here, so only ``best_in`` could prune."""
    args, lp = prune_inputs(h + nj, h, nj, cuda, offset)
    before = kernels.strip_cuda.launches
    got = kernels.strip_cuda(*args, **PKW, flush_every=flush, max_ctas=ctas,
                             prune=lp)
    assert kernels.strip_cuda.launches == before + 1
    rec = got[8]
    if ctas:
        assert rec.blocks == ctas
    want = wf.strip_plain_pruned(*args, lp, (rec.rows, rec.blocks), **PKW,
                                 flush_every=flush)
    for k, (x, y) in enumerate(zip(got[:8], want[:8])):
        assert (x is None) == (y is None), k
        if x is not None:
            assert torch.equal(x.long(), y.long()), k
    assert torch.equal(rec.record, want[8].record)
    assert (rec.pruned_cells(h) > 0) == bool(ctas)


def test_pruned_kernel_repeats_byte_for_byte(cuda):
    """A pruning launch of 2^17 rows on the full grid and on 16 blocks,
    each twice: the decisions depend on the inputs and the grid, not on
    timing, so the outputs, flushed rows and record repeat exactly; the
    best is the unpruned launch's."""
    args, lp = prune_inputs(5, 1 << 17, 20000, cuda)
    full = wf.strip(*args, **PKW)
    for ctas in (0, 16):
        one, two = (kernels.strip_cuda(*args, **PKW, flush_every=4096,
                                       max_ctas=ctas, prune=lp)
                    for _ in range(2))
        for x, y in zip(one[:8], two[:8]):
            assert (x is None and y is None) or torch.equal(x, y)
        assert torch.equal(one[8].record, two[8].record)
        assert torch.equal(wf.merge_best(one[2], one[3]), full.best)
    assert one[8].pruned_cells(1 << 17) > 0


@pytest.mark.parametrize("alpha,ctas,best_in", [(8, 0, 0), (8, 4, 0),
                                                 (4, 0, 2000), (4, 64, 2000)])
def test_pruned_kernel_at_the_main_paths_geometry(cuda, alpha, ctas,
                                                  best_in):
    """The pruning instances at 8 rows a thread (stage 1's on the 1M pair)
    and 4, on launches of more sub-strips than the grid (the full grid, or
    4 or 64 blocks), with a partial last sub-strip:
    ``strip_tune.pruned_waves`` holds sampled sub-strips against the twin
    byte for byte from the launch's own flushed rows, among them every one
    of the last 8192 rows, where the rule skips a part of the columns
    against a best from the chain of prefix bests (at 4 rows a thread the
    full grid holds every sub-strip at once: there only ``best_in``
    prunes)."""
    from masa_tpu_torch.tools import strip_tune

    r = strip_tune.pruned_waves(cuda, alpha, ctas, best_in)
    assert r["partial"] > 0
    assert r["chained"] > 0 or (alpha == 4 and not ctas)


def test_pruned_partition_on_the_card(cuda, monkeypatch):
    """``forward_pass`` with pruning on the card prunes inside its one
    launch (here on 4 blocks) and keeps the CPU's unpruned best and
    endpoint; cells and pruned cells add up."""
    import functools

    from masa_tpu_torch.stages import core
    from masa_tpu_torch.types import Recurrence

    s0, s1 = bench_homolog(3, 12000, 11000)
    fw = functools.partial(core.forward_pass, s0, s1, ScoreParams(),
                           Recurrence.SMITH_WATERMAN, InitType.WITH_ZEROES,
                           InitType.WITH_ZEROES, backend="kernel")
    want = fw(prune=False, device="cpu", cfg=wf.StripConfig(rows=4096))
    capped = functools.partial(kernels.strip_cuda, max_ctas=4)
    capped.launches = 0  # the wrapper counts on the name it is bound to
    monkeypatch.setattr(kernels, "strip_cuda", capped)
    got = fw(prune=True, device="cuda")
    assert capped.launches == 1
    assert (got.best, got.best_i, got.best_j) == (want.best, want.best_i,
                                                  want.best_j)
    assert got.pruned_cells > 0
    assert got.cells + got.pruned_cells == len(s0) * len(s1)


def test_special_row_bests_on_the_card(cuda, monkeypatch):
    """``strips.run_partition``'s best down to each special row, from the
    strip kernel's per-row captures (one launch, pruning inside it on 4
    blocks, and without pruning), equals the oracle's, the earlier of two
    equal bests (a 600-base repeat ending at rows 600 and 2600) kept."""
    import functools

    from masa_tpu_torch.ops import oracle, strips

    rng = np.random.default_rng(1515)
    bases = np.frombuffer(b"ACGT", np.uint8)
    x, y, z = (rng.choice(bases, k).astype(np.uint8)
               for k in (600, 1400, 1000))
    z[:16] = y[:16]  # each copy of x extends alike
    s0 = np.concatenate([x, y, x, z])
    s1 = np.concatenate([x, rng.choice(bases, 2000).astype(np.uint8)])
    want = {}
    oracle.dp_rows(s0, s1, ScoreParams(), special_rows=tuple(
        range(512, len(s0), 512)), special_best=want)
    capped = functools.partial(kernels.strip_cuda, max_ctas=4)
    capped.launches = 0
    monkeypatch.setattr(kernels, "strip_cuda", capped)
    for prune in (True, False):
        got = {}
        res = strips.run_partition(
            wf.StripConfig(rows=1 << 20), torch.from_numpy(s0).to(cuda),
            torch.from_numpy(s1).to(cuda), ScoreParams(), special_every=512,
            prune=prune, on_special_row=lambda *a: None,
            on_special_best=lambda r, i, j, b: got.setdefault(r, (b, i, j)))
        assert got == want, prune
        assert want[len(s0) // 512 * 512] == (res.best, res.best_i,
                                              res.best_j)
        assert res.best_i < 1000 and (res.pruned_cells > 0) == prune
    assert capped.launches == 2


def test_pruned_wrapper_refuses(cuda):
    """A pruning launch that the rule does not allow raises; so does a
    best handed in as anything but an int64 tensor on the card."""
    args, lp = prune_inputs(1, 300, 300, cuda)
    for bad in (dict(sw=False), dict(track_best=False),
                dict(store_lastcol=True)):
        with pytest.raises(ValueError, match="pruning"):
            kernels.strip_cuda(*args, **{**PKW, **bad}, prune=lp)
    with pytest.raises(ValueError, match="best_in"):
        kernels.strip_cuda(*args, **PKW, prune=lp._replace(
            best_in=lp.best_in.int()))
    with pytest.raises(ValueError, match="outside"):
        kernels.strip_cuda(*args, **PKW, prune=lp._replace(m=10))


def batched_inputs(seed, B, h_max, w_max, dev, n=20000):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, n).astype(np.uint8)
    s1 = s0.copy()
    flip = rng.random(n) < 0.1
    s1[flip] = rng.choice(bases, int(flip.sum()))
    h = rng.integers(1, h_max + 1, B)
    w = rng.integers(0, w_max + 1, B)
    i0 = rng.integers(0, n - h)
    j0 = np.clip(i0 + rng.integers(-50, 50, B), 0, n - w)
    elems = np.stack([i0, h, j0, w, rng.integers(0, 3, B),
                      rng.integers(0, 3, B)], 1).astype(np.int32)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return t(s0), t(s1), elems


@pytest.mark.parametrize("seed,B,h_max,w_max", [
    (1, 1, 1, 1), (2, 300, 70, 130), (3, 64, 600, 40), (4, 5, 5000, 300),
    (5, 2000, 16, 2)])
def test_batched_kernel_matches_plain(cuda, seed, B, h_max, w_max):
    a, b, elems = batched_inputs(seed, B, h_max, w_max, cuda)
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2)
    before = kernels.batched_strip_cuda.launches
    got = wf.batched_strip(a, b, elems, max(w_max, 1), **kw)
    assert kernels.batched_strip_cuda.launches == before + 1
    want = wf.batched_strip_plain(a, b, elems, max(w_max, 1), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


EDGE_CASES = list(batched_tune.edge_cases())


@pytest.mark.parametrize("name,elems,width", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_batched_kernel_edges_match_plain(cuda, name, elems, width):
    """A launch per height around a warp's, a block's and a chained
    element's rows (widths 0, 1, 33, 64, 100, 130; every border code),
    mixed heights with stragglers, one-row elements, a width of one."""
    a, b = (torch.from_numpy(x).to(cuda)
            for x in batched_tune.sequences(43, 1 << 15))
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2)
    got = wf.batched_strip(a, b, elems, width, **kw)
    want = wf.batched_strip_plain(a, b, elems, width, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("geo", batched_tune.FORCED,
                         ids=lambda g: "x".join(map(str, g)))
def test_batched_kernels_match_plain_at_every_geometry(cuda, geo):
    """Each (rows per thread, warps per element, elements per block)
    forced in place of ``batched_geometry``'s choice, on mixed heights
    with chained stragglers and on equal shapes whose last row sits
    mid-thread and mid-warp."""
    kw = dict(match=2, mismatch=-1, gap_open=2, gap_ext=1)
    a, b = (torch.from_numpy(x).to(cuda)
            for x in batched_tune.sequences(43, 1 << 15))
    mixed = [c for c in EDGE_CASES if c[0].startswith("mixed")
             or c[0] in ("h=257", "h=4097")]
    fixed = [batched_tune.fixed_inputs(np.random.default_rng(3), *shape,
                                       cuda)
             for shape in ((5, 257, 77), (2, 2049, 130))]
    want_mixed = [wf.batched_strip_plain(a, b, el, width, **kw)
                  for _, el, width in mixed]
    want_fixed = [wf.batched_strip_fixed_plain(*args, **kw)
                  for args in fixed]
    with batched_tune.forced(*geo):
        for (_, el, width), want in zip(mixed, want_mixed):
            got = wf.batched_strip(a, b, el, width, **kw)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        for args, want in zip(fixed, want_fixed):
            got = wf.batched_strip_fixed(*args, **kw)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_batched_outputs_keep_the_callers_order(cuda):
    """Elements are dispatched tallest first; the outputs come back in the
    order of ``elems``, and -INF stands past each element's width."""
    a, b, elems = batched_inputs(8, 40, 900, 60, cuda)
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2)
    got = wf.batched_strip(a, b, elems, 64, **kw)
    for k in (0, 7, 39):
        one = wf.batched_strip(a, b, elems[k:k + 1], 64, **kw)
        assert torch.equal(got[0][k], one[0][0])
        assert torch.equal(got[1][k], one[1][0])
        assert bool((got[0][k, elems[k, 3]:] == NEG).all())
        assert bool((got[1][k, elems[k, 3]:] == NEG).all())


def test_batched_max_warps_mirror_the_kernel(cuda):
    lib = kernels.load("batched_strip")
    for alpha, warps in kernels.BATCHED_MAX_WARPS.items():
        assert lib.masa_batched_strip_max_warps(alpha) == warps
    assert lib.masa_batched_strip_max_warps(3) == 0


def test_batched_wrapper_rejects_bad_inputs(cuda):
    a, b, elems = batched_inputs(1, 4, 10, 10, cuda)
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2)
    bad = elems.copy()
    bad[0, 1] = 0
    with pytest.raises(ValueError, match="heights"):
        kernels.batched_strip_cuda(a, b, bad, 10, **kw)
    with pytest.raises(ValueError, match="widths"):
        kernels.batched_strip_cuda(a, b, elems, 1, **kw)
    bad = elems.copy()
    bad[0, 4] = 3
    with pytest.raises(ValueError, match="CUSTOM"):
        kernels.batched_strip_cuda(a, b, bad, 10, **kw)
    with pytest.raises(ValueError, match="uint8"):
        kernels.batched_strip_cuda(a.long(), b, elems, 10, **kw)


def test_batched_stage4_matches_cpu(cuda):
    """The card's stage 4 (kernel) and the CPU's (plain) give the same
    crosspoints on a homologous pair with gaps."""
    from masa_tpu_torch.ops import oracle
    from masa_tpu_torch.types import Crosspoint, Recurrence

    a, b, _ = batched_inputs(6, 1, 1, 1, "cpu", n=3000)
    s0, s1 = a.numpy(), np.concatenate([b.numpy()[:1000],
                                        b.numpy()[1040:]])
    P = ScoreParams()
    total = int(oracle.dp_rows(s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
                               InitType.WITH_GAPS, InitType.WITH_GAPS
                               ).last_h[-1])
    cps = [Crosspoint(0, 0, 0), Crosspoint(len(s0), len(s1), total)]
    got = batched_mm.reduce_partitions_batched(s0, s1, cps, P, 16,
                                               device=cuda)
    assert got == batched_mm.reduce_partitions_batched(s0, s1, cps, P, 16,
                                                       device="cpu")


def fixed_inputs(seed, B, h, nj, dev):
    """Equal-shape batches with CUSTOM random borders, buses and corners
    (-INF in a fifth of the gap cells)."""
    rng = np.random.default_rng(seed)

    def t(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x).astype(dt)).to(dev)

    def gaps(shape):
        return np.where(rng.random(shape) < 0.2, NEG,
                        rng.integers(-80, 20, shape))

    bases = np.frombuffer(b"ACGT", np.uint8)
    a = rng.choice(bases, (B, h))
    b = a[:, np.arange(nj) % h].copy()  # homologous, a quarter flipped
    flip = rng.random((B, nj)) < 0.25
    b[flip] = rng.choice(bases, int(flip.sum()))
    return (t(a, np.uint8), t(b, np.uint8),
            t(rng.integers(-60, 40, (B, h)), np.int32),
            t(gaps((B, h)), np.int32),
            t(rng.integers(-60, 40, (B, nj)), np.int32),
            t(gaps((B, nj)), np.int32),
            t(rng.integers(-60, 40, B), np.int32))


@pytest.mark.parametrize("B,h,nj", [(1, 1, 1), (3, 300, 256), (17, 64, 129),
                                    (4, 2049, 77), (2000, 8, 33),
                                    *batched_tune.fixed_cases()])
def test_batched_fixed_kernel_matches_plain(cuda, B, h, nj):
    args = fixed_inputs(B + h + nj, B, h, nj, cuda)
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2)
    before = kernels.batched_strip_fixed_cuda.launches
    got = wf.batched_strip_fixed(*args, **kw)
    assert kernels.batched_strip_fixed_cuda.launches == before + 1
    want = wf.batched_strip_fixed_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_batched_fixed_wrapper_rejects_bad_inputs(cuda):
    args = list(fixed_inputs(1, 2, 10, 10, cuda))
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2)
    with pytest.raises(ValueError, match="int32"):
        kernels.batched_strip_fixed_cuda(*args[:2], args[2].long(),
                                         *args[3:], **kw)
    with pytest.raises(ValueError, match="on cpu"):
        kernels.batched_strip_fixed_cuda(*args[:6], args[6].cpu(), **kw)


@pytest.mark.parametrize("body", ["par", "ser", "mix", "dpx", "m16", "k1",
                                  "k1n", "k1w"])
@pytest.mark.parametrize("iters", [0, 1, 257])
def test_roofline_kernel_matches_plain(cuda, body, iters):
    from masa_tpu_torch.tools import roofline as rl

    xs = [torch.from_numpy(x).to(cuda) for x in rl.inputs(body)]
    before = rl.run_cuda.launches
    got = rl.run(body, xs, iters)
    assert rl.run_cuda.launches == before + 1
    assert torch.equal(got, rl.run_plain(body, xs, iters))


@pytest.mark.parametrize("body", ["k1", "k1n", "k1w"])
@pytest.mark.parametrize("threads", [32, 64, 128])
def test_roofline_cell_bodies_at_every_block_size(cuda, body, threads):
    """A cell body's column characters are per block."""
    from masa_tpu_torch.tools import roofline as rl

    xs = [torch.from_numpy(x).to(cuda) for x in rl.inputs(body)]
    assert torch.equal(rl.run_cuda(body, xs, 33, threads),
                       rl.run_plain(body, xs, 33, threads))


def test_roofline_launch_alone_counts_and_fills_the_card(cuda):
    """``prepare`` once, ``launch`` many times: each launch counts one and
    rewrites the prepared output; the filling shape (SMs x the blocks the
    runtime fits on an SM) equals the plain version too."""
    from masa_tpu_torch.tools import roofline as rl

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    per_sm = rl.blocks_per_sm("k1")
    assert 1 <= per_sm <= 8
    xs = rl.full_inputs("k1", sms * per_sm * rl.THREADS, cuda)
    before = rl.run_cuda.launches
    p = rl.prepare("k1", xs)
    assert rl.run_cuda.launches == before and p.blocks == sms * per_sm
    want = rl.run_plain("k1", xs, 20)
    for n in (1, 2):
        assert torch.equal(rl.launch(p, 20), want)
        assert rl.run_cuda.launches == before + n
    ms, spread = rl.time_launch(p, 64, 3)
    assert ms > 0 and spread >= 0
    with pytest.raises(ValueError, match="whole warps"):
        rl.prepare("k1w", [x[:48] for x in xs], 48)


def test_roofline_measure_reads_the_card(cuda):
    """The tool's line: the TPU tool's keys and the new ones; par reaches
    the INT32 lanes' peak at the clock read, every cell body comes near
    its instruction floor without passing it, and none reaches the floor
    of the recurrence (the kernels' bound)."""
    from masa_tpu_torch.tools import roofline as rl

    line = rl.measure()
    for key in ("par_native_ops_per_s", "ser_latency_ns", "mix_alpha",
                "mix_rs", "mix_bound_gcups", "mix16_bound_gcups",
                "mix_dpx_bound_gcups", "k1_cell_gcups", "k1n_cell_gcups",
                "k1w_gcups", "cell_floor_gcups", "instructions",
                "sm_clock_mhz", "sm_clock_max_mhz", "int32_peak_ops_per_s",
                "timings", "filling_launch", "card", "power_limit", "note"):
        assert key in line, key
    share = line["share_of_instruction_floor"]
    assert 0.9 <= share["par"] <= 1.01, share
    for body in ("mix", "dpx", "k1", "k1n", "k1w"):
        assert 0.8 <= share[body] <= 1.0, share
    assert line["k1w_gcups"] < line["k1_cell_gcups"] \
        < line["k1n_cell_gcups"]
    floor = line["cell_floor_gcups"]
    assert floor["tracked"] == round(line["int32_peak_ops_per_s"] / 5, 1)
    assert line["k1_cell_gcups"] < floor["tracked"] < floor["untracked"]
    assert max(line["k1n_cell_gcups"], line["mix_bound_gcups"],
               line["mix_dpx_bound_gcups"]) < floor["untracked"]
    fill = line["filling_launch"]
    assert fill["ms"] >= fill["instruction_floor_ms"] and fill["ms"] >= 5.0
    assert all(t["spread"] < 0.05 for t in line["timings"].values())
    assert 60 <= line["par_alu_lanes_per_clock_on_one_sm"]["16"] <= 66


def test_roofline_counts_its_instructions_in_the_sass(cuda):
    """Every body and the kernels' own inner loops are found in the built
    libraries; a cell is at least its three add-max, its max, its compare
    and its select."""
    from masa_tpu_torch.tools import roofline as rl

    instr = rl.instructions()
    assert set(rl.BODIES) <= set(instr) and len(instr) == len(
        rl.BODIES) + len(rl.KERNEL_LOOPS)
    for name, counts in instr.items():
        if counts["per"] == "cell" and name != "m16":
            assert 6 <= counts["total"] <= 20, (name, counts)
            assert counts["alu"] >= 4, (name, counts)
    assert instr["k1"]["alu"] > instr["k1n"]["alu"] >= 4
    assert instr["k1w"]["lsu"] > instr["k1"]["lsu"]
    loops = rl.cell_loops(kernels.build("strip"))
    # ALPHA 8, 4, 2 x SW x TRACK x FLUSH, and x FLUSH pruned (SW, TRACK)
    assert len(loops) == 30
    assert all(6 <= v["alu"] <= 20 and len(v["digest"]) == 12
               for v in loops.values())


@pytest.mark.parametrize("ndev", [1, 3])
def test_sharded_stage1_on_the_card_matches_cpu(cuda, ndev):
    """The sharded pipeline's strips on the card (deferred error flags,
    one read-back a round) against the same pipeline's plain strips:
    every slab's endpoint, last row, special rows and received border,
    with a partial tail strip and a width not divisible by 3; pruning
    counts too."""
    from masa_tpu_torch.parallel import mesh, sharded

    rng = np.random.default_rng(31)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, 2900).astype(np.uint8)
    s1 = np.where(rng.random(2900) < 0.1, rng.choice(bases, 2900), s0)[:2897]
    cfg = wf.StripConfig(rows=512)
    got = sharded.sharded_stage1_full(s0, s1, mesh.make_mesh(ndev), cfg,
                                      ScoreParams(), prune=True)
    want = sharded.sharded_stage1_full(
        s0, s1, mesh.make_mesh(ndev, device="cpu"), cfg, ScoreParams(),
        prune=True)
    assert (got.best, got.best_i, got.best_j) == (want.best, want.best_i,
                                                  want.best_j)
    assert list(got.pruned_strips) == list(want.pruned_strips)
    for g, w in zip(got.parts, want.parts):
        assert (g.best, g.best_i, g.best_j) == (w.best, w.best_i, w.best_j)
        assert np.array_equal(g.last_h, w.last_h)
        assert g.specials.rows() == w.specials.rows()
        for r in w.specials.rows():
            assert all(np.array_equal(x, y) for x, y in
                       zip(g.specials.get(r), w.specials.get(r)))
        if w.first_col is not None:
            assert np.array_equal(g.first_col[0], w.first_col[0])


def test_sharded_align_on_the_card(cuda):
    """The full sharded alignment with its traceback on the card."""
    from masa_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    assert dryrun_multichip(3, "cuda") == 600


def test_row_pull_copies_on_a_side_stream(cuda):
    """A RowPull's copies to pinned host memory run on its side stream and
    land as the row: the packed bytes (start, ready, packed: the CPU's
    packed form of the same row, escapes included) and the int32 row
    (rows)."""
    from masa_tpu_torch.ops.strips import RowPull

    h = torch.arange(-5, 70000, dtype=torch.int32, device=cuda)
    h[100:130] = NEG
    f = -h
    pull = RowPull(h, f, torch.cuda.Stream(cuda))
    assert not pull.ready()
    pull.start()
    got = pull.packed()
    assert pull.ready() and pull._packed[0].packed.is_pinned()
    want = RowPull(h.cpu(), f.cpu()).packed()
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert np.array_equal(x, y)
    assert len(got[0][1]) >= 2  # the -INF run's ends are escapes
    assert np.array_equal(pull.anchors(1000)[0], h[::1000].cpu().numpy())
    got_h, got_f = pull.rows()
    assert pull._host.is_pinned()
    assert np.array_equal(got_h, h.cpu().numpy())
    assert np.array_equal(got_f, f.cpu().numpy())


def test_packing_on_the_card_matches_cpu(cuda):
    """delta_pack_device and the packed pulls on the card give the CPU's
    bytes, escapes and rows (odd lengths, one cell, -INF runs)."""
    rng = np.random.default_rng(8)
    for nj in (1, 2, 777, 1 << 20):
        v = np.cumsum(rng.integers(-9, 10, nj)).astype(np.int32)
        v[nj // 3:nj // 3 + 5] = NEG
        cpu = torch.from_numpy(v)
        assert torch.equal(wf.delta_pack_device(cpu.to(cuda), nj).cpu(),
                           wf.delta_pack_device(cpu, nj))
        for x, y in zip(wf.packed_row_host(wf.pull_row_delta_start(
                cpu.to(cuda), nj, torch.cuda.Stream(cuda))),
                        wf.packed_row_host(wf.pull_row_delta_start(cpu,
                                                                   nj))):
            assert np.array_equal(x, y)
        assert np.array_equal(wf.pull_row_delta(cpu.to(cuda), nj), v)


def test_hop_kernels_match_plain(cuda):
    """hop_prep and hop_match against their plain versions: every type,
    SW and NW, hits at k = 0 and beyond, no stop, an overshoot, ok = 0 on
    entry, cj < W + 1, a reachable goal, random states."""
    err, seen = hop_tune.check(cuda)
    assert err == 0
    assert set(seen) == {"hit at 0", "hit", "no stop", "overshoot", "ok 0",
                         "cj < W + 1", "reachable", "random"}


def test_hop_wrappers_reject_bad_inputs(cuda):
    s1r = torch.zeros(100, dtype=torch.uint8, device=cuda)
    st = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernels.hop_prep_cuda(s1r, st, 100, 5, 3, 2)   # W >= n
    with pytest.raises(ValueError):
        kernels.hop_prep_cuda(s1r, st.long(), 10, 5, 3, 2)
    cut = torch.zeros(100, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kernels.hop_match_cuda(cut, cut, cut[:9], cut[:10], st, st.clone(),
                               10, 5, match=1, gap_open=3, gap_ext=2,
                               sw=False)


@pytest.mark.parametrize("W,hb", [(1024, 512), (2048, 1000), (16384, 8192),
                                  (1024, 100), (8192, 4100)])
def test_hop_kernel_matches_plain(cuda, W, hb):
    """The one-launch hop against wavefront.hop_plain at the main paths'
    hops (the bench's, the CLI's), past one CTA and on a cluster of odd
    size: every case of hop_tune.LABELS, the state with the last row and
    without, the whole last row."""
    err, seen = hop_tune.check_fused(cuda, 1 << 20, W, hb)
    assert err == 0 and set(seen) == set(hop_tune.LABELS)


def test_hop_kernel_at_every_geometry(cuda):
    """Every CTA shape and cluster that covers a hop gives the plain
    hop's state."""
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=True)
    (a, s1r, cut_h, cut_f), st = hop_tune.planted(cuda, 1 << 16, 2048,
                                                     1024)
    want = torch.empty(4, dtype=torch.int32, device=cuda)
    wf.hop_plain(a, s1r, cut_h, cut_f, st, want, 2048, **kw)
    geos = hop_tune.geometries(1024, kernels.hop_max_cluster(cuda))
    assert len(geos) >= 6
    for geo in geos:
        got = torch.empty(4, dtype=torch.int32, device=cuda)
        kernels.hop_cuda(a, s1r, cut_h, cut_f, st, got, 2048, geometry=geo,
                         **kw)
        assert got.tolist() == want.tolist(), geo


def test_tall_hop_takes_three_launches(cuda, monkeypatch):
    """A hop taller than a cluster holds goes through hop_prep, the strip
    kernel and hop_match, by its shape alone; forced onto that route a
    hop gives hop_plain's state."""
    assert kernels.hop_route(65537, 131072, cuda) is None
    assert kernels.hop_route(8192, 16384, cuda) is not None
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=True)
    (a, s1r, cut_h, cut_f), st = hop_tune.planted(cuda, 1 << 16, 2048,
                                                     1024)
    want = torch.empty(4, dtype=torch.int32, device=cuda)
    wf.hop_plain(a, s1r, cut_h, cut_f, st, want, 2048, **kw)
    monkeypatch.setattr(kernels, "hop_route", lambda *a: None)
    counts = [kernels.hop_prep_cuda.launches, kernels.hop_cuda.launches]
    got = torch.empty(4, dtype=torch.int32, device=cuda)
    flags, routes = [], []
    wf.hop_step(a, s1r, cut_h, cut_f, st, got, 2048, flags=flags,
                routes=routes, **kw)
    kernels.check_flags(torch.cat(flags).tolist())
    assert got.tolist() == want.tolist() and routes == ["three"]
    assert [kernels.hop_prep_cuda.launches, kernels.hop_cuda.launches] \
        == [counts[0] + 1, counts[1]]


def test_hop_three_returns_its_last_row(cuda):
    """``hop_three`` hands back the strip kernel's last row beside the
    state, equal to ``hop_plain``'s with ``last_row``; the chromosome-scale
    runs' hops take their routes on the card by shape: the 5M run's
    (12,288 x 32,768) one launch, the 23M run's (72,704 x 262,144) the
    three."""
    assert kernels.hop_route(12288, 32768, cuda) is not None
    assert kernels.hop_route(72704, 262144, cuda) is None
    assert kernels.hop_route(65537, 131072, cuda) is None
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=True)
    (a, s1r, cut_h, cut_f), st = hop_tune.planted(cuda, 1 << 16, 2048,
                                                     1024)
    want = torch.empty(4, dtype=torch.int32, device=cuda)
    _, want_h, want_f = wf.hop_plain(a, s1r, cut_h, cut_f, st, want, 2048,
                                     last_row=True, **kw)
    got = torch.empty(4, dtype=torch.int32, device=cuda)
    out, rev_h, rev_f = wf.hop_three(a, s1r, cut_h, cut_f, st, got, 2048,
                                     **kw)
    assert out is got and got.tolist() == want.tolist()
    assert torch.equal(rev_h, want_h) and torch.equal(rev_f, want_f)
    routes = []
    wf.hop_step(a, s1r, cut_h, cut_f, st, got, 2048, routes=routes, **kw)
    assert routes == ["one"] and got.tolist() == want.tolist()


def test_hop_max_warps_mirror_the_kernel(cuda):
    assert kernels.load("hop").masa_hop_max_warps() == kernels.HOP_MAX_WARPS
    assert kernels.hop_max_cluster(cuda) in (kernels.HOP_PORTABLE_CLUSTER,
                                             kernels.HOP_MAX_CLUSTER)


def test_hop_kernel_wrapper_rejects_bad_inputs(cuda):
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2, sw=True)
    (a, s1r, cut_h, cut_f), st = hop_tune.planted(cuda, 1 << 14, 1024,
                                                     512)
    out = torch.empty(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # the state read where it is written
        kernels.hop_cuda(a, s1r, cut_h, cut_f, st, st, 1024, **kw)
    with pytest.raises(ValueError):  # W >= n
        kernels.hop_cuda(a, s1r, cut_h, cut_f, st, out, s1r.numel(), **kw)
    with pytest.raises(ValueError):  # a cut of int64
        kernels.hop_cuda(a, s1r, cut_h.long(), cut_f, st, out, 1024, **kw)
    with pytest.raises(RuntimeError):  # a geometry that leaves a CTA empty
        kernels.hop_cuda(a, s1r, cut_h, cut_f, st, out, 1024,
                         geometry=kernels.HopGeometry(4, 4, 2), **kw)


def test_chained_march_on_the_card_matches_cpu(cuda):
    """A march on the card chains its hops (chain=None is on there), one
    launch of the hop kernel a hop issued, and gives the CPU host march's
    crosspoints; its hops copy no sequence from the host."""
    from masa_tpu_torch.stages import core, pipeline
    from masa_tpu_torch.types import AlignmentStart

    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, 20000).astype(np.uint8)
    s1 = s0.copy()
    flip = rng.random(len(s1)) < 0.08
    s1[flip] = rng.choice(bases, int(flip.sum()))
    s1 = np.concatenate([rng.choice(bases, 9000).astype(np.uint8), s1])
    start = AlignmentStart.SEQUENCE_1_AND_2
    got = {}
    for dev in ("cpu", "cuda"):
        pcfg = pipeline.PipelineConfig(alignment_start=start,
                                       flush_interval=1024, device=dev,
                                       backend="kernel")
        res, ep = pipeline.stage1_pass(s0, s1, pcfg)
        stats = core.MarchStats()
        before = dict(wf.dev_seq_counts)
        launches = (kernels.hop_cuda.launches, kernels.hop_prep_cuda.launches)
        got[dev] = [tuple(c) for c in pipeline.stage2_march(
            s0, s1, pcfg, ep, res.specials, res.dev_cache, stats)]
        if dev == "cuda":
            assert stats.chained >= 3 and stats.segments >= 1, stats
            assert wf.dev_seq_counts["uploads"] == before["uploads"]
            assert (kernels.hop_cuda.launches - launches[0],
                    kernels.hop_prep_cuda.launches - launches[1]) \
                == (stats.issued, 0)
        else:
            assert stats.segments == 0
    assert got["cuda"] == got["cpu"]


def test_goal_match_on_the_card_matches_cpu(cuda):
    """goal_match_device on CUDA tensors gives the CPU's verdicts."""
    rng = np.random.default_rng(5)
    cut_h, cut_f = (rng.integers(-60, 60, 4000) for _ in range(2))
    for _ in range(40):
        cj = int(rng.integers(2, 4000))
        w = int(rng.integers(1, cj))
        rev_h, rev_f = (rng.integers(-60, 60, w) for _ in range(2))
        goal = int(rng.integers(-30, 90))
        args = [torch.tensor(x, dtype=torch.int32)
                for x in (cut_h, cut_f, rev_h, rev_f)]
        want = wf.goal_match_device(*args, cj, goal, -5, -7, W1=w + 1,
                                    go=3)
        got = wf.goal_match_device(*(a.to(cuda) for a in args), cj, goal,
                                   -5, -7, W1=w + 1, go=3)
        assert got.is_cuda and got.cpu().tolist() == want.tolist()


# --- stage 5's batched traceback (csrc/traceback.cu) -----------------------

TB_SHAPES = [(0, 9), (9, 0), (0, 0), (1, 300), (300, 1), (137, 136),
             (512, 512), (64, 4096), (4096, 64), (33, 1), (31, 40)]
TB_SCORES = [ScoreParams(), ScoreParams(2, -1, 1, 2), ScoreParams(1, -2, 3, 1)]


def tb_pair(h, w, seed):
    """``w`` columns copied from ``h`` random rows with substitutions,
    insertions and deletions."""
    r = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = r.choice(bases, h).astype(np.uint8)
    out = []
    for c in s0:
        x = r.random()
        if x < 0.04:
            continue
        out.append(c if x > 0.12 else r.choice(bases))
        if x > 0.96:
            out.extend(r.choice(bases, int(r.integers(1, 4))))
    s1 = np.array(out[:w], np.uint8)
    if len(s1) < w:
        s1 = np.concatenate([s1, r.choice(bases, w - len(s1))])
    return s0, s1.astype(np.uint8)


def tb_batch(parts, dev):
    """Sequence views on ``dev`` and items for ``(s0, s1, ts, te)``
    partitions laid end to end."""
    a = np.concatenate([np.zeros(0, np.uint8)] + [p[0] for p in parts])
    b = np.concatenate([np.zeros(0, np.uint8)] + [p[1] for p in parts])
    i0 = np.cumsum([0] + [len(p[0]) for p in parts])[:-1]
    j0 = np.cumsum([0] + [len(p[1]) for p in parts])[:-1]
    items = np.array([(x, len(p[0]), y, len(p[1]), p[2], p[3])
                      for x, y, p in zip(i0, j0, parts)], np.int64)
    return (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
            items)


def tb_native(s0, s1, ts, te, params):
    from masa_tpu_torch.native import bindings

    try:
        return bindings.traceback_ops(s0, s1, ts, te, params)
    except RuntimeError:
        return None


@pytest.mark.parametrize("k", range(len(TB_SCORES)))
def test_traceback_kernel_matches_plain(cuda, k):
    """Every shape and all nine start and end states in one call of the
    kernel (several launches by shared memory): each partition's score,
    runs and failure equal the plain version's (one shape a call) and the
    native call's."""
    params = TB_SCORES[k]
    parts = []
    for n, (h, w) in enumerate(TB_SHAPES):
        s0, s1 = tb_pair(h, w, 100 * k + n)
        parts += [(s0, s1, ts, te) for ts in range(3) for te in range(3)]
    a, b, items = tb_batch(parts, cuda)
    before = kernels.traceback_cuda.launches
    out = smallsw.traceback_batch(a, b, items, params)
    assert out.is_cuda and kernels.traceback_cuda.launches > before
    got = smallsw.traceback_decode(out.cpu().numpy(), items[:, 1:4:2])
    for n in range(len(TB_SHAPES)):
        sl = slice(9 * n, 9 * n + 9)
        pa, pb, pitems = tb_batch(parts[sl], "cpu")
        plain = smallsw.traceback_decode(
            smallsw.traceback_plain(pa, pb, pitems, params).numpy(),
            pitems[:, 1:4:2])
        for (s0, s1, ts, te), (seg, ops), (pseg, pops) in zip(
                parts[sl], got[sl], plain):
            what = (TB_SHAPES[n], ts, te)
            assert seg == pseg, what
            assert (ops is None) == (pops is None), what
            want = tb_native(s0, s1, ts, te, params)
            assert (want is None) == (ops is None), what
            if ops is not None:
                assert np.array_equal(ops, pops), what
                assert seg == want[0] and np.array_equal(ops, want[1]), what


@pytest.mark.parametrize("h,w,B", [(512, 512, 2048), (136, 136, 7688),
                                   (520, 500, 300)])
def test_traceback_kernel_at_the_main_paths_shapes(cuda, h, w, B):
    """The CLI's partitions (2,048 of 512 x 512), the library call's
    (~7,688 of ~136 x 136) and ragged ones about 512, each against the
    native call."""
    rng = np.random.default_rng(h + B)
    parts = []
    for n in range(B):
        hh = int(rng.integers(h - 8, h + 1))
        ww = int(rng.integers(w - 8, w + 1))
        s0, s1 = tb_pair(hh, ww, 1000 + n)
        parts.append((s0, s1, int(rng.integers(3)), int(rng.integers(3))))
    a, b, items = tb_batch(parts, cuda)
    got = smallsw.traceback_decode(
        smallsw.traceback_batch(a, b, items, ScoreParams()).cpu().numpy(),
        items[:, 1:4:2])
    for (s0, s1, ts, te), (seg, ops) in zip(parts, got):
        want = tb_native(s0, s1, ts, te, ScoreParams())
        assert (want is None) == (ops is None)
        if ops is not None:
            assert seg == want[0] and np.array_equal(ops, want[1])


def test_traceback_shared_bytes_mirror_the_kernel(cuda):
    """The shared memory the wrapper asks for (``traceback_smem``) is what
    the kernel's layout needs: a launch of that size runs and walks, one
    of a byte less is refused, as is a block of more warps than the
    kernel takes."""
    lib = kernels.load("traceback")
    limit = kernels.traceback_max_shared(cuda)
    assert limit >= 227 * 1024
    assert kernels.traceback_fits(512, 512, ScoreParams(), limit)
    a = torch.zeros(600, dtype=torch.uint8, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for h, w in [(0, 0), (1, 1), (137, 136), (512, 512), (520, 64)]:
        items = np.array([[0, h, 0, w, 0, 0]], np.int64)
        hdr, ops, total = kernels.traceback_layout(items[:, 1:4:2])
        table = torch.from_numpy(np.concatenate(
            [items, hdr[:, None], ops[:, None]], 1).astype(np.int32)).to(cuda)
        out = torch.zeros(total, dtype=torch.int32, device=cuda)
        warps = int(kernels.traceback_warps(h))
        words = int(kernels.traceback_table_words(h, w))
        smem = kernels.traceback_smem(warps, words, w + 1)

        def launch(nw, size):
            return lib.masa_traceback_launch(
                a.data_ptr(), a.data_ptr(), table.data_ptr(), 1,
                out.data_ptr(), 1, -3, 3, 2, nw, words, w + 1, size, stream)

        assert launch(warps, smem - 1) != 0, (h, w)
        assert launch(kernels.TRACEBACK_MAX_WARPS + 1, 1 << 17) != 0
        assert launch(warps, smem) == 0, (h, w)
        torch.cuda.synchronize()
        want = tb_native(np.zeros(h, np.uint8), np.zeros(w, np.uint8), 0, 0,
                         ScoreParams())
        assert out[0].item() == want[0] and out[1].item() == len(want[1])


def test_traceback_wrapper_rejects_bad_inputs(cuda):
    a = torch.zeros(800, dtype=torch.uint8, device=cuda)
    kw = dict(match=1, mismatch=-3, gap_open=3, gap_ext=2)
    for items in ([[0, 700, 0, 700, 0, 0]],      # past the shared memory
                  [[0, 4, 0, 4, 3, 0]],          # no such state
                  [[790, 20, 0, 4, 0, 0]],       # past the sequence
                  np.zeros((0, 6))):
        with pytest.raises(ValueError):
            kernels.traceback_cuda(a, a, np.array(items, np.int64), **kw)


def test_stage5_on_the_card_matches_the_host(cuda, tmp_path):
    """Stage 5 on the card (every partition through the kernel) gives the
    host route's alignment byte for byte: statistics, gap lists, the CGFF
    file."""
    import os

    from masa_tpu_torch.biology import alignment as balign
    from masa_tpu_torch.ops import myers_miller as mm
    from masa_tpu_torch.stages import pipeline
    from masa_tpu_torch.utils import trace

    s0, s1 = tb_pair(30000, 29800, 7)
    pcfg = pipeline.PipelineConfig(device="cuda")
    res, end = pipeline.stage1_pass(s0, s1, pcfg)
    cps = pipeline.stage2_march(s0, s1, pcfg, end, res.specials,
                                res.dev_cache)
    cps = mm.stage4_reduce(s0, s1, cps, pcfg.params, 16,
                           stage5_max_cells=pcfg.max_cells_stage5,
                           device="cuda")
    saved, kernels.event_log = kernels.event_log, []
    trace.reset()
    try:
        card = pipeline.stage5_emit(s0, s1, pcfg, cps)
        counts = dict(trace.counts)
    finally:
        kernels.event_log = saved
        trace.reset()
    host = pipeline.stage5_emit(
        s0, s1, pipeline.PipelineConfig(device="cpu"), cps)
    assert counts[(None, "partitions.card")] == len(cps) - 1
    assert counts[(None, "partitions")] == len(cps) - 1
    files = []
    for name, aln in (("card", card), ("host", host)):
        path = os.path.join(tmp_path, f"{name}.cgff")
        balign.write_cgff(path, aln)
        with open(path, "rb") as fh:
            files.append(fh.read())
    assert files[0] == files[1]
    assert card.gaps == host.gaps and card.raw_score == host.raw_score
