"""The Hopper kernels (the strip kernel, the two batched strip kernels and
the roofline bodies) against their plain PyTorch versions, on the card.

These need a CUDA GPU and nvcc and skip elsewhere, and import nothing of
masa_tpu.  The repo's conftest imports JAX, which a machine with only the
port's dependencies lacks, so run them there with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerance: exact equality (integer DP)."""

import numpy as np
import pytest
import torch

from masa_tpu_torch.ops import batched_mm, kernels
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.tools import batched_tune
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


@pytest.mark.parametrize("body", ["par", "ser", "mix", "dpx", "m16"])
@pytest.mark.parametrize("iters", [0, 1, 257])
def test_roofline_kernel_matches_plain(cuda, body, iters):
    from masa_tpu_torch.tools import roofline as rl

    xs = [torch.from_numpy(x).to(cuda) for x in rl.inputs(body)]
    before = rl.run_cuda.launches
    got = rl.run(body, xs, iters)
    assert rl.run_cuda.launches == before + 1
    assert torch.equal(got, rl.run_plain(body, xs, iters))
