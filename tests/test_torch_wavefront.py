"""The port's strip contract (masa_tpu_torch/ops/wavefront.py) against
masa_tpu: the plain PyTorch strip equals the JAX scan twin
(masa_tpu.ops.wavefront.strip_scan) and the NumPy oracle, exactly.

Inputs are made with numpy from a seed; both sides see the same arrays.
Tolerance: exact equality (integer DP)."""

import numpy as np
import pytest
import torch

from masa_tpu.models.scoring import border_cells
from masa_tpu.ops import oracle
from masa_tpu.ops import wavefront as jwf
from masa_tpu.types import INF, InitType, Recurrence, ScoreParams
from masa_tpu_torch.ops import kernels
from masa_tpu_torch import convert
from masa_tpu_torch.ops import wavefront as wf

NEG = -INF
BORDERS = [InitType.WITH_ZEROES, InitType.WITH_GAPS,
           InitType.WITH_GAPS_OPENED, InitType.CUSTOM]


def make_strip(seed, h, nj, border, params, i0=0):
    """Chars, the row above (bus), the left border and the corner for a
    strip whose top is DP row i0."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    a = rng.choice(bases, h).astype(np.uint8)
    b = np.resize(a, nj).copy()
    flip = rng.random(nj) < 0.3
    b[flip] = rng.choice(bases, int(flip.sum()))
    if border == InitType.CUSTOM:
        bus_h = rng.integers(-30, 40, nj).astype(np.int32)
        bus_f = np.where(rng.random(nj) < 0.2, NEG,
                         rng.integers(-40, 30, nj)).astype(np.int32)
        col_h = rng.integers(-30, 40, h).astype(np.int32)
        col_e = np.where(rng.random(h) < 0.2, NEG,
                         rng.integers(-40, 30, h)).astype(np.int32)
        corner = int(rng.integers(-30, 40))
    else:
        row_h, _ = border_cells(nj + 1, border, params)
        bus_h = row_h[1:].astype(np.int32)
        bus_f = np.full(nj, NEG, np.int32)
        ch, _ = border_cells(h + 1, border, params, start=i0)
        col_h, corner = ch[1:].astype(np.int32), int(ch[0])
        col_e = np.full(h, NEG, np.int32)
    return a, b, bus_h, bus_f, col_h, col_e, corner


def run_plain(inputs, params, sw, **kw):
    a, b, bus_h, bus_f, col_h, col_e, corner = inputs
    t = torch.from_numpy
    return wf.strip(t(a), t(b), t(bus_h), t(bus_f), t(col_h), t(col_e),
                    corner, match=params.match, mismatch=params.mismatch,
                    gap_open=params.gap_open, gap_ext=params.gap_ext, sw=sw,
                    **kw)


def run_scan(inputs, params, sw, rs=1, flush_every=0):
    """masa_tpu's scan twin on the same strip (full rows = alpha*rs*128)."""
    a, b, bus_h, bus_f, col_h, col_e, corner = inputs
    h, nj = len(a), len(b)
    cfg = jwf.WavefrontConfig(
        alpha=4, rs=rs, chunk=512,
        recurrence=(Recurrence.SMITH_WATERMAN if sw
                    else Recurrence.NEEDLEMAN_WUNSCH),
        match=params.match, mismatch=params.mismatch,
        gap_open=params.gap_open, gap_ext=params.gap_ext,
        track_best=True, store_lastcol=True, flush_every=flush_every)
    T = cfg.steps(nj)

    def pad(v, fill):
        out = np.full(T, fill, np.int32)
        out[:nj] = v
        return out

    ih, ie = jwf.pack_border_cols(cfg, col_h, col_e)
    out = jwf.strip_scan(cfg, jwf.pack_strip_rows(cfg, a),
                         pad(b, jwf.B_SENTINEL), pad(bus_h, NEG),
                         pad(bus_f, NEG), ih, ie, np.int32(corner),
                         nj=nj, h_true=h)
    return out, jwf.resolve_best(out["best_v"], out["best_t"])


def np_(x):
    return x.numpy().astype(np.int64)


@pytest.mark.parametrize("h", [512, 300, 1])
@pytest.mark.parametrize("border", BORDERS, ids=lambda b: b.name)
@pytest.mark.parametrize("sw", [True, False], ids=["SW", "NW"])
def test_plain_matches_scan_twin(sw, border, h):
    params = ScoreParams() if border != InitType.WITH_GAPS \
        else ScoreParams(2, -1, 2, 1)
    nj = 77
    inputs = make_strip(100 + h, h, nj, border, params, i0=1000)
    ref, ref_best = run_scan(inputs, params, sw)
    out = run_plain(inputs, params, sw, track_best=True, store_lastcol=True)
    np.testing.assert_array_equal(np_(out.bus_h), np.asarray(ref["bus_h"]))
    np.testing.assert_array_equal(np_(out.bus_f), np.asarray(ref["bus_f"]))
    np.testing.assert_array_equal(np_(out.lastcol_h),
                                  np.asarray(ref["lastcol_h"]))
    np.testing.assert_array_equal(np_(out.lastcol_e),
                                  np.asarray(ref["lastcol_e"]))
    assert tuple(out.best.tolist()) == ref_best


@pytest.mark.parametrize("sw", [True, False], ids=["SW", "NW"])
def test_plain_flush_matches_scan_twin(sw):
    """Interior flushed rows equal the twin's mid-strip flush (rs=2:
    1024-row strip, row 511 flushed)."""
    params = ScoreParams()
    inputs = make_strip(7, 1024, 45, InitType.WITH_ZEROES, params)
    ref, ref_best = run_scan(inputs, params, sw, rs=2, flush_every=512)
    out = run_plain(inputs, params, sw, track_best=True, flush_every=512)
    np.testing.assert_array_equal(np_(out.rows_h), np.asarray(ref["rows_h"]))
    np.testing.assert_array_equal(np_(out.rows_f), np.asarray(ref["rows_f"]))
    np.testing.assert_array_equal(np_(out.bus_h), np.asarray(ref["bus_h"]))
    assert tuple(out.best.tolist()) == ref_best


@pytest.mark.parametrize("flush_every", [0, 13, 40])
@pytest.mark.parametrize("border", BORDERS, ids=lambda b: b.name)
@pytest.mark.parametrize("sw", [True, False], ids=["SW", "NW"])
def test_plain_matches_oracle(sw, border, flush_every):
    """The whole matrix as one strip: last row, last column and flushed
    rows against oracle.dp_rows, the best against the dense matrix."""
    params = ScoreParams()
    m, n = 90, 61
    a, b, bus_h, bus_f, col_h, col_e, _ = make_strip(
        5, m, n, border, params)
    rec = Recurrence.SMITH_WATERMAN if sw else Recurrence.NEEDLEMAN_WUNSCH
    if border == InitType.CUSTOM:
        corner = 7
        first_row = (np.r_[corner, bus_h], np.r_[NEG, bus_f])
        first_col = (np.r_[corner, col_h], np.r_[NEG, col_e])
    else:
        corner, first_row, first_col = 0, None, None
    rows = tuple(range(flush_every, m, flush_every)) if flush_every else ()
    ref = oracle.dp_rows(a, b, params, rec, border, border, first_row,
                         first_col, special_rows=rows)
    out = run_plain((a, b, bus_h, bus_f, col_h, col_e, corner), params, sw,
                    track_best=True, store_lastcol=True,
                    flush_every=flush_every)
    np.testing.assert_array_equal(np_(out.bus_h), ref.last_h[1:])
    np.testing.assert_array_equal(np_(out.bus_f), ref.last_f[1:])
    np.testing.assert_array_equal(np_(out.lastcol_h), ref.col_h[1:])
    np.testing.assert_array_equal(np_(out.lastcol_e), ref.col_e[1:])
    if rows:
        np.testing.assert_array_equal(
            np_(out.rows_h), np.stack([ref.specials[r][0][1:] for r in rows]))
        np.testing.assert_array_equal(
            np_(out.rows_f), np.stack([ref.specials[r][1][1:] for r in rows]))
    else:
        assert out.rows_h is None
    dense = oracle.dp_matrix(a, b, params, rec, border, border, first_row,
                             first_col).h[1:, 1:]
    s = dense.max()
    ii, jj = np.nonzero(dense == s)
    k = np.lexsort((jj, ii))[0]
    assert tuple(out.best.tolist()) == (int(s), int(ii[k]), int(jj[k]))


def test_outputs_follow_the_flags():
    params = ScoreParams()
    out = run_plain(make_strip(3, 40, 30, InitType.WITH_ZEROES, params),
                    params, True)
    assert out.best is None and out.lastcol_h is None and out.rows_h is None
    assert out.bus_h.dtype == torch.int32 and out.bus_h.shape == (30,)


def test_cpu_tensors_route_to_plain():
    """strip() on CPU tensors is the plain version and launches nothing;
    the kernel wrapper refuses CPU tensors rather than falling back."""
    params = ScoreParams()
    inputs = make_strip(9, 64, 50, InitType.WITH_GAPS, params)
    before = kernels.strip_cuda.launches
    out = run_plain(inputs, params, True, track_best=True)
    t = [torch.from_numpy(x) for x in inputs[:6]]
    plain = wf.strip_plain(*t, inputs[6], match=1, mismatch=-3, gap_open=3,
                           gap_ext=2, sw=True, track_best=True)
    assert kernels.strip_cuda.launches == before == 0
    assert torch.equal(out.bus_h, plain.bus_h)
    assert torch.equal(out.best, plain.best)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.strip_cuda(*t, inputs[6], match=1, mismatch=-3, gap_open=3,
                           gap_ext=2, sw=True)


def test_border_synthesis_matches_scoring():
    params = ScoreParams(2, -1, 3, 2)
    k = torch.arange(0, 50)
    for code in BORDERS[:3]:
        ref, _ = border_cells(50, code, params)
        got = wf.border_h(convert.to_port(code), k, params.gap_open,
                          params.gap_ext)
        np.testing.assert_array_equal(got.numpy(), ref)
        bh, bf = wf.init_bus(convert.to_port(code), 49, params.gap_open,
                             params.gap_ext, "cpu")
        np.testing.assert_array_equal(bh.numpy(), ref[1:])
        assert (bf == NEG).all()


def test_merge_best_tie_break():
    """Ties go to the smallest row, then that row's (first) column."""
    v = torch.tensor([3, 9, 9, 1], dtype=torch.int32)
    j = torch.tensor([5, 7, 2, 0], dtype=torch.int32)
    assert wf.merge_best(v, j).tolist() == [9, 1, 7]


def test_merge_best_reads_no_index_back(monkeypatch):
    """The row's j is gathered, never selected by a 0-dim tensor index: a
    select reads the index back to the host (on CUDA, a sync after every
    launch, which kept the cards of a sharded round from overlapping)."""
    v = torch.tensor([1, 4, 4], dtype=torch.int32)
    j = torch.tensor([0, 6, 1], dtype=torch.int32)
    selects = []
    getitem = torch.Tensor.__getitem__

    def spy(self, index):
        if isinstance(index, torch.Tensor) and index.dim() == 0:
            selects.append(index)
        return getitem(self, index)

    monkeypatch.setattr(torch.Tensor, "__getitem__", spy)
    assert wf.merge_best(v, j).tolist() == [4, 1, 6]
    assert not selects
