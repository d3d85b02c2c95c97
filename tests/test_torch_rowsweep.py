"""The port's row-sweep entry points (masa_tpu_torch/ops/rowsweep.py)
against masa_tpu's, on the CPU: the counterpart of tests/test_rowsweep.py.

The same numpy-seeded inputs go through ``masa_tpu.ops.rowsweep`` (plain
XLA on the CPU, as the reference's own tests run it) and through the port,
and through the port's oracle.  Tolerance 0: every output is compared
value for value with the reference; against the oracle, -INF-like values
are canonicalized first, as the reference's tests do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masa_tpu.ops import rowsweep as ref_rowsweep
from masa_tpu.ops import wavefront as ref_wf
from masa_tpu_torch.models.scoring import border_cells
from masa_tpu_torch.ops import oracle, rowsweep
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.types import INF, InitType, Recurrence, ScoreParams

P = ScoreParams()
NEG = -INF
SW, NW = Recurrence.SMITH_WATERMAN, Recurrence.NEEDLEMAN_WUNSCH
ZEROES, GAPS, OPENED = (InitType.WITH_ZEROES, InitType.WITH_GAPS,
                        InitType.WITH_GAPS_OPENED)


def sweep_inputs(s0, s1, row_init, col_init, params=P):
    """The arrays both sweeps take for a whole matrix from synthesized
    borders, as numpy."""
    m, n = len(s0), len(s1)
    rh, _ = border_cells(n + 1, row_init, params)
    ch, _ = border_cells(m + 1, col_init, params)
    return dict(
        a=np.asarray(s0, np.int32),
        b=np.concatenate([[0], np.asarray(s1, np.int32)]).astype(np.int32),
        h0=ch[1:].astype(np.int32), e0=np.full(m, NEG, np.int32),
        row_h=rh.astype(np.int32), row_f=np.full(n + 1, NEG, np.int32))


def both(x, rec, params=P, stop_after=None, **kw):
    """The reference's sweep and the port's on the same arrays, each as a
    dict of numpy arrays."""
    m, n1 = len(x["a"]), len(x["b"])
    stop = m if stop_after is None else stop_after
    static = dict(n1=n1, m_steps=m, sw=rec == SW, go=params.gap_open,
                  ge=params.gap_ext, match=params.match,
                  mismatch=params.mismatch, **kw)
    order = ("a", "b", "h0", "e0", "row_h", "row_f")
    ref = ref_rowsweep.sweep(*(jnp.asarray(x[k]) for k in order),
                             jnp.int32(stop), **static)
    got = rowsweep.sweep(*(torch.from_numpy(x[k]) for k in order), stop,
                         **static)
    assert all(v.dtype == torch.int32 for v in got.values())
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()})


def assert_same(ref, got):
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def canon(a):
    a = np.asarray(a, np.int64)
    return np.where(a <= -INF // 2, -INF, a)


@pytest.mark.parametrize("rec,row_init,col_init", [
    (SW, ZEROES, ZEROES), (NW, GAPS, GAPS), (NW, OPENED, GAPS),
    (NW, GAPS, OPENED), (NW, ZEROES, ZEROES)])
def test_last_row_parity(dna, homolog, rec, row_init, col_init):
    s0 = dna(173, seed=801)
    s1 = homolog(s0, seed=802)[:166]
    ref, got = both(sweep_inputs(s0, s1, row_init, col_init), rec)
    assert_same(ref, got)
    want = oracle.dp_rows(s0, s1, P, rec, row_init, col_init)
    np.testing.assert_array_equal(canon(got["h"]), canon(want.last_h))
    np.testing.assert_array_equal(canon(got["f"]), canon(want.last_f))


def test_nonuniform_params(dna, homolog):
    params = ScoreParams(match=3, mismatch=-2, gap_open=5, gap_ext=1)
    s0 = dna(90, seed=803)
    s1 = homolog(s0, seed=804)
    ref, got = both(sweep_inputs(s0, s1, ZEROES, ZEROES, params), SW,
                    params)
    assert_same(ref, got)
    want = oracle.dp_rows(s0, s1, params)
    np.testing.assert_array_equal(canon(got["h"]), canon(want.last_h))
    np.testing.assert_array_equal(canon(got["f"]), canon(want.last_f))


@pytest.mark.parametrize("stop", [70, 0, 1, 120, 500])
def test_stop_after_freezes(dna, homolog, stop):
    """stop_after=k returns exactly the row-k bus, and every output equals
    the reference's, the frozen rows' last column included."""
    s0 = dna(120, seed=805)
    s1 = homolog(s0, seed=806)
    ref, got = both(sweep_inputs(s0, s1, GAPS, GAPS), NW, stop_after=stop,
                    track_best=True, want_lastcol=True)
    assert_same(ref, got)
    k = min(stop, len(s0))
    if k:
        want = oracle.dp_rows(s0[:k], s1, P, NW, GAPS, GAPS)
        np.testing.assert_array_equal(canon(got["h"]), canon(want.last_h))
        np.testing.assert_array_equal(canon(got["f"]), canon(want.last_f))


def test_chaining_equals_single(dna, homolog):
    """Two chained sweeps == one sweep (the bus contract), in both
    packages."""
    s0 = dna(140, seed=807)
    s1 = homolog(s0, seed=808)
    x = sweep_inputs(s0, s1, GAPS, GAPS)
    whole_ref, whole = both(x, NW)
    cut = 64
    first = {**x, "a": x["a"][:cut], "h0": x["h0"][:cut],
             "e0": x["e0"][:cut]}
    first_ref, first_got = both(first, NW)
    assert_same(first_ref, first_got)
    second = {**x, "a": x["a"][cut:], "h0": x["h0"][cut:],
              "e0": x["e0"][cut:], "row_h": first_got["h"],
              "row_f": first_got["f"]}
    second_ref, second_got = both(second, NW)
    assert_same(second_ref, second_got)
    assert_same(whole_ref, whole)
    np.testing.assert_array_equal(second_got["h"], whole["h"])
    np.testing.assert_array_equal(second_got["f"], whole["f"])


@pytest.mark.parametrize("rec,inits", [(SW, (ZEROES, ZEROES)),
                                       (NW, (GAPS, GAPS)),
                                       (NW, (ZEROES, OPENED))])
def test_best_and_lastcol(dna, homolog, rec, inits):
    s0 = dna(110, seed=809)
    s1 = homolog(s0, seed=810)
    ref, got = both(sweep_inputs(s0, s1, *inits), rec, track_best=True,
                    want_lastcol=True)
    assert_same(ref, got)
    want = oracle.dp_rows(s0, s1, P, rec, *inits)
    if rec == SW:
        assert tuple(int(v) for v in got["best"]) == (
            want.best, want.best_i, want.best_j)
    np.testing.assert_array_equal(canon(got["lastcol_h"]),
                                  canon(want.col_h[1:]))
    np.testing.assert_array_equal(canon(got["lastcol_e"]),
                                  canon(want.col_e[1:]))


def test_best_counts_the_border_column():
    """A border value above every interior cell wins, at column 0, in both
    packages; so does a tie on the same row."""
    rng = np.random.default_rng(5)
    m, n = 12, 9
    x = dict(a=rng.integers(65, 69, m).astype(np.int32),
             b=rng.integers(65, 69, n + 1).astype(np.int32),
             h0=rng.integers(-30, 5, m).astype(np.int32),
             e0=np.full(m, NEG, np.int32),
             row_h=rng.integers(-30, 5, n + 1).astype(np.int32),
             row_f=np.full(n + 1, NEG, np.int32))
    x["h0"][7] = 400
    ref, got = both(x, NW, track_best=True)
    assert_same(ref, got)
    assert tuple(got["best"]) == (400, 8, 0)


def test_sweep_refuses_mismatched_shapes():
    x = {k: torch.from_numpy(v) for k, v in sweep_inputs(
        np.frombuffer(b"ACGT", np.uint8), np.frombuffer(b"ACG", np.uint8),
        GAPS, GAPS).items()}
    kw = dict(sw=False, go=3, ge=2, match=1, mismatch=-3)
    with pytest.raises(ValueError, match="n1"):
        rowsweep.sweep(x["a"], x["b"], x["h0"], x["e0"], x["row_h"],
                       x["row_f"], 4, n1=5, m_steps=4, **kw)
    with pytest.raises(ValueError, match="m_steps"):
        rowsweep.sweep(x["a"], x["b"], x["h0"], x["e0"], x["row_h"],
                       x["row_f"], 4, n1=4, m_steps=3, **kw)


@pytest.mark.parametrize("sw", [False, True])
def test_batched_engine_mixed_heights(dna, sw):
    """The batched engine: per-element offsets, border codes, row offsets
    and heights against padded sequences, equal to the reference's engine
    and exact against the oracle."""
    s0 = dna(600, seed=811)
    s1 = dna(500, seed=812)
    pad0 = np.full(800, ref_wf.A_SENTINEL, np.int32)
    pad0[:600] = s0
    pad1 = np.full(700, ref_wf.B_SENTINEL, np.int32)
    pad1[:500] = s1
    n1, R, B = 129, 96, 5
    scores = (P.gap_open, P.gap_ext, P.match, P.mismatch)
    i0s = np.array([0, 50, 100, 13, 200], np.int32)
    j0s = np.array([0, 64, 128, 7, 190], np.int32)
    r0s = np.array([0, 0, 0, 0, 17], np.int32)
    hs = np.array([96, 40, 0, 77, 300], np.int32)
    codes = np.array([1, 1, 1, 2, 0], np.int32)
    rh, _ = border_cells(n1, GAPS, P)
    bus_h = np.tile(rh[1:].astype(np.int32), (B, 1))
    bus_f = np.full((B, n1 - 1), NEG, np.int32)
    arrays = (pad0, pad1, i0s, j0s, r0s, codes, bus_h, bus_f, hs)
    ref_h, ref_f = ref_rowsweep.batched_sweep_engine(n1, R, sw, *scores)(
        *(jnp.asarray(x) for x in arrays))
    got_h, got_f = rowsweep.batched_sweep_engine(n1, R, sw, *scores)(
        *(torch.from_numpy(x) for x in arrays))
    assert got_h.dtype == got_f.dtype == torch.int32
    got_h, got_f = got_h.numpy(), got_f.numpy()
    np.testing.assert_array_equal(got_h, np.asarray(ref_h))
    np.testing.assert_array_equal(got_f, np.asarray(ref_f))
    np.testing.assert_array_equal(got_h[2], bus_h[2])  # no rows left
    if sw:
        return
    for k in (0, 1, 3):  # from row 0 of their borders: the oracle's strips
        ci = GAPS if codes[k] == 1 else OPENED
        sub0 = np.asarray(pad0[i0s[k]:i0s[k] + hs[k]], np.uint8)
        sub1 = np.asarray(pad1[j0s[k]:j0s[k] + n1 - 1], np.uint8)
        want = oracle.dp_rows(sub0, sub1, P, NW, GAPS, ci)
        np.testing.assert_array_equal(canon(got_h[k]),
                                      canon(want.last_h[1:]))
        np.testing.assert_array_equal(canon(got_f[k]),
                                      canon(want.last_f[1:]))


def test_plain_strips_and_rowsweep_share_one_sweep(monkeypatch):
    """``rowsweep`` keeps no sweep of its own: its entries run
    ``wavefront.strip_plain`` and ``wavefront.batched_sweep_plain``, which
    ``batched_strip_plain`` runs too."""
    calls = []
    for name in ("strip_plain", "batched_sweep_plain"):
        inner = getattr(wf, name)
        monkeypatch.setattr(wf, name, lambda *a, _f=inner, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    x = {k: torch.from_numpy(v) for k, v in sweep_inputs(
        np.frombuffer(b"ACGTAC", np.uint8), np.frombuffer(b"ACGGT", np.uint8),
        GAPS, GAPS).items()}
    rowsweep.sweep(x["a"], x["b"], x["h0"], x["e0"], x["row_h"], x["row_f"],
                   6, n1=6, m_steps=6, sw=False, go=3, ge=2, match=1,
                   mismatch=-3)
    assert calls == ["strip_plain"]
    a = torch.from_numpy(np.frombuffer(b"ACGTACGT", np.uint8).copy())
    elems = np.array([[0, 4, 1, 3, 1, 1]], np.int32)
    wf.batched_strip_plain(a, a, elems, 3, match=1, mismatch=-3, gap_open=3,
                           gap_ext=2)
    bus = torch.zeros((1, 3), dtype=torch.int32)
    rowsweep.batched_sweep_engine(4, 4, False, 3, 2, 1, -3)(
        a, a, [0], [1], [0], [1], bus, bus, torch.tensor([4]))
    assert calls[1:] == ["batched_sweep_plain"] * 2
