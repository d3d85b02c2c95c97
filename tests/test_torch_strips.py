"""The port's run_partition against masa_tpu's (scan backend): the best and
its (i, j), the last row, every special row and the last column, with
pad_rows on and off.  Inputs from numpy seeds; tolerance: exact."""

import dataclasses

import numpy as np
import pytest

from masa_tpu.ops import strips as jstrips
from masa_tpu.ops import wavefront as jwf
from masa_tpu.types import INF, InitType, Recurrence, ScoreParams
from masa_tpu_torch import convert
from masa_tpu_torch.ops import strips
from masa_tpu_torch.ops import wavefront as wf

port = convert.to_port

NEG = -INF
SW, NW = Recurrence.SMITH_WATERMAN, Recurrence.NEEDLEMAN_WUNSCH


def pair(seed, m, n):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, m).astype(np.uint8)
    s1 = np.resize(s0[::3], n).copy()
    flip = rng.random(n) < 0.2
    s1[flip] = rng.choice(bases, int(flip.sum()))
    return s0, s1


def both(s0, s1, params, rec, row_init, col_init, port_rows, special_every,
         track_best=True, store_lastcol=False, pad_rows=False,
         first_row=None, first_col=None):
    kw = dict(recurrence=rec, match=params.match, mismatch=params.mismatch,
              gap_open=params.gap_open, gap_ext=params.gap_ext,
              track_best=track_best, store_lastcol=store_lastcol)
    ref = jstrips.run_partition(
        jwf.WavefrontConfig(alpha=4, rs=1, chunk=512, **kw), s0, s1, params,
        row_init, col_init, first_row=first_row, first_col=first_col,
        backend="scan", special_every=special_every, pad_rows=pad_rows)
    # the port takes its own types: the same values, converted
    kw["recurrence"] = port(rec)
    got = strips.run_partition(
        wf.StripConfig(rows=port_rows, **kw), s0, s1, port(params),
        port(row_init), port(col_init), first_row=first_row,
        first_col=first_col, special_every=special_every, pad_rows=pad_rows)
    return ref, got


def assert_same(ref, got, pad_rows=False, track_best=True):
    if track_best:
        assert (got.best, got.best_i, got.best_j) == (
            ref.best, ref.best_i, ref.best_j)
    if pad_rows:
        assert got.last_h is None  # a padded tail strip has no last row
    else:
        np.testing.assert_array_equal(got.last_h, ref.last_h)
        np.testing.assert_array_equal(got.last_f, ref.last_f)
    assert sorted(got.specials) == sorted(ref.specials)
    for r in ref.specials:
        np.testing.assert_array_equal(got.specials[r][0], ref.specials[r][0])
        np.testing.assert_array_equal(got.specials[r][1], ref.specials[r][1])
    if ref.col_h is not None:
        np.testing.assert_array_equal(got.col_h, ref.col_h)
        np.testing.assert_array_equal(got.col_e, ref.col_e)


@pytest.mark.parametrize("pad_rows", [False, True], ids=["exact", "pad"])
@pytest.mark.parametrize("port_rows", [512, 1024, 1 << 22])
def test_sw_partition_matches(port_rows, pad_rows):
    """Three strips of 512 plus a tail; the port runs 512-row strips,
    1024-row strips that flush row 512 mid-strip, or one launch."""
    s0, s1 = pair(1, 1300, 150)
    ref, got = both(s0, s1, ScoreParams(), SW, InitType.WITH_ZEROES,
                    InitType.WITH_ZEROES, port_rows, 512, pad_rows=pad_rows)
    assert sorted(got.specials) == [512, 1024]
    assert_same(ref, got, pad_rows)


@pytest.mark.parametrize("inits", [
    (InitType.WITH_GAPS, InitType.WITH_GAPS),
    (InitType.WITH_GAPS_OPENED, InitType.WITH_GAPS),
    (InitType.WITH_GAPS, InitType.WITH_GAPS_OPENED),
], ids=["gaps", "opened_row", "opened_col"])
def test_nw_partition_with_last_column(inits):
    s0, s1 = pair(2, 700, 90)
    params = ScoreParams(2, -1, 2, 1)
    ref, got = both(s0, s1, params, NW, *inits, 256, 512, track_best=False,
                    store_lastcol=True)
    assert_same(ref, got, track_best=False)


def test_nw_best_tracking_includes_borders():
    """NW with best tracking (the nw_best endpoint): border cells seed the
    best exactly as in masa_tpu."""
    s0, s1 = pair(3, 600, 70)
    ref, got = both(s0, s1, ScoreParams(), NW, InitType.WITH_ZEROES,
                    InitType.WITH_GAPS, 512, 0)
    assert_same(ref, got)


def test_custom_borders():
    s0, s1 = pair(4, 550, 60)
    rng = np.random.default_rng(4)
    fr = (rng.integers(-20, 20, 61), np.where(rng.random(61) < 0.3, NEG,
                                              rng.integers(-30, 10, 61)))
    fc = (rng.integers(-20, 20, 551), np.where(rng.random(551) < 0.3, NEG,
                                               rng.integers(-30, 10, 551)))
    fc[0][0] = fr[0][0]
    ref, got = both(s0, s1, ScoreParams(), SW, InitType.CUSTOM,
                    InitType.CUSTOM, 300, 512, store_lastcol=True,
                    first_row=fr, first_col=fc)
    assert_same(ref, got)


def test_special_rows_stream_to_callback():
    s0, s1 = pair(5, 1100, 40)
    seen = []
    res = strips.run_partition(
        wf.StripConfig(rows=1 << 22), s0, s1, special_every=256,
        on_special_row=lambda r, h, f: seen.append((r, len(h), h.dtype)))
    assert [r for r, _, _ in seen] == [256, 512, 768, 1024]
    assert all(n == 40 and d == np.int64 for _, n, d in seen)
    assert res.specials == {}


def test_stop_check_halts_after_a_strip():
    s0, s1 = pair(6, 1000, 50)
    cfg = wf.StripConfig(rows=256)
    calls = []

    def stop(out, rows_done, strip_rows, col_off):
        calls.append((rows_done, strip_rows, col_off))
        return rows_done >= 512

    res = strips.run_partition(cfg, s0, s1, stop_check=stop)
    assert calls == [(256, 256, 0), (512, 256, 0)]
    full = strips.run_partition(dataclasses.replace(cfg, rows=512),
                                s0[:512], s1)
    assert (res.best, res.best_i, res.best_j) == (
        full.best, full.best_i, full.best_j)
