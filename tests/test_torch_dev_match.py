"""The port's device-resident stage 2 against masa_tpu's, on the CPU.

Counterpart of tests/test_dev_match.py.  Stage 1 keeps its special rows
where it computed them (``core.DevRowCache``; CPU tensors here), stage 2
matches a hop's goal there (``wavefront.goal_match_device``) or reads
only the cut's column window from the store, and stage 1 can hand the
store its rows lazily.  Every case is held against masa_tpu on the same
seeded inputs (its forward pass and device match run as JAX on the CPU,
its march through the NumPy oracle), and the device paths must be
*taken*, counted as masa_tpu's own test counts them.  Tolerance: exact
equality (integers and bytes)."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masa_tpu.cli import main as jmain
from masa_tpu.models.scoring import match_column as jmatch_column
from masa_tpu.ops import wavefront as jwf
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.stages import core as jcore
from masa_tpu.stages import runner as jrunner
from masa_tpu.types import (AlignmentStart as JStart,
                            Crosspoint as JCrosspoint,
                            CrosspointType as JCrosspointType,
                            InitType as JInit, ScoreParams)
from masa_tpu_torch.cli import main
from masa_tpu_torch.core import sra
from masa_tpu_torch.core.manager import AlignerManager
from masa_tpu_torch.models.scoring import match_column
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import core, runner
from masa_tpu_torch.types import (AlignmentStart, Crosspoint,
                                  CrosspointType, InitType, Recurrence)

from test_torch_runner_cli import jobs, quiet, same_artifacts

P = ScoreParams()
CFG = WavefrontConfig(alpha=4, rs=1, chunk=512, track_best=True,
                      store_lastcol=False)
R = CFG.rows  # 512: both packages' CPU strips, the special-row cadence


def far_pair(dna, homolog, rows, seed=603):
    """s1 = 12000 random bases, then a homolog of s0: the path runs far
    from column 0, so hop windows (the 4096 floor) clear it and the device
    match can serve (its precondition j_low >= 1)."""
    s0 = dna(rows, seed=seed)
    return s0, np.concatenate([dna(12000, seed=699),
                               homolog(s0, seed=seed + 1)])


def port_stage1(s0, s1, store=None, budget=1 << 30, lazy=False):
    cache = core.DevRowCache(budget)
    res = core.forward_pass(
        s0, s1, P, Recurrence.SMITH_WATERMAN, InitType.WITH_ZEROES,
        InitType.WITH_ZEROES, special_every=R, store=store,
        backend="kernel", device="cpu", dev_cache=cache, lazy_rows=lazy)
    return res, cache


def ref_stage1(s0, s1, budget=None):
    cache = jcore.DevRowCache(budget)
    res = jcore.forward_pass(
        s0, s1, P, jcore.Recurrence.SMITH_WATERMAN, JInit.WITH_ZEROES,
        JInit.WITH_ZEROES, special_every=R, backend="scan", cfg=CFG,
        dev_cache=cache)
    return res, cache


def ref_chain(s0, s1, res):
    """masa_tpu's crosspoint chain through its NumPy oracle march."""
    ep = JCrosspoint(res.best_i, res.best_j, res.best, JCrosspointType.MATCH)
    got = jcore.reverse_march(
        s0, s1, P, ep, copy.deepcopy(res.specials), JInit.WITH_ZEROES,
        JInit.WITH_ZEROES, JStart.ANYWHERE, backend="numpy")
    return [tuple(int(x) for x in c) for c in got]


def port_march(s0, s1, res, store, cache, stats=None):
    ep = Crosspoint(res.best_i, res.best_j, res.best, CrosspointType.MATCH)
    got = core.reverse_march(
        s0, s1, P, ep, store, InitType.WITH_ZEROES, InitType.WITH_ZEROES,
        AlignmentStart.ANYWHERE, backend="kernel", device="cpu",
        dev_cache=cache, stats=stats)
    return [tuple(int(x) for x in c) for c in got]


def count_calls(monkeypatch, owner, name, calls, key):
    orig = getattr(owner, name)

    def counted(*a, **k):
        calls[key] += 1
        return orig(*a, **k)

    monkeypatch.setattr(owner, name, counted)


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_dev_cache_populated(dna, homolog, lazy):
    """(a) The cache holds every stored row, equal to the store's rows and
    to masa_tpu's cache and store; a lazy store reads back the same."""
    s0 = dna(4 * R + 77, seed=601)
    s1 = homolog(s0, seed=602)
    res, cache = port_stage1(s0, s1, lazy=lazy)
    jres, jcache = ref_stage1(s0, s1)
    store = res.specials
    assert (res.best, res.best_i, res.best_j) == \
        (jres.best, jres.best_i, jres.best_j)
    assert len(cache) == len(store.rows()) == 4
    assert store.rows() == jres.specials.rows()
    n = len(s1)
    for r in store.rows():
        dev_h, dev_f, h0, f0 = cache.get(r)
        host_h, host_f = store.get(r)
        jh, jf, jh0, jf0 = jcache.get(r)
        assert (h0, f0) == (host_h[0], host_f[0]) == (jh0, jf0)
        np.testing.assert_array_equal(dev_h.numpy(), host_h[1:])
        np.testing.assert_array_equal(dev_f.numpy(), host_f[1:])
        np.testing.assert_array_equal(dev_h.numpy(), np.asarray(jh[:n]))
        np.testing.assert_array_equal(dev_f.numpy(), np.asarray(jf[:n]))
        for x, y in zip(store.get(r), jres.specials.get(r)):
            np.testing.assert_array_equal(x, y)
    assert cache.nbytes == 4 * 2 * 4 * n


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_dev_match_march_parity(dna, homolog, monkeypatch, lazy):
    """(b) reverse_march with the cache gives masa_tpu's oracle chain; the
    device match fires at least twice, host matches no more often."""
    s0, s1 = far_pair(dna, homolog, 4 * R + 33)
    res, cache = port_stage1(s0, s1, lazy=lazy)
    want = ref_chain(s0, s1, ref_stage1(s0, s1)[0])
    calls = {"dev": 0, "host": 0}
    count_calls(monkeypatch, AlignerManager, "dispatch_last_row_device",
                calls, "dev")
    count_calls(monkeypatch, AlignerManager, "_match_goal", calls, "host")
    stats = core.MarchStats()
    got = port_march(s0, s1, res, res.specials, cache, stats)
    assert got == want
    assert calls["dev"] >= 2, calls
    assert calls["host"] <= calls["dev"], calls
    assert stats.dev_matches == calls["dev"] and stats.window_reads == 0
    # the march dropped the rows above each crosspoint it matched from the
    # cache (the start, got[0], is found without a cut)
    assert cache._rows and all(r <= got[1][0] for r in cache._rows)


@pytest.mark.parametrize("codec,lazy", [("none", False), ("none", True),
                                        ("4bit", True)])
def test_windowed_cut_march_parity(dna, homolog, monkeypatch, tmp_path,
                                   codec, lazy):
    """(c) No cache (a resumed call) over the port's disk rows: with the
    window read forced where the card would take it, the march reads cut
    windows alone, matches them on the device and gives masa_tpu's
    chain.  A "none" row reads the window's bytes alone from its file."""
    s0, s1 = far_pair(dna, homolog, 4 * R + 33)
    part = sra.SpecialRowsPartition(str(tmp_path / "p"), 0, 0, len(s0),
                                    len(s1), ram_limit=0, codec=codec)
    res, _ = port_stage1(s0, s1, store=part, lazy=lazy)
    assert part._disk and not part._ram and not part._pending
    want = ref_chain(s0, s1, ref_stage1(s0, s1)[0])
    calls = {"win": 0, "dev": 0}
    fetch = core._fetch_window_cut

    def count_fetch(*a, **k):
        out = fetch(*a, **k)
        calls["win"] += out is not None
        return out

    monkeypatch.setattr(core, "_fetch_window_cut", count_fetch)
    monkeypatch.setattr(core, "_windowed_cut_ok", lambda *a, **k: True)
    count_calls(monkeypatch, AlignerManager, "dispatch_last_row_device",
                calls, "dev")
    reopened = sra.SpecialRowsPartition(part.dir, 0, 0, len(s0), len(s1),
                                        ram_limit=0, codec=codec)
    stats = core.MarchStats()
    got = port_march(s0, s1, res, reopened, None, stats)
    assert got == want
    assert calls["win"] >= 2 and calls["dev"] >= 2, calls
    assert stats.window_reads == calls["win"]
    assert stats.window_bytes < stats.window_reads * 8 * (len(s1) + 1)


def test_window_read_of_a_none_row(tmp_path):
    """A stored "none" row's window equals the slice of the whole row,
    at both ends, past the end and empty; so do the other codecs'."""
    rng = np.random.default_rng(11)
    h = np.cumsum(rng.integers(-3, 4, 5001)).astype(np.int64)
    f = h - rng.integers(0, 9, 5001)
    f[100:300] = -999999999
    for k, codec in enumerate(("none", "8bit", "vlc")):
        sra.write_row(str(tmp_path), k, h, f, codec)
        for lo, hi in ((0, 1), (0, 5001), (4000, 4600), (4999, 7000),
                       (6000, 7000), (17, 17)):
            gh, gf = sra.read_row_window(str(tmp_path), k, lo, hi)
            np.testing.assert_array_equal(gh, h[lo:hi])
            np.testing.assert_array_equal(gf, f[lo:hi])
            assert gh.dtype == np.int64


def verdict_cases(seed, host_h, host_f):
    """Seeded (cj, width, goal, rev_h, rev_f) windows: random rows, and
    rows built to stop at a chosen k as each outcome: aligned, gapped,
    an overshoot of each sum, no stop."""
    rng = np.random.default_rng(seed)
    n = len(host_h) - 1
    cases = []
    for kind in ["random"] * 12 + [0, 1, 2, 3, 4] * 4:
        cj = int(rng.integers(10, n))
        width = int(rng.integers(1, cj))
        goal = int(rng.integers(-50, 400))
        if kind == "random":
            rev_h = rng.integers(-200, 200, width)
            rev_f = rng.integers(-200, 200, width)
        else:
            rev_h = np.full(width, -10 ** 6)
            rev_f = np.full(width, -10 ** 6)
            k = int(rng.integers(1, width + 1))  # index 0 is the border
            fh, ff = int(host_h[cj - k]), int(host_f[cj - k])
            if kind in (0, 2):
                rev_h[k - 1] = goal - fh + (kind == 2) * 5
            elif kind in (1, 3):
                rev_f[k - 1] = goal - P.gap_open - ff + (kind == 3) * 7
        cases.append((cj, width, goal, rev_h.astype(np.int64),
                      rev_f.astype(np.int64)))
    return cases


def test_goal_match_device_matches_masa_tpu(dna, homolog):
    """(d) goal_match_device against masa_tpu's (JAX on the CPU) and
    against match_column of both packages, on 32 seeded windows of a
    stored row: every outcome, misses and both overshoots among them."""
    s0 = dna(2 * R + 11, seed=605)
    s1 = homolog(s0, seed=606)
    res, cache = port_stage1(s0, s1)
    r = res.specials.rows()[0]
    host_h, host_f = res.specials.get(r)
    dev_h, dev_f, _, _ = cache.get(r)
    rev0h, rev0f = -5, -17
    seen = set()
    for cj, width, goal, rev_h, rev_f in verdict_cases(7, host_h, host_f):
        fwd_h = host_h[cj - width:cj + 1][::-1]
        fwd_f = host_f[cj - width:cj + 1][::-1]
        rh = np.concatenate([[rev0h], rev_h])
        rf = np.concatenate([[rev0f], rev_f])
        want = match_column(rh, rf, fwd_h, fwd_f, goal, P.gap_open)
        assert tuple(want) == tuple(jmatch_column(rh, rf, fwd_h, fwd_f, goal,
                                                  P.gap_open))
        got = wf.goal_match_device(
            dev_h, dev_f, torch.tensor(rev_h, dtype=torch.int32),
            torch.tensor(rev_f, dtype=torch.int32), cj, goal, rev0h, rev0f,
            W1=width + 1, go=P.gap_open)
        ref = jwf.goal_match_device(
            jnp.asarray(dev_h.numpy()), jnp.asarray(dev_f.numpy()),
            jnp.asarray(rev_h, jnp.int32), jnp.asarray(rev_f, jnp.int32),
            jnp.int32(cj), jnp.int32(goal), jnp.int32(rev0h),
            jnp.int32(rev0f), W1=width + 1, go=P.gap_open)
        assert got.dtype == torch.int32
        assert got.tolist() == np.asarray(ref).tolist()
        status, k, score = got.tolist()
        seen.add(status)
        if want.found:
            assert status in (0, 1) and (k, score) == (want.k, want.score)
            assert (status == 0) == (want.type.name == "ALIGNED")
        elif want.k >= 0:
            assert status in (2, 3) and k == want.k
            assert (status == 2) == (want.type.name == "ERROR_SUM_MATCH")
        else:
            assert status == 4 and k == -1
    assert seen == {0, 1, 2, 3, 4}, seen


def test_goal_match_device_refuses_a_window_off_the_cut():
    t = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        wf.goal_match_device(t, t, t, t, 5, 0, 0, 0, W1=7, go=3)
    with pytest.raises(ValueError):
        wf.goal_match_device(t, t, t[:2], t[:2], 8, 0, 0, 0, W1=5, go=3)


def test_eviction_and_truncation(dna, homolog):
    """(e) A budget of two and a half rows keeps the two largest rows (the
    smallest go first), as masa_tpu's cache does with room for as many of
    its own (padded) rows; truncate_above drops the rows above a
    crosspoint, in both packages."""
    s0 = dna(6 * R + 5, seed=607)
    s1 = homolog(s0, seed=608)
    row_bytes = 2 * 4 * len(s1)
    res, cache = port_stage1(s0, s1, budget=5 * row_bytes // 2)
    _, whole = ref_stage1(s0, s1)
    _, jcache = ref_stage1(s0, s1,
                           budget=5 * whole._bytes // (2 * len(whole)))
    rows = res.specials.rows()
    assert len(rows) == len(whole) == 6
    assert sorted(cache._rows) == sorted(jcache._rows) == rows[-2:]
    assert [cache.get(r) is None for r in rows] == \
        [jcache.get(r) is None for r in rows] == [True] * 4 + [False] * 2
    assert cache.nbytes == 2 * row_bytes
    cache.truncate_above(rows[-1] - 1)
    jcache.truncate_above(rows[-1] - 1)
    assert sorted(cache._rows) == sorted(jcache._rows) == rows[-2:-1]
    assert cache.nbytes == row_bytes
    # a row larger than the whole budget is not kept
    small = core.DevRowCache(row_bytes - 1)
    small.put_dev(R, *cache.get(rows[-2])[:2])
    assert len(small) == 0 and small.nbytes == 0


def tree(top):
    out = {}
    for d, _, files in os.walk(top):
        for name in files:
            with open(os.path.join(d, name), "rb") as fh:
                out[os.path.relpath(os.path.join(d, name), top)] = fh.read()
    return out


@pytest.mark.parametrize("codec,mixed,prune", [
    ("none", False, False), ("4bit", False, False), ("none", True, False),
    ("none", False, True)],
    ids=["none-disk", "4bit-disk", "none-ram+disk", "none-disk-pruned"])
def test_lazy_stage1_writes_the_eager_rows(pair3k, tmp_path, monkeypatch,
                                           codec, mixed, prune):
    """(f) A lazy stage 1 through the runner writes the rows an eager one
    writes: every row reads back through the area with the same values.
    The files differ by design, as masa_tpu's do: eager rows are the
    partition's codec, byte for byte masa_tpu's eager rows, and lazy rows
    bound for disk are the device's packed form ("MSRQ"), byte for byte
    masa_tpu's lazy rows.  The port's lazy placement is pinned row by
    row.  Mixed, masa_tpu's placement of a lazy row depends on whether
    the copy of the row before it has landed (an in-flight row charges
    the disk budget), so there the files both packages wrote are held
    byte for byte.  With block pruning on, the port's rows hold -INF
    where its windows (masa_tpu's rule without masa_tpu's power-of-two
    window buckets) pruned more than masa_tpu's, so that case holds lazy
    against eager alone."""
    s0, s1 = pair3k
    # mixed: room for 3 rows in RAM and 3 on disk, so they alternate
    row = 8 * (len(s1) + 1) + 20
    base = dict(ram_limit=3 * row if mixed else 0,
                disk_limit=3 * row if mixed else 1 << 30,
                sra_compression=codec, backend="kernel",
                block_pruning=prune)
    calls = {"lazy": 0}
    count_calls(monkeypatch, AlignerManager, "dispatch_row_lazy", calls,
                "lazy")
    lazy, ref = jobs(tmp_path / "lazy", **base)
    runner.stage1(lazy, s0, s1, log=quiet)
    assert calls["lazy"] == 5
    assert len(lazy.runtime_dev_rows.cache) == 5
    eager, _ = jobs(tmp_path / "eager", **base)
    with monkeypatch.context() as mp:
        mp.setattr(core, "lazy_rows_fit", lambda *a: False)
        runner.stage1(eager, s0, s1, log=quiet)
    assert calls["lazy"] == 5
    mine = lazy.sra_area(1, 0).open_partition(0, 0)
    ours = eager.sra_area(1, 0).open_partition(0, 0)
    assert mine.rows() == ours.rows() and len(mine.rows()) == 5
    for r in mine.rows():
        for x, y in zip(mine.get(r), ours.get(r)):
            np.testing.assert_array_equal(x, y)
    rows = {d: tree(os.path.join(d, "special_rows"))
            for d in (lazy.dir, eager.dir)}
    assert len([k for k in rows[eager.dir] if "row." in k]) == (
        2 if mixed else 5)
    assert all(raw[:4] == b"MSRQ" for k, raw in rows[lazy.dir].items()
               if "row." in k)
    # the port's lazy placement.  Mixed: row 512 goes to RAM (1/3 of each
    # budget), 1024 to disk (RAM would be 2/3, disk 1/3); once written, a
    # disk row charges its packed file (about an eighth of a row), so the
    # disk stays the emptier budget and takes the three rows after it
    on_disk = sorted(int(k.rsplit("row.", 1)[1][:10])
                     for k in rows[lazy.dir] if "row." in k)
    assert on_disk == ([1024, 1536, 2048, 2560] if mixed
                       else [512, 1024, 1536, 2048, 2560])
    if prune:
        return
    monkeypatch.setenv("MASA_TPU_DEV_ROWS_MB", "0")  # masa_tpu eager
    jrunner.stage1(ref, s0, s1, log=quiet)
    assert tree(os.path.join(ref.dir, "special_rows")) == rows[eager.dir]
    # masa_tpu's lazy rows: the same files
    _, jlazy = jobs(tmp_path / "jlazy", **base)
    monkeypatch.delenv("MASA_TPU_DEV_ROWS_MB")
    jrunner.stage1(jlazy, s0, s1, log=quiet)
    jrows = tree(os.path.join(jlazy.dir, "special_rows"))
    if mixed:
        both = set(jrows) & set(rows[lazy.dir])
        assert len([k for k in both if "row." in k]) >= 1
        jrows = {k: jrows[k] for k in both}
        rows[lazy.dir] = {k: rows[lazy.dir][k] for k in both}
    assert jrows == rows[lazy.dir]
    theirs = jlazy.sra_area(1, 0).open_partition(0, 0)
    assert theirs.rows() == mine.rows()
    for r in theirs.rows():
        for x, y in zip(mine.get(r), theirs.get(r)):
            np.testing.assert_array_equal(x, y)


@pytest.fixture
def pair3k(dna, homolog):
    s0 = dna(3000, seed=201)
    return s0, homolog(s0, seed=202, sub_rate=0.08, indel_rate=0.02)


def write_fasta(path, desc, seq):
    with open(path, "wb") as f:
        f.write(b">" + desc.encode() + b"\n" + bytes(seq) + b"\n")


def stats_of(work):
    with open(os.path.join(work, "statistics_02.00")) as fh:
        return {k.strip(): int(v) for k, v in
                (line.split(":") for line in fh if ":" in line)
                if k.strip() != "total_ms"}


def test_cli_single_call_and_resumed_call(dna, homolog, tmp_path,
                                          monkeypatch, capsys):
    """(g) The CLI on the CPU: one full call matches stage 2 on the device
    from the cache; a --stage-1 call and a resumed call match from cut
    windows read off the disk rows (the read forced as on the card).
    Both write masa_tpu's CLI's crosspoint and alignment files byte for
    byte, and the same score line."""
    s0, s1 = far_pair(dna, homolog, 4 * R + 33, seed=611)
    fa, fb = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    write_fasta(fa, "a", s0)
    write_fasta(fb, "b", s1)
    common = [fa, fb, "--backend", "kernel", "--ram-size", "0",
              "--disk-size", "1G"]
    ref = str(tmp_path / "ref")
    assert jmain(common + ["--work-dir", ref]) == 0
    want = capsys.readouterr().out
    one = str(tmp_path / "one")
    assert main(common + ["--work-dir", one, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    st = stats_of(one)
    assert st["dev_matches"] >= 2 and st["window_reads"] == 0, st
    assert st["host_matches"] <= st["dev_matches"], st
    two = str(tmp_path / "two")
    assert main(common + ["--work-dir", two, "--device", "cpu",
                          "--stage-1"]) == 0
    monkeypatch.setattr(core, "_windowed_cut_ok", lambda *a, **k: True)
    assert main(common + ["--work-dir", two, "--device", "cpu"]) == 0
    resumed = capsys.readouterr().out
    st = stats_of(two)
    assert st["window_reads"] >= 2 and st["dev_matches"] >= 2, st
    assert "stage1: already executed (resume)" in resumed
    line = [x for x in want.splitlines() if x.startswith("alignment score")]
    assert line and line[0] in got.splitlines() \
        and line[0] in resumed.splitlines()
    same_artifacts(one, ref)
    same_artifacts(two, ref)
