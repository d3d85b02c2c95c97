"""The port's delta-packed special rows against masa_tpu's, on the CPU.

``ops/wavefront``'s packing family (``delta_pack_device``,
``pull_row_delta``, ``pull_row_delta_start``/``_finish``,
``packed_row_host``, ``gather_device``), ``ops/strips.RowPull``'s packed
form and ``core/sra.write_row_packed`` are held against masa_tpu's
functions of the same names on the same rows: a DP row of a forward
pass, rows with escapes (-INF runs, large steps, a delta of exactly -8),
odd lengths and one cell.  The packed bytes, the escapes and the decoded
rows must be equal, and a row file masa_tpu's bytes.  Then the lazy rows
of a stage 1 on disk: the port's runner and CLI write masa_tpu's lazy
rows byte for byte (masa_tpu's CPU CLI takes the lazy path with
``--backend kernel``).  Tolerance: exact equality."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masa_tpu.cli import main as jmain
from masa_tpu.core import manager as jmanager
from masa_tpu.core import sra as jsra
from masa_tpu.ops import strips as jstrips
from masa_tpu.ops import wavefront as jwf
from masa_tpu_torch.cli import main
from masa_tpu_torch.core import manager, sra
from masa_tpu_torch.ops import strips
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import core
from masa_tpu_torch.types import InitType, Recurrence, ScoreParams

NEG = wf.NEG


def dp_row(n=5000, seed=1):
    """A row of an SW forward pass (the oracle) over a homologous pair."""
    from masa_tpu_torch.ops import oracle

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, 300).astype(np.uint8)
    s1 = rng.choice(bases, n).astype(np.uint8)
    s1[1000:1300] = s0
    res = oracle.dp_rows(s0, s1, ScoreParams(), Recurrence.SMITH_WATERMAN,
                         InitType.WITH_ZEROES, InitType.WITH_ZEROES,
                         special_rows=(300,))
    h, f = res.specials[300]
    return h[1:].astype(np.int32), f[1:].astype(np.int32)


def escape_row(n, seed):
    """Small steps, -INF runs, large jumps and deltas of exactly -8 and
    8 (both escapes)."""
    rng = np.random.default_rng(seed)
    v = np.cumsum(rng.integers(-5, 6, n)).astype(np.int64)
    v[n // 3:n // 3 + 7] = NEG
    v[n // 2:] += 1000
    if n > 10:
        v[5] = v[4] - 8
        v[9] = v[8] + 8
    return v.astype(np.int32)


ROWS = {
    "dp_h": dp_row()[0], "dp_f": dp_row()[1],
    "escapes_even": escape_row(4096, 2), "escapes_odd": escape_row(777, 3),
    "one": np.array([-12], np.int32), "one_small": np.array([3], np.int32),
    "pruned": np.concatenate([np.full(600, NEG, np.int32),
                              np.arange(401, dtype=np.int32)]),
}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_packing_matches_masa_tpu(name):
    """Packed bytes, escapes and values: the port's functions give
    masa_tpu's (a longer bus packs its first nj values only)."""
    v = ROWS[name]
    nj = len(v)
    bus = np.concatenate([v, np.full(5, 77, np.int32)])
    mine = wf.delta_pack_device(torch.from_numpy(bus), nj)
    theirs = np.asarray(jwf.delta_pack_device(jnp.asarray(bus), nj))
    assert mine.dtype == torch.uint8 and len(mine) == (nj + 1) // 2
    np.testing.assert_array_equal(mine.numpy(), theirs.view(np.uint8))
    got = wf.packed_row_host(wf.pull_row_delta_start(torch.from_numpy(bus),
                                                     nj))
    want = jwf.packed_row_host(jwf.pull_row_delta_start(jnp.asarray(bus),
                                                        nj))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
        assert np.asarray(x).dtype == np.asarray(y).dtype
    row = wf.pull_row_delta(torch.from_numpy(bus), nj)
    np.testing.assert_array_equal(row, jwf.pull_row_delta(jnp.asarray(bus),
                                                          nj))
    np.testing.assert_array_equal(row, v.astype(np.int64))
    assert row.dtype == np.int64
    np.testing.assert_array_equal(
        wf.pull_row_delta_finish(wf.pull_row_delta_start(
            torch.from_numpy(bus), nj)), v)
    np.testing.assert_array_equal(wf.decode_packed_row(*got, nj), v)


def test_gather_and_escapes():
    """The escapes are exactly the deltas outside [-7, 7], the -8 and 8
    ones among them, and their values are gathered from the row."""
    v = ROWS["escapes_even"]
    u, mark, exact = wf.packed_row_host(wf.pull_row_delta_start(
        torch.from_numpy(v), len(v)))
    d = np.diff(np.concatenate([[0], v.astype(np.int64)]))
    np.testing.assert_array_equal(mark, np.nonzero(np.abs(d) > 7)[0])
    assert 5 in mark and 9 in mark and 0 not in mark
    np.testing.assert_array_equal(exact, v[mark])
    idx = torch.tensor([0, 5, 100])
    assert wf.gather_device(torch.from_numpy(v), idx).tolist() == \
        np.asarray(jwf.gather_device(jnp.asarray(v),
                                     jnp.asarray(idx.numpy()))).tolist()


class JLazy:
    """masa_tpu's LazyFullRow over its RowPull of the same row."""

    def __new__(cls, h, f, bh, bf):
        pull = jstrips.RowPull(jnp.asarray(h), jnp.asarray(f), len(h))
        return jmanager.LazyFullRow(pull, bh, bf)


@pytest.mark.parametrize("name", ["dp", "escapes", "odd", "one"])
def test_row_pull_and_row_file_match_masa_tpu(tmp_path, name):
    """RowPull's packed form and anchors, and the MSRQ file
    write_row_packed makes of a LazyFullRow, are masa_tpu's byte for
    byte; the file reads back through both packages whole and by
    window."""
    h, f = {"dp": dp_row(), "escapes": (ROWS["escapes_even"],
                                        escape_row(4096, 5)),
            "odd": (ROWS["escapes_odd"], escape_row(777, 6)),
            "one": (ROWS["one"], ROWS["one_small"])}[name]
    pull = strips.RowPull(torch.from_numpy(h), torch.from_numpy(f))
    assert not pull.ready()
    mine = manager.LazyFullRow(pull, -7, NEG)
    theirs = JLazy(h, f, -7, NEG)
    assert mine.start() is mine and pull.ready()
    for got, want in zip(mine.packed(), theirs.packed()):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    for stride in (1, 3, 1 << 16):
        for x, y in zip(mine.anchors(stride), theirs.anchors(stride)):
            np.testing.assert_array_equal(x, y)
    os.makedirs(tmp_path / "a")
    os.makedirs(tmp_path / "b")
    size = sra.write_row_packed(str(tmp_path / "a"), 512, mine)
    assert size == jsra.write_row_packed(str(tmp_path / "b"), 512, theirs)
    path = "row.0000000512.bin"
    with open(tmp_path / "a" / path, "rb") as x, \
            open(tmp_path / "b" / path, "rb") as y:
        raw = x.read()
        assert raw[:4] == b"MSRQ" and raw == y.read()
    want_h = np.concatenate([[-7], h]).astype(np.int64)
    got_h, got_f = sra.read_row(str(tmp_path / "a"), 512)
    np.testing.assert_array_equal(got_h, want_h)
    np.testing.assert_array_equal(got_f[1:], f)
    n = len(h) + 1
    for lo, hi in ((0, 1), (0, n), (max(n - 3, 0), n), (n // 2, n // 2 + 9)):
        for x, y in zip(sra.read_row_window(str(tmp_path / "a"), 512, lo,
                                            hi),
                        (want_h[lo:hi], got_f[lo:hi])):
            np.testing.assert_array_equal(x, y)
    # the int32 rows of the same pull, as a RAM read takes them
    np.testing.assert_array_equal(mine.full_rows()[0], want_h)


def test_forward_pass_rows_pull_packed_as_masa_tpu(dna, homolog):
    """The special rows of an eager forward pass (the strips' plain
    version), pulled packed from a bus one cell longer, give the int32
    rows the pass stored, and masa_tpu's packed pull of the same bus."""
    s0 = dna(1100, seed=31)
    s1 = homolog(s0, seed=32)
    res = core.forward_pass(
        s0, s1, ScoreParams(), Recurrence.SMITH_WATERMAN,
        InitType.WITH_ZEROES, InitType.WITH_ZEROES, special_every=256,
        backend="kernel", device="cpu")
    assert len(res.specials.rows()) == 4
    for r in res.specials.rows():
        for row in res.specials.get(r):
            nj = len(row)
            bus = np.concatenate([row, [77]]).astype(np.int32)
            got = wf.pull_row_delta(torch.from_numpy(bus), nj)
            np.testing.assert_array_equal(got, row)
            np.testing.assert_array_equal(
                got, jwf.pull_row_delta(jnp.asarray(bus), nj))


def write_fasta(path, desc, seq):
    with open(path, "wb") as fh:
        fh.write(b">" + desc.encode() + b"\n" + bytes(seq) + b"\n")


def rows_of(work):
    out = {}
    top = os.path.join(work, "special_rows")
    for d, _, files in os.walk(top):
        for name in files:
            if name.startswith("row."):
                with open(os.path.join(d, name), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, name), top)] = \
                        fh.read()
    return out


def test_cli_lazy_rows_are_masa_tpus_on_disk(dna, homolog, tmp_path,
                                             capsys):
    """`--stage-1 --backend kernel --ram-size 0`: both CLIs on the CPU
    deliver their special rows lazily and write them as MSRQ files, the
    port's byte for byte masa_tpu's, with the same score line."""
    s0 = dna(2100, seed=41)
    s1 = homolog(s0, seed=42)
    fa, fb = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    write_fasta(fa, "a", s0)
    write_fasta(fb, "b", s1)
    common = [fa, fb, "--backend", "kernel", "--ram-size", "0",
              "--disk-size", "1G", "--stage-1", "--no-block-pruning"]
    assert jmain(common + ["--work-dir", str(tmp_path / "ref")]) == 0
    want = capsys.readouterr().out
    assert main(common + ["--work-dir", str(tmp_path / "mine"),
                          "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    theirs, mine = rows_of(str(tmp_path / "ref")), rows_of(
        str(tmp_path / "mine"))
    assert len(mine) >= 3 and mine == theirs
    assert all(raw[:4] == b"MSRQ" for raw in mine.values())
    line = [x for x in want.splitlines() if x.startswith("best score")]
    assert line and line[0] in got.splitlines()
