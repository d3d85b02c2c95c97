"""Special rows packed a batch at a time, on the CPU.

On a card the disk-bound special rows of a stage-1 launch are packed
together (``ops/strips.RowPacker``: ``kernels.rowpack_cuda``, one buffer,
one copy); on the CPU a packer packs each row as it is wanted, through
the kernel's plain version (``wavefront.rowpack_plain``).  Here packers
that batch as on a card (``Batching``) run the plain version over whole
batches, and are held to the per-row path: each row's packed form and
anchors to ``wavefront.packed_row_host`` and ``gather_device`` of the same
row, its MSRQ file to masa_tpu's ``write_row_packed`` byte for byte, read
back whole and by window.  Rows of an odd length, -INF stretches, rows
dense with escapes and a row past its escape slot (which takes the
per-row path and is not counted in ``rows.card``); a launch whose rows
mix RAM and disk, batched against the same launch row by row (the same
placement, the same files, the RAM rows never packed); a stage 1 killed
inside a launch and resumed from the files.  Tolerance: exact."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masa_tpu.core import manager as jmanager
from masa_tpu.core import sra as jsra
from masa_tpu.ops import strips as jstrips
from masa_tpu_torch.core import manager, sra
from masa_tpu_torch.core.job import Job, JobConfig
from masa_tpu_torch.ops import kernels, oracle, strips
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import runner
from masa_tpu_torch.types import InitType, Recurrence, ScoreParams
from masa_tpu_torch.utils import trace

NEG = wf.NEG


class Batching(strips.RowPacker):
    """A packer that waits for its batch's close on the CPU, as one with
    a side stream does on a card."""

    def __init__(self, stream=None):
        super().__init__(stream)
        self.at_once = False


def walk(n, seed, lo=-5, hi=6):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.integers(lo, hi, n)).astype(np.int32)


def pruned(n, seed):
    """A row with -INF stretches at the grain pruning leaves them (whole
    chunks of wavefront.PRUNE_CHUNK columns), the last one to the end."""
    v = walk(n, seed)
    c = wf.PRUNE_CHUNK
    v[:c] = NEG
    v[3 * c:5 * c] = NEG
    v[n - n % c - c:] = NEG
    return v


def dense(n, seed):
    """Every delta an escape: steps of 8 to 40 either way."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(8, 41, n) * rng.choice([-1, 1], n)
    return np.cumsum(steps).astype(np.int32)


def dp_rows(k=4, n=3000, seed=3):
    """k special rows of an SW forward pass over a homologous pair."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, 200 * k).astype(np.uint8)
    s1 = rng.choice(bases, n).astype(np.uint8)
    s1[700:700 + len(s0)] = s0
    res = oracle.dp_rows(s0, s1, ScoreParams(), Recurrence.SMITH_WATERMAN,
                         InitType.WITH_ZEROES, InitType.WITH_ZEROES,
                         special_rows=tuple(200 * (q + 1) for q in range(k)))
    return [tuple(x[1:].astype(np.int32) for x in res.specials[200 * (q + 1)])
            for q in range(k)]


BATCHES = {
    "odd": [(walk(777, 1), walk(777, 2)), (walk(777, 3), walk(777, 4)),
            (walk(777, 5, -9, 10), walk(777, 6, -9, 10))],
    "pruned": [(pruned(4096, 7), pruned(4096, 8)),
               (pruned(4096, 9), walk(4096, 10))],
    # within the slot: nj <= 64 holds every cell
    "dense": [(dense(60, 11), dense(60, 12)), (dense(60, 13), walk(60, 14))],
    "one": [(np.array([-12], np.int32), np.array([3], np.int32))] * 3,
    "dp": dp_rows(),
    "long": [(walk(200_000, 15), pruned(200_000, 16))],
}


def batch(rows, packer=None):
    """RowPulls of ``rows`` in one batch of ``packer`` (``Batching()``),
    started and closed."""
    packer = packer or Batching()
    pulls = [strips.RowPull(torch.from_numpy(h), torch.from_numpy(f),
                            packer=packer) for h, f in rows]
    for p in pulls:
        p.start()
        assert not p.ready()
    packer.close()
    return pulls


def row_path(x):
    """The per-row path of a half-row: its packed form and anchors."""
    t = torch.from_numpy(x)
    got = wf.packed_row_host(wf.pull_row_delta_start(t, len(x)))
    idx = torch.arange(0, len(x), wf.ANCHOR_STRIDE)
    return got, wf.gather_device(t, idx).numpy().astype(np.int64)


def assert_same(got, want):
    for x, y in zip(got, want):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


@pytest.fixture
def traced():
    trace.reset()
    kernels.event_log = []
    try:
        yield trace
    finally:
        kernels.event_log = None
        trace.reset()


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_a_batch_packs_each_row_as_the_row_path(name, traced):
    rows = BATCHES[name]
    pulls = batch(rows)
    assert len({id(p._batch) for p in pulls}) == 1
    for p, (h, f) in zip(pulls, rows):
        assert p.ready()
        packed, anchors = p.packed(), p.anchors(wf.ANCHOR_STRIDE)
        for s, x in enumerate((h, f)):
            want, anc = row_path(x)
            assert_same(packed[s], want)
            assert_same(anchors[s], anc)
            np.testing.assert_array_equal(
                wf.decode_packed_row(*packed[s], len(x)), x)
        # another stride gathers from the row
        for s, x in enumerate((h, f)):
            np.testing.assert_array_equal(p.anchors(3)[s], x[::3])
    # rows whose escapes all fit their slots (the third odd one does not)
    fit = [all(len(row_path(x)[0][1]) <= wf.rowpack_capacity(len(x))
               for x in r) for r in rows]
    assert fit == [name != "odd" or q < 2 for q in range(len(rows))]
    assert traced.counts == {(None, "rows.card"): sum(fit)}


def test_escapes_come_out_sorted_across_blocks():
    """Escapes spread over many 2048-cell blocks of the kernel's grid,
    several in one block and none in others, in ascending order."""
    v = walk(50_000, 17)
    for c in (3, 4, 2047, 2048, 2049, 9000, 9001, 30_000, 49_999):
        v[c:] += 100
    (h, _), = [p.packed() for p in batch([(v, v[::-1].copy())])]
    assert list(h[1]) == [3, 4, 2047, 2048, 2049, 9000, 9001, 30_000,
                          49_999]
    np.testing.assert_array_equal(h[2], v[h[1]])


class JLazy:
    """masa_tpu's LazyFullRow over its RowPull of the same row."""

    def __new__(cls, h, f, bh, bf):
        pull = jstrips.RowPull(jnp.asarray(h), jnp.asarray(f), len(h))
        return jmanager.LazyFullRow(pull, bh, bf)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batched_row_files_are_masa_tpus(tmp_path, name):
    """Each row of a batch written as masa_tpu writes the same row, and
    read back whole and by window."""
    rows = BATCHES[name]
    pulls = batch(rows)
    a, b = tmp_path / "a", tmp_path / "b"
    os.makedirs(a)
    os.makedirs(b)
    for q, (p, (h, f)) in enumerate(zip(pulls, rows)):
        r = 512 * (q + 1)
        size = sra.write_row_packed(str(a), r, manager.LazyFullRow(p, -7, NEG))
        assert size == jsra.write_row_packed(str(b), r, JLazy(h, f, -7, NEG))
        path = f"row.{r:010d}.bin"
        assert (a / path).read_bytes() == (b / path).read_bytes()
        want = [np.concatenate([[b0], x]).astype(np.int64)
                for b0, x in ((-7, h), (NEG, f))]
        assert_same(sra.read_row(str(a), r), want)
        n = len(h) + 1
        for lo, hi in ((0, 1), (0, n), (max(n - 3, 0), n),
                       (n // 2, n // 2 + 9), (n // 3, n // 3 + 70_000)):
            assert_same(sra.read_row_window(str(a), r, lo, hi),
                        [x[lo:hi] for x in want])


def test_a_row_past_its_escape_slot_takes_the_row_path(tmp_path, traced):
    """A half with more escapes than its slot holds (64 + nj / 256) is
    found by the host scan and read from the row, as before; the rest of
    the batch is not, and only rows packed whole count in rows.card."""
    n = 5000
    cap = wf.rowpack_capacity(n)
    over = dense(n, 18)
    jumps = np.zeros(n, np.int32)
    jumps[np.arange(1, n, n // cap)[:cap]] = 100  # an escape each
    at_cap = walk(n, 19) + np.cumsum(jumps, dtype=np.int32)
    rows = [(walk(n, 20), walk(n, 21)), (walk(n, 22), over),
            (at_cap, walk(n, 23))]
    pulls = batch(rows)
    b = pulls[0]._batch
    assert int(b.cnt[1, 1]) == n > cap and int(b.cnt[2, 0]) == cap
    scans = []
    real = wf._escapes

    def counted(u, nj):
        scans.append(nj)
        return real(u, nj)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wf, "_escapes", counted)
        got = [p.packed() for p in pulls]
    over_cap = [int(b.cnt[q, s]) > cap for q in range(3) for s in (0, 1)]
    assert scans == [n] * sum(over_cap)
    for (h, f), g in zip(rows, got):
        for s, x in enumerate((h, f)):
            assert_same(g[s], row_path(x)[0])
    assert traced.counts == {
        (None, "rows.card"): sum(1 for q in range(3)
                                 if not any(over_cap[2 * q:2 * q + 2]))}
    for q, (p, (h, f)) in enumerate(zip(pulls, rows)):
        os.makedirs(tmp_path / str(q))
        sra.write_row_packed(str(tmp_path / str(q)), 1, manager.LazyFullRow(
            p, 0, NEG))
        os.makedirs(tmp_path / f"j{q}")
        jsra.write_row_packed(str(tmp_path / f"j{q}"), 1, JLazy(h, f, 0, NEG))
        path = "row.0000000001.bin"
        assert (tmp_path / str(q) / path).read_bytes() == \
            (tmp_path / f"j{q}" / path).read_bytes()


def test_a_batchs_buffer_lives_with_its_rows():
    """A batch's host buffer is its rows' own until they are dropped:
    batches packed after it by the same packer take buffers of their own
    and leave its rows' packed form as the per-row path gives it."""
    rows = BATCHES["odd"]
    packer = Batching()
    first = batch(rows, packer)
    later = [batch(BATCHES["dp"], packer) for _ in range(2)]
    ptrs = {b[0]._batch.host.data_ptr() for b in [first] + later}
    assert len(ptrs) == 3
    for p, (h, f) in zip(first, rows):
        for s, x in enumerate((h, f)):
            assert_same(p.packed()[s], row_path(x)[0])


def run(s0, s1, cfg, store, special_every, prune, packer):
    """Stage 1's way of a partition into a store: lazy rows on the CPU,
    packed with ``packer``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(strips, "RowPacker", packer)
        res = strips.run_partition(
            cfg, s0, s1, ScoreParams(), InitType.WITH_ZEROES,
            InitType.WITH_ZEROES, special_every=special_every, prune=prune,
            on_special_row_lazy=lambda r, p: store.put_lazy(
                r, manager.LazyFullRow(p, 0, NEG)))
        store.finalize()
    return res


def files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith("row.")}


@pytest.mark.parametrize("prune", [False, True], ids=["whole", "pruned"])
def test_a_launch_mixing_ram_and_disk(tmp_path, dna, homolog, prune):
    """A launch of eight special rows (2048 rows, one every 256), some of
    them kept in RAM: batched, the store places every row where it places
    it row by row, writes the same files, and never packs a RAM row; with
    pruning inside the launch the rows carry -INF stretches."""
    s0 = dna(2600, seed=51)
    s1 = homolog(s0, seed=52)[:2500]
    cfg = wf.StripConfig(rows=2048, launch_prune=(64, 2) if prune else None)
    nbytes = 8 * (len(s1) + 1) + 20
    got = {}
    for name, packer in (("rows", strips.RowPacker), ("batch", Batching)):
        store = sra.SpecialRowsPartition(
            str(tmp_path / name), 0, 0, len(s0), len(s1),
            ram_limit=4 * nbytes, disk_limit=45_000)
        run(s0, s1, cfg, store, 256, prune, packer)
        got[name] = store
    rows, batched = got["rows"], got["batch"]
    assert sorted(batched._ram) == sorted(rows._ram)
    first = [r in batched._ram for r in range(256, 2049, 256)]
    assert any(first) and not all(first)
    assert len(batched._ram) + len(batched._disk) == 10
    assert batched._disk == rows._disk
    assert files(batched.dir) == files(rows.dir)
    assert all(not lazy.pull._wanted for lazy in batched._ram.values())
    for r in batched._ram:
        assert_same(batched.get(r), rows.get(r))
    if prune:
        h, _ = batched.get(max(batched._disk))
        assert (h == NEG).any()


def test_a_stage_1_killed_inside_a_launch_resumes_from_the_files(tmp_path):
    """Stage 1 on 1024-row launches (special rows 512 and 1024 in the
    first, 1536 in the second), batched, killed once the store holds row
    1536: the first launch's files landed at that row's put, so stage 1
    resumes from row 1024, and the run ends as the uninterrupted one,
    its files byte for byte."""
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s1 = rng.choice(bases, 1600).astype(np.uint8)
    s0 = np.concatenate([s1[:600], rng.choice(bases, 1000).astype(np.uint8)])
    kc = wf.StripConfig(rows=1024)

    def job(wd):
        return Job(JobConfig(work_dir=wd, ram_limit=0, disk_limit=1 << 17,
                             backend="kernel"), device="cpu")

    def quiet(*a, **k):
        pass

    put_lazy = runner._OffsetStore.put_lazy

    def dying(self, r, lazy):
        put_lazy(self, r, lazy)
        if self.offset + r >= 1536:
            raise KeyboardInterrupt("killed")

    wd, ref = str(tmp_path / "w"), str(tmp_path / "ref")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(strips, "RowPacker", Batching)
        clean = runner.align_job(job(ref), s0, s1, kernel_cfg=kc, log=quiet)
        mp.setattr(runner._OffsetStore, "put_lazy", dying)
        with pytest.raises(KeyboardInterrupt):
            runner.stage1(job(wd), s0, s1, kernel_cfg=kc, log=quiet)
    area = os.path.join(wd, "special_rows")
    part, = [os.path.join(d, "") for d, _, names in os.walk(area)
             if any(n.startswith("row.") for n in names)]
    assert sorted(files(part)) == ["row.0000000512.bin",
                                   "row.0000001024.bin"]
    msgs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(strips, "RowPacker", Batching)
        aln = runner.align_job(job(wd), s0, s1, kernel_cfg=kc,
                               log=msgs.append)
    assert "stage1: resuming from special row 1024" in msgs
    assert aln.raw_score == clean.raw_score == 600
    for f in ("crosspoints/crosspoint_01.00", "crosspoints/crosspoint_02.00",
              "alignment.00.txt"):
        with open(os.path.join(wd, f), "rb") as x, \
                open(os.path.join(ref, f), "rb") as y:
            assert x.read() == y.read(), f
