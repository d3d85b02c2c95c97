"""The port's own host layer against the modules it was taken from.

``masa_tpu_torch`` keeps a copy of every JAX-free module of ``masa_tpu``
that it needs (types, scoring, the oracle, the sequence and alignment
files, the native library, the row codecs, the cell streams, the work
directory's files, stage 6, the grid and the block aligner, the TCP
ring).  Each case here sends the same seeded numpy
inputs through the reference's function and the port's and expects equal
results: tolerance 0, as everything is integer or bytes.  Values cross
between the packages only through ``masa_tpu_torch.convert``.
"""

import contextlib
import ctypes
import dataclasses
import fcntl
import hashlib
import io
import os
import shutil
import subprocess
import tempfile

import numpy as np
import pytest

import masa_tpu
import masa_tpu.biology.alignment
import masa_tpu.biology.sequence
import masa_tpu.ops.oracle
import masa_tpu.types
import masa_tpu_torch
from masa_tpu_torch import convert

BASES = np.frombuffer(b"ACGT", np.uint8)


def mod(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg.__name__}.{name}")


BOTH = (masa_tpu, masa_tpu_torch)

# masa_tpu's value-type modules, handed to convert.to_ref
REF = (masa_tpu.types, masa_tpu.biology.sequence, masa_tpu.biology.alignment)


def plain(x):
    """A value of either package as nested plain data, for ==."""
    x = convert.to_plain(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = dataclasses.asdict(x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def pair(seed, m, n=None, rate=0.1):
    rng = np.random.default_rng(seed)
    s0 = rng.choice(BASES, m).astype(np.uint8)
    s1 = s0.copy()
    idx = rng.random(m) < rate
    s1[idx] = rng.choice(BASES, int(idx.sum())).astype(np.uint8)
    if n is not None:
        s1 = s1[:n] if n <= m else np.concatenate(
            [s1, rng.choice(BASES, n - m).astype(np.uint8)])
    return s0, s1


# --- one function per copied module: run it in `pkg`, return plain data ----

def run_types(pkg):
    t = mod(pkg, "types")
    cp = t.Crosspoint(3, 9, 17, t.CrosspointType.GAP_1)
    p = t.Partition(2, 3, 40, 50)
    enums = {name: {e.name: int(e) for e in getattr(t, name)}
             for name in ("Recurrence", "InitType", "StartType",
                          "CrosspointType", "AlignmentStart", "MatchType")}
    return [t.INF, enums, cp.reversed(100, 120), cp.transposed(),
            p.height, p.width, p.translated(5, -1), str(p),
            t.ScoreParams(2, -1, 4, 1).gap_first, t.BestScore(1, 2, 3)]


def run_scoring(pkg):
    sc, t = mod(pkg, "models.scoring"), mod(pkg, "types")
    rng = np.random.default_rng(11)
    out = [sc.encode_sequence("acgtNnAC"), sc.encode_sequence(b"ACGT"),
           sc.encode_sequence(np.frombuffer(b"TTGA", np.uint8))]
    for code in (t.InitType.WITH_ZEROES, t.InitType.WITH_GAPS,
                 t.InitType.WITH_GAPS_OPENED):
        out.append(sc.border_cells(37, code, t.ScoreParams(2, -1, 3, 2),
                                   start=5))
    # matches of each kind: aligned, gapped, over the goal, none
    fwd_h = rng.integers(-20, 40, 64)
    fwd_g = rng.integers(-20, 40, 64)
    rev_h = rng.integers(-20, 40, 64)
    rev_g = rng.integers(-20, 40, 64)
    for goal in (int(fwd_h[20] + rev_h[20]), int(fwd_g[7] + rev_g[7] + 3),
                 -100, 1000):
        out.append(sc.match_column(rev_h, rev_g, fwd_h, fwd_g, goal, 3))
    return out


def run_oracle(pkg):
    o, t = mod(pkg, "ops.oracle"), mod(pkg, "types")
    s0, s1 = pair(5, 90, 75)
    out = []
    for rec, ri, ci in (
            (t.Recurrence.SMITH_WATERMAN, t.InitType.WITH_ZEROES,
             t.InitType.WITH_ZEROES),
            (t.Recurrence.NEEDLEMAN_WUNSCH, t.InitType.WITH_GAPS,
             t.InitType.WITH_GAPS),
            (t.Recurrence.NEEDLEMAN_WUNSCH, t.InitType.WITH_GAPS_OPENED,
             t.InitType.WITH_ZEROES)):
        r = o.dp_rows(s0, s1, t.ScoreParams(2, -1, 3, 1), rec, ri, ci,
                      special_rows=(16, 48), row_bests=True)
        out.append(dataclasses.asdict(r))
        d = o.dp_matrix(s0[:30], s1[:25], t.ScoreParams(), rec, ri, ci)
        out.append([d.h, d.e, d.f, d.best()])
    return out


def run_smallsw(pkg):
    sw, t = mod(pkg, "ops.smallsw"), mod(pkg, "types")
    aln_mod = mod(pkg, "biology.alignment")
    s0, s1 = pair(9, 60, 52)
    p = t.ScoreParams()
    out = [sw.constrained_dp(s0, s1, ts, p) for ts in (0, 1, 2)]
    aln = aln_mod.Alignment(sequences=[])
    for te in (0, 1, 2):
        out.append(sw.traceback_segment(s0, s1, 4, 7, 0, te, p, aln))
    return out + [aln]


def _reference_native_lib() -> str:
    """masa_tpu/native/masanative.cpp built once, under a file lock, into
    a temporary path named by the source's hash (g++ writes a temporary
    file that is then renamed into place)."""
    from masa_tpu.native import bindings

    with open(bindings._SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    out = os.path.join(tempfile.gettempdir(), f"masa_tpu_native_{digest}.so")
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-march=native", "-shared",
                            "-fPIC", "-std=c++17", "-pthread",
                            bindings._SRC, "-o", tmp],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, out)
    return out


@contextlib.contextmanager
def reference_native():
    """masa_tpu's native bindings over a library of their own source.
    masa_tpu builds its library in place (``_masanative.so`` beside the
    source), so a process that loads it while another test worker writes
    it keeps no library and its native tests skip; here the library comes
    from ``_reference_native_lib`` and is handed to the bindings, after
    their own ``_configure``, for the block."""
    from masa_tpu.native import bindings

    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler for the native library here")
    lib = ctypes.CDLL(_reference_native_lib())
    bindings._configure(lib)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bindings, "_LIB", lib)
        mp.setattr(bindings, "_TRIED", True)
        yield bindings


@contextlib.contextmanager
def native_bindings(pkg):
    """``pkg``'s native bindings with their library loaded."""
    if pkg is masa_tpu:
        with reference_native() as b:
            yield b
        return
    b = mod(pkg, "native.bindings")
    if not b.available():
        pytest.skip("no C++ compiler for the native library here")
    yield b


def run_native(pkg):
    with native_bindings(pkg) as b:
        return run_native_with(b, pkg)


def run_native_with(b, pkg):
    t, o = mod(pkg, "types"), mod(pkg, "ops.oracle")
    s0, s1 = pair(21, 700, 690, rate=0.05)
    p = t.ScoreParams()
    nw = t.Recurrence.NEEDLEMAN_WUNSCH
    end = int(o.dp_rows(s0, s1, p, nw, t.InitType.WITH_GAPS,
                        t.InitType.WITH_GAPS).last_h[-1])
    cps = [t.Crosspoint(0, 0, 0), t.Crosspoint(len(s0), len(s1), end)]
    ladder = b.reduce_partitions(s0, s1, cps, p, 16)
    assert len(ladder) > 20
    return [ladder, b.traceback_ops(s0[:40], s1[:38], 0, 0, p)]


def run_sequence(pkg, tmp_path):
    sq = mod(pkg, "biology.sequence")
    path = os.path.join(tmp_path, "x.fa")
    s0, _ = pair(31, 333)
    s0[[5, 77]] = ord("N")
    body = s0.tobytes().lower()
    with open(path, "wb") as fh:
        fh.write(b">chr test\n" + b"\n".join(
            body[k:k + 70] for k in range(0, len(body), 70)) + b"\n")
    out = [sq.parse_fasta(b">d\nacg\ntn\n"), sq.parse_fasta(b"ACGT")]
    for kw in ({}, {"reverse": True}, {"complement": True, "clear_n": True},
               {"reverse": True, "complement": True, "trim_start": 11,
                "trim_end": 300}):
        s = sq.Sequence.from_file(path, sq.SequenceModifiers(**kw))
        out.append([s, s.data(), len(s), s.modifiers.flags,
                    s.absolute_pos(7), s.reversed_view().data(),
                    s.trimmed_view(20, 120).data()])
    out.append(sq.SequenceModifiers.from_flags(5, 3, 9))
    return out


def example_alignment(pkg):
    """A small gapped alignment built by ``pkg``'s own stage 5."""
    sw, t = mod(pkg, "ops.smallsw"), mod(pkg, "types")
    am, sq = mod(pkg, "biology.alignment"), mod(pkg, "biology.sequence")
    s0, s1 = pair(41, 200)
    s1 = np.delete(s1, np.arange(90, 96))
    s1 = np.insert(s1, 40, BASES[[0, 1, 2]])
    aln = am.Alignment(sequences=[sq.Sequence(s0), sq.Sequence(s1)],
                       method=am.ALIGNMENT_METHOD_GLOBAL)
    aln.start, aln.end = [1, 1], [len(s0), len(s1)]
    aln.raw_score = sw.traceback_segment(s0, s1, 0, 0, 0, 0, t.ScoreParams(),
                                         aln)
    return aln, s0, s1


def run_alignment(pkg, tmp_path):
    am = mod(pkg, "biology.alignment")
    aln, s0, s1 = example_alignment(pkg)
    assert aln.gaps[0] and aln.gaps[1] and aln.check_consistency()
    path = os.path.join(tmp_path, "a.cgff")
    am.write_cgff(path, aln)
    with open(path, "rb") as fh:
        raw = fh.read()
    return [raw, am.read_cgff(path), aln.aligned_length(0),
            aln.sorted_gaps(1)]


def run_stage6(pkg, tmp_path):
    s6, t = mod(pkg, "stages.stage6"), mod(pkg, "types")
    aln, s0, s1 = example_alignment(pkg)
    blocks = np.arange(48, dtype=np.int32).reshape(6, 8)
    return [s6.render_text(aln, s0, s1), s6.render_text(aln, s0, s1, 40),
            s6.render_histogram(aln, s0, s1),
            dataclasses.asdict(s6.recheck(aln, s0, s1, t.ScoreParams())),
            sorted(s6.FORMATS),
            mod(pkg, "stages.svg").render_svg(aln, len(s0), len(s1),
                                              blocks=blocks)]


def run_rowcodec(pkg):
    rc = mod(pkg, "io.rowcodec")
    rng = np.random.default_rng(51)
    h = np.cumsum(rng.integers(-3, 4, 500)).astype(np.int64)
    h[[40, 300]] += 100000
    f = h - rng.integers(0, 9, 500)
    return {c: rc.encode_row(c, h, f) for c in rc.CODECS}


def run_cells(pkg, tmp_path):
    c, t = mod(pkg, "io.cells"), mod(pkg, "types")
    rng = np.random.default_rng(61)
    h = rng.integers(-50, 50, 300).astype(np.int32)
    g = rng.integers(-50, 50, 300).astype(np.int32)
    path = os.path.join(tmp_path, "border.bin")
    w = c.open_writer("file://" + path)
    for k in range(0, 300, 64):
        w.write(h[k:k + 64], g[k:k + 64])
    w.close()
    with open(path, "rb") as fh:
        raw = fh.read()
    r = c.BufferedCellsReader(c.open_reader("file://" + path), chunk=50)
    got = [r.read(n) for n in (1, 99, 200)]
    r.close()
    init = c.InitialCellsReader(t.InitType.WITH_GAPS, t.ScoreParams())
    init.seek(3)
    rev = c.ReversedCellsReader(c.MemoryCellsReader(h, g), 300)
    return [raw, got, init.read(9), rev.read(17),
            c.SplitCellsReader(c.MemoryCellsReader(h, g), 10, 30).read(30),
            c.DummyCellsReader().read(4)]


def run_crosspoints(pkg, tmp_path):
    cf, t = mod(pkg, "core.crosspoints"), mod(pkg, "types")
    path = os.path.join(tmp_path, "cp.bin")
    f = cf.CrosspointsFile(path)
    f.set_autosave()
    rng = np.random.default_rng(71)
    pts = np.sort(rng.integers(0, 5000, (12, 2)), axis=0)
    for k, (i, j) in enumerate(pts):
        f.write(t.Crosspoint(int(i), int(j), 3 * k, k % 3))
    f.close()
    with open(path, "rb") as fh:
        raw = fh.read()
    g = cf.CrosspointsFile(path)
    return [raw, g.load(), g.reversed_(5000, 5000), g.largest_partition()]


def run_status(pkg, tmp_path):
    st = mod(pkg, "core.status")
    path = os.path.join(tmp_path, "status")
    s = st.Status(path)
    s.update(stage=2)
    s.update(stage=3)
    with open(path, "rb") as fh:
        raw = fh.read()
    again = st.Status(path)
    return [raw, {k: v for k, v in vars(again).items() if k != "path"}]


def run_best_score(pkg):
    bs = mod(pkg, "core.best_score")
    rng = np.random.default_rng(81)
    lst = bs.BestScoreList(limit=4, min_score=10, min_distance=16)
    added = [lst.add(int(i), int(j), int(s)) for i, j, s in
             rng.integers(0, 200, (60, 3))]
    return [added, list(lst), lst.best, len(lst)]


def run_blocks_file(pkg, tmp_path):
    bf = mod(pkg, "core.blocks_file")
    path = os.path.join(tmp_path, "blocks")
    f = bf.BlocksFile(path)
    rng = np.random.default_rng(91)
    for _ in range(9):
        f.add_row(rng.integers(0, 999, 13).astype(np.int32))
    f.save()
    with open(path, "rb") as fh:
        raw = fh.read()
    return [raw, bf.BlocksFile.load(path), f.reduce(4, 5)]


def run_pruning(pkg):
    pr, t = mod(pkg, "core.pruning"), mod(pkg, "types")
    rng = np.random.default_rng(101)
    bus = rng.integers(0, 300, 4096)
    mx = pr.chunk_maxima(bus, 16, 256)
    p = t.ScoreParams()
    out = [mx]
    for best, done in ((250, 100), (900, 2000), (2500, 3500)):
        out.append(pr.pruning_window(mx, best, done, 4096, 4096, 256, p))
    g = pr.BlockPruningGeneric(4096, 4096, p)
    g.update_best(1500)
    out.append([g.is_prunable(3000, 200, 10), g.is_prunable(100, 100, 10)])
    return out


def run_capabilities(pkg):
    return dataclasses.asdict(
        mod(pkg, "core.capabilities").AlignerCapabilities())


def run_pool(pkg, tmp_path):
    pl, t = mod(pkg, "parallel.pool"), mod(pkg, "types")
    shared = os.path.join(tmp_path, "shared")
    os.makedirs(shared)
    a = pl.AlignerPool(shared, 0, 2)
    b = pl.AlignerPool(shared, 1, 2)
    a.dispatch_score(t.BestScore(4, 5, 60))
    b.dispatch_crosspoint(t.Crosspoint(7, 8, 9, 2), True)
    src = os.path.join(tmp_path, "payload.bin")
    with open(src, "wb") as fh:
        fh.write(b"cells")  # read back as text by the pool
    b.dispatch_file(src, "rows")
    listing = {}
    for root, _, files in os.walk(shared):
        for name in files:
            with open(os.path.join(root, name), "rb") as fh:
                listing[os.path.relpath(os.path.join(root, name),
                                        shared)] = fh.read()
    os.makedirs(os.path.join(tmp_path, "in"))
    got = a.receive_file("rows", os.path.join(tmp_path, "in"))
    return [listing, b.receive_score(), a.receive_crosspoint(),
            os.path.basename(got), a.is_first_node(), b.is_last_node()]


def run_config(pkg, tmp_path):
    cfg, job = mod(pkg, "utils.config"), mod(pkg, "core.job")
    path = os.path.join(tmp_path, "masa.cfg")
    with open(path, "w") as fh:
        fh.write("[global]\nram_size = 64M\ndisk_size = 2G\n"
                 "[stage4]\nmaximum_partition = 32\n"
                 "strategy = ORTHOGONAL\n[stage5]\nmax_cells = 4096\n")
    jc = job.JobConfig(work_dir=os.path.join(tmp_path, "w"))
    loaded = cfg.load_config(path)
    cfg.apply_to_job_config(loaded, jc)
    d = dataclasses.asdict(jc)
    d.pop("work_dir")
    return [dataclasses.asdict(loaded), d, cfg.parse_size("3K"),
            cfg.parse_size("1.5G")]


def run_timer(pkg):
    tm = mod(pkg, "utils.timer")
    t = tm.Timer()
    names = [t.create_event(n) for n in ("load", "stage1")]
    t.init()
    for n in names:
        assert t.event_record(n) >= 0
    buf = io.StringIO()
    t.print_statistics(buf, cells=1000)
    ticks = []
    with tm.RecurrentTimer(0.01, lambda: ticks.append(1)):
        import time
        time.sleep(0.05)
    vm = mod(pkg, "utils.memory").process_vm_size()
    # the times differ run to run: compare the report's labels only
    return [names, [ln.split(":")[0].strip()
                    for ln in buf.getvalue().splitlines()],
            bool(ticks), vm > 0]


def run_sra(pkg, tmp_path):
    sra = mod(pkg, "core.sra")
    rng = np.random.default_rng(111)
    area = sra.SpecialRowsArea(os.path.join(tmp_path, "area"), ram_limit=0,
                               disk_limit=1 << 20, codec="4bit")
    part = area.create_partition(0, 0, 400, 256)
    rows = {}
    for r in (64, 128, 192):
        h = np.cumsum(rng.integers(-3, 4, 257)).astype(np.int64)
        rows[r] = (h, h - 5)
        part.put(r, *rows[r])
    part.finalize()
    listing = {}
    for root, _, files in os.walk(os.path.join(tmp_path, "area")):
        for name in sorted(files):
            with open(os.path.join(root, name), "rb") as fh:
                listing[os.path.relpath(os.path.join(root, name),
                                        tmp_path)] = fh.read()
    again = sra.SpecialRowsArea(os.path.join(tmp_path, "area"), ram_limit=0,
                                disk_limit=1 << 20, codec="4bit")
    p2 = again.open_partition(400, 256)
    return [listing, sorted(part.rows()), part.get(128),
            part.get_window(192, 10, 40), sorted(p2.rows()),
            p2.next_below(190), p2.last_row()]


def run_job_manager(pkg, tmp_path):
    """Job (flush ladder, info check, files) and AlignerManager (border
    synthesis, dispatch funnel, goal matching) driven by hand."""
    job, mg, t = mod(pkg, "core.job"), mod(pkg, "core.manager"), \
        mod(pkg, "types")
    kw = {"device": "cpu"} if pkg is masa_tpu_torch else {}
    j = job.Job(job.JobConfig(work_dir=os.path.join(tmp_path, "w"),
                              ram_limit=1 << 16, disk_limit=1 << 20),
                "aa", "bb", **kw)
    ladder = [j.calculate_flush_intervals(50000, 40000, align_to=a)
              for a in (1, 512)]
    j.status.update(stage=1)
    files = sorted(os.path.relpath(os.path.join(r, f), j.dir)
                   for r, _, fs in os.walk(j.dir) for f in fs)

    class Aligner:
        def set_manager(self, manager):
            self.manager = manager

    m = mg.AlignerManager(Aligner(), t.ScoreParams())
    m.first_col_init = t.InitType.WITH_GAPS
    borders = m._col_borders(12)
    return [ladder, files, borders, m._col_border(7)]


def run_grid(pkg):
    g, t = mod(pkg, "core.grid"), mod(pkg, "types")
    p = t.Partition(3, 4, 203, 154)
    out = [g.split_evenly(10, 3), g.split_evenly(2, 5), g.split_evenly(0, 2)]
    for grid in (g.Grid.with_block_size(p, 64, 48),
                 g.Grid.with_block_count(p, 3, 7), g.Grid(p)):
        out.append([grid.splits_i, grid.splits_j, grid.nbi, grid.nbj,
                    grid.block(grid.nbi - 1, grid.nbj - 1),
                    grid.block_of(100, 100), grid.block_of(0, 0),
                    grid.block_of(999, 999)])
    return out


def run_block_aligner(pkg):
    """A pruned SW partition and a CUSTOM-border NW one through the block
    aligner (behind the lock wrapper) under the package's own manager."""
    ba, mg, t = (mod(pkg, "core.block_aligner"), mod(pkg, "core.manager"),
                 mod(pkg, "types"))
    o, sc = mod(pkg, "ops.oracle"), mod(pkg, "stages.core")
    s0, s1 = pair(13, 300, 280, rate=0.05)
    out = []
    dense = o.dp_matrix(s0, s1, t.ScoreParams(),
                        t.Recurrence.NEEDLEMAN_WUNSCH, t.InitType.WITH_GAPS,
                        t.InitType.WITH_GAPS)
    for rec, part, row, col, prune in (
            (t.Recurrence.SMITH_WATERMAN, (0, 0, 300, 280),
             (t.InitType.WITH_ZEROES, None), (t.InitType.WITH_ZEROES, None),
             True),
            (t.Recurrence.NEEDLEMAN_WUNSCH, (50, 60, 300, 280),
             (t.InitType.CUSTOM, (dense.h[50, 60:], dense.f[50, 60:])),
             (t.InitType.CUSTOM, (dense.h[50:, 60], dense.e[50:, 60])),
             False)):
        al = ba.SafeAligner(ba.BlockAligner(block_height=48, block_width=56))
        mgr = mg.AlignerManager(al, t.ScoreParams())
        mgr.set_recurrence_type(rec)
        mgr.set_first_row(*row)
        mgr.set_first_column(*col)
        mgr.last_column_wanted = True
        store = sc.SpecialRowStore()
        mgr.set_special_rows_store(store)
        mgr.set_special_row_interval(96)
        mgr.set_block_pruning(prune)
        al.set_sequences(s0, s1)
        mgr.align_partition(t.Partition(*part))
        out.append([{r: store.get(r) for r in store.rows()}, mgr.last_row,
                    mgr.last_column, list(mgr.best_scores), al.stats.cells,
                    al.stats.pruned_cells,
                    dataclasses.asdict(al.get_capabilities())])
    assert out[0][5] > 0  # the SW case did prune
    return out


def run_netring(pkg):
    """Three nodes on OS-picked ports: join, gossip, the token, a score and
    a status query (bounded: the module's calls time out after 5 s)."""
    nr = mod(pkg, "parallel.netring")
    nodes = [nr.NetRing(k) for k in (4, 2, 9)]
    try:
        for n in nodes[1:]:
            n.join(*nodes[0].addr)
        for n in nodes:
            n.discover()
        nodes[2].notify_score(7, 8, 90)
        nodes[1].stage = 3
        return [[sorted(n.peers) for n in nodes],
                nodes[0].ring_test(timeout=5.0),
                nodes[1].ring_test(timeout=5.0),
                [tuple(n.best_score) for n in nodes], nodes[0].status_of(2),
                nodes[0]._call(nodes[1].addr, {"cmd": "NOPE"})]
    finally:
        for n in nodes:
            n.close()


CASES = {
    "core.grid": run_grid, "core.block_aligner": run_block_aligner,
    "parallel.netring": run_netring,
    "types": run_types, "models.scoring": run_scoring,
    "ops.oracle": run_oracle, "ops.smallsw": run_smallsw,
    "native.bindings": run_native, "io.rowcodec": run_rowcodec,
    "core.best_score": run_best_score, "core.pruning": run_pruning,
    "core.capabilities": run_capabilities, "utils.timer": run_timer,
}
CASES_TMP = {
    "biology.sequence": run_sequence, "biology.alignment": run_alignment,
    "stages.stage6": run_stage6, "io.cells": run_cells,
    "core.crosspoints": run_crosspoints, "core.status": run_status,
    "core.blocks_file": run_blocks_file, "parallel.pool": run_pool,
    "utils.config": run_config, "core.sra": run_sra,
    "core.job+manager": run_job_manager,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_copy_equals_reference(name):
    ref, got = (plain(CASES[name](pkg)) for pkg in BOTH)
    assert got == ref


@pytest.mark.parametrize("name", sorted(CASES_TMP))
def test_copy_equals_reference_files(name, tmp_path):
    out = []
    for pkg in BOTH:
        d = tmp_path / pkg.__name__
        d.mkdir()
        out.append(plain(CASES_TMP[name](pkg, str(d))))
    assert out[1] == out[0]


@pytest.mark.parametrize("enc,dec", [BOTH, BOTH[::-1]],
                         ids=["ref-to-port", "port-to-ref"])
def test_rowcodec_crosses_packages(enc, dec):
    """A row encoded by one package decodes in the other to the row."""
    rng = np.random.default_rng(7)
    h = np.cumsum(rng.integers(-3, 4, 333)).astype(np.int64)
    f = h - rng.integers(0, 9, 333)
    e, d = mod(enc, "io.rowcodec"), mod(dec, "io.rowcodec")
    for codec in e.CODECS:
        gh, gf = d.decode_row(codec, e.encode_row(codec, h, f), 333)
        assert np.array_equal(gh, h) and np.array_equal(gf, f), codec


@pytest.mark.parametrize("wr,rd", [BOTH, BOTH[::-1]],
                         ids=["ref-to-port", "port-to-ref"])
def test_files_cross_packages(wr, rd, tmp_path):
    """A crosspoint file, a cell stream and a CGFF alignment written by
    one package read back in the other."""
    t = mod(wr, "types")
    path = str(tmp_path / "cp.bin")
    f = mod(wr, "core.crosspoints").CrosspointsFile(path)
    cps = [t.Crosspoint(0, 0, 0), t.Crosspoint(9, 8, 5, 1),
           t.Crosspoint(30, 31, 22, 2)]
    for c in cps:
        f.write(c)
    f.save()
    got = mod(rd, "core.crosspoints").CrosspointsFile(path).load()
    assert [tuple(int(x) for x in c) for c in got] \
        == [tuple(int(x) for x in c) for c in cps]
    h = np.arange(50, dtype=np.int32)
    w = mod(wr, "io.cells").open_writer("file://" + str(tmp_path / "c"))
    w.write(h, -h)
    w.close()
    r = mod(rd, "io.cells").open_reader("file://" + str(tmp_path / "c"))
    gh, gg = r.read(50)
    assert np.array_equal(gh, h) and np.array_equal(gg, -h)
    aln, _, _ = example_alignment(wr)
    mod(wr, "biology.alignment").write_cgff(str(tmp_path / "a"), aln)
    back = mod(rd, "biology.alignment").read_cgff(str(tmp_path / "a"))
    assert plain(back.gaps) == plain(aln.gaps)
    assert back.raw_score == aln.raw_score


def test_package_data_ships_every_kernel_source():
    """A non-editable install carries every file the kernels build from:
    each file under masa_tpu_torch/csrc/ (the header the three kernel
    sources include, too) and the native source match a package-data
    glob of pyproject.toml."""
    import fnmatch
    import tomllib

    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "pyproject.toml"), "rb") as fh:
        globs = tomllib.load(fh)["tool"]["setuptools"]["package-data"][
            "masa_tpu_torch"]
    top = os.path.dirname(masa_tpu_torch.__file__)
    files = [os.path.relpath(os.path.join(d, f), top)
             for sub in ("csrc", "native")
             for d, _, fs in os.walk(os.path.join(top, sub)) for f in fs
             if not f.endswith((".py", ".pyc"))]
    assert "csrc/gotoh_cell.cuh" in files and "native/masanative.cpp" \
        in files
    assert [f for f in files
            if not any(fnmatch.fnmatch(f, g) for g in globs)] == []


def test_version_is_the_projects():
    """``masa_tpu_torch.__version__`` is the project's, as masa_tpu's."""
    import re

    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "pyproject.toml")) as fh:
        project = re.search(r'^version\s*=\s*"([^"]+)"', fh.read(), re.M)
    assert masa_tpu_torch.__version__ == masa_tpu.__version__ \
        == project.group(1) == "0.3.0"


def test_convert_round_trips():
    """masa_tpu values -> the port's -> masa_tpu's again, and each side's
    value is of its own package's class."""
    jt, pt = masa_tpu.types, masa_tpu_torch.types
    aln, _, _ = example_alignment(masa_tpu)
    values = [jt.ScoreParams(2, -1, 4, 1), jt.Partition(1, 2, 30, 40),
              jt.Crosspoint(5, 6, 7, jt.CrosspointType.GAP_2),
              jt.BestScore(9, 8, 70), jt.MatchResult(True, 3, 4, 1),
              jt.InitType.CUSTOM, jt.Recurrence.NEEDLEMAN_WUNSCH,
              jt.AlignmentStart.SEQUENCE_1_OR_2, jt.CrosspointType.GAP_1,
              jt.StartType.GAP_1 if hasattr(jt.StartType, "GAP_1")
              else list(jt.StartType)[0], jt.MatchType.GAPPED,
              [jt.Crosspoint(0, 0, 0)], {"best": (jt.BestScore(1, 1, 1),)},
              aln, aln.sequences[0], 7, "text", None]
    for v in values:
        p = convert.to_port(v)
        back = convert.to_ref(p, *REF)
        assert plain(back) == plain(v) == plain(p)
        assert type(back) is type(v)
        if type(v).__module__.startswith("masa_tpu."):
            assert type(p).__module__ == type(v).__module__.replace(
                "masa_tpu.", "masa_tpu_torch.", 1)
            assert type(p) is not type(v)
    assert convert.to_port(jt.ScoreParams()) == pt.ScoreParams()
    assert convert.to_port(jt.ScoreParams()) != jt.ScoreParams()
    assert convert.to_port(jt.InitType.CUSTOM) is pt.InitType.CUSTOM
    arr = np.arange(4)
    assert convert.to_port(arr) is arr


def test_port_entry_points_take_port_types():
    """``align`` with the port's ScoreParams and enums, against the
    reference's oracle fed the converted values."""
    s0, s1 = pair(3, 400, 380)
    p = masa_tpu_torch.ScoreParams(2, -1, 3, 1)
    aln = masa_tpu_torch.align(s0, s1, **dataclasses.asdict(p),
                               device="cpu")
    ref = masa_tpu.ops.oracle.dp_rows(s0, s1, convert.to_ref(p, *REF))
    assert aln.raw_score == ref.best
    assert type(aln).__module__ == "masa_tpu_torch.biology.alignment"


def test_device_helpers_match_masa_tpu(monkeypatch):
    """utils/devices against masa_tpu's on the CPU: the device listing's
    format (masa_tpu lists the conftest's 8 CPU devices, the port its one
    CPU), uniform weights, and ``get_fork_weights`` cycling them over the
    forks (masa_tpu's probe times 8 virtual CPU devices, so both are held
    to their uniform weights here)."""
    import masa_tpu.core.aligner
    import masa_tpu.utils.devices as jdev
    from masa_tpu_torch.core import aligner, block_aligner
    from masa_tpu_torch.utils import devices

    mine = devices.format_device_list().splitlines()
    ref = jdev.format_device_list().splitlines()
    assert mine[0] == ref[0] and mine[-1] == ref[1] \
        == "  [0] cpu cpu (process 0)"
    assert devices.device_weights() == jdev.device_weights()[:1] == [1.0]
    assert devices.device_weights(probe=True) == [1.0]  # no CUDA card
    uniform = jdev.device_weights
    monkeypatch.setattr(jdev, "device_weights",
                        lambda probe=False, reps=3: uniform())
    got = aligner.CPUAligner().get_fork_weights(5)
    assert got == masa_tpu.core.aligner.CPUAligner().get_fork_weights(5) \
        == [1.0] * 5
    assert block_aligner.SafeAligner(aligner.CPUAligner()) \
        .get_fork_weights(3) == [1.0] * 3
    assert devices.select_device(3, "cpu").type == "cpu"
