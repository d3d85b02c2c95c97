"""The port's chromosome-scale tool (``python -m
masa_tpu_torch.tools.big_run``) against masa_tpu, on the CPU.

Its pairs are the repository's ``tools/big_run.py`` draws, rebuilt here
from bench.py's ``homolog`` and numpy's ``rng(0)``, ``rng(1)`` and
``rng(2)`` at reduced m.  Its work-directory contract is the reference's:
a stale or finished directory is cleared, a crashed attempt resumes and
the line sums the attempts' seconds.  At ``--device cpu`` on a small pair
padded as at 23M, at the 23M run's JobConfig (several special rows), its
score, stage-2 and stage-4 crosspoint files and alignment equal
masa_tpu's ``runner.align_job`` with the same JobConfig, byte for byte;
its line carries every key of the reference's but the two Mosaic compile
keys.  A chained stage-2 march whose row cache kept only the last rows
(the rest read as cut windows, as at 23M on the card) gives the host
march's crosspoints and masa_tpu's.  The shape rules give the 5M run's
hop one launch and the 23M run's three on the H100's 132 SMs, and size
the big launches with no wrap.  Stage 5 asks ``shutil.which`` once.
Tolerance 0 throughout."""

import ast
import contextlib
import copy
import importlib.util
import io
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from masa_tpu.core.job import Job as JJob, JobConfig as JJobConfig
from masa_tpu.stages import core as jcore
from masa_tpu.stages import runner as jrunner
from masa_tpu.types import (AlignmentStart as JStart,
                            Crosspoint as JCrosspoint,
                            CrosspointType as JType, InitType as JInit,
                            ScoreParams)
from masa_tpu_torch.core.crosspoints import CrosspointsFile
from masa_tpu_torch.core.job import Job, JobConfig
from masa_tpu_torch.native import bindings
from masa_tpu_torch.ops import kernels, oracle, strips
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.stages import core, pipeline, runner
from masa_tpu_torch.tools import big_run, pairs
from masa_tpu_torch.types import (AlignmentStart, Crosspoint,
                                  CrosspointType, InitType, Recurrence)
from masa_tpu_torch.types import ScoreParams as PortScoreParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = ScoreParams()          # masa_tpu's
PP = PortScoreParams()     # the port's
H100_SMS = 132
# the small run: padded as at 23M (n > m), at the 23M run's JobConfig
# (64 GiB of disk): a special row every 512 rows (the grain), three rows
# and four hops
M, N = 2048, 2560
ARGV = ["23M", "--device", "cpu"]
FILES = ["crosspoints/crosspoint_02.00", "crosspoints/crosspoint_04.00",
         "alignment.00.txt"]


def reference_bench():
    """The repository's bench.py as a module (its ``homolog``)."""
    spec = importlib.util.spec_from_file_location(
        "reference_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_keys():
    """The keys of the line the repository's tools/big_run.py prints: the
    string keys of the dictionary inside its ``json.dumps`` call."""
    with open(os.path.join(REPO, "tools", "big_run.py")) as fh:
        tree = ast.parse(fh.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  "") == "dumps":
            for d in ast.walk(node):
                if isinstance(d, ast.Dict):
                    keys |= {k.value for k in d.keys
                             if isinstance(k, ast.Constant)}
    return keys


def run_tool(argv, score=None):
    """``big_run.main(argv)`` in-process, its 23M pair cut to M x N bases
    (``pairs.SIZES``, ``PADDED``; ``SCORES`` gets ``score``, else loses the
    size): its exit code, stdout lines and last-line JSON (None when it
    printed nothing)."""
    buf = io.StringIO()
    scores = {k: v for k, v in pairs.SCORES.items() if k != "23M"}
    if score is not None:
        scores["23M"] = score
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(buf):
        mp.setitem(pairs.SIZES, "23M", M)
        mp.setitem(pairs.PADDED, "23M", N)
        mp.setattr(pairs, "SCORES", scores)
        rc = big_run.main(argv)
    lines = buf.getvalue().splitlines()
    return rc, lines, json.loads(lines[-1]) if lines else None


def read(path):
    with open(path, "rb") as fh:
        return fh.read()


# --- the pairs ----------------------------------------------------------


@pytest.mark.parametrize("m,n", [(3 * (1 << 16) + 77, None),
                                 (3 * (1 << 16) + 77, 3 * (1 << 16) + 900),
                                 (1 << 16, 1 << 16)],
                         ids=["5M-like", "23M-like", "no-indel"])
def test_big_pair_is_the_reference_draw(m, n):
    """tools/big_run.py:90-97 rebuilt: s0 rng(0)'s draw, s1
    bench.homolog(rng(1), s0, 1 << 16), padded from rng(2) only where the
    target exceeds m."""
    bench = reference_bench()
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = np.random.default_rng(0).choice(bases, size=m).astype(np.uint8)
    h1 = bench.homolog(np.random.default_rng(1), s0, indel_every=1 << 16)
    target = n if n is not None else m
    if target > m:
        extra = np.random.default_rng(2).choice(
            bases, size=target - len(h1)).astype(np.uint8)
        h1 = np.concatenate([h1, extra])
    got0, got1 = pairs.homolog_pair(m, n)
    assert np.array_equal(got0, s0) and np.array_equal(got1, h1)
    if target > m:
        assert len(got1) == target


def test_big_pair_sizes_and_scores():
    """The sizes and masa_tpu's scores of tools/big_run.py and its
    records; 5M is the record's shape."""
    assert pairs.SIZES == {"1M": 1 << 20, "3M": 3 << 20, "5M": 5 << 20,
                           "8M": 1 << 23, "23M": 23 << 20}
    assert pairs.PADDED == {"23M": 25 << 20}
    assert pairs.SCORES == {"1M": 796634, "5M": 3984627, "23M": 18334019}
    s0, s1 = pairs.big_pair("5M")
    # records/big_run_5M_r5_pruneON_final.log: 5242880 x 5242945
    assert (len(s0), len(s1)) == (5242880, 5242945)


# --- the work directory's contract -------------------------------------


@pytest.mark.parametrize("case", ["stale", "finished", "fresh", "resume",
                                  "absent"])
def test_meta_contract(tmp_path, case):
    """A directory with no meta (this tool did not write it) or a finished
    run's is cleared, and so is any with --fresh; an unfinished run's meta
    is handed back to resume."""
    wd = str(tmp_path / "w")
    said = []
    if case != "absent":
        os.makedirs(wd)
        with open(os.path.join(wd, "status"), "w") as fh:
            fh.write("{}")
    if case in ("finished", "fresh", "resume"):
        big_run.save_meta(wd, "5M", 12.5, 1, case == "finished", {})
    meta = big_run.open_meta(wd, case == "fresh", said.append)
    if case in ("resume",):
        assert meta["elapsed_s"] == 12.5 and meta["attempts"] == 1
        assert os.path.exists(os.path.join(wd, "status")) and not said
    else:
        assert meta is None and not os.path.exists(wd)
        assert bool(said) == (case != "absent")


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """masa_tpu's runner.align_job on the same pair and JobConfig."""
    wd = str(tmp_path_factory.mktemp("ref") / "w")
    s0, s1 = pairs.homolog_pair(M, N)
    job = JJob(JJobConfig(work_dir=wd, disk_limit=64 << 30))
    aln = jrunner.align_job(job, s0, s1, log=lambda *a, **k: None)
    return wd, aln


@pytest.fixture(scope="module")
def tool_run(tmp_path_factory, ref_run):
    """The tool at --device cpu on the small padded pair, fresh, with
    masa_tpu's score on that pair as the size's reference score."""
    wd = str(tmp_path_factory.mktemp("big") / "w")
    rc, lines, got = run_tool(ARGV + ["--work-dir", wd, "--fresh"],
                              score=ref_run[1].raw_score)
    assert rc == 0
    return wd, lines, got


def test_crashed_attempt_resumes_and_sums_its_seconds(tool_run, tmp_path,
                                                      monkeypatch):
    """An attempt that fails in stage 3 leaves its meta (not done, its
    seconds); the same command then resumes (stages 1 and 2 already
    executed), reports two attempts and the sum of both attempts'
    seconds, and writes the uncrashed run's files byte for byte."""
    wd = str(tmp_path / "w")
    real = runner.stage3

    def crash(*a, **k):
        raise RuntimeError("a crash in stage 3")

    monkeypatch.setattr(runner, "stage3", crash)
    with pytest.raises(RuntimeError, match="a crash"):
        run_tool(ARGV + ["--work-dir", wd])
    with open(os.path.join(wd, big_run.META)) as fh:
        meta = json.load(fh)
    assert meta["attempts"] == 1 and not meta["done"]
    assert meta["elapsed_s"] > 0 and "stage2" in meta["marks"]
    monkeypatch.setattr(runner, "stage3", real)
    rc, lines, got = run_tool(ARGV + ["--work-dir", wd])
    assert rc == 0 and got["resumed"] and got["attempts"] == 2
    assert any(line.startswith("[resume] attempt 2") for line in lines)
    assert any("stage2: already executed" in line for line in lines)
    assert got["full_alignment_s"] == pytest.approx(
        meta["elapsed_s"] + got["this_attempt_s"], abs=0.02)
    assert got["score"] == tool_run[2]["score"]
    for f in FILES:
        assert read(os.path.join(wd, f)) == read(
            os.path.join(tool_run[0], f)), f
    # a finished run is cleared, not replayed
    rc, lines, again = run_tool(ARGV + ["--work-dir", wd])
    assert rc == 0 and not again["resumed"] and again["attempts"] == 1
    assert any("the previous run finished" in line for line in lines)


def test_no_card_exits_without_a_line(tmp_path, monkeypatch, capsys):
    """Asked for the card where there is none: exit 2, nothing on
    stdout, the reason on stderr, no work directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wd = str(tmp_path / "w")
    assert big_run.main(["5M", "--work-dir", wd]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err
    assert not os.path.exists(wd)


# --- the tool against masa_tpu ------------------------------------------


def test_tool_scores_as_masa_tpu(tool_run, ref_run):
    _, _, got = tool_run
    assert got["score"] == ref_run[1].raw_score
    assert (got["m"], got["n"]) == (M, N)
    assert got["special_rows"]["flush_interval"] == 512
    rows = got["special_rows"]
    assert rows["ram_rows"] + rows["disk_rows"] == 3 == rows["dev_rows"]
    assert got["reference_score"] == got["score"]


@pytest.mark.parametrize("name", FILES)
def test_tool_files_equal_masa_tpus(tool_run, ref_run, name):
    assert read(os.path.join(tool_run[0], name)) == read(
        os.path.join(ref_run[0], name))


def test_tool_line_keys(tool_run):
    """Every key of the reference's line but Mosaic's compile keys, and
    the port's own; on the CPU no kernel launched and no card."""
    _, lines, got = tool_run
    assert not reference_keys() - {"cold_load_s", "cold_by_stage_s"} \
        - set(got)
    for k in ("card", "build_s", "stage_kernel_ms", "stage_launches",
              "special_rows", "hops", "peak_device_bytes",
              "peak_rss_bytes", "peak_work_dir_bytes"):
        assert k in got, k
    assert set(got["stage_end_marks_s"]) >= {f"stage{k}"
                                              for k in range(1, 7)}
    assert got["card"] is None and got["peak_device_bytes"] is None
    assert got["peak_work_dir_bytes"] >= got["special_rows"]["disk_bytes"]
    assert got["peak_work_dir_bytes"] > 0
    assert got["hops"]["issued"] == (got["hops"]["one_launch"]
                                     + got["hops"]["three_launch"])
    assert all(v == 0 for st in got["stage_launches"].values()
               for v in st.values())
    assert not got["resumed"] and got["attempts"] == 1


# --- a stage 1 resumed below its best ------------------------------------


def best_above_pair():
    """s1 = 1600 bases of ``default_rng(5)``, s0 = s1[:600] and 1000 more
    bases: the best (600 at (600, 600)) lies above row 1024."""
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s1 = rng.choice(bases, 1600).astype(np.uint8)
    s0 = np.concatenate([s1[:600], rng.choice(bases, 1000).astype(np.uint8)])
    return s0, s1


@pytest.fixture(scope="module")
def best_above_ref(tmp_path_factory):
    """masa_tpu's uninterrupted runner.align_job on that pair, a special
    row every 512 rows, all on disk."""
    wd = str(tmp_path_factory.mktemp("above") / "w")
    s0, s1 = best_above_pair()
    job = JJob(JJobConfig(work_dir=wd, ram_limit=0, disk_limit=1 << 17))
    aln = jrunner.align_job(job, s0, s1, log=lambda *a, **k: None)
    return wd, aln


@pytest.mark.parametrize("backend,rows,prune,kills", [
    ("numpy", None, None, (1024,)),
    ("kernel", None, None, (1024,)),
    ("kernel", 2048, None, (1024,)),
    ("kernel", 2048, (64, 2), (1024,)),
    ("kernel", 2048, None, (1024, 1536))],
    ids=["oracle", "strip-ends", "interior-rows", "pruned-launch", "twice"])
def test_stage1_resumed_below_its_best(best_above_ref, tmp_path, backend,
                                       rows, prune, kills):
    """Stage 1 killed once the store holds row 1024 (and, resumed, again
    at 1536), then run to the end: the resumed stage 1 takes the best of
    the rows above its resume row from the status file (written before
    each special row), so its score and its stage-1, -2 and -4 crosspoint
    and alignment files are masa_tpu's uninterrupted run's, byte for
    byte, on the oracle, on 512-row strips (each special row a strip's
    end), on one 2048-row strip (rows 512, 1024, 1536 inside it) and with
    pruning inside that launch.  (masa_tpu's own resumed stage 1 scores
    156 here.)"""
    s0, s1 = best_above_pair()
    kc = (None if rows is None else
          wf.StripConfig(rows=rows, launch_prune=prune))
    wd = str(tmp_path / "w")

    def job():
        return Job(JobConfig(work_dir=wd, ram_limit=0, disk_limit=1 << 17,
                             backend=backend), device="cpu")

    put, put_lazy = runner._OffsetStore.put, runner._OffsetStore.put_lazy
    for kill in kills:
        def dying(self, r, *a, put=put, kill=kill):
            put(self, r, *a)
            if self.offset + r >= kill:
                raise KeyboardInterrupt("killed")

        def dying_lazy(self, r, lazy, kill=kill):
            put_lazy(self, r, lazy)
            if self.offset + r >= kill:
                raise KeyboardInterrupt("killed")

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(runner._OffsetStore, "put", dying)
            mp.setattr(runner._OffsetStore, "put_lazy", dying_lazy)
            with pytest.raises(KeyboardInterrupt):
                runner.stage1(job(), s0, s1, kernel_cfg=kc,
                              log=lambda *a, **k: None)
    msgs = []
    aln = runner.align_job(job(), s0, s1, kernel_cfg=kc, log=msgs.append)
    assert f"stage1: resuming from special row {kills[-1]}" in msgs
    ref_wd, ref = best_above_ref
    assert aln.raw_score == ref.raw_score == 600
    for f in ["crosspoints/crosspoint_01.00"] + FILES:
        assert read(os.path.join(wd, f)) == read(os.path.join(ref_wd, f)), f


@pytest.mark.parametrize("rows,prune", [(512, None), (1024, None),
                                        (2048, None), (2048, (64, 2))],
                         ids=["strip-ends", "two-strips", "one-strip",
                              "pruned"])
def test_special_row_bests_are_the_oracles(rows, prune):
    """``strips.run_partition``'s ``on_special_best`` (the plain strips,
    as on the card the kernel's per-row captures) gives at each special
    row the oracle's best of the rows down to it, the earlier of two
    equal bests (a 300-base repeat ending at rows 300 and 1300: in one
    strip, or the later one in the strip below) kept."""
    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGT", np.uint8)

    def draw(k):
        return rng.choice(bases, k).astype(np.uint8)

    x, y, z = draw(300), draw(700), draw(400)
    z[:16] = y[:16]  # each copy of x extends alike
    s0 = np.concatenate([x, y, x, z])
    s1 = np.concatenate([x, draw(900)])
    got = {}
    cfg = wf.StripConfig(rows=rows, launch_prune=prune)
    res = strips.run_partition(
        cfg, s0, s1, PP, special_every=512, prune=prune is not None,
        on_special_row=lambda *a: None,
        on_special_best=lambda r, i, j, s: got.setdefault(r, (s, i, j)))
    want = {}
    ref = oracle.dp_rows(s0, s1, PP, special_rows=(512, 1024, 1536),
                         row_bests=True, special_best=want)
    assert got == want
    b, i, j = want[1536]
    assert i < 512 and ref.row_best_val[i + 999] == b  # the later copy
    assert (b, i, j) == (res.best, res.best_i, res.best_j)


# --- a march over a row cache that kept only the last rows --------------


@pytest.fixture(scope="module")
def far_run():
    """s1 = 12000 unrelated bases, then a homolog of s0 (6 x 512 + 33
    rows): hop windows of the kernel backend (4096) clear column 0.  The
    port's stage 1 on the plain strips with every row kept, and masa_tpu's
    crosspoints through its NumPy oracle march."""
    rng = np.random.default_rng(1501)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, 6 * 512 + 33).astype(np.uint8)
    s1 = s0.copy()
    flip = rng.random(len(s1)) < 0.08
    s1[flip] = rng.choice(bases, int(flip.sum()))
    s1 = np.concatenate([rng.choice(bases, 12000).astype(np.uint8), s1])
    cache = core.DevRowCache(1 << 30)
    res = core.forward_pass(
        s0, s1, PP, Recurrence.SMITH_WATERMAN, InitType.WITH_ZEROES,
        InitType.WITH_ZEROES, special_every=512, backend="kernel",
        device="cpu", dev_cache=cache)
    jres = jcore.forward_pass(
        s0, s1, P, jcore.Recurrence.SMITH_WATERMAN, JInit.WITH_ZEROES,
        JInit.WITH_ZEROES, special_every=512, backend="numpy")
    ep = JCrosspoint(jres.best_i, jres.best_j, jres.best, JType.MATCH)
    want = jcore.reverse_march(
        s0, s1, P, ep, copy.deepcopy(jres.specials), JInit.WITH_ZEROES,
        JInit.WITH_ZEROES, JStart.ANYWHERE, backend="numpy")
    return s0, s1, res, cache, [tuple(int(x) for x in c) for c in want]


def test_mixed_cache_march_matches_both_host_marches(far_run, monkeypatch):
    """The cache's budget holds the last four of six rows (eviction drops
    the smallest first, as stage 1 fills it top-down): the march chains
    them on the device and reads the two below as cut windows from the
    store, matched on the device (forced here, as on a card), with the
    crosspoints of the port's host march and of masa_tpu's."""
    s0, s1, res, full, want = far_run
    rows = res.specials.rows()
    assert len(rows) == 6
    size = core.DevRowCache._size(full.get(rows[0])[0])
    small = core.DevRowCache(4 * size)
    for r in rows:
        h, f, h0, f0 = full.get(r)
        small.put_dev(r, h, f)
        small.attach_border(r, h0, f0)
    assert sorted(small._rows) == rows[-4:]
    monkeypatch.setattr(core, "_windowed_cut_ok", lambda *a, **k: True)
    ep = Crosspoint(res.best_i, res.best_j, res.best, CrosspointType.MATCH)

    def march(cache, chain, stats):
        got = core.reverse_march(
            s0, s1, PP, ep, res.specials.copy(), InitType.WITH_ZEROES,
            InitType.WITH_ZEROES, AlignmentStart.ANYWHERE, backend="kernel",
            device="cpu", dev_cache=cache, stats=stats, chain=chain)
        return [tuple(int(x) for x in c) for c in got]

    stats, host_stats = core.MarchStats(), core.MarchStats()
    mixed = march(small.copy(), True, stats)
    host = march(None, False, host_stats)
    assert mixed == host == want
    assert stats.chained >= 3 and stats.segments >= 1, stats
    assert stats.window_reads >= 2 and stats.issued_three == 0, stats
    assert host_stats.chained == 0 and host_stats.window_reads >= 5


# --- shapes at chromosome scale -----------------------------------------


def flush_interval(size):
    """The special-row interval of tools/big_run.py's JobConfig at
    ``size``, as the runner aligns it."""
    m = pairs.SIZES[size]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = JobConfig(work_dir=tmp)
        if size == "23M":
            cfg.disk_limit = 64 << 30
        return Job(cfg, device="cpu").calculate_flush_intervals(
            m, pairs.PADDED.get(size, m), align_to=pipeline.FLUSH_GRAIN)[0]


@pytest.mark.parametrize("size,hb,W,one", [("5M", 12288, 32768, True),
                                           ("23M", 72704, 262144, False)])
def test_big_hops_route(size, hb, W, one):
    """The 5M run's hops (12,288 x 32,768) take one launch of the hop
    kernel on an H100 (132 SMs, clusters of 16; on a card of 8, too); the
    23M run's (72,704 x 262,144, past 2^31 cells) fit no cluster, so
    ``wavefront.hop_step`` takes ``hop_three`` there."""
    m = pairs.SIZES[size]
    assert flush_interval(size) == hb
    assert core._hop_window(Crosspoint(m, pairs.PADDED.get(size, m), 0),
                            m - hb, "auto") == W
    for cluster in (kernels.HOP_MAX_CLUSTER, kernels.HOP_PORTABLE_CLUSTER):
        geo = kernels.hop_geometry(hb, W, H100_SMS, cluster)
        assert (geo is not None) == one, geo
    if one:
        assert kernels.hop_geometry(hb, W, H100_SMS, 16) == (8, 4, 12)


def test_stage1_launches_at_chromosome_scale():
    """Stage 1's launches at 5M and 23M: strips of whole intervals whose
    flushed rows fit FLUSH_ROWS_BYTES, so a launch's flat offsets stay
    under 2^28 cells; 2048-row blocks; pruned-cell counts past 2^40 in
    int64."""
    cfg = core.default_config("cuda")
    for size, nj, hb, rows in (("5M", 5242945, 12288, 307200),
                               ("23M", 26214400, 72704, 363520)):
        m = pairs.SIZES[size]
        assert flush_interval(size) == hb
        R = strips.strip_height(cfg, nj, hb)
        assert R == rows and R % hb == 0
        n_int = (R - 1) // hb
        assert 8 * n_int * nj <= strips.FLUSH_ROWS_BYTES
        assert n_int * nj < 1 << 28
        assert kernels.strip_geometry(R, H100_SMS) == (8, 8)
        assert -(-m // R) * R >= m
    rec = wf.PruneRecord(torch.full((178, 2), 26214400, dtype=torch.int32),
                         2048, 132)
    got = rec.pruned_cells(363520)
    assert got == 363520 * 26214400 and got > 1 << 43


def test_batched_tables_at_chromosome_scale():
    """Stage 4's element tables at the 23M run's sizes: 23,552 pairs of
    a level (47,104 halves) with offsets up to 2^25 and a level of tall
    halves that chain sub-strips; the geometry and the item table keep
    every offset, height and width, the sub-strip numbers and counters
    count without a wrap."""
    rng = np.random.default_rng(15)
    B = 2 * 23552
    i0 = np.sort(rng.integers(0, (23 << 20) - 600, B))
    j0 = np.sort(rng.integers(0, (25 << 20) - 600, B))
    h = rng.integers(250, 300, B)
    w = rng.integers(250, 600, B)
    codes = rng.integers(0, 3, (B, 2))
    elems = np.stack([i0, h, j0, w, codes[:, 0], codes[:, 1]],
                     1).astype(np.int32)
    assert elems[:, 0].max() > 1 << 24 and elems[:, 2].max() > 1 << 24
    geo = kernels.batched_geometry(elems[:, 1], H100_SMS)
    items, counters = kernels.batched_items(elems, geo)
    assert counters == 0 and len(items) == B
    assert np.array_equal(items[:, :6], elems[geo.order])
    assert np.array_equal(np.sort(items[:, 6]), np.arange(B))
    # level 1 of the 23M run: 330 pairs, halves of 36,352 rows
    tall = np.array([[k * 72704, 36352, k * 79000, 72704, 1, 1]
                     for k in range(660)], np.int32)
    geo = kernels.batched_geometry(tall[:, 1], H100_SMS)
    items, counters = kernels.batched_items(tall, geo)
    n_sub = -(-36352 // geo.rows)
    assert len(items) == 660 * n_sub and counters == len(items)
    assert np.array_equal(items[:, 7], np.tile(np.arange(n_sub), 660))
    assert np.array_equal(items[:, 8], np.arange(len(items)))
    assert items[:, 0].max() == 659 * 72704
    assert items[:, 2].max() == 659 * 79000


# --- stage 5 decides the native helpers once ----------------------------


def test_stage5_asks_for_the_compiler_once(tool_run, monkeypatch):
    """Stage 5 over the run's 128 partitions asks ``shutil.which`` once
    (``bindings.available`` is decided once a process), and its
    alignment is the run's."""
    wd, _, got = tool_run
    cps = CrosspointsFile(os.path.join(wd, FILES[1])).load()
    assert len(cps) > 100
    calls = []
    which = shutil.which

    def counted(*a, **k):
        calls.append(a)
        return which(*a, **k)

    monkeypatch.setattr(bindings, "_AVAILABLE", None)
    monkeypatch.setattr(bindings.shutil, "which", counted)
    s0, s1 = pairs.homolog_pair(M, N)
    pcfg = pipeline.PipelineConfig(params=PP, device="cpu")
    aln = pipeline.stage5_emit(s0, s1, pcfg, cps, None)
    assert aln.raw_score == got["score"]
    assert len(calls) == 1, len(calls)
    assert bindings.available() == (which("g++") is not None)
    assert len(calls) == 1
