"""The port's column split against masa_tpu's, on the CPU: run_partition
with a streamed border and last column, slab stage 1 with its special
rows, the serial and threaded splits, the pipelined and speculative slab
tracebacks, and the oversize split.  masa_tpu runs as its own tests run it
(the scan backend, 512-row strips); the port runs the plain strips.
Inputs from numpy seeds; tolerance: exact equality (integer DP)."""

import socket

import numpy as np
import pytest

from masa_tpu.io import cells as cio
from masa_tpu.ops import oracle
from masa_tpu.ops import strips as jstrips
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.parallel import split as jsplit
from masa_tpu.stages import stage6 as jstage6
from masa_tpu.types import InitType, Recurrence, ScoreParams
from masa_tpu_torch import convert
from masa_tpu_torch.io import cells as pcio
from masa_tpu_torch.ops import strips
from masa_tpu_torch.ops import wavefront as wf
from masa_tpu_torch.parallel import split
from masa_tpu_torch.stages import core, stage6

P = ScoreParams()
PP = convert.to_port(P)  # the port takes its own types
port = convert.to_port
JCFG = WavefrontConfig(alpha=4, rs=1, chunk=128, track_best=True)  # 512 rows


def free_base(n: int) -> int:
    """A port p with p .. p+n-1 free on localhost, picked by the OS."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        socks = []
        try:
            for port in range(base, base + n):
                t = socket.socket()
                socks.append(t)
                t.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()


class ListWriter(cio.CellsWriter):
    def __init__(self):
        self.h, self.g = [], []

    def write(self, h, g):
        self.h.append(np.array(h, np.int32))
        self.g.append(np.array(g, np.int32))


def left_border(s0, left):
    """The last column (H, E) of a slab left of the partition: the border
    a streamed reader delivers."""
    ref = oracle.dp_rows(s0, left, P)
    return ref.col_h[1:].astype(np.int32), ref.col_e[1:].astype(np.int32)


def slab_parts(mod, cfg, s0, s1, nparts, work_dir, special_every):
    work_dir.mkdir()
    points = mod.split_points(len(s1), [1.0] * nparts)
    urls = mod.auto_urls(str(work_dir), nparts)
    kw = {"device": "cpu"} if mod is split else {"backend": "scan"}
    return [mod.run_part_stage1(
        s0, s1, k, points, PP if mod is split else P, cfg,
        load_url=urls[k - 1] if k > 0 else None,
        flush_url=urls[k] if k < nparts - 1 else None,
        buffered=False, special_every=special_every, **kw,
    ) for k in range(nparts)]


def assert_parts_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.best, g.best_i, g.best_j, g.cells, g.j0, g.j1) == (
            r.best, r.best_i, r.best_j, r.cells, r.j0, r.j1)
        np.testing.assert_array_equal(g.last_h, r.last_h)
        np.testing.assert_array_equal(g.last_f, r.last_f)
        assert (g.first_col is None) == (r.first_col is None)
        if r.first_col is not None:
            np.testing.assert_array_equal(g.first_col[0], r.first_col[0])
            np.testing.assert_array_equal(g.first_col[1], r.first_col[1])
        assert (g.specials is None) == (r.specials is None)
        if r.specials is not None:
            assert g.specials.rows() == r.specials.rows()
            for row in r.specials.rows():
                for x, y in zip(g.specials.get(row), r.specials.get(row)):
                    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("port_rows", [512, 2048], ids=["strip", "launch"])
def test_run_partition_streamed_border(dna, homolog, port_rows):
    """A CUSTOM left border read from a stream and the last column written
    to one: every PartitionResult field, and the written column, equal
    masa_tpu's.  The port's 2048-row strips read 2048 border rows a launch
    and flush rows 512..1536 inside it."""
    s0 = dna(2300, seed=11)
    s1 = homolog(s0, seed=12)
    left, right = s1[:300], s1[300:700]
    bh, be = left_border(s0, left)
    kw = dict(recurrence=Recurrence.SMITH_WATERMAN, match=P.match,
              mismatch=P.mismatch, gap_open=P.gap_open, gap_ext=P.gap_ext,
              track_best=True, store_lastcol=True)
    jw, pw = ListWriter(), ListWriter()
    ref = jstrips.run_partition(
        WavefrontConfig(alpha=4, rs=1, chunk=128, **kw), s0, right, P,
        InitType.WITH_ZEROES, InitType.CUSTOM, backend="scan",
        special_every=512, first_col_reader=cio.MemoryCellsReader(bh, be),
        lastcol_writer=jw)
    got = strips.run_partition(
        wf.StripConfig(rows=port_rows, **port(kw)), s0, right, PP,
        port(InitType.WITH_ZEROES), port(InitType.CUSTOM), special_every=512,
        first_col_reader=pcio.MemoryCellsReader(bh, be), lastcol_writer=pw)
    assert (got.best, got.best_i, got.best_j, got.cells, got.pruned_cells) \
        == (ref.best, ref.best_i, ref.best_j, ref.cells, ref.pruned_cells)
    for name in ("last_h", "last_f", "col_h", "col_e"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert sorted(got.specials) == sorted(ref.specials) == [512, 1024, 1536,
                                                            2048]
    for r in ref.specials:
        np.testing.assert_array_equal(got.specials[r][0], ref.specials[r][0])
        np.testing.assert_array_equal(got.specials[r][1], ref.specials[r][1])
    np.testing.assert_array_equal(np.concatenate(pw.h), np.concatenate(jw.h))
    np.testing.assert_array_equal(np.concatenate(pw.g), np.concatenate(jw.g))
    # the whole matrix equals the oracle's on the joined columns
    full = oracle.dp_rows(s0, s1[:700], P)
    np.testing.assert_array_equal(got.last_h[1:], full.last_h[301:])


def test_streamed_border_rejects_padding_and_a_lone_writer():
    s0 = np.frombuffer(b"ACGT" * 10, np.uint8)
    cfg = wf.StripConfig(rows=16)
    reader = pcio.MemoryCellsReader(np.zeros(40), np.zeros(40))
    with pytest.raises(ValueError, match="exact strip heights"):
        strips.run_partition(cfg, s0, s0, col_init=port(InitType.CUSTOM),
                             first_col_reader=reader, pad_rows=True)
    with pytest.raises(ValueError, match="store_lastcol"):
        strips.run_partition(cfg, s0, s0, lastcol_writer=ListWriter())


@pytest.mark.parametrize("port_rows", [512, 2048], ids=["strip", "launch"])
def test_part_stage1_matches(dna, homolog, tmp_path, port_rows):
    """Three slabs with special rows every 512: every part equals
    masa_tpu's, the border column read and each special row's column 0
    included.  With 2048-row launches the rows 512, 1024 and 1536 are
    flushed inside a launch whose border was read to row 2048, so column
    0 must come from the border at the row itself."""
    s0 = dna(2300, seed=21)
    s1 = homolog(s0, seed=22)[:900]
    ref = slab_parts(jsplit, JCFG, s0, s1, 3, tmp_path / "ref", 512)
    got = slab_parts(split, wf.StripConfig(rows=port_rows), s0, s1, 3,
                     tmp_path / "port", 512)
    assert_parts_equal(got, ref)
    # the value at the launch's last row would differ from it
    col = ref[1].first_col[0]
    assert any(ref[1].specials.get(r)[0][0] != col[2048]
               for r in (512, 1024, 1536))


@pytest.mark.parametrize("nparts", [2, 3])
def test_serial_split_matches_oracle(dna, homolog, tmp_path, nparts):
    s0 = dna(700, seed=121)
    s1 = homolog(s0, seed=122)
    parts = split.run_split_serial(s0, s1, nparts, str(tmp_path), PP,
                                   wf.StripConfig(rows=512), device="cpu")
    ref = oracle.dp_rows(s0, s1, P)
    assert max(p.best for p in parts) == ref.best
    np.testing.assert_array_equal(np.concatenate([p.last_h for p in parts]),
                                  ref.last_h[1:])
    (tmp_path / "ref").mkdir()
    want = jsplit.run_split_serial(s0, s1, nparts, str(tmp_path / "ref"), P,
                                   JCFG)
    assert [(p.best, p.best_i, p.best_j) for p in parts] == [
        (p.best, p.best_i, p.best_j) for p in want]


def test_split_threads_over_sockets(dna, homolog):
    s0 = dna(600, seed=123)
    s1 = homolog(s0, seed=124)
    parts = split.run_split_threads(s0, s1, 3, PP, wf.StripConfig(rows=256),
                                    base_port=free_base(2), device="cpu")
    ref = oracle.dp_rows(s0, s1, P)
    assert max(p.best for p in parts) == ref.best
    np.testing.assert_array_equal(np.concatenate([p.last_h for p in parts]),
                                  ref.last_h[1:])


@pytest.mark.parametrize("nparts", [2, 3])
def test_pipelined_traceback_matches(dna, homolog, tmp_path, nparts):
    """The slab-by-slab stage 2: masa_tpu's crosspoints, the oracle's
    score, and stages 3 and 5 on them give the exact alignment."""
    from masa_tpu_torch.stages import pipeline

    s0 = dna(1300, seed=131)
    s1 = homolog(s0, seed=132)
    ref = slab_parts(jsplit, JCFG, s0, s1, nparts, tmp_path / "ref", 512)
    got = slab_parts(split, None, s0, s1, nparts, tmp_path / "port", 512)
    cps = split.pipelined_traceback(s0, s1, got, PP, device="cpu")
    assert cps == jsplit.pipelined_traceback(s0, s1, ref, P)
    best = oracle.dp_rows(s0, s1, P).best
    assert cps[-1].score == best and cps[0].score == 0
    assert any(0 < c.j and c.j in {p.j0 for p in got} for c in cps), \
        "the path should cross a slab border"
    pcfg = pipeline.PipelineConfig(max_cells_stage5=1 << 14, device="cpu")
    aln = pipeline.stage5_emit(s0, s1, pcfg,
                               pipeline.stage3_densify(s0, s1, pcfg, cps))
    assert stage6.recheck(aln, s0, s1, PP).score == aln.raw_score == best


@pytest.mark.parametrize("case", ["reuse", "miss"])
def test_speculative_traceback_matches(dna, homolog, tmp_path, case):
    """Identical sequences: every slab's own best is on the optimal path,
    so speculation is spliced; a far homolog: speculation misses.  The
    crosspoints and the reused count equal masa_tpu's."""
    s0 = dna(900, seed=151 if case == "reuse" else 153)
    s1 = (s0.copy() if case == "reuse" else
          homolog(s0, seed=154, sub_rate=0.3, indel_rate=0.15))
    ref = slab_parts(jsplit, JCFG, s0, s1, 3, tmp_path / "ref", 512)
    got = slab_parts(split, None, s0, s1, 3, tmp_path / "port", 512)
    cps, reused = split.speculative_traceback(s0, s1, got, PP,
                                                 device="cpu")
    want, want_reused = jsplit.speculative_traceback(s0, s1, ref, P)
    assert (cps, reused) == (want, want_reused)
    assert (reused > 0) == (case == "reuse")
    assert cps[-1].score == oracle.dp_rows(s0, s1, P).best
    # the speculative march works on a copy: the stores are still whole
    assert got[0].specials.rows() == ref[0].specials.rows()


def test_align_oversize_matches(dna, homolog, tmp_path):
    s0 = dna(700, seed=41)
    s1 = homolog(s0, seed=42)
    (tmp_path / "port").mkdir()
    best, aln = split.align_oversize(
        s0, s1, max_width=256, work_dir=str(tmp_path / "port"), params=PP,
        max_cells_stage5=1 << 14, device="cpu")
    (tmp_path / "ref").mkdir()
    want_best, want = jsplit.align_oversize(
        s0, s1, max_width=256, work_dir=str(tmp_path / "ref"), params=P,
        cfg=JCFG, max_cells_stage5=1 << 14)
    ref = oracle.dp_rows(s0, s1, P)
    assert best == want_best == aln.raw_score == ref.best
    assert stage6.render_text(aln, s0, s1) == jstage6.render_text(want, s0,
                                                                  s1)


def test_slab_interval():
    """The special-row cadence of a slab kept in RAM: the CPU strip
    height (masa_tpu's 512 rows), and on a CUDA device, where one launch
    covers the slab, the interval that fits the byte limit."""
    assert split.slab_interval(3000, 1500, "cpu") == 512
    assert split.slab_interval(3000, 1500, "cpu",
                               wf.StripConfig(rows=2048)) == 2048
    # 2^20 rows x 2^19 columns x 8 B in 1 GiB: every 4097 rows, to 4608
    assert split.slab_interval(1 << 20, 1 << 19, "cuda") == 4608
    assert core.default_config("cuda").rows == 1 << 22
    assert split.slab_interval(1 << 20, 1 << 19, "cuda",
                               limit=1 << 32) == 1536
