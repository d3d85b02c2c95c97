"""The CLI at the special-row cadence of its own defaults on the 1M pair
(``--ram-size 1G --disk-size 16G``: a row every 512, ``FLUSH_GRAIN``),
on the CPU at a size where small budgets give the same interval, with the
trace switch (``ops.kernels.event_log``) on.

Two pairs through ``cli.main``: a sequence against itself, as the
benchmark's ``cp1m-cli16.full`` aligns, and a homolog with substitutions
and indels (``masabench.pairs.homolog``), so that gapped paths are
covered too.  Each answer is held to the benchmark's plain reference
(``masabench.reference``), every limit 0.  The port's records are held
to the work directory: the counter ``rows.bytes`` to the row files stage
1 left and ``rows.card`` to its disk rows, the ``status.save`` spans to one a row at least, the counter
``hops.segments`` to stage 2's ``MarchStats`` in ``statistics_02.00``,
and stage 2's file spans (``cps.write``, ``rows.remove``) to the
crosspoints it appended and the row files it removed.  Stage 2 chains its
hops over the row cache as on a card (``reverse_march(chain=True)``; CPU
tensors stand for the card).  Then the cell's registry entry and its
four new readers."""

import contextlib
import importlib.util
import io
import json
import os
import re

import numpy as np
import pytest

from masabench import pairs, reference, run
from masabench.program import ROWS
from masabench.entries.cli import read_text
from masa_tpu_torch.cli import main
from masa_tpu_torch.ops import kernels
from masa_tpu_torch.stages import core, pipeline, runner
from masa_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "cp1m-cli16.full"
SCORES = {"match": 1, "mismatch": -3, "gap_open": 3, "gap_ext": 2}
# m * n * 8 / (64 KiB + 64 KiB) + 1 rounds up to one FLUSH_GRAIN; the
# first row fits RAM and the rest go to disk, as at the defaults
BUDGET = ["--ram-size", "64K", "--disk-size", "64K"]
M = 2600
NEW = ("stage1_status_s.cli16", "stage1_disk_mb.cli16",
       "stage2_segments.cli16", "stage2_files_s.cli16")
# the accepted per-layer metrics of the layers the cell runs (stages 1,
# 2, 5 and 6, kernel 1 and the device), in BENCHMARK.json's order
OLD = ("stage1_host_s.align", "stage2_s", "stage5_s", "strip_roofline.align",
       "device_idle.align", "stage1_flush_s.align", "stage2_wait_s",
       "stage5_partitions", "stage5_dp_s", "stage6_s")
# the spans of stage 2's file calls, and of stage 1's row store
FILES = ("cps.write", "rows.remove")


def _pairs():
    rng = np.random.default_rng(24)
    s0 = rng.choice(pairs.BASES, M).astype(np.uint8)
    return {"self": (s0, s0.copy()),
            "homolog": (s0, pairs.homolog(rng, s0, 0.05, 300, 4))}


def _row_files(work):
    """The special-row files under ``work``, by name, with their bytes."""
    out = {}
    for dirpath, _, names in os.walk(os.path.join(work, "special_rows")):
        out.update({n: os.path.getsize(os.path.join(dirpath, n))
                    for n in names if re.fullmatch(r"row\.\d+\.bin", n)})
    return out


def _stats(path):
    out = {}
    with open(path) as fh:
        for line in fh:
            key, _, value = line.strip().partition(":")
            if value.strip().lstrip("-").isdigit():
                out[key] = int(value)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each pair's CLI job with the switch on: what it printed, its
    answer, its records, its statistics, the row files stage 1 left (read
    as stage 1 returns: stage 2 removes the rows above each crosspoint)
    and those the job left."""
    out = {}
    for name, (s0, s1) in _pairs().items():
        tmp = str(tmp_path_factory.mktemp(name))
        fasta = []
        for k, seq in enumerate((s0, s1)):
            fasta.append(os.path.join(tmp, f"{k}.fa"))
            pairs.write_fasta(fasta[-1], f"s{k}", seq)
        work = os.path.join(tmp, "work")
        left = {}
        stage1, march = runner.stage1, core.reverse_march

        def stage1_then_list(job, *a, **kw):
            best = stage1(job, *a, **kw)
            left.update(_row_files(job.dir))
            return best

        def chained_march(*a, **kw):
            return march(*a, chain=True, **kw)

        tap = io.StringIO()
        trace.reset()
        kernels.event_log = []
        try:
            with pytest.MonkeyPatch.context() as mp, \
                    contextlib.redirect_stdout(tap):
                mp.setattr(runner, "stage1", stage1_then_list)
                mp.setattr(core, "reverse_march", chained_march)
                rc = main(fasta + ["--work-dir", work, "--device", "cpu",
                                   ] + BUDGET)
        finally:
            kernels.event_log = None
        spans, counts = list(trace.spans), dict(trace.counts)
        trace.reset()
        best = re.search(r"stage1: best=(-?\d+) at \((\d+),(\d+)\)",
                         tap.getvalue())
        out[name] = {
            "rc": rc, "pair": (s0, s1), "spans": spans, "counts": counts,
            "best": tuple(int(x) for x in best.groups()),
            "text": read_text(os.path.join(work, "alignment.00.txt")),
            "stats1": _stats(os.path.join(work, "statistics_01.00")),
            "stats2": _stats(os.path.join(work, "statistics_02.00")),
            "left": left, "end": _row_files(work)}
    return out


PAIRS = ["self", "homolog"]


@pytest.mark.parametrize("name", PAIRS)
def test_the_cadence_is_the_defaults(runs, name):
    """A row every 512, at least four of them, in RAM and on disk."""
    got = runs[name]
    assert got["rc"] == 0
    assert got["stats1"]["flush_interval"] == pipeline.FLUSH_GRAIN == 512
    rows = got["stats1"]["ram_rows"] + got["stats1"]["disk_rows"]
    assert rows == (len(got["pair"][0]) - 1) // 512 >= 4
    assert got["stats1"]["ram_rows"] >= 1 and got["stats1"]["disk_rows"] >= 1


@pytest.mark.parametrize("name", PAIRS)
def test_the_answer_is_the_references(runs, name):
    got = runs[name]
    s0, s1 = got["pair"]
    score, i, j = reference.sw_best(s0, s1, SCORES)
    text = got["text"]
    assert got["best"] == (score, i, j)
    assert text["score"] == score and text["end"] == (i, j)
    path = reference.judge_path(s0, s1, text["start"], text["end"],
                                *text["rows"], SCORES)
    assert path == {"score": score, "faults": 0}
    if name == "homolog":
        assert b"-" in text["rows"][0].tobytes() + text["rows"][1].tobytes()


@pytest.mark.parametrize("name", PAIRS)
def test_the_byte_counter_is_the_row_files(runs, name):
    """``rows.bytes`` is the bytes of the row files stage 1 left, one a
    disk row, as ``statistics_01.00`` books them, and ``rows.card`` the
    disk rows packed in a batch (every one: none overflows its escape
    slot); no other stage counts."""
    got = runs[name]
    counts, left = got["counts"], got["left"]
    assert len(left) == got["stats1"]["disk_rows"]
    assert counts[("stage1", "rows.bytes")] == sum(left.values()) \
        == got["stats1"]["disk_bytes"]
    assert counts[("stage1", "rows.card")] == got["stats1"]["disk_rows"]
    assert sorted(k for k in counts if k[1].startswith("rows.")) == [
        ("stage1", "rows.bytes"), ("stage1", "rows.card")]


@pytest.mark.parametrize("name", PAIRS)
def test_a_status_write_a_special_row(runs, name):
    """One ``status.save`` a row flushed and one as the stage ends, none
    inside a row's spans or a wait, so that their sums count each second
    once."""
    got = runs[name]
    saves = [s for s in got["spans"] if s[:2] == ("status.save", "stage1")]
    rows = got["stats1"]["ram_rows"] + got["stats1"]["disk_rows"]
    assert len(saves) >= rows + 1
    leaves = sorted((t0, t1) for n, _, t0, t1 in got["spans"]
                    if n in ROWS + FILES + ("status.save", "wait"))
    for (_, a1), (b0, _) in zip(leaves, leaves[1:]):
        assert a1 <= b0
    # every stage rewrites it as it ends
    assert {s[1] for s in got["spans"] if s[0] == "status.save"} == {
        f"stage{k}" for k in range(1, 7)}


@pytest.mark.parametrize("name", PAIRS)
def test_the_segment_counter_is_the_march(runs, name):
    got = runs[name]
    hops = {k: v for k, v in got["counts"].items()
            if k[1].startswith("hops.")}
    stats = got["stats2"]
    assert hops == {("stage2", "hops.segments"): stats["segments"]}
    assert stats["issued"] >= 4 and stats["segments"] >= 1


@pytest.mark.parametrize("name", PAIRS)
def test_stage2_file_calls_are_spanned(runs, name):
    """A ``cps.write`` span for each crosspoint stage 2 appends to its
    file (the endpoint, then each one found), and ``rows.remove`` spans
    where it removes the row files above one."""
    got = runs[name]
    spans = [s for s in got["spans"] if s[0] in FILES]
    writes = [s for s in spans if s[:2] == ("cps.write", "stage2")]
    assert len(writes) == got["stats2"]["crosspoints"]
    removes = [s for s in spans if s[0] == "rows.remove"]
    assert set(got["end"]) < set(got["left"])
    assert removes and {s[1] for s in removes} == {"stage2"}


def test_the_cell_is_registered():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = run.Cell(bench, CELL, ROOT)
    assert [m["name"] for m in cell.end_to_end] == ["align_gcups", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(OLD + NEW)
    cfg = cell.config
    assert (cfg["ram_size"], cfg["disk_size"]) == ("1G", "16G")
    assert cfg["cli_options"] == ["ram_size", "disk_size"]
    assert cfg["reduced"] == [] and "source_values" not in cfg
    assert cell.traffic["mode"] == "full" and cell.chips == 1


def _reader(metric):
    path = os.path.join(ROOT, "masabench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "reader_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Run:
    def __init__(self, pairs_done):
        self.pairs_done = pairs_done


S = 10 ** 9
# the spans and counts of two pairs, and each reader's value a pair
SPANS = [("rows.pack", "stage1", 0, S), ("rows.write", "stage1", S, 3 * S),
         ("status.save", "stage1", 3 * S, 4 * S),
         ("status.save", "stage2", 0, 9 * S), ("wait", "stage1", 0, 9 * S),
         ("cps.write", "stage2", 0, S), ("rows.remove", "stage2", S, 4 * S),
         ("cps.write", "stage1", 0, 9 * S), ("wait", "stage2", 0, 9 * S)]
COUNTS = {("stage1", "rows.bytes"): 4_200_000_000,
          ("stage2", "rows.bytes"): 7, ("stage2", "hops.segments"): 6,
          ("stage1", "hops.segments"): 9}
VALUES = {"stage1_status_s.cli16": 0.5, "stage1_disk_mb.cli16": 2100.0,
          "stage2_segments.cli16": 3.0, "stage2_files_s.cli16": 2.0}


@pytest.mark.parametrize("metric", NEW)
def test_a_reader_gives_the_per_pair_total(metric):
    read = _reader(metric)
    trace.reset()
    try:
        assert read(_Run(2)) is None  # nothing recorded
        trace.spans.extend(SPANS)
        trace.counts.update(COUNTS)
        assert read(_Run(2)) == pytest.approx(VALUES[metric])
        assert read(_Run(0)) is None  # no pair finished
    finally:
        trace.reset()
