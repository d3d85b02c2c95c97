"""The port's own spans and counters (``masa_tpu_torch.utils.trace``) on
the CPU.  Recording is on exactly while ``ops.kernels.event_log`` is a
list: a library call (``pipeline.align_pair``) and an in-process CLI job
record nothing with it off, the same answers and work-directory files
with it on, each stage once, every span inside its stage, stage 5's
partitions and stage 1's file writes; the benchmark's readers of these
records (``masabench/program.py``) on a hand-built recorder state.  The
pair runs the plain strips (backend "kernel"), a 2081-row homolog behind
3000 random columns, so that hops match on the device (CPU tensors) and
rows reach the disk packed (``--ram-size 0``).  Tolerance: exact."""

import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from masa_tpu_torch.cli import main
from masa_tpu_torch.ops import kernels
from masa_tpu_torch.stages import pipeline
from masa_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ("rows.pack", "rows.pull", "rows.escapes", "rows.write")
# lines of the statistics files that hold the clock's readings
TIMED = ("compute:", "TOTAL:", "MCUPS:", "total_ms:", "vm_size_mb:")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(5)

    def dna(n):
        return rng.choice(np.frombuffer(b"ACGT", np.uint8), n)

    s0 = dna(4 * 512 + 33)
    s1 = s0.copy()
    mut = rng.random(len(s1)) < 0.05
    s1[mut] = dna(int(mut.sum()))
    return s0, np.concatenate([dna(3000), s1])


def _library(pair, tmp):
    """align_pair's stage-5 input (the crosspoints) and its answer."""
    got = {}
    emit = pipeline.stage5_emit

    def stage5_emit(s0, s1, pcfg, cps, *a):
        got["cps"] = cps
        return emit(s0, s1, pcfg, cps, *a)

    pipeline.stage5_emit = stage5_emit
    try:
        aln = pipeline.align_pair(*pair, pipeline.PipelineConfig(
            backend="kernel", device="cpu"))
    finally:
        pipeline.stage5_emit = emit
    return {"score": aln.raw_score, "start": aln.start, "end": aln.end,
            "gaps": [[(g.pos, g.len) for g in side] for side in aln.gaps],
            "partitions": len(got["cps"]) - 1}


def _cli(pair, tmp):
    """The CLI's work directory, file by file (the clock's lines left out
    of the statistics), and its disk rows."""
    fasta = []
    for k, seq in enumerate(pair):
        fasta.append(os.path.join(tmp, f"{k}.fa"))
        with open(fasta[-1], "wb") as fh:
            fh.write(b">s%d\n" % k + seq.tobytes() + b"\n")
    work = os.path.join(tmp, "work")
    assert main(fasta + ["--work-dir", work, "--device", "cpu", "--backend",
                         "kernel", "--ram-size", "0", "--disk-size", "1G",
                         "--verbose", "0"]) == 0
    files = {}
    for dirpath, _, names in os.walk(work):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                data = fh.read()
            if name.startswith("statistics_"):
                data = b"".join(line for line in data.splitlines(True)
                                if line.split()[:1] and line.split()[0]
                                .decode() not in TIMED)
            files[os.path.relpath(path, work)] = data
    stats = files["statistics_01.00"].decode()
    disk = [int(line.split(":")[1]) for line in stats.splitlines()
            if line.strip().startswith("disk_rows:")]
    return {"files": files, "disk_rows": disk[0]}


ENTRIES = {"library": _library, "cli": _cli}
STAGES = {"library": ["stage1", "stage2", "stage3", "stage4", "stage5"],
          "cli": ["stage1", "stage2", "stage3", "stage4", "stage5",
                  "stage6"]}


@pytest.fixture(scope="module")
def runs(pair, tmp_path_factory):
    """Each entry run with the switch off, then on: its answer, and the
    records of each with a time.time_ns() bracket around the call."""
    out = {}
    for name, fn in ENTRIES.items():
        for on in (False, True):
            trace.reset()
            kernels.event_log = [] if on else None
            try:
                t0 = time.time_ns()
                got = fn(pair, str(tmp_path_factory.mktemp(name)))
                t1 = time.time_ns()
            finally:
                kernels.event_log = None
            out[name, on] = (got, list(trace.spans), dict(trace.counts),
                             (t0, t1))
    trace.reset()
    return out


@pytest.mark.parametrize("entry", ENTRIES)
def test_switched_off_nothing_is_recorded(runs, entry):
    _, spans, counts, _ = runs[entry, False]
    assert spans == [] and counts == {}


@pytest.mark.parametrize("entry", ENTRIES)
def test_switched_on_the_answer_is_the_same(runs, entry):
    assert runs[entry, True][0] == runs[entry, False][0]


@pytest.mark.parametrize("entry", ENTRIES)
def test_each_stage_once_and_every_span_inside_its_stage(runs, entry):
    _, spans, counts, (b0, b1) = runs[entry, True]
    stages = {name: (t0, t1) for name, stage, t0, t1 in spans
              if name == stage}
    assert [s[0] for s in spans if s[0] == s[1]] == STAGES[entry]
    assert list(stages) == STAGES[entry]
    for name, stage, t0, t1 in spans:
        assert b0 <= t0 <= t1 <= b1
        s0, s1 = stages[stage]
        assert s0 <= t0 and t1 <= s1, (name, stage)
    # the work sites: the rows' flush, waits on the device in stages 1 and
    # 2, the DP of every partition
    names = {(name, stage) for name, stage, _, _ in spans}
    assert {("wait", "stage1"), ("wait", "stage2"),
            ("dp", "stage5")} <= names
    assert {("rows.pack", "stage1"), ("rows.escapes", "stage1")} <= names \
        or entry == "library"
    for stage, _ in counts:
        assert stage in stages


@pytest.mark.parametrize("entry", ENTRIES)
def test_the_row_spans_and_the_waits_never_nest(runs, entry):
    """Their sums count each second once."""
    _, spans, _, _ = runs[entry, True]
    leaves = sorted((t0, t1) for name, _, t0, t1 in spans
                    if name in ROWS + ("wait", "dp"))
    for (_, a1), (b0, _) in zip(leaves, leaves[1:]):
        assert a1 <= b0


def test_partitions_are_stage_5s_crosspoints_less_one(runs):
    got, spans, counts, _ = runs["library", True]
    assert counts == {("stage5", "partitions"): got["partitions"]}
    assert sum(1 for s in spans if s[:2] == ("dp", "stage5")) == \
        got["partitions"]


def test_file_writes_are_the_disk_rows(runs):
    got, spans, counts, _ = runs["cli", True]
    writes = [s for s in spans if s[0] == "rows.write"]
    assert got["disk_rows"] >= 2
    assert len(writes) == got["disk_rows"]
    assert all(s[1] == "stage1" for s in writes)
    assert counts[("stage5", "partitions")] == sum(
        1 for s in spans if s[:2] == ("dp", "stage5"))


def test_switched_off_a_site_allocates_nothing():
    assert kernels.event_log is None
    assert trace.span("a") is trace.span("b") is trace.stage("stage1")
    trace.count("partitions")
    assert trace.counts == {}


def test_switching_off_keeps_the_records():
    trace.reset()
    kernels.event_log = []
    try:
        with trace.stage("stage5"):
            with trace.span("dp"):
                pass
            trace.count("partitions", 3)
    finally:
        kernels.event_log = None
    assert [s[:2] for s in trace.spans] == [("dp", "stage5"),
                                            ("stage5", "stage5")]
    assert trace.counts == {("stage5", "partitions"): 3}
    trace.reset()
    assert trace.spans == [] and trace.counts == {}


def test_the_stage_runner_keeps_on_stage(pair):
    """on_stage(name, seconds, result) as each stage ends, in order, with
    the switch off and on."""
    for on in (False, True):
        seen = []
        kernels.event_log = [] if on else None
        try:
            aln = pipeline.align_pair(
                *pair, pipeline.PipelineConfig(device="cpu"),
                on_stage=lambda n, s, out: seen.append((n, s, out)))
        finally:
            kernels.event_log = None
        assert [n for n, _, _ in seen] == STAGES["library"]
        assert all(s >= 0 for _, s, _ in seen) and seen[-1][2] is aln
    trace.reset()


# -- the benchmark's readers of the records --------------------------------

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
# (metric, the spans and counts of two pairs, the value a pair)
READERS = [
    ("stage1_flush_s.align",
     [("rows.pack", "stage1", 0, S), ("rows.pull", "stage1", S, 2 * S),
      ("rows.escapes", "stage1", 2 * S, 3 * S),
      ("rows.write", "stage1", 3 * S, 5 * S),
      ("rows.write", "stage2", 0, 7 * S), ("wait", "stage1", 0, 9 * S)],
     {}, 2.5),
    ("stage2_wait_s",
     [("wait", "stage2", 0, 3 * S), ("rows.pull", "stage2", 0, S),
      ("wait", "stage3", 0, 9 * S)], {}, 2.0),
    ("stage3_wait_s.lib",
     [("wait", "stage3", 0, 5 * S), ("rows.pull", "stage3", 0, S),
      ("wait", "stage2", 0, 9 * S), ("stage3", "stage3", 0, 9 * S)],
     {}, 3.0),
    ("stage5_partitions", [],
     {("stage5", "partitions"): 4096, ("stage3", "partitions"): 2}, 2048),
    ("stage5_dp_s",
     [("dp", "stage5", 0, S), ("dp", "stage5", S, 4 * S),
      ("stage5", "stage5", 0, 9 * S)], {}, 2.0),
    ("stage6_s",
     [("stage6", "stage6", 0, 3 * S), ("stage6", "stage6", 0, S),
      ("wait", "stage6", 0, 9 * S)], {}, 2.0),
]


@pytest.mark.parametrize("metric,spans,counts,value", READERS,
                         ids=[r[0] for r in READERS])
def test_a_reader_gives_the_per_pair_total(metric, spans, counts, value):
    read = _reader(metric)
    trace.reset()
    try:
        assert read(_Run(2)) is None  # nothing recorded
        trace.spans.extend(spans)
        trace.counts.update(counts)
        assert read(_Run(2)) == pytest.approx(value)
        assert read(_Run(0)) is None  # no pair finished
    finally:
        trace.reset()


@pytest.mark.parametrize("first", ["masa_tpu_torch.utils.trace",
                                   "masa_tpu_torch.ops.kernels"])
def test_the_recorder_and_the_kernels_import_in_either_order(first):
    p = subprocess.run([sys.executable, "-c", f"import {first}; "
                        "from masa_tpu_torch.utils import trace; "
                        "trace.span('x')"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr


def test_the_port_reads_no_trace_variable():
    found = []
    for dirpath, _, names in os.walk(os.path.join(ROOT, "masa_tpu_torch")):
        for name in names:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as fh:
                    if "MASA_SHARDED_TRACE" in fh.read():
                        found.append(name)
    assert found == []
