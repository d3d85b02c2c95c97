"""The port's bench (``python -m masa_tpu_torch.bench``) against masa_tpu,
on the CPU, and stage 4's level lines.

The bench at ``--device cpu`` runs bench.py's CPU sizes on the plain
versions: its stage-1 best on bench.py's random 2048-base pair must equal
masa_tpu's ``strips.run_partition`` (the scan backend, bench.py's CPU
config) and the oracle's, and its full score on the 1024-base homolog
masa_tpu's ``runner.align_job`` at ``JobConfig``'s defaults.  Tolerance 0
(integer DP).  Its JSON line carries every key of bench.py's line; its
pairs are bench.py's draws byte for byte; its stage clock reads the port
runner's own lines and skips stage 4's level lines, which the port's
batched engine prints as masa_tpu's does."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import masa_tpu
from masa_tpu.core.job import Job as JJob, JobConfig as JJobConfig
from masa_tpu.ops import batched_mm as jbm
from masa_tpu.ops import oracle, strips as jstrips
from masa_tpu.ops.wavefront import WavefrontConfig
from masa_tpu.stages import runner as jrunner
from masa_tpu.types import InitType, ScoreParams
from masa_tpu_torch import bench, convert
from masa_tpu_torch.core.job import CrosspointsFile, Job, JobConfig
from masa_tpu_torch.ops import batched_mm, myers_miller
from masa_tpu_torch.stages import runner
from masa_tpu_torch.tools import pairs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = (masa_tpu.types, masa_tpu.biology.sequence, masa_tpu.biology.alignment)
P = ScoreParams()
STAGES = [f"stage{k}" for k in range(1, 7)]


def reference_bench():
    """The repository's bench.py as a module (its ``homolog``)."""
    spec = importlib.util.spec_from_file_location(
        "reference_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_bench(argv):
    """``bench.main(argv)`` in-process: its stdout lines and last-line
    JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench.main(argv) == 0
    lines = buf.getvalue().splitlines()
    return lines, json.loads(lines[-1])


@pytest.fixture(scope="module")
def port_line():
    lines, got = run_bench(["--device", "cpu"])
    assert all(line.startswith("# ") for line in lines[:-1])
    return got


@pytest.fixture(scope="module")
def want(tmp_path_factory):
    """masa_tpu's values on bench.py's CPU inputs, once."""
    s0, s1 = pairs.random_pair(2048, 2048)
    cfg = WavefrontConfig(alpha=4, rs=1, chunk=512, track_best=True,
                          store_lastcol=False)
    res = jstrips.run_partition(cfg, s0, s1, P, InitType.WITH_ZEROES,
                                InitType.WITH_ZEROES, backend="scan",
                                want_last_row=False)
    h1 = pairs.homolog(np.random.default_rng(1), s0[:1024],
                       indel_every=1 << 9)
    work = str(tmp_path_factory.mktemp("ref_full"))
    aln = jrunner.align_job(JJob(JJobConfig(work_dir=work, params=P)),
                            s0[:1024], h1, log=lambda *a: None)
    return {"best": res.best, "oracle": int(oracle.dp_rows(s0, s1).best),
            "full": aln.raw_score}


def test_stage1_best_equals_masa_tpu(port_line, want):
    d = port_line["detail"]
    assert (d["m"], d["n"], d["device"], d["backend"]) == (
        2048, 2048, "cpu", "plain")
    assert d["best_score"] == want["best"] == want["oracle"]


def test_full_score_equals_masa_tpu(port_line, want):
    d = port_line["detail"]
    assert d["full_score"] == want["full"]
    assert d["full_special_rows"]["flush_interval"] == 512
    assert d["full_error"] is None and d["card"] is None


def test_stage_seconds_name_every_stage(port_line):
    d = port_line["detail"]
    assert list(d["full_stage_s"]) == STAGES
    assert list(d["full_kernel_ms"]) == STAGES == list(d["full_launches"])
    assert port_line["metric"] == "stage1_sw_gcups_1chip"


def test_line_has_every_key_of_bench_py(port_line):
    keys = chip_smoke().bench_py_keys()
    assert {"metric", "value", "unit", "vs_baseline", "detail",
            "full_stage_s", "full_error"} <= keys
    got = set(port_line) | set(port_line["detail"])
    assert keys <= got, keys - got


def test_full_phase_can_be_skipped(monkeypatch):
    monkeypatch.setenv("MASA_BENCH_FULL", "0")
    _, got = run_bench(["--device", "cpu"])
    d = got["detail"]
    assert d["full_score"] is d["full_alignment_s"] is d["full_stage_s"] \
        is None
    assert d["best_score"] > 0


@pytest.mark.parametrize("m,n", [(2048, 2048), (1 << 20, 1 << 20)])
def test_pairs_are_bench_pys_draws(m, n):
    """bench.py's draws: rng(0) gives s0 then s1; the full run's s1 is
    its homolog of s0 from rng(1) (indels every 2^16 bases on the card,
    2^9 in the CPU run)."""
    ref = reference_bench()
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, size=m).astype(np.uint8)
    s1 = rng.choice(bases, size=n).astype(np.uint8)
    g0, g1 = pairs.random_pair(m, n)
    assert g0.tobytes() == s0.tobytes() and g1.tobytes() == s1.tobytes()
    if m == 1 << 20:
        b0, b1 = pairs.bench_pair()
        want = ref.homolog(np.random.default_rng(1), s0, indel_every=1 << 16)
        assert b0.tobytes() == s0.tobytes()
    else:
        b1 = pairs.homolog(np.random.default_rng(1), s0[:1024],
                           indel_every=1 << 9)
        want = ref.homolog(np.random.default_rng(1), s0[:1024],
                           indel_every=1 << 9)
    assert b1.tobytes() == want.tobytes()


def nw_pair(seed, m, cut):
    """tests/test_torch_batched_mm.py's NW pair: 10% substitutions and a
    deletion of ``cut`` bases a third of the way in."""
    from masa_tpu.types import Crosspoint, CrosspointType, Recurrence

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, m).astype(np.uint8)
    s1 = s0.copy()
    flip = rng.random(m) < 0.1
    s1[flip] = rng.choice(bases, int(flip.sum()))
    s1 = np.concatenate([s1[:m // 3], s1[m // 3 + cut:]])
    ref = oracle.dp_rows(s0, s1, P, Recurrence.NEEDLEMAN_WUNSCH,
                         InitType.WITH_GAPS, InitType.WITH_GAPS)
    return s0, s1, [Crosspoint(0, 0, 0, CrosspointType.MATCH),
                    Crosspoint(m, len(s1), int(ref.last_h[-1]),
                               CrosspointType.MATCH)]


@pytest.mark.parametrize("seed,m,cut,mps", [(0, 600, 25, 8), (1, 900, 40, 64)])
def test_stage4_level_lines_are_masa_tpus(seed, m, cut, mps):
    """The batched engine prints masa_tpu's line after each level."""
    s0, s1, cps = nw_pair(seed, m, cut)
    want, got = [], []
    jbm.reduce_partitions_batched(s0, s1, cps, P, mps, log=want.append)
    batched_mm.reduce_partitions_batched(
        s0, s1, convert.to_port(cps), convert.to_port(P), mps,
        device="cpu", log=got.append)
    assert got == want
    assert len(got) >= 2 and got[0].startswith("stage4[batched]: level 1: ")


def test_runner_lines_through_the_stage_clocks(monkeypatch, tmp_path):
    """The port runner with the card's stage 4 (the batched engine, on
    CPU tensors): stage 4's level lines reach its log as masa_tpu's engine
    prints them on the same stage-3 crosspoints; the bench's clock and
    chip_smoke.py's stage parser find each stage's completion line once
    and skip the level lines and stage 1's progress lines."""
    monkeypatch.setattr(myers_miller, "stage4_engine",
                        lambda device, strategy: "batched")
    s0, _ = pairs.random_pair(1536, 1)
    s1 = pairs.homolog(np.random.default_rng(1), s0, indel_every=1 << 9)
    cfg = JobConfig(work_dir=str(tmp_path / "w"), stage5_max_cells=1 << 12)
    lines = []
    aln = runner.align_job(Job(cfg, device="cpu"), s0, s1,
                           log=lines.append)
    cps3 = CrosspointsFile(str(tmp_path / "w" / "crosspoints"
                               / "crosspoint_03.00")).load()
    want = []
    jbm.reduce_partitions_batched(s0, s1, convert.to_ref(cps3, *REF), P, 64,
                                  log=want.append)
    levels = [x for x in lines if x.startswith("stage4[batched]")]
    assert levels == want and len(levels) >= 2
    assert aln.raw_score == jrunner.align_job(
        JJob(JJobConfig(work_dir=str(tmp_path / "j"))), s0, s1,
        log=lambda *a: None).raw_score

    clock = bench.StageClock()
    for line in lines + ["stage1: ... flushed row 512/1536 (33.3%)"]:
        with contextlib.redirect_stdout(io.StringIO()):
            clock(line)
    assert list(clock.seconds) == STAGES
    done = [d for d in map(bench.stage_done, lines) if d]
    assert [d[0] for d in done] == STAGES
    assert all(bench.stage_done(x) is None for x in levels)
    secs = chip_smoke().stage_seconds("\n".join(lines))
    assert secs == {name: s for name, s in done[:5]}
    assert list(secs) == STAGES[:5]


@pytest.mark.parametrize("line,want", [
    ("stage1: weighted column split [524286, 524286], special rows every "
     "8192: best=796634 in 1.82s", ("stage1", 1.82)),
    ("stage1: sharded over 2 devices, 65536-row strips: best=796634, "
     "pruned strips [0, 3] in 1.90s", ("stage1", 1.9)),
    ("stage2: 128 crosspoints (pipelined, 0 reused) in 0.41s",
     ("stage2", 0.41)),
    ("stage2: 128 crosspoints in 0.35s (matched on the device 127, on the "
     "host 0; window reads 0 (0 bytes); chained 126 in 5 segments, 0 "
     "broken)", ("stage2", 0.35)),
    ("stage5: score=-12 verified in 4.37s", ("stage5", 4.37)),
    ("stage6: wrote work/alignment.00.txt", ("stage6", None)),
    ("stage1: ... flushed row 512/1536 (33.3%)", None),
    ("stage1: resuming from special row 8192", None),
    ("stage2: already executed (resume)", None),
    ("stage4[batched]: level 1: 6 pairs", None),
    ("stage1 (sharded over 2 devices): best=796634", None),
])
def test_stage_done_reads_the_cli_modes_lines(line, want):
    """One parser for every stage line: the runner's, and the CLI's split
    and sharded modes' (cli.py), which chip_smoke.py's phases read."""
    assert bench.stage_done(line) == want


def test_main_path_hops_are_the_clis_and_the_benchs():
    """The hop shapes chip_smoke.py holds the hop kernels to: the CLI's
    (a row every 8192 at 1 GiB, all on disk) and the bench's (a row every
    512 at JobConfig's defaults), read off the code that picks them."""
    assert chip_smoke().main_path_hops() == [(1024, 512), (16384, 8192)]


def chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_chip_smoke_reads_the_bench_line(port_line, monkeypatch):
    """chip_smoke.py's bench phase, fed the CPU line reshaped as the
    card's (its child process and card name stubbed): it returns the
    bench's launches, and refuses a wrong score or a missing key."""
    cs = chip_smoke()
    line = json.loads(json.dumps(port_line))
    d = line["detail"]
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    d.update(m=1 << 20, n=1 << 20, best_score=19, full_score=796634,
             device="NVIDIA H100 80GB HBM3", card=card,
             launches={k: 1 for k in cs.COUNTED})
    out = "# stage 1 run 1\n" + json.dumps(line) + "\n"
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, out, ""))
    monkeypatch.setattr(cs, "log", lambda *a: None)
    monkeypatch.setattr(cs, "PROBE_ROWS", 2)
    import torch

    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert cs.bench_phase(card) == d["launches"]
    for key, bad in (("full_score", 796633), ("best_score", 18)):
        wrong = json.loads(json.dumps(line))
        wrong["detail"][key] = bad
        with pytest.raises(AssertionError, match="wrong"):
            cs.bench_checked(json.dumps(wrong), d["device"], card)
    del line["detail"]["full_gcups"]
    with pytest.raises(AssertionError, match="lacks"):
        cs.bench_checked(json.dumps(line), d["device"], card)


def test_no_card_no_line():
    """``--device cuda`` (the default) with no card visible: a non-zero
    exit and no JSON line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", "masa_tpu_torch.bench"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_bench_spread_probe_and_summary(port_line):
    """The spread tool's pieces that need no card: its disk probe, and a
    turn's numbers read off the bench's line."""
    from masa_tpu_torch.tools import bench_spread

    probe = bench_spread.disk_probe(rows=3, row_bytes=4096)
    assert probe["rows"] == 3 and probe["write_ms"] > 0 <= probe["remove_ms"]
    turn = {"lines": ["# a line", json.dumps(port_line)], "wall_s": 1.0,
            "child_cpu_s": [0.5, 0.1], "parent_cpu_s": [0.0, 0.0],
            "loadavg": [0.1, 0.2, 0.3]}
    got = bench_spread.summary(turn)
    d = port_line["detail"]
    assert (got["full_score"], got["best_score"]) == (d["full_score"],
                                                      d["best_score"])
    assert list(got["full_stage_s"]) == STAGES
