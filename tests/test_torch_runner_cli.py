"""The port's persistent runner and CLI against masa_tpu's, on the CPU.

Counterparts of tests/test_runner_cli.py: each case runs masa_tpu's runner
or CLI and the port's (``device="cpu"``, the plain strips) on the same
inputs in separate work directories and compares the stage 1-4 crosspoint
files byte for byte (the special-row cadence is the same: 512 rows), the
alignment, the stage-6 output and the CLI's score line.  Work directories
cross between the packages: one package's stage 1 (or a crash in it)
feeds the other's stages.  3 kbp pairs; tolerance: exact equality."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

import masa_tpu
from masa_tpu.cli import main as jmain
from masa_tpu.core import capabilities as jcaps
from masa_tpu.core.job import Job as JJob
from masa_tpu.core.job import JobConfig as JJobConfig
from masa_tpu.ops import oracle
from masa_tpu.stages import runner as jrunner
from masa_tpu.types import AlignmentStart, ScoreParams
from masa_tpu_torch import convert
from masa_tpu_torch.cli import main
from masa_tpu_torch.core import capabilities as pcaps
from masa_tpu_torch.core.job import Job, JobConfig
from masa_tpu_torch.stages import runner
import masa_tpu.biology.alignment
import masa_tpu.biology.sequence

# masa_tpu's value-type modules, handed to convert.to_ref
REF = (masa_tpu.types, masa_tpu.biology.sequence, masa_tpu.biology.alignment)

P = ScoreParams()
N = 3000
JCaps = jcaps.AlignerCapabilities


def quiet(*a, **k):
    pass


def Caps(max_len, cls=pcaps.AlignerCapabilities):
    """Capabilities of one package (the port's unless told otherwise)."""
    return cls(maximum_seq1_len=max_len)


def jcfg(cfg):
    """A port JobConfig as masa_tpu's (each package takes its own types)."""
    return JJobConfig(**convert.to_ref(dict(vars(cfg)), *REF))


def pcfg(cfg):
    """A masa_tpu JobConfig as the port's."""
    return JobConfig(**convert.to_port(dict(vars(cfg))))


def write_fasta(path, desc, seq):
    with open(path, "wb") as f:
        f.write(b">" + desc.encode() + b"\n" + bytes(seq) + b"\n")


def cp_files(workdir) -> dict:
    d = os.path.join(workdir, "crosspoints")
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as fh:
            out[name] = fh.read()
    return out


def same_artifacts(mine, ref):
    """Equal crosspoint files, alignments and stage-6 renderings."""
    assert cp_files(mine) == cp_files(ref)
    for name in sorted(os.listdir(ref)):
        if name.startswith("alignment."):
            with open(os.path.join(mine, name), "rb") as a, \
                    open(os.path.join(ref, name), "rb") as b:
                assert a.read() == b.read(), name


def jobs(tmp_path, **kw):
    """(port Job, masa_tpu Job) on the same config in two directories."""
    base = dict(ram_limit=1 << 20, disk_limit=1 << 20)
    base.update(kw)
    mine = Job(JobConfig(work_dir=str(tmp_path / "port"),
                         **convert.to_port(base)), device="cpu")
    ref = JJob(JJobConfig(work_dir=str(tmp_path / "ref"), **base))
    return mine, ref


@pytest.fixture
def pair(dna, homolog):
    s0 = dna(N, seed=201)
    return s0, homolog(s0, seed=202, sub_rate=0.08, indel_rate=0.02)


class TestRunner:
    def test_full_run_and_resume(self, pair, tmp_path):
        """The strip engine (auto backend) against masa_tpu's: the same
        artifacts; a second run resumes every stage from them."""
        s0, s1 = pair
        mine, ref = jobs(tmp_path)
        aln = runner.align_job(mine, s0, s1, log=quiet)
        want = jrunner.align_job(ref, s0, s1, log=quiet)
        assert aln.raw_score == want.raw_score == oracle.dp_rows(s0, s1).best
        same_artifacts(mine.dir, ref.dir)

        again = Job(mine.cfg, device="cpu")
        msgs = []
        best = runner.stage1(again, s0, s1, log=msgs.append)
        assert best.best.score == aln.raw_score
        assert runner.stage2(again, s0, s1, log=msgs.append)[-1].score \
            == aln.raw_score
        assert msgs == ["stage1: already executed (resume)",
                        "stage2: already executed (resume)"]

    @pytest.mark.parametrize("crash_in,start", [
        ("port", AlignmentStart.SEQUENCE_2),
        ("masa_tpu", AlignmentStart.ANYWHERE)])
    def test_stage1_midstage_crash_resume(self, pair, tmp_path, monkeypatch,
                                          crash_in, start):
        """A stage 1 killed after two flushed rows (by either package)
        resumes under the port from the last flushed row, with a column
        border sliced from row 1024 (semi-global) or synthesized (local);
        the resumed work directory ends as a clean masa_tpu run's."""
        s0, s1 = pair
        mine, ref = jobs(tmp_path, ram_limit=0, backend="numpy",
                         alignment_start=start)
        mod = runner if crash_in == "port" else jrunner
        put = mod._OffsetStore.put
        calls = {"n": 0}

        def dying(self, r, h, f):
            calls["n"] += 1
            if calls["n"] > 2:
                raise KeyboardInterrupt("simulated crash")
            put(self, r, h, f)

        monkeypatch.setattr(mod._OffsetStore, "put", dying)
        crashed = mine if crash_in == "port" else JJob(jcfg(mine.cfg))
        with pytest.raises(KeyboardInterrupt):
            mod.stage1(crashed, s0, s1, log=quiet)
        monkeypatch.setattr(mod._OffsetStore, "put", put)

        msgs = []
        runner.stage1(Job(mine.cfg, device="cpu"), s0, s1, log=msgs.append)
        assert "stage1: resuming from special row 1024" in msgs
        jrunner.stage1(ref, s0, s1, log=quiet)
        assert cp_files(mine.dir) == cp_files(ref.dir)
        aln = runner.execute_traceback(Job(mine.cfg, device="cpu"), s0, s1,
                                       log=quiet)
        want = jrunner.execute_traceback(ref, s0, s1, log=quiet)
        same_artifacts(mine.dir, ref.dir)
        assert aln.raw_score == want.raw_score

    def test_stage2_midstage_crash_resume(self, pair, tmp_path,
                                          monkeypatch):
        """Stage 2 killed after its first hop: the rerun marches from the
        deepest autosaved crosspoint and ends as masa_tpu's stage 2."""
        from masa_tpu_torch.stages import core

        s0, s1 = pair
        # every special row on disk: RAM rows do not survive a crash
        mine, ref = jobs(tmp_path, ram_limit=0, backend="numpy",
                         stage4_max_partition=0)
        runner.stage1(mine, s0, s1, log=quiet)
        orig = core.reverse_pass_and_match
        calls = {"n": 0}

        def dying(*a, **k):
            calls["n"] += 1
            if calls["n"] > 1:
                raise KeyboardInterrupt("simulated crash")
            return orig(*a, **k)

        monkeypatch.setattr(core, "reverse_pass_and_match", dying)
        with pytest.raises(KeyboardInterrupt):
            runner.stage2(mine, s0, s1, log=quiet)
        monkeypatch.setattr(core, "reverse_pass_and_match", orig)
        cpf = mine.crosspoints_file(runner.STAGE_2, 0)
        partial = cpf.load()
        assert not cpf.complete and len(partial) >= 2

        msgs = []
        runner.stage2(Job(mine.cfg, device="cpu"), s0, s1, log=msgs.append)
        assert any("resuming mid-stage" in m for m in msgs)
        jrunner.stage1(ref, s0, s1, log=quiet)
        jrunner.stage2(ref, s0, s1, log=quiet)
        assert cp_files(mine.dir) == cp_files(ref.dir)

    def test_stage3_midstage_crash_resume(self, pair, tmp_path,
                                          monkeypatch):
        """Stage 3 killed after its first segment continues from the
        autosaved prefix and ends as masa_tpu's stage 3."""
        from masa_tpu_torch.stages import pipeline

        s0, s1 = pair
        mine, ref = jobs(tmp_path, backend="numpy", stage4_max_partition=0,
                         stage4_strategy="ORIGINAL_MM",
                         stage5_max_cells=1 << 16)
        runner.stage1(mine, s0, s1, log=quiet)
        runner.stage2(mine, s0, s1, log=quiet)
        orig = pipeline._densify_segment
        calls = {"n": 0}

        def dying(seq0, seq1, pcfg, c0, c1, max_cells, depth):
            if depth == 0:
                calls["n"] += 1
                if calls["n"] > 1:
                    raise KeyboardInterrupt("simulated crash")
            return orig(seq0, seq1, pcfg, c0, c1, max_cells, depth)

        monkeypatch.setattr(pipeline, "_densify_segment", dying)
        with pytest.raises(KeyboardInterrupt):
            runner.stage3(mine, s0, s1, log=quiet)
        monkeypatch.setattr(pipeline, "_densify_segment", orig)
        cpf = mine.crosspoints_file(runner.STAGE_3, 0)
        assert len(cpf.load()) >= 2 and not cpf.complete

        msgs = []
        cps = runner.stage3(Job(mine.cfg, device="cpu"), s0, s1,
                            log=msgs.append)
        assert any("resuming mid-stage" in m for m in msgs)
        assert len(cps) > len(mine.crosspoints_file(runner.STAGE_2,
                                                    0).load())
        jrunner.stage1(ref, s0, s1, log=quiet)
        jrunner.stage2(ref, s0, s1, log=quiet)
        jrunner.stage3(ref, s0, s1, log=quiet)
        assert cp_files(mine.dir) == cp_files(ref.dir)

    def test_info_mismatch_detected(self, tmp_path):
        cfg = JobConfig(work_dir=str(tmp_path / "w"))
        Job(cfg, "aaa", "bbb", device="cpu")
        with pytest.raises(RuntimeError, match="different sequence"):
            Job(cfg, "aaa", "ccc", device="cpu")

    @pytest.mark.parametrize("strategy", ["ORIGINAL_MM", "ORTHOGONAL"])
    def test_stage4_strategies(self, pair, tmp_path, strategy):
        """Stage 4 with the non-default strategies (the port's Python
        splitter; test_full_run_and_resume runs the default, the native
        ladder): masa_tpu's crosspoints and alignment."""
        s0, s1 = pair
        mine, ref = jobs(tmp_path, backend="numpy", stage4_strategy=strategy,
                         stage5_max_cells=1 << 16)
        aln = runner.align_job(mine, s0, s1, log=quiet)
        jrunner.align_job(ref, s0, s1, log=quiet)
        same_artifacts(mine.dir, ref.dir)
        assert aln.raw_score == oracle.dp_rows(s0, s1).best

    def test_across_packages(self, pair, tmp_path):
        """masa_tpu's stage 1 feeds the port's traceback and the port's
        stage 1 feeds masa_tpu's: both end as one package's own run."""
        s0, s1 = pair
        mine, ref = jobs(tmp_path, ram_limit=0)
        runner.stage1(mine, s0, s1, log=quiet)
        jrunner.stage1(ref, s0, s1, log=quiet)
        assert cp_files(mine.dir) == cp_files(ref.dir)
        full = str(tmp_path / "full")
        jrunner.align_job(JJob(JJobConfig(work_dir=full, ram_limit=0,
                                          disk_limit=1 << 20)), s0, s1,
                          log=quiet)
        aln_a = jrunner.execute_traceback(JJob(jcfg(mine.cfg)), s0, s1, log=quiet)
        aln_b = runner.execute_traceback(Job(pcfg(ref.cfg), device="cpu"), s0, s1,
                                         log=quiet)
        assert aln_a.raw_score == aln_b.raw_score
        same_artifacts(mine.dir, full)
        same_artifacts(ref.dir, full)

    def test_packed_rows_from_masa_tpu_resume(self, pair, tmp_path,
                                              monkeypatch):
        """A stage 1 that masa_tpu checkpointed in its packed row format
        (MSRQ, as on its device) resumes under the port: stage 2 reads the
        rows through the port's decoder and finds masa_tpu's chain."""
        monkeypatch.setenv("MASA_TPU_FORCE_PACKED_PULL", "1")
        s0, s1 = pair
        cfg = JobConfig(work_dir=str(tmp_path / "w"), ram_limit=0,
                        disk_limit=1 << 30, stage4_max_partition=0)
        jrunner.stage1(JJob(jcfg(cfg)), s0, s1, log=quiet)
        rows = [os.path.join(dp, f) for dp, _, fs in
                os.walk(os.path.join(cfg.work_dir, "special_rows"))
                for f in fs if f.startswith("row.")]
        assert rows
        with open(rows[0], "rb") as fh:
            assert fh.read(4) == b"MSRQ"
        copy = str(tmp_path / "copy")
        shutil.copytree(cfg.work_dir, copy)
        cps = runner.stage2(Job(cfg, device="cpu"), s0, s1, log=quiet)
        want = jrunner.stage2(JJob(jcfg(JobConfig(**{**vars(cfg),
                                                     "work_dir": copy}))),
                              s0, s1, log=quiet)
        assert cps == want


class TestMultiAlignment:
    def test_two_alignments(self, tmp_path):
        """Two well-separated local alignments, found and traced as
        masa_tpu does (--max-alignments)."""
        r = np.random.default_rng(161)
        bases = np.frombuffer(b"ACGT", np.uint8)
        a = r.choice(bases, size=200).astype(np.uint8)
        b = r.choice(bases, size=150).astype(np.uint8)

        def pad(n, seed):
            return np.random.default_rng(seed).choice(bases, n).astype(
                np.uint8)

        s0 = np.concatenate([a, pad(200, 1), b])
        s1 = np.concatenate([b, pad(180, 2), a])
        mine, ref = jobs(tmp_path, max_alignments=2, backend="numpy",
                         stage4_max_partition=0)
        runner.align_job(mine, s0, s1, log=quiet)
        jrunner.align_job(ref, s0, s1, log=quiet)
        same_artifacts(mine.dir, ref.dir)
        from masa_tpu.biology.alignment import read_cgff

        assert read_cgff(mine.path("alignment.00.cgff")).raw_score == 200
        assert read_cgff(mine.path("alignment.01.cgff")).raw_score == 150


def run_both(argv, tmp_path):
    """The port's CLI and masa_tpu's on the same arguments (separate work
    directories); their stdout, after the header line."""
    outs = []
    for name, fn, extra in (("port", main, ["--device", "cpu"]),
                            ("ref", jmain, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv + ["--work-dir", str(tmp_path / name)] + extra)
        assert rc == 0
        outs.append(buf.getvalue().splitlines()[1:])
    return outs


class TestCLI:
    @pytest.fixture
    def fastas(self, pair, tmp_path):
        f0, f1 = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
        write_fasta(f0, "seq a", pair[0])
        write_fasta(f1, "seq b", pair[1])
        return f0, f1

    def test_local(self, fastas, pair, tmp_path):
        mine, ref = run_both(list(fastas), tmp_path)
        score = [ln for ln in mine if ln.startswith("alignment score:")]
        assert score == [ln for ln in ref if ln.startswith("alignment")]
        assert score[0].startswith(
            f"alignment score: {oracle.dp_rows(*pair).best}  (matches=")
        same_artifacts(str(tmp_path / "port"), str(tmp_path / "ref"))

    def test_global_stage1_only(self, fastas, tmp_path):
        mine, ref = run_both([fastas[0], fastas[0], "--alignment-start",
                              "!", "--stage-1"], tmp_path)
        assert mine[-1] == ref[-1] == f"best score: {N} at ({N},{N})"
        assert cp_files(str(tmp_path / "port")) == cp_files(
            str(tmp_path / "ref"))

    def test_reverse_complement(self, pair, tmp_path):
        comp = dict(zip(b"ACGT", b"TGCA"))
        f0, f1 = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
        write_fasta(f0, "a", pair[0])
        write_fasta(f1, "b", bytes(comp[c] for c in pair[0][::-1]))
        mine, ref = run_both([f0, f1, "--reverse-complement", "2",
                              "--stage-1", "--backend", "numpy"], tmp_path)
        assert mine[-1] == ref[-1] == f"best score: {N} at ({N},{N})"

    def test_oversize_input_stops(self, fastas, tmp_path, capsys,
                                  monkeypatch):
        """The column split of an oversize input aligns locally only, as
        in masa_tpu: a global alignment stops with an error."""
        from masa_tpu_torch import cli

        monkeypatch.setattr(cli, "AlignerCapabilities", lambda: Caps(100))
        with pytest.raises(SystemExit):
            main(list(fastas) + ["--device", "cpu", "--alignment-start",
                                 "!", "--work-dir", str(tmp_path / "w")])
        assert "only support local alignment" in capsys.readouterr().err


@pytest.fixture
def seed42_fastas(tmp_path):
    """The verify recipe's seed-42 3000 bp pair (8% substitutions): local
    score 2204 at (3000, 3000)."""
    rng = np.random.default_rng(42)
    s0 = "".join(rng.choice(list("ACGT"), 3000))
    s1 = list(s0)
    for i in np.nonzero(rng.random(3000) < 0.08)[0]:
        s1[i] = "ACGT"[rng.integers(4)]
    paths = []
    for name, seq in (("a.fa", s0), ("b.fa", "".join(s1))):
        lines = [seq[k:k + 70] for k in range(0, len(seq), 70)]
        (tmp_path / name).write_text(f">{name}\n" + "\n".join(lines) + "\n")
        paths.append(str(tmp_path / name))
    return paths


SCORE_42 = "alignment score: 2204  ("


class TestColumnSplitCLI:
    """--split W1,..,Wn, --fork and the oversize split through both CLIs on
    the seed-42 pair: the same score line and byte-identical crosspoint
    and alignment files.  Both CLIs' --fork listen on ports 7300 and up,
    so every CLI fork case lives in this file and runs in turn."""

    @pytest.mark.parametrize("flags", [
        ["--split", "1,1"], ["--split", "1,2", "--traceback", "speculative"],
        ["--fork", "2"]], ids=["split", "split-speculative", "fork"])
    def test_matches_masa_tpu(self, seed42_fastas, tmp_path, flags):
        mine, ref = run_both(seed42_fastas + flags, tmp_path)
        score = [ln for ln in mine if ln.startswith("alignment score:")]
        assert score == [ln for ln in ref if ln.startswith("alignment")]
        assert score[0].startswith(SCORE_42)
        same_artifacts(str(tmp_path / "port"), str(tmp_path / "ref"))

    def test_split_stage1_only(self, seed42_fastas, tmp_path):
        mine, ref = run_both(seed42_fastas + ["--split", "2,1", "--stage-1"],
                             tmp_path)
        assert mine[-1] == ref[-1] == ("stage1 (weighted column split "
                                       "[2000, 1000]): best=2204")

    def test_oversize_input_splits(self, seed42_fastas, tmp_path,
                                   monkeypatch):
        """seq1 wider than the capability: chained 1024-column slabs,
        masa_tpu's score line and alignment."""
        from masa_tpu_torch import cli

        monkeypatch.setattr(cli, "AlignerCapabilities", lambda: Caps(1024))
        monkeypatch.setattr(jcaps, "AlignerCapabilities",
                            lambda: Caps(1024, JCaps))
        mine, ref = run_both(seed42_fastas, tmp_path)
        assert "seq1 exceeds per-run capability (1024 bp): splitting " \
            "columns" in mine
        score = [ln for ln in mine if ln.startswith("alignment score:")]
        assert score == [ln for ln in ref if ln.startswith("alignment")]
        assert score[0].startswith(SCORE_42)
        same_artifacts(str(tmp_path / "port"), str(tmp_path / "ref"))


class TestShardedCLI:
    """--split N (the sharded mode) through both CLIs on the seed-42 pair:
    masa_tpu's slab cut (W = 750 on 4 slabs) and strip height (4096 rows),
    so the same crosspoint and alignment files byte for byte and the same
    lines."""

    def test_matches_masa_tpu(self, seed42_fastas, tmp_path):
        mine, ref = run_both(seed42_fastas + ["--split", "4"], tmp_path)
        assert mine[-1] == ref[-1]
        assert mine[-1].startswith(SCORE_42 + "sharded over 4 devices; ")
        assert "stage5: score=2204 verified" in " ".join(mine)
        same_artifacts(str(tmp_path / "port"), str(tmp_path / "ref"))
        assert os.path.exists(tmp_path / "port" / "sharded" /
                              "sharded_carry.npz")

    def test_stage1_only(self, seed42_fastas, tmp_path):
        mine, ref = run_both(seed42_fastas + ["--split", "4", "--stage-1"],
                             tmp_path)
        assert mine[-1] == ref[-1] == ("stage1 (sharded over 4 devices): "
                                       "best=2204")

    def test_global_alignment_stops(self, seed42_fastas, tmp_path, capsys):
        """Only local alignment shards, in both packages: a parser error
        (exit 2) for --alignment-start '!'."""
        for name, fn, extra in (("port", main, ["--device", "cpu"]),
                                ("ref", jmain, [])):
            with pytest.raises(SystemExit) as e:
                fn(seed42_fastas + ["--split", "2", "--alignment-start", "!",
                                    "--work-dir", str(tmp_path / name)]
                   + extra)
            assert e.value.code == 2, name
            assert "--split only supports local alignment" in \
                capsys.readouterr().err

    def test_list_devices(self, capsys):
        """masa_tpu's listing: a header, then one line a device with its
        process (the conftest gives masa_tpu 8 CPU devices; the port lists
        its CPU once)."""
        assert main(["--list-devices"]) == 0
        mine = capsys.readouterr().out.splitlines()
        assert jmain(["--list-devices"]) == 0
        ref = capsys.readouterr().out.splitlines()
        assert mine[0] == ref[0] == "available devices:"
        assert mine[-1] == ref[1] == "  [0] cpu cpu (process 0)"


def test_cli_self_test():
    assert main(["--test", "--device", "cpu"]) == 0
