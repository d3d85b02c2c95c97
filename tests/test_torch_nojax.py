"""The port imports neither JAX nor the JAX package: a full alignment
through the strip engine, the batched stage-4 engine, the stage-6 re-score
and the CLI (its ``--test`` included) run in child processes where ``import
jax`` and ``import masa_tpu`` are made to fail, no source file of the port
names either in an import, and chip_smoke.py refuses to run without a CUDA
device.  (``masa_tpu`` is imported here, in the parent, for its oracle
only.)"""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED_RUN = r"""
import sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "masa_tpu"):
            raise ImportError(f"{name} is blocked in this test")

sys.meta_path.insert(0, NoJax())

def foreign():
    return [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "masa_tpu")]

import numpy as np

import masa_tpu_torch
import masa_tpu_torch.convert
from masa_tpu_torch.ops import oracle

rng = np.random.default_rng(3)
bases = np.frombuffer(b"ACGT", np.uint8)
s0 = rng.choice(bases, 600).astype(np.uint8)
s1 = s0.copy()
idx = rng.random(600) < 0.1
s1[idx] = rng.choice(bases, int(idx.sum())).astype(np.uint8)
# backend "kernel": stage 1 runs the strip engine and dispatches its
# special row (600 > 512) through the manager's border synthesis
aln = masa_tpu_torch.align(s0, s1, device="cpu", backend="kernel")
ref = oracle.dp_rows(s0, s1)
assert aln.raw_score == ref.best, (aln.raw_score, ref.best)
assert list(aln.end) == [ref.best_i, ref.best_j]
# the GPU's stage 4 (batched strips; plain on the CPU) and stage 6
from masa_tpu_torch.ops import batched_mm
from masa_tpu_torch.stages import stage6
from masa_tpu_torch.types import Crosspoint
cps = [Crosspoint(0, 0, 0), Crosspoint(300, 300, int(
    oracle.dp_rows(s0[:300], s1[:300], masa_tpu_torch.ScoreParams(),
                   masa_tpu_torch.Recurrence.NEEDLEMAN_WUNSCH,
                   masa_tpu_torch.InitType.WITH_GAPS,
                   masa_tpu_torch.InitType.WITH_GAPS).last_h[-1]))]
out = batched_mm.reduce_partitions_batched(
    s0, s1, cps, masa_tpu_torch.ScoreParams(), 16, device="cpu")
assert out[0] == cps[0] and out[-1] == cps[-1] and len(out) > 2
assert stage6.recheck(aln, s0, s1).score == aln.raw_score
# the CLI's built-in self-check, in this same blocked process
from masa_tpu_torch.cli import main
assert main(["--test", "--device", "cpu"]) == 0
assert not foreign(), foreign()
print("ok", aln.raw_score)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_alignment_runs_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=REPO,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "self-test: PASS" in r.stdout, r.stdout
    assert r.stdout.splitlines()[-1].startswith("ok "), r.stdout


BLOCKED_CLI = r"""
import runpy
import sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "masa_tpu"):
            raise ImportError(f"{name} is blocked in this test")

sys.meta_path.insert(0, NoJax())

def foreign():
    return [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "masa_tpu")]
sys.argv = ["masa_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("masa_tpu_torch", run_name="__main__")
finally:
    assert not foreign(), foreign()
"""


def test_cli_runs_with_jax_blocked(tmp_path):
    """``python -m masa_tpu_torch --device cpu a.fa b.fa`` with ``import
    jax`` made to fail: the full persistent run, in one call, prints
    masa_tpu's score line (the oracle's score for the pair), and its stage
    2 matches on the device from the rows stage 1 kept there (the pair's
    path runs clear of column 0, where the device match serves)."""
    import numpy as np

    from masa_tpu.ops import oracle

    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s0 = rng.choice(bases, 1500)
    s1 = s0.copy()
    idx = rng.random(1500) < 0.08
    s1[idx] = rng.choice(bases, int(idx.sum()))
    s1 = np.concatenate([rng.choice(bases, 4500), s1])
    for name, s in (("a.fa", s0), ("b.fa", s1)):
        (tmp_path / name).write_bytes(b">" + name.encode() + b"\n"
                                      + s.tobytes() + b"\n")
    r = subprocess.run(
        [sys.executable, "-c", BLOCKED_CLI, "--device", "cpu",
         str(tmp_path / "a.fa"), str(tmp_path / "b.fa"),
         "--work-dir", str(tmp_path / "w"), "--backend", "kernel"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    best = oracle.dp_rows(s0, s1).best
    assert f"alignment score: {best}  (matches=" in r.stdout, r.stdout
    with open(tmp_path / "w" / "statistics_02.00") as fh:
        stats = dict(line.split(":") for line in fh if ":" in line)
    assert int(stats["  dev_matches"]) >= 2, stats
    assert int(stats["  window_reads"]) == 0, stats


def _blocked_fastas(tmp_path):
    import numpy as np

    rng = np.random.default_rng(42)
    s0 = rng.choice(np.frombuffer(b"ACGT", np.uint8), 1500)
    s1 = s0.copy()
    idx = rng.random(1500) < 0.08
    s1[idx] = rng.choice(np.frombuffer(b"ACGT", np.uint8), int(idx.sum()))
    for name, s in (("a.fa", s0), ("b.fa", s1)):
        (tmp_path / name).write_bytes(b">" + name.encode() + b"\n"
                                      + s.tobytes() + b"\n")
    return s0, s1


def test_split_cli_runs_with_jax_blocked(tmp_path):
    """``--split 1,1`` (slab stage 1 with a file:// border, the slab
    traceback, stages 3-6) with ``import jax`` made to fail."""
    from masa_tpu.ops import oracle

    s0, s1 = _blocked_fastas(tmp_path)
    r = subprocess.run(
        [sys.executable, "-c", BLOCKED_CLI, "--device", "cpu",
         str(tmp_path / "a.fa"), str(tmp_path / "b.fa"),
         "--work-dir", str(tmp_path / "w"), "--split", "1,1"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    best = oracle.dp_rows(s0, s1).best
    assert (f"alignment score: {best}  (weighted column split [750, 750]; "
            f"matches=") in r.stdout, r.stdout


BLOCKED_SHARDED = r"""
import sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "masa_tpu"):
            raise ImportError(f"{name} is blocked in this test")

sys.meta_path.insert(0, NoJax())
from masa_tpu_torch.cli import main
from masa_tpu_torch.tools.dryrun_multichip import dryrun_multichip

assert main(sys.argv[1:]) == 0
assert dryrun_multichip(2, "cpu") == 600
foreign = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "masa_tpu")]
assert not foreign, foreign
"""


def test_sharded_runs_with_jax_blocked(tmp_path):
    """``--split 2`` (the sharded mode: a 2-slab pipeline, the slab
    traceback, stages 3-6) and the sharded dry run, in one child process
    with ``import jax`` and ``import masa_tpu`` made to fail."""
    from masa_tpu.ops import oracle

    s0, s1 = _blocked_fastas(tmp_path)
    r = subprocess.run(
        [sys.executable, "-c", BLOCKED_SHARDED, "--device", "cpu",
         str(tmp_path / "a.fa"), str(tmp_path / "b.fa"),
         "--work-dir", str(tmp_path / "w"), "--split", "2"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    best = oracle.dp_rows(s0, s1).best
    assert (f"alignment score: {best}  (sharded over 2 devices; "
            f"matches=") in r.stdout, r.stdout
    assert "dryrun_multichip(2) on cpu: full alignment score=600" \
        in r.stdout, r.stdout


# imported by every fork worker at start-up (site's sitecustomize hook):
# blocks JAX and checks at exit that nothing imported it
SITECUSTOMIZE = r"""
import atexit
import sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "masa_tpu"):
            raise ImportError(f"{name} is blocked in this test")

sys.meta_path.insert(0, NoJax())

def foreign():
    return [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "masa_tpu")]

@atexit.register
def _check():
    if foreign():
        sys.stderr.write(f"imported: {foreign()}\n")
        import os
        os._exit(3)
"""


def test_fork_workers_run_with_jax_blocked(tmp_path):
    """Two fork workers, each with ``import jax`` made to fail, align the
    pair to the oracle's score."""
    from masa_tpu.ops import oracle
    from masa_tpu_torch.parallel.fork import run_fork

    from test_torch_split import free_base

    s0, s1 = _blocked_fastas(tmp_path)
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    res = run_fork(s0, s1, [1.0, 1.0], str(tmp_path / "fw"),
                   base_port=free_base(1), device="cpu", timeout=300,
                   extra_env={"PYTHONPATH": str(site)})
    assert res["score"] == oracle.dp_rows(s0, s1).best


def _imports(path):
    import ast

    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "masa_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_source_of_the_port_imports_jax_or_masa_tpu():
    """Every file under masa_tpu_torch/ and chip_smoke.py, by its syntax
    tree: no import (at any depth, so run-time imports too) names jax,
    jaxlib or masa_tpu; import_module and __import__ are called only with
    a string literal, and with none naming them, so no computed name can
    reach them either."""
    import ast

    sources = _port_sources()
    assert len(sources) > 40, len(sources)
    bad = {}
    for path in sources:
        names = {n for n in _imports(path)
                 if n.split(".")[0] in ("jax", "jaxlib", "masa_tpu")}
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                        "import_module", "__import__")):
                continue
            arg = node.args[0] if node.args else None
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                names.add(f"computed import at line {node.lineno}")
            elif arg.value.split(".")[0] in ("jax", "jaxlib", "masa_tpu"):
                names.add(arg.value)
        if names:
            bad[os.path.relpath(path, REPO)] = sorted(names)
    assert not bad, bad


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the system through masa_tpu_torch alone:
    no module of JAX or of the JAX package is imported by name."""
    names = _imports(os.path.join(REPO, "chip_smoke.py"))
    assert "masa_tpu_torch" in {n.split(".")[0] for n in names}
    bad = {n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                   "masa_tpu")}
    assert not bad, bad


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return False
        except (ValueError, AttributeError):
            continue
    return True


def test_chip_smoke_needs_a_cuda_device(tmp_path):
    """With no CUDA device visible the script exits non-zero, says why
    and prints no result; so does a lone copy of it outside the repo."""
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert _no_result(r.stdout)
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    bare = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=bare,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert _no_result(r.stdout)


BLOCKED_BIG_RUN = r"""
import runpy
import sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "masa_tpu"):
            raise ImportError(f"{name} is blocked in this test")

sys.meta_path.insert(0, NoJax())
sys.argv = ["big_run"] + sys.argv[1:]
from masa_tpu_torch.tools import pairs
pairs.SIZES["23M"], pairs.PADDED["23M"] = 1024, 1300  # a small pair
del pairs.SCORES["23M"]
try:
    runpy.run_module("masa_tpu_torch.tools.big_run", run_name="__main__")
finally:
    foreign = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "masa_tpu")]
    assert not foreign, foreign
"""


def test_big_run_runs_with_jax_blocked(tmp_path):
    """``python -m masa_tpu_torch.tools.big_run`` (the chromosome-scale
    tool, at --device cpu on a small padded pair) with ``import jax`` and
    ``import masa_tpu`` made to fail: it runs the six stages and prints
    its line; the AST walk above covers its source."""
    assert os.path.join(REPO, "masa_tpu_torch", "tools", "big_run.py") \
        in _port_sources()
    r = subprocess.run(
        [sys.executable, "-c", BLOCKED_BIG_RUN, "23M", "--device", "cpu",
         "--work-dir", str(tmp_path / "w")],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.splitlines()[-1])
    assert line["n"] == 1300 and line["score"] > 0
    assert "stage6" in line["stage_end_marks_s"]
