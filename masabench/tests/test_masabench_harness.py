"""The harness on the CPU: it finds every cell's configuration, traffic,
entry and metrics by name, draws the same pair from the same seed, runs a
whole cell end to end at a tiny size on the port's plain versions, and
refuses to run the command without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from masabench import pairs, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
BIG_SEED = (1 << 31) + 12345


def tiny(name, m=400, traffic=None):
    """Cell ``name`` at m bases a side; ``traffic``: another mix of
    ``masabench/traffic`` in place of the cell's."""
    cell = run.Cell(BENCH, name, ROOT)
    cell.config["pair"]["m"] = m
    cell.config["warmup_m"] = 120
    if traffic:
        cell.traffic = run.load_json(os.path.join(run.HERE, "traffic",
                                                  f"{traffic}.json"))
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_finds_its_files_by_name(name):
    cell = run.Cell(BENCH, name, ROOT)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["mode"] in ("full", "score")
    assert os.path.exists(os.path.join(run.HERE, "entries",
                                       cell.config["entry"] + ".py"))
    for trace in (False, True):
        for m in cell.metrics(trace):
            assert callable(run._load_module("metrics", m["name"]).read)
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_every_config_key_reduced_is_in_its_file():
    for c in BENCH["configs"]:
        cfg = run.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert set(c["reduced"]) <= set(cfg)


def test_the_pair_is_a_function_of_the_seed():
    spec = {"m": 5000, "sub_rate": 0.08, "indel_every": 512, "indel_max": 7}
    a0, a1 = pairs.draw(BIG_SEED, spec)
    b0, b1 = pairs.draw(BIG_SEED, spec)
    c0, c1 = pairs.draw(BIG_SEED + 1, spec)
    assert np.array_equal(a0, b0) and np.array_equal(a1, b1)
    assert not np.array_equal(a0, c0)
    assert len(a0) == len(c0) == 5000
    assert abs(len(a1) - 5000) <= 9 * 7 and set(a1.tobytes()) <= set(b"ACGT")
    # s1 is s0's homolog: most of its bases agree along the diagonal
    assert (a0[:400] == a1[:400]).mean() > 0.85


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_a_configs_pair_is_a_sequence_against_itself(name):
    cfg = run.load_json(os.path.join(ROOT, f"masabench/configs/{name}.json"))
    s0, s1 = pairs.draw(BIG_SEED, dict(cfg["pair"], m=3000), 2)
    t0, _ = pairs.draw(BIG_SEED, dict(cfg["pair"], m=3000), 3)
    assert np.array_equal(s0, s1) and not np.array_equal(s0, t0)


def test_fasta_round_trip(tmp_path):
    seq = pairs.draw(7, {"m": 333, "sub_rate": 0.08, "indel_every": 100,
                         "indel_max": 7})[0]
    path = str(tmp_path / "a.fa")
    pairs.write_fasta(path, "a", seq, width=50)
    lines = open(path, "rb").read().split(b"\n")
    assert lines[0] == b">a" and b"".join(lines[1:]) == seq.tobytes()


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_end_to_end_on_the_cpu(name, trace):
    cell = tiny(name)
    result, failed = run.run_cell(cell, BIG_SEED, 0.01, trace, device="cpu")
    assert result["correct"] and failed == 0
    assert result["attempted"] == 1
    assert list(result)[-1] == "checks"
    assert result["checks"]["score_gap"] == {"value": 0, "limit": 0}
    assert result["checks"]["end_gap"] == {"value": 0, "limit": 0}
    assert result["checks"]["score_spread"] == {"value": 0, "limit": 0}
    assert result["checks"]["end_faults"] == {"value": 0, "limit": 0}
    full = cell.traffic["mode"] == "full"
    assert ("path_gap" in result["checks"]) == full
    names = {m["name"] for m in cell.metrics(trace)}
    got = set(result["metrics"])
    if trace:
        # the CPU has no device trace, no launch events and no launches
        assert got == names - {"device_idle.align", "strip_roofline.align"}
        assert "busy_s" in result["device"] and "window_s" in result["device"]
    else:
        assert got == names
        rate = [v for k, v in result["metrics"].items() if "gcups" in k]
        assert rate[0]["value"] > 0 and rate[0]["unit"] == "GCUPS"


def test_the_window_runs_pairs_back_to_back_until_its_clock_is_up():
    # the score-only mix (--no-flush): the CLI's best score and end point
    cell = tiny("cp1m-cli.full", m=300, traffic="score")
    result, _ = run.run_cell(cell, 5, 0.3, False, device="cpu")
    assert result["correct"] and result["attempted"] >= 2
    assert "path_gap" not in result["checks"]


def test_the_command_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        rc = run.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1"])
    finally:
        os.chdir(cwd)
    out = capsys.readouterr()
    assert rc != 0 and not out.out.strip()
    assert "CUDA card" in out.err


def test_the_command_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "masabench"), tmp_path / "masabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "masabench", "--workload",
                        CELLS[0], "--seed", "3", "--seconds", "1"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


# -- what the harness may import -------------------------------------------

BANNED = {"jax", "jaxlib", "flax", "masa_tpu"}


def imported(path):
    """The top-level names a file imports."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def files():
    for dirpath, _, names in os.walk(run.HERE):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def test_nothing_imports_jax_or_the_jax_package():
    found = {p: imported(p) & BANNED for p in files()}
    assert not {p: f for p, f in found.items() if f}
    # names are compared whole: the port's name begins with the JAX one's
    assert "masa_tpu_torch" not in BANNED and "masa_tpu_torch" not in \
        run.BANNED


@pytest.mark.parametrize("name", ["reference.py", "pairs.py", "frozen.py",
                                  "check.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    got = imported(os.path.join(run.HERE, name))
    assert not got & (BANNED | {"masa_tpu_torch"})


def test_benchmark_json_names_files_under_its_paths():
    paths = BENCH["paths"]
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
    assert json.dumps(BENCH["command"]).count("/") == 0


def test_device_activity_is_the_union_of_operations_inside_the_pairs():
    from masabench.trace import reduce_activity

    pairs = [(0, 100), (200, 300)]
    stages = [(0, 50, "stage1"), (50, 100, "stage5"), (200, 300, "stage1")]
    dev = [(10, 30, "k"), (20, 40, "k"), (90, 210, "h"), (250, 260, "k")]
    got = reduce_activity(pairs, stages, dev)
    # busy: 10-40, 90-100, 200-210, 250-260; the pairs: 200 ns
    assert got["busy_s"] * 1e9 == pytest.approx(60)
    assert got["window_s"] * 1e9 == pytest.approx(200)
    idle = dict(got["breakdown"]["idle_gaps"])
    assert idle["stage1"] * 1e9 == pytest.approx(10 + 10 + 40 + 40)
    assert idle["stage5"] * 1e9 == pytest.approx(40)
    ops = dict(got["breakdown"]["device_ops"])
    assert ops["k"] * 1e9 == pytest.approx(50) and ops["h"] * 1e9 == \
        pytest.approx(20)
