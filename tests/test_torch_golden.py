"""The golden CLI runs (tests/test_golden.py) through the port's CLI on the
CPU, beside masa_tpu's CLI on the same FASTA files: the frozen score line,
and the same crosspoint files and stage-6 output as masa_tpu's run.
Tolerance: exact equality."""

import contextlib
import io
import os

import pytest

from masa_tpu.cli import main as jmain
from masa_tpu_torch.cli import main
from test_golden import _LINE, CASES, G
from test_torch_runner_cli import same_artifacts


def run(fn, pair, flags, workdir, extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn([os.path.join(G, f"{pair}_a.fa"),
                 os.path.join(G, f"{pair}_b.fa"),
                 "--work-dir", workdir, "--backend", "numpy",
                 "--verbose", "0"] + flags + extra)
    assert rc == 0
    m = _LINE.search(buf.getvalue())
    assert m, buf.getvalue()
    return tuple(int(x) for x in m.groups())


@pytest.mark.parametrize("pair,flags,expect", CASES,
                         ids=[f"{p}-{'_'.join(f) or 'local'}"
                              for p, f, _ in CASES])
def test_golden_cli(pair, flags, expect, tmp_path):
    mine, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert run(main, pair, flags, mine, ["--device", "cpu"]) == expect
    assert run(jmain, pair, flags, ref, []) == expect
    same_artifacts(mine, ref)
