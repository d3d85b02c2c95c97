"""The set-up's seconds: from the harness's start to the window's:
imports, the kernels' build or load, the first pair, the warm-up pair."""


def read(run):
    return run.setup_s
