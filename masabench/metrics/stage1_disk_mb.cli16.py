"""Special rows, the CLI at its defaults: the MB (10^6 bytes) a pair of
the special-row files stage 1 wrote to the work directory, by the
program's own counter."""

from masabench.program import count

_bytes = count("stage1", "rows.bytes")


def read(run):
    b = _bytes(run)
    return None if b is None else b / 1e6
