"""Special rows, the CLI at its defaults: the seconds a pair of stage 1's
rewrites of the crash-safe status file (tmp + rename, one a special
row), by the program's own span."""

from masabench.program import span_s

read = span_s("stage1", ("status.save",))
