"""Special rows, full alignments: the seconds a pair of stage 1's row
flush, by the program's own spans (pack, pull, escapes, file write)."""

from masabench.program import ROWS, span_s

read = span_s("stage1", ROWS)
