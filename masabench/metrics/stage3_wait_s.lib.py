"""Passes: the seconds a pair the host waits on the card in the library
call's stage 3, by the program's own spans (a read of a result or of a
row)."""

from masabench.program import WAITS, span_s

read = span_s("stage3", WAITS)
