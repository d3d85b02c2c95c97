"""Hops, the CLI at its defaults: the seconds a pair of stage 2's
work-directory file calls, by the program's own spans (a crosspoint's
append to its file, and the removal of the special-row files above it)."""

from masabench.program import span_s

read = span_s("stage2", ("cps.write", "rows.remove"))
