"""Hops, the CLI at its defaults: the chained segments a pair stage 2's
march issued its hops in, by the program's own counter."""

from masabench.program import count

read = count("stage2", "hops.segments")
