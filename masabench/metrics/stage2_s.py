"""Hops: stage 2's seconds a pair (a span around the stage's function, ended by
a device sync)."""

from masabench.readings import stage_s

read = stage_s("stage2")
