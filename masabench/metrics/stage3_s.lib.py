"""Passes: stage 3's seconds a pair in the library call (a span around
stage3_densify)."""

from masabench.readings import stage_s

read = stage_s("stage3")
