"""Text: the seconds a pair of stage 6 (the re-check, the rendering and
the file), by the program's own stage span."""

from masabench.program import stage_s

read = stage_s("stage6")
