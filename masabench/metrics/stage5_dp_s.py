"""Host traceback: the seconds a pair of stage 5's constrained DP (the
native call, or the plain DP without it), by the program's own spans; the
rest of the stage is the walk of its operations."""

from masabench.program import span_s

read = span_s("stage5", ("dp",))
