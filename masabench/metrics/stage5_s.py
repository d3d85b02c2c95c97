"""Host traceback: stage 5's seconds a pair (a span around the stage's
function)."""

from masabench.readings import stage_s

read = stage_s("stage5")
