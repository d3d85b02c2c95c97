"""Host traceback: the partitions a pair stage 5 aligns, by the program's
own counter."""

from masabench.program import count

read = count("stage5", "partitions")
