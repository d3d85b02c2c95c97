"""Special rows, full alignments: stage 1's seconds a pair less kernel 1's
event time."""

from masabench.readings import stage1_host_s

read = stage1_host_s
