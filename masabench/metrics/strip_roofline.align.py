"""Kernel 1 in full alignments: the matrix's cells x 5 INT32-lane
instructions over the peak, as a share of stage 1's kernel-1 event time
(%)."""

from masabench.readings import strip_roofline

read = strip_roofline
