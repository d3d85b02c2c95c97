"""Full alignments: the m*n of the pairs finished in the window over its
seconds (GCUPS)."""

from masabench.readings import gcups

read = gcups
