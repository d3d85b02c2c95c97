"""Passes: kernel 1's launches a pair inside stage 3 (the wrapper's launch
counter)."""

from masabench.readings import launches

read = launches("stage3", "strip")
