"""Frozen constants of the yardstick, so that a change to the program
cannot move it: kernel 1's roofline peak and the work of one cell."""

# Kernel 1's peak: 132 SMs x 64 INT32 lanes x 1,980 MHz, the H100 SXM's
# published SM count, INT32 lanes per SM and boost clock, in lane
# instructions a second; a Gotoh cell with its best tracked takes 5.
INT32_PEAK = 132 * 64 * 1980e6
CELL_INSTRUCTIONS = 5
