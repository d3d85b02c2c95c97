// The Gotoh affine-gap cell of the Hopper kernels, in one place.
//
// csrc/strip.cu and csrc/batched_strip.cu sweep it over their strips and
// csrc/roofline.cu times it alone (bodies k1, k1n, k1w), so the
// roofline's cell rates are rates of the very instructions the kernels
// execute per cell and cannot drift away from them.  They say what this
// spelling of the cell costs; they are not the kernels' bound.
//
// One cell at (row r, column j), from the cell to the left (h, e: the
// row's H and E at column j-1), the cell above (vh, vf: H and F of row
// r-1 at column j) and the diagonal dg = H(r-1, j-1):
//
//   E = max(h + gofirst, e - ge)          gofirst = -(gap_open + gap_ext)
//   F = max(vh + gofirst, vf - ge)
//   H = max(dg + (a == b ? match : mismatch), E, F)       [and 0 for SW]
//
// On return h, e hold the row's new H and E, vh, vf the new H and F (what
// the cell below reads as its cell above), and dg the row's old H (the
// diagonal of the cell below).  Eight integer instructions: three DPX
// add-max (__viaddmax_s32), one max (__vimax_s32_relu for SW), two
// subtracts, a compare and a select.  On an H100 the compiler sends the
// two subtracts to the FMA pipe (VIADD), so six need one of the SM's 64
// INT32 lanes (tools/roofline.py counts them in the SASS).  The scores are
// run-time values.  The recurrence itself needs four of the six, the
// add-max and the max: the compare and the select could leave the lanes
// (literal scores, a looked-up substitution), and the kernels' bound
// counts those four only (tools/roofline.py CELL_FLOOR).

#pragma once

namespace masa {

template <bool SW>
__device__ __forceinline__ void gotoh_cell(int& h, int& e, int& dg, int& vh,
                                           int& vf, int a, int b, int match,
                                           int mismatch, int gofirst, int ge) {
  const int en = __viaddmax_s32(h, gofirst, e - ge);
  const int f = __viaddmax_s32(vh, gofirst, vf - ge);
  const int sub = a == b ? match : mismatch;
  const int d = __viaddmax_s32(dg, sub, en);
  const int hv = SW ? __vimax_s32_relu(d, f) : max(d, f);
  dg = h;
  h = hv;
  e = en;
  vh = hv;
  vf = f;
}

// The per-row best: the largest H and the first column reaching it.
// Three more instructions a cell, all on the INT32 lanes (the compiler
// makes it a max, a compare and a select); the bound counts one, the max.
__device__ __forceinline__ void track_best(int hv, int j, int& bv, int& bj) {
  if (hv > bv) {
    bv = hv;
    bj = j;
  }
}

}  // namespace masa
