// Hopper batched strip kernel: many score-only NW strips in one launch.
//
// Replaces masa_tpu/ops/wavefront.py:batched_strip_pallas_dyn, the TPU
// kernel of stage 4's level-batched Myers-Miller engine (ops/batched_mm).
// Element e of a launch is one half-pass of one crosspoint pair: rows
// [i0, i0+h) of the sequence view `a` against columns [j0, j0+w) of `b`,
// Needleman-Wunsch with affine gaps, from synthesized borders.  It keeps
// the strip contract of csrc/strip.cu in logical coordinates:
//   bus_h/bus_f[e, j] = DP (H, F) of the element's last row at column j+1
// for j < w; columns j >= w are not written.  The first row's bus is
// H = border(row_code, j+1), F = -INF; the left border at row r (DP row
// r+1) is H = border(col_code, r+1), E = -INF; the corner is
// border(col_code, 0).  Border codes follow masa_tpu.types.InitType:
// 0 zeroes, 1 gaps, 2 gaps opened.
//
// What bounds it: as for csrc/strip.cu, int32 ALU work per cell and one
// __syncthreads() per wavefront step; the bus (8 bytes per column) and the
// characters are read once per sub-strip, so memory bandwidth is not the
// limit.  Stage 4's halves are short (tens to hundreds of rows) and many
// (thousands per level), so the card is filled by elements, not rows.
//
// What the design does about that: one block per element, so a level's
// thousands of halves spread over every SM in one launch with no
// cross-block traffic.  Thread t owns ALPHA consecutive rows and at step s
// computes column j = s - t for all of them, as in csrc/strip.cu; the
// block size is a launch argument, picked from the tallest element, so a
// 64-row half runs on one warp instead of idling 248 threads.  An element
// taller than ALPHA * blockDim rows chains sub-strips in the same block,
// reading and rewriting its bus row in place (a barrier orders them).
// Heights, widths, offsets, border codes and scores are runtime data.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -999999999;  // -INF of masa_tpu.types, with headroom
constexpr int ALPHA = 8;         // rows per thread
constexpr int MAX_THREADS = 256;
enum Field { I0, H, J0, W, ROW_CODE, COL_CODE, N_FIELDS };

struct Args {
  const uint8_t* a;  // sequence view the rows index
  const uint8_t* b;  // sequence view the columns index
  const int* elems;  // (B, N_FIELDS)
  int* bus_h;        // (B, width)
  int* bus_f;
  int width;
  int match, mismatch, go, ge;
};

// models.scoring.border_cells: the border H at position k
__device__ __forceinline__ int border_h(int code, int k, int go, int ge) {
  if (code == 0) return 0;
  if (code == 1) return k == 0 ? 0 : -go - k * ge;
  return -k * ge;
}

__global__ void __launch_bounds__(MAX_THREADS)
    batched_strip_kernel(Args p) {
  __shared__ int xh[2][MAX_THREADS];
  __shared__ int xf[2][MAX_THREADS];
  const int* el = p.elems + (size_t)blockIdx.x * N_FIELDS;
  const int h = el[H], w = el[W];
  if (w <= 0) return;  // the whole block leaves together
  const uint8_t* a = p.a + el[I0];
  const uint8_t* b = p.b + el[J0];
  const int rc = el[ROW_CODE], cc = el[COL_CODE];
  int* bus_h = p.bus_h + (size_t)blockIdx.x * p.width;
  int* bus_f = p.bus_f + (size_t)blockIdx.x * p.width;
  const int t = threadIdx.x;
  const int rows = ALPHA * (int)blockDim.x;

  for (int top = 0; top < h; top += rows) {
    const int h_sub = min(rows, h - top);
    const int last_t = (h_sub - 1) / ALPHA;  // owner of the last row
    const int last_k = (h_sub - 1) % ALPHA;
    const int row0 = top + t * ALPHA;
    const bool owner = t <= last_t;

    int hl[ALPHA], el_[ALPHA], ch[ALPHA];
#pragma unroll
    for (int k = 0; k < ALPHA; ++k) {
      const int r = row0 + k;
      const bool valid = owner && r < h;
      ch[k] = valid ? (int)a[r] : -1;  // -1 never equals a byte
      hl[k] = valid ? border_h(cc, r + 1, p.go, p.ge) : NEG;
      el_[k] = NEG;
    }
    // H of the row above at column -1: the left border (the corner at 0)
    int dprev = owner ? border_h(cc, row0, p.go, p.ge) : NEG;

    const int steps = w + last_t;
    for (int s = 0; s < steps; ++s) {
      const int j = s - t;
      int uh = NEG, uf = NEG;  // (H, F) of the row above at column j
      if (t == 0) {
        if (j < w) {
          if (top == 0) {
            uh = border_h(rc, j + 1, p.go, p.ge);
          } else {
            uh = bus_h[j];
            uf = bus_f[j];
          }
        }
      } else {
        uh = xh[(s - 1) & 1][t - 1];
        uf = xf[(s - 1) & 1][t - 1];
      }
      if (owner && j >= 0 && j < w) {
        const int bc = b[j];
        int dg = dprev, vh = uh, vf = uf, oh = 0, of = 0;
#pragma unroll
        for (int k = 0; k < ALPHA; ++k) {
          const int e = max(hl[k] - p.go, el_[k]) - p.ge;
          const int f = max(vh - p.go, vf) - p.ge;
          const int hv =
              max(max(dg + (ch[k] == bc ? p.match : p.mismatch), e), f);
          dg = hl[k];
          hl[k] = hv;
          el_[k] = e;
          vh = hv;
          vf = f;
          if (k == last_k) {
            oh = hv;
            of = f;
          }
        }
        xh[s & 1][t] = vh;
        xf[s & 1][t] = vf;
        dprev = uh;
        if (t == last_t) {
          bus_h[j] = oh;
          bus_f[j] = of;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int masa_batched_strip_max_threads() { return MAX_THREADS; }

// Launch `n` elements on `stream` with `threads` threads per block (a
// multiple of 32, at most MAX_THREADS).  Returns a cudaError_t value: 0
// when the launch was accepted.
extern "C" int masa_batched_strip_launch(const void* a, const void* b,
                                         const void* elems, int n,
                                         int threads, void* bus_h,
                                         void* bus_f, int width, int match,
                                         int mismatch, int gap_open,
                                         int gap_ext, void* stream) {
  if (n < 1 || threads < 32 || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidConfiguration;
  Args p;
  p.a = static_cast<const uint8_t*>(a);
  p.b = static_cast<const uint8_t*>(b);
  p.elems = static_cast<const int*>(elems);
  p.bus_h = static_cast<int*>(bus_h);
  p.bus_f = static_cast<int*>(bus_f);
  p.width = width;
  p.match = match;
  p.mismatch = mismatch;
  p.go = gap_open;
  p.ge = gap_ext;
  batched_strip_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}
