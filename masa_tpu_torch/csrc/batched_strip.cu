// Hopper batched strip kernels: many score-only NW strips in one launch.
//
// Two entries share one sweep (`sweep` below):
//
//  * batched_strip_kernel replaces masa_tpu/ops/wavefront.py:
//    batched_strip_pallas_dyn, the TPU kernel of stage 4's level-batched
//    Myers-Miller engine (ops/batched_mm).  Element e of a launch is one
//    half-pass of one crosspoint pair: rows [i0, i0+h) of the sequence
//    view `a` against columns [j0, j0+w) of `b`, from synthesized borders.
//    The first row's bus is H = border(row_code, j+1), F = -INF; the left
//    border at row r (DP row r+1) is H = border(col_code, r+1), E = -INF;
//    the corner is border(col_code, 0).  Border codes follow
//    masa_tpu.types.InitType: 0 zeroes, 1 gaps, 2 gaps opened.  Output:
//    bus_h/bus_f[e, j] = DP (H, F) of the element's last row at column
//    j+1 for j < w; columns j >= w are not written.
//
//  * batched_strip_fixed_kernel replaces masa_tpu/ops/wavefront.py:
//    batched_strip_pallas: B equal-shape elements (h rows, nj columns)
//    with every border given: characters a (B, h) and b (B, nj), the left
//    border's H/E (B, h) at DP rows 1..h, the row above (B, nj) and a
//    corner (B,).  The kernel rewrites the row above, in place, into the
//    last row's (H, F).  Logical column order: the TPU's lane offset and
//    padding are not part of it.
//
// Both keep the strip contract of csrc/strip.cu in logical coordinates.
//
// What bounds them: as for csrc/strip.cu, int32 ALU work per cell and one
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

struct Score {
  int match, mismatch, go, ge;
};

// models.scoring.border_cells: the border H at position k
__device__ __forceinline__ int border_h(int code, int k, int go, int ge) {
  if (code == 0) return 0;
  if (code == 1) return k == 0 ? 0 : -go - k * ge;
  return -k * ge;
}

// Borders synthesized from InitType codes (batched_strip_kernel).
struct CodeBorder {
  int rc, cc, go, ge;
  // DP (H, E) of the left border at DP row r+1
  __device__ int left_h(int r) const { return border_h(cc, r + 1, go, ge); }
  __device__ int left_e(int) const { return NEG; }
  // DP H of the left border at DP row r (r = 0: the corner)
  __device__ int above_h(int r) const { return border_h(cc, r, go, ge); }
  // the first row's (H, F) at column j, before any sub-strip wrote it
  __device__ void first_row(int j, const int*, const int*, int& uh,
                            int& uf) const {
    uh = border_h(rc, j + 1, go, ge);
    uf = NEG;
  }
};

// Borders given as data (batched_strip_fixed_kernel).
struct DataBorder {
  const int* col_h;  // (h,) this element's left border
  const int* col_e;
  int corner;
  __device__ int left_h(int r) const { return col_h[r]; }
  __device__ int left_e(int r) const { return col_e[r]; }
  __device__ int above_h(int r) const {
    return r == 0 ? corner : col_h[r - 1];
  }
  __device__ void first_row(int j, const int* bus_h, const int* bus_f,
                            int& uh, int& uf) const {
    uh = bus_h[j];
    uf = bus_f[j];
  }
};

// One element, h rows by w columns, on the whole block: chained
// sub-strips of ALPHA * blockDim rows; the last row's (H, F) lands in
// bus_h/bus_f[0, w).  Every thread of the block must call it.
template <class Border>
__device__ void sweep(const Border& bd, const uint8_t* a, const uint8_t* b,
                      int h, int w, int* bus_h, int* bus_f, const Score& sc,
                      int (*xh)[MAX_THREADS], int (*xf)[MAX_THREADS]) {
  const int t = threadIdx.x;
  const int rows = ALPHA * (int)blockDim.x;

  for (int top = 0; top < h; top += rows) {
    const int h_sub = min(rows, h - top);
    const int last_t = (h_sub - 1) / ALPHA;  // owner of the last row
    const int last_k = (h_sub - 1) % ALPHA;
    const int row0 = top + t * ALPHA;
    const bool owner = t <= last_t;

    int hl[ALPHA], el[ALPHA], ch[ALPHA];
#pragma unroll
    for (int k = 0; k < ALPHA; ++k) {
      const int r = row0 + k;
      const bool valid = owner && r < h;
      ch[k] = valid ? (int)a[r] : -1;  // -1 never equals a byte
      hl[k] = valid ? bd.left_h(r) : NEG;
      el[k] = valid ? bd.left_e(r) : NEG;
    }
    // H of the row above at column -1: the left border (the corner at 0)
    int dprev = owner ? bd.above_h(row0) : NEG;

    const int steps = w + last_t;
    for (int s = 0; s < steps; ++s) {
      const int j = s - t;
      int uh = NEG, uf = NEG;  // (H, F) of the row above at column j
      if (t == 0) {
        if (j < w) {
          if (top == 0) {
            bd.first_row(j, bus_h, bus_f, uh, uf);
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
          const int e = max(hl[k] - sc.go, el[k]) - sc.ge;
          const int f = max(vh - sc.go, vf) - sc.ge;
          const int hv =
              max(max(dg + (ch[k] == bc ? sc.match : sc.mismatch), e), f);
          dg = hl[k];
          hl[k] = hv;
          el[k] = e;
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

__global__ void __launch_bounds__(MAX_THREADS)
    batched_strip_kernel(const uint8_t* a, const uint8_t* b,
                         const int* elems, int* bus_h, int* bus_f,
                         int width, Score sc) {
  __shared__ int xh[2][MAX_THREADS];
  __shared__ int xf[2][MAX_THREADS];
  const int* el = elems + (size_t)blockIdx.x * N_FIELDS;
  if (el[W] <= 0) return;  // the whole block leaves together
  const CodeBorder bd{el[ROW_CODE], el[COL_CODE], sc.go, sc.ge};
  sweep(bd, a + el[I0], b + el[J0], el[H], el[W],
        bus_h + (size_t)blockIdx.x * width,
        bus_f + (size_t)blockIdx.x * width, sc, xh, xf);
}

__global__ void __launch_bounds__(MAX_THREADS)
    batched_strip_fixed_kernel(const uint8_t* a, const uint8_t* b,
                               const int* col_h, const int* col_e,
                               const int* corners, int* bus_h, int* bus_f,
                               int h, int nj, Score sc) {
  __shared__ int xh[2][MAX_THREADS];
  __shared__ int xf[2][MAX_THREADS];
  const size_t e = blockIdx.x;
  const DataBorder bd{col_h + e * h, col_e + e * h, corners[e]};
  sweep(bd, a + e * h, b + e * nj, h, nj, bus_h + e * nj, bus_f + e * nj,
        sc, xh, xf);
}

bool bad_threads(int threads) {
  return threads < 32 || threads > MAX_THREADS || threads % 32;
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
  if (n < 1 || bad_threads(threads))
    return (int)cudaErrorInvalidConfiguration;
  const Score sc{match, mismatch, gap_open, gap_ext};
  batched_strip_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const int*>(elems), static_cast<int*>(bus_h),
      static_cast<int*>(bus_f), width, sc);
  return (int)cudaGetLastError();
}

// Launch `n` equal-shape elements of h rows by nj columns on `stream`;
// bus_h/bus_f hold the rows above on entry and the last rows on return.
// Returns a cudaError_t value: 0 when the launch was accepted.
extern "C" int masa_batched_strip_fixed_launch(
    const void* a, const void* b, const void* col_h, const void* col_e,
    const void* corners, int n, int h, int nj, int threads, void* bus_h,
    void* bus_f, int match, int mismatch, int gap_open, int gap_ext,
    void* stream) {
  if (n < 1 || h < 1 || nj < 1 || bad_threads(threads))
    return (int)cudaErrorInvalidConfiguration;
  const Score sc{match, mismatch, gap_open, gap_ext};
  batched_strip_fixed_kernel<<<n, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const int*>(col_h), static_cast<const int*>(col_e),
      static_cast<const int*>(corners), static_cast<int*>(bus_h),
      static_cast<int*>(bus_f), h, nj, sc);
  return (int)cudaGetLastError();
}
