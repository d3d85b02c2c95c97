// Hopper strip kernel: one strip of the Gotoh affine-gap DP (SW or NW).
//
// Replaces masa_tpu/ops/wavefront.py:strip_pallas, the TPU's anti-diagonal
// strip kernel.  It keeps that kernel's contract, in logical coordinates
// (masa_tpu/ops/wavefront.py "Index conventions"):
//   kernel column j in [0, nj)  <->  DP column j+1 (consumes b[j])
//   kernel row    i in [0, h)   <->  DP row i0+i+1 (consumes a[i])
//   bus_h/bus_f[j]  = DP (H, F) at (i0, j+1); the strip's last row on exit
//   col_h/col_e[i]  = DP (H, E) of the left border at row i0+i+1
//   corner          = DP H at (i0, 0)
// Outputs besides the bus: per-row best (value, first j reaching it), the
// last column's H/E, and the H/F of every interior row i with
// (i+1) % flush_every == 0.
//
// What bounds it: int32 ALU work, about a dozen max/add/select per cell, and
// one __syncthreads() per wavefront step.  A strip reads about 8 bytes of
// bus and one character per column and writes 8 bytes back, so it is not
// bound by memory bandwidth.
//
// What the design does about that: thread t owns ALPHA consecutive rows and
// at step s computes column j = s - t for all of them, so the vertical chain
// stays in registers and one barrier is paid per ALPHA cells a thread.  Only
// the bottom row's (H, F) crosses to thread t+1, through double-buffered
// shared memory.  A strip taller than one block is cut into sub-strips of
// BLOCK_ROWS rows.  Persistent blocks (a cooperative launch, so all are
// resident) take sub-strips in turn, and sub-strip g reads the bus in place
// as sub-strip g-1 writes it, following a per-sub-strip progress counter in
// global memory.  A tall strip therefore keeps every SM busy, with a ramp
// of about THREADS + PUBLISH steps per sub-strip.  Heights, widths, scores,
// the recurrence and the flush cadence are runtime arguments.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -999999999;  // -INF of masa_tpu.types, with headroom
constexpr int ALPHA = 8;         // rows per thread
constexpr int THREADS = 256;     // threads per block
constexpr int BLOCK_ROWS = ALPHA * THREADS;
constexpr int PUBLISH = 32;      // bus columns per progress update
// A sub-strip that waits this long for the one above gives up and flags
// the run, so a fault can never hang the card.
constexpr unsigned long long WAIT_NS = 10ull * 1000 * 1000 * 1000;

struct Args {
  const uint8_t* a;
  const uint8_t* b;
  int* bus_h;
  int* bus_f;
  const int* col_h;
  const int* col_e;
  int* best_v;
  int* best_j;
  int* last_h;
  int* last_e;
  int* rows_h;
  int* rows_f;
  int* progress;  // (n_sub,) zeroed: columns of bus each sub-strip wrote
  int* error;     // (1,) zeroed: set to 1 when a wait timed out
  int corner, h, nj, n_sub;
  int match, mismatch, go, ge;
  int sw, track_best, store_lastcol, flush_every;
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(THREADS) strip_kernel(Args p) {
  __shared__ int xh[2][THREADS];
  __shared__ int xf[2][THREADS];
  const int t = threadIdx.x;
  int aborted = 0;  // thread 0: a wait timed out

  for (int g = blockIdx.x; g < p.n_sub; g += gridDim.x) {
    const int top = g * BLOCK_ROWS;
    const int h_sub = min(BLOCK_ROWS, p.h - top);
    const int last_t = (h_sub - 1) / ALPHA;  // owner of the sub-strip's last row
    const int last_k = (h_sub - 1) % ALPHA;
    const int row0 = top + t * ALPHA;
    const bool owner = t <= last_t;

    int hl[ALPHA], el[ALPHA], bv[ALPHA], bj[ALPHA], ch[ALPHA], fq[ALPHA];
#pragma unroll
    for (int k = 0; k < ALPHA; ++k) {
      const int r = row0 + k;
      const bool valid = owner && r < p.h;
      ch[k] = valid ? (int)p.a[r] : -1;  // -1 never equals a byte
      hl[k] = valid ? p.col_h[r] : NEG;  // H(r, column -1) = left border
      el[k] = valid ? p.col_e[r] : NEG;
      bv[k] = NEG;
      bj[k] = 0;
      fq[k] = (valid && p.flush_every > 0 && r < p.h - 1 &&
               (r + 1) % p.flush_every == 0)
                  ? (r + 1) / p.flush_every - 1
                  : -1;
    }
    // H of the row above at column j-1 (the diagonal of this thread's
    // first row); at j = 0 it is the left border of that row.
    int dprev = row0 == 0 ? p.corner : (owner ? p.col_h[row0 - 1] : NEG);
    int avail = g == 0 ? p.nj : 0;  // bus columns known to be written

    const int steps = p.nj + last_t;
    for (int s = 0; s < steps; ++s) {
      const int j = s - t;
      int uh = NEG, uf = NEG;  // (H, F) of the row above at column j
      if (t == 0) {
        if (j < p.nj) {
          if (j >= avail) {
            const unsigned long long t0 = now_ns();
            while (true) {
              avail = atomicAdd(p.progress + g - 1, 0);
              if (avail > j) break;
              if (now_ns() - t0 > WAIT_NS) {
                atomicExch(p.error, 1);
                aborted = 1;
                break;
              }
              __nanosleep(32);
            }
            __threadfence();
          }
          uh = __ldcg(p.bus_h + j);
          uf = __ldcg(p.bus_f + j);
        }
      } else {
        uh = xh[(s - 1) & 1][t - 1];
        uf = xf[(s - 1) & 1][t - 1];
      }
      if (owner && j >= 0 && j < p.nj) {
        const int bc = p.b[j];
        int dg = dprev, vh = uh, vf = uf, oh = 0, of = 0;
#pragma unroll
        for (int k = 0; k < ALPHA; ++k) {
          const int e = max(hl[k] - p.go, el[k]) - p.ge;
          const int f = max(vh - p.go, vf) - p.ge;
          int hv = max(max(dg + (ch[k] == bc ? p.match : p.mismatch), e), f);
          if (p.sw) hv = max(hv, 0);
          dg = hl[k];
          hl[k] = hv;
          el[k] = e;
          vh = hv;
          vf = f;
          const int r = row0 + k;
          if (r < p.h) {
            if (p.track_best && hv > bv[k]) {
              bv[k] = hv;
              bj[k] = j;
            }
            if (p.store_lastcol && j == p.nj - 1) {
              p.last_h[r] = hv;
              p.last_e[r] = e;
            }
            if (fq[k] >= 0) {
              const size_t o = (size_t)fq[k] * p.nj + j;
              p.rows_h[o] = hv;
              p.rows_f[o] = f;
            }
          }
          if (k == last_k) {
            oh = hv;
            of = f;
          }
        }
        xh[s & 1][t] = vh;
        xf[s & 1][t] = vf;
        dprev = uh;
        if (t == last_t) {
          __stcg(p.bus_h + j, oh);
          __stcg(p.bus_f + j, of);
          if ((j + 1) % PUBLISH == 0 || j == p.nj - 1) {
            __threadfence();
            atomicExch(p.progress + g, j + 1);
          }
        }
      }
      if (__syncthreads_or(aborted)) return;
    }

    if (p.track_best) {
#pragma unroll
      for (int k = 0; k < ALPHA; ++k) {
        const int r = row0 + k;
        if (owner && r < p.h) {
          p.best_v[r] = bv[k];
          p.best_j[r] = bj[k];
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int masa_strip_block_rows() { return BLOCK_ROWS; }

// Blocks the card holds at once (blocks per SM at full occupancy x SMs):
// a strip of more sub-strips than this runs its blocks in several waves.
// Returns -1 when the device cannot be queried.
extern "C" int masa_strip_resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, strip_kernel,
                                                    THREADS, 0) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

// Launch one strip on `stream`.  Returns a cudaError_t value: 0 when the
// launch was accepted.  max_ctas > 0 caps the number of persistent blocks.
extern "C" int masa_strip_launch(
    const void* a, const void* b, void* bus_h, void* bus_f, const void* col_h,
    const void* col_e, int corner, int h, int nj, int match, int mismatch,
    int gap_open, int gap_ext, int sw, int track_best, int store_lastcol,
    int flush_every, void* best_v, void* best_j, void* last_h, void* last_e,
    void* rows_h, void* rows_f, void* progress, void* error, int max_ctas,
    void* stream) {
  Args p;
  p.a = static_cast<const uint8_t*>(a);
  p.b = static_cast<const uint8_t*>(b);
  p.bus_h = static_cast<int*>(bus_h);
  p.bus_f = static_cast<int*>(bus_f);
  p.col_h = static_cast<const int*>(col_h);
  p.col_e = static_cast<const int*>(col_e);
  p.best_v = static_cast<int*>(best_v);
  p.best_j = static_cast<int*>(best_j);
  p.last_h = static_cast<int*>(last_h);
  p.last_e = static_cast<int*>(last_e);
  p.rows_h = static_cast<int*>(rows_h);
  p.rows_f = static_cast<int*>(rows_f);
  p.progress = static_cast<int*>(progress);
  p.error = static_cast<int*>(error);
  p.corner = corner;
  p.h = h;
  p.nj = nj;
  p.n_sub = (h + BLOCK_ROWS - 1) / BLOCK_ROWS;
  p.match = match;
  p.mismatch = mismatch;
  p.go = gap_open;
  p.ge = gap_ext;
  p.sw = sw;
  p.track_best = track_best;
  p.store_lastcol = store_lastcol;
  p.flush_every = flush_every;

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, strip_kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  int grid = per_sm * sms < p.n_sub ? per_sm * sms : p.n_sub;
  if (max_ctas > 0 && max_ctas < grid) grid = max_ctas;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)strip_kernel, dim3(grid),
                                    dim3(THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
