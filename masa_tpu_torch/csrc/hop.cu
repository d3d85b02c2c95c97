// A stage-2 hop's prologue and epilogue on the card, so that a chain of
// hops needs no read on the host until its end.
//
// These are no counterparts of Pallas kernels: masa_tpu computes both in
// XLA around its strip kernel (masa_tpu/ops/wavefront.py:1216
// hop_step_device, :1171 goal_match_device).  A hop is three launches:
//
//   hop_prep_kernel   from the hop's state (cj, score, type, ok), an int32
//                     (4,) tensor on the card, writes the window b of W
//                     characters of the reversed seq1 at n - cj, the
//                     entering bus from the row border code and the left
//                     border H/E from the column border code (an
//                     elementwise gather and fill);
//   the strip kernel  csrc/strip.cu, unchanged: NW over hb x W, nothing
//                     tracked, corner 0;
//   hop_match_kernel  one block: the first k in [0, W] where the forward
//                     cut plus the reverse row reaches the goal (a
//                     block-wide min over W + 1 int64 sums, each thread
//                     stopping at its own first), then the state update.
//
// The plain versions are ops/wavefront.py hop_prep_plain and
// hop_match_plain; the kernels must give the same bytes.
//
// Bound: both move a few bytes a column (prep: W chars in, W chars and 8 W
// + 8 hb bytes of borders out; match: 16 bytes a column up to the first
// stop), microseconds at 3.35 TB/s, so a launch's latency, not the card,
// sets their time.  The design does nothing about that beyond keeping the
// hop on the card: the chain's gain is the host reads it saves.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NEG = -999999999;  // -INF of the package's types
constexpr int WITH_GAPS = 1;     // InitType
constexpr int WITH_GAPS_OPENED = 2;
constexpr int GAP_1 = 1;         // CrosspointType
constexpr int GAP_2 = 2;
constexpr int MATCH_THREADS = 512;

// Border H at position k >= 1 (models/scoring.border_cells): a fresh gap,
// or one that continues.
__device__ __forceinline__ int border_h(int code, int k, int go, int ge) {
  return code == WITH_GAPS_OPENED ? -k * ge : -go - k * ge;
}

__global__ void hop_prep_kernel(const uint8_t* __restrict__ s1r, int n,
                                const int* __restrict__ st, int W, int hb,
                                int go, int ge, uint8_t* __restrict__ b,
                                int* __restrict__ bus_h,
                                int* __restrict__ bus_f,
                                int* __restrict__ col_h,
                                int* __restrict__ col_e) {
  const int cj = st[0];
  const int typ = st[2];
  // an ineligible hop (cj < W + 1) reads a window clamped into the
  // sequence: its result is dropped by the epilogue
  long long j0 = (long long)n - cj;
  j0 = j0 < 0 ? 0 : (j0 > n - W ? n - W : j0);
  const int row_code = typ == GAP_1 ? WITH_GAPS_OPENED : WITH_GAPS;
  const int col_code = typ == GAP_2 ? WITH_GAPS_OPENED : WITH_GAPS;
  const int len = W > hb ? W : hb;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += gridDim.x * blockDim.x) {
    if (i < W) {
      b[i] = s1r[j0 + i];
      bus_h[i] = border_h(row_code, i + 1, go, ge);
      bus_f[i] = NEG;
    }
    if (i < hb) {
      col_h[i] = border_h(col_code, i + 1, go, ge);
      col_e[i] = NEG;
    }
  }
}

__global__ void __launch_bounds__(MATCH_THREADS)
hop_match_kernel(const int* __restrict__ cut_h, const int* __restrict__ cut_f,
                 int cut_n, const int* __restrict__ rev_h,
                 const int* __restrict__ rev_f, const int* __restrict__ st_in,
                 int* __restrict__ st_out, int W, int hb, int match, int go,
                 int ge, int sw) {
  __shared__ int warp_min[MATCH_THREADS / 32];
  const int cj = st_in[0], score = st_in[1], typ = st_in[2];
  // eligibility, the same for every thread: the window clear of column 0
  // inside the cut, and under SW the goal out of reach inside the hop
  int ok = st_in[3] && cj >= W + 1 && cj <= cut_n;
  if (sw && (long long)score <= (long long)(hb < cj ? hb : cj) * match)
    ok = 0;
  if (!ok) {
    if (threadIdx.x == 0) {
      st_out[0] = cj;
      st_out[1] = score;
      st_out[2] = typ;
      st_out[3] = 0;
    }
    return;
  }
  const long long goal = (long long)score + (typ != 0 ? go : 0);
  // the reverse row's border element, H and F alike: the column border
  // at row hb (fresh gap, or the pinned one for GAP_2)
  const long long edge = -(long long)hb * ge - (typ == GAP_2 ? 0 : go);
  const int W1 = W + 1;
  int first = W1;
  for (int k = threadIdx.x; k < W1; k += blockDim.x) {
    const long long fh = cut_h[cj - 1 - k], ff = cut_f[cj - 1 - k];
    const long long rh = k ? rev_h[k - 1] : edge;
    const long long rf = k ? rev_f[k - 1] : edge;
    if (fh + rh >= goal || ff + rf + go >= goal) {
      first = k;  // a thread's k only grow: its first stop is its least
      break;
    }
  }
  for (int off = 16; off; off >>= 1)
    first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = first;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    first = min(first, warp_min[w]);
  int out_cj = cj, out_score = score, out_typ = typ, out_ok = 0;
  if (first < W1) {
    const int k = first;
    const long long fh = cut_h[cj - 1 - k], ff = cut_f[cj - 1 - k];
    const long long rh = k ? rev_h[k - 1] : edge;
    const long long rf = k ? rev_f[k - 1] : edge;
    const bool m_at = fh + rh == goal;
    if (m_at || ff + rf + go == goal) {  // a hit, not an overshoot
      out_cj = cj - k;
      out_score = m_at ? (int)fh : (int)ff;
      out_typ = m_at ? 0 : GAP_2;
      out_ok = 1;
    }
  }
  st_out[0] = out_cj;
  st_out[1] = out_score;
  st_out[2] = out_typ;
  st_out[3] = out_ok;
}

}  // namespace

// Returns a cudaError_t value: 0 when the launch was accepted.
extern "C" int masa_hop_prep_launch(const void* s1r, int n, const void* st,
                                    int W, int hb, int go, int ge, void* b,
                                    void* bus_h, void* bus_f, void* col_h,
                                    void* col_e, void* stream) {
  if (W < 1 || W >= n || hb < 1) return (int)cudaErrorInvalidValue;
  const int len = W > hb ? W : hb;
  const int threads = 256;
  int blocks = (len + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  hop_prep_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(s1r), n, static_cast<const int*>(st), W,
      hb, go, ge, static_cast<uint8_t*>(b), static_cast<int*>(bus_h),
      static_cast<int*>(bus_f), static_cast<int*>(col_h),
      static_cast<int*>(col_e));
  return (int)cudaGetLastError();
}

extern "C" int masa_hop_match_launch(const void* cut_h, const void* cut_f,
                                     int cut_n, const void* rev_h,
                                     const void* rev_f, const void* st_in,
                                     void* st_out, int W, int hb, int match,
                                     int go, int ge, int sw, void* stream) {
  if (W < 1 || hb < 1) return (int)cudaErrorInvalidValue;
  hop_match_kernel<<<1, MATCH_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cut_h), static_cast<const int*>(cut_f), cut_n,
      static_cast<const int*>(rev_h), static_cast<const int*>(rev_f),
      static_cast<const int*>(st_in), static_cast<int*>(st_out), W, hb,
      match, go, ge, sw);
  return (int)cudaGetLastError();
}
