// Special rows packed for the disk on the card, a batch (one stage-1
// launch's disk-bound rows) at a time: each half-row (a row's H or F, int32
// cells) becomes masa_tpu's packed form in one buffer that crosses to the
// host in one copy (ops/wavefront.RowPackLayout):
//
//   nibbles  ceil(nj/2) bytes, zeros to `upad`: the deltas between
//            neighbouring cells (the first delta is the first cell), one
//            signed nibble each, the low nibble first; a delta outside
//            [-7, 7] is written 8, an escape
//   anchors  the cells at 0, stride, 2 stride, ... as int64
//   count    the half's escapes as int64 (past `cap`: the slot overflowed)
//   escapes  the first `cap` escapes' positions, ascending, then their
//            exact values, both int64
//
// Replaces no TPU kernel: masa_tpu packs a row with a few XLA operations
// (masa_tpu/ops/wavefront.py delta_pack_device) and finds its escapes on
// the host, a row at a time; so did the port, in ~20 small launches, four
// blocking reads and two host scans a row.  The plain version is
// ops/wavefront.rowpack_plain, built from delta_pack_device and _escapes.
//
// Bound: bytes.  A half-row of nj cells reads 4 nj bytes and writes nj / 2;
// 128 rows of 2^20 cells (a stage-1 launch of the 1M pair at the CLI's
// defaults) read 1 GiB, ~0.34 ms at 3.35 TB/s.  Two launches a batch:
//   1. rowpack_kernel: a block packs 2048 cells of one half (8 a thread,
//      two 16-byte loads where the rows allow), writes their nibble
//      bytes and anchors, and counts their escapes;
//   2. rowpack_escapes_kernel: a block with escapes sums the counts of
//      its half's earlier blocks (the per-row scan), scans its threads'
//      counts and writes its escapes in column order at their ranks, so
//      the positions come out sorted without an atomic append; the last
//      block of each half writes the half's count.  Escapes are rare in
//      DP rows (a -INF stretch's ends, a few steps of -8), so most blocks
//      of launch 2 return after one read.
// The rows' pointers travel in the launch's parameters, TABLE half-rows a
// launch pair.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 8;                  // cells a thread
constexpr int SPAN = THREADS * PER;     // cells a block
constexpr int WARPS = THREADS / 32;
constexpr int TABLE = 256;              // half-rows a launch

struct Halves {
  const int* p[TABLE];
};

struct Out {
  uint8_t* u;       // (halves, upad) nibble bytes
  long long* anc;   // (halves, nanc)
  long long* cnt;   // (halves)
  long long* esc;   // (halves, 2, cap)
  int* blk;         // (TABLE, nblk) escapes a block, this launch's halves
  int nj, stride, nanc, upad, cap, nblk;
};

__device__ __forceinline__ unsigned nibble(long long d) {
  return (d >= -7 && d <= 7) ? static_cast<unsigned>(d & 0xF) : 8u;
}

// The thread's PER cells from c0 (0 past the row) and the cell before them
// (0 before the row: the first delta is the first cell).
template <bool VEC>
__device__ __forceinline__ void load(const int* x, int c0, int nj,
                                     int (&v)[PER], int& prev) {
  prev = (c0 > 0 && c0 <= nj) ? x[c0 - 1] : 0;
  if (VEC && c0 + PER <= nj) {
    const int4* q = reinterpret_cast<const int4*>(x + c0);
    const int4 a = q[0], b = q[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = c0 + i < nj ? x[c0 + i] : 0;
  }
}

// Bit i set where cell c0 + i is an escape.
__device__ __forceinline__ unsigned escapes_of(const int (&v)[PER], int prev,
                                               int c0, int nj,
                                               unsigned& word) {
  unsigned flags = 0;
  long long p = prev;
  word = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (c0 + i < nj) {
      const unsigned nb = nibble(static_cast<long long>(v[i]) - p);
      flags |= static_cast<unsigned>(nb == 8u) << i;
      word |= nb << (4 * i);
      p = v[i];
    }
  }
  return flags;
}

// The sum of v over the block, in every thread.
__device__ __forceinline__ int block_sum(int v, int* sh) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += sh[w];
  __syncthreads();
  return t;
}

// The sum of v over the block's threads before this one.
__device__ __forceinline__ int block_exclusive(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += t;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += sh[w];
  __syncthreads();
  return before + inc - v;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
rowpack_kernel(const Halves rows, const int base, const Out o) {
  __shared__ int sh[WARPS];
  const int q = blockIdx.y;
  const long long hq = base + q;
  const int c0 = blockIdx.x * SPAN + threadIdx.x * PER;
  int v[PER], prev;
  load<VEC>(rows.p[q], c0, o.nj, v, prev);
  unsigned word;
  const int n = __popc(escapes_of(v, prev, c0, o.nj, word));
  // the thread's 4 bytes (cells past the row are zero nibbles, so the
  // padding to upad is written as zeros)
  if (c0 / 2 < o.upad)
    *reinterpret_cast<unsigned*>(o.u + hq * o.upad + c0 / 2) = word;
  // the anchors among the thread's cells
  long long next = (static_cast<long long>(c0) + o.stride - 1) / o.stride
                   * o.stride;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (c0 + i == next && next < o.nj) {
      o.anc[hq * o.nanc + next / o.stride] = v[i];
      next += o.stride;
    }
  }
  const int t = block_sum(n, sh);
  if (threadIdx.x == 0)
    o.blk[static_cast<long long>(q) * o.nblk + blockIdx.x] = t;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
rowpack_escapes_kernel(const Halves rows, const int base, const Out o) {
  __shared__ int sh[WARPS];
  const int q = blockIdx.y;
  const long long hq = base + q;
  const int* blk = o.blk + static_cast<long long>(q) * o.nblk;
  const int own = blk[blockIdx.x];
  const bool last = blockIdx.x == o.nblk - 1;
  if (own == 0 && !last) return;  // the same in every thread of the block
  int s = 0;
  for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x); b += THREADS)
    s += blk[b];
  s = block_sum(s, sh);  // escapes of the half before this block
  if (last && threadIdx.x == 0) o.cnt[hq] = static_cast<long long>(s) + own;
  if (own == 0 || s >= o.cap) return;
  const int c0 = blockIdx.x * SPAN + threadIdx.x * PER;
  int v[PER], prev;
  load<VEC>(rows.p[q], c0, o.nj, v, prev);
  unsigned word;
  const unsigned flags = escapes_of(v, prev, c0, o.nj, word);
  int k = s + block_exclusive(__popc(flags), sh);
  long long* pos = o.esc + hq * 2 * o.cap;
  long long* val = pos + o.cap;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if ((flags >> i) & 1u) {
      if (k < o.cap) {
        pos[k] = c0 + i;
        val[k] = v[i];
      }
      ++k;
    }
  }
}

}  // namespace

// Pack `halves` half-rows (int32, nj cells each; `table` holds their
// device addresses on the host, H then F of each row) into the buffer
// sections u, anc, cnt and esc (RowPackLayout) on `stream`.  `blk` is
// scratch of min(halves, TABLE) * ceil(nj / 2048) ints; `vec`: every
// half-row's address is a multiple of 16 bytes.  Two launches a TABLE
// half-rows.  Returns a cudaError_t value: 0 when every launch was
// accepted.
extern "C" int masa_rowpack_launch(const void* table, int halves, int nj,
                                   int stride, int nanc, int upad, int cap,
                                   void* u, void* anc, void* cnt, void* esc,
                                   void* blk, int vec, void* stream) {
  if (halves < 1 || nj < 1 || stride < 1 || cap < 1 || upad % 8 != 0 ||
      upad < (nj + 1) / 2 || nanc != (nj + stride - 1) / stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const Out o{static_cast<uint8_t*>(u), static_cast<long long*>(anc),
              static_cast<long long*>(cnt), static_cast<long long*>(esc),
              static_cast<int*>(blk), nj, stride, nanc, upad, cap,
              (nj + SPAN - 1) / SPAN};
  const long long* ptrs = static_cast<const long long*>(table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int base = 0; base < halves; base += TABLE) {
    const int n = halves - base < TABLE ? halves - base : TABLE;
    Halves rows{};
    for (int i = 0; i < n; ++i)
      rows.p[i] = reinterpret_cast<const int*>(ptrs[base + i]);
    const dim3 grid(o.nblk, n);
    if (vec)
      rowpack_kernel<true><<<grid, THREADS, 0, s>>>(rows, base, o);
    else
      rowpack_kernel<false><<<grid, THREADS, 0, s>>>(rows, base, o);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (vec)
      rowpack_escapes_kernel<true><<<grid, THREADS, 0, s>>>(rows, base, o);
    else
      rowpack_escapes_kernel<false><<<grid, THREADS, 0, s>>>(rows, base, o);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
