// Hopper roofline microbenchmarks for the DP cell of csrc/strip.cu and
// csrc/batched_strip.cu.
//
// Replaces the Pallas kernels of tools/roofline.py (bench_kernel.make_call,
// tools/roofline.py:86), which measure a TPU core's vector issue rate,
// its dependent-op latency and the DP step's op mix.  Here every thread
// is one lane: it loads its inputs (one int32 per input array, or one
// pair of int16 packed in an int32 for m16), runs `iters` iterations of a
// body in registers, and stores a reduction over its values.  The TPU
// tool's bodies (every one consumes the loop index, so the compiler
// cannot fold the loop; each stores the max over its values):
//
//   PAR  W = 8 independent chains of v = max(v ^ it, v - 1): issue rate;
//   SER  one chain of 8 such steps per iteration: dependent-op latency
//        (launched as one warp, so nothing hides it);
//   MIX  the TPU step's dependency graph for ALPHA = 8 rows per thread
//        (tools/roofline.py:133-153): e/f/sub/h chains, the substitution
//        from a compare with a loop constant, no best, no exchange;
//   DPX  the same graph issued through Hopper's DPX instructions
//        (__viaddmax_s32, __vimax_s32_relu): the same values;
//   M16  MIX on packed int16 pairs (__vsub2, __vmaxs2, ...): the card's
//        form of the TPU's 16-bit packing question (tools/roofline.py:
//        161-166).
//
// The bodies with this package's own cell (gotoh_cell.cuh, the code
// csrc/strip.cu and csrc/batched_strip.cu sweep), ALPHA = 8 rows per
// thread, one wavefront step per iteration, each storing the wrapping sum
// of its values:
//
//   K1   the strip kernel's SW cell with best tracking: the scores are
//        run-time values, the row characters sit in registers, the column
//        character is read per step from shared memory (as sh.bs), the
//        column index j = it - lane feeds the best.  The row above is the
//        thread's own bottom row of the step before: registers only, no
//        shuffle, no ring, no wait: what the cell of the strip kernel's
//        tracked launches costs as it is spelled today;
//   K1N  the cell without tracking and with a plain max (NW): the strip
//        kernel's launches that track nothing, and both batched kernels;
//   K1W  K1 plus what one warp of the strip
//        kernel adds per step: lane 0's int2 read from a ring in shared
//        memory, the two __shfl_up_sync that hand the bottom row to the
//        next lane, lane 31's int2 write to the ring below.  No other
//        warp to wait for.  K1 -> K1W is the cost of the exchange inside
//        a warp; K1W -> the strip kernel's rate is the cost of waiting.
//
// What bounds them: the SM's integer instruction rate (all but SER) or one
// instruction's latency (SER); no global-memory traffic inside the loop.
// The loops carry explicit unroll factors (UNROLL_*), so the host side
// (masa_tpu_torch/tools/roofline.py) can count a body's instructions per
// iteration in the built library's SASS; it times T and 2T iterations
// with CUDA events around the launch alone and takes the slope, so the
// launch and the loads cancel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gotoh_cell.cuh"

namespace {

enum Body { PAR = 0, SER = 1, MIX = 2, DPX = 3, M16 = 4, K1 = 5, K1N = 6,
            K1W = 7 };
constexpr int W = 8;      // PAR chains
constexpr int ALPHA = 8;  // rows per thread of MIX and of the cell bodies
constexpr int GO = 3, GE = 2;
constexpr int MATCH = 1, MISMATCH = -3;  // handed to the cell bodies at launch
constexpr int NEG = -999999999;
constexpr int CHUNK = 32;  // csrc/strip.cu's: bs holds two chunks of b
constexpr int RING = 128;  // csrc/strip.cu's ring, in columns
constexpr int MAX_WARPS = 8;   // of a K1W block: csrc/strip.cu's compute warps
constexpr unsigned ALL = 0xffffffffu;
// Iterations per trip of each body's main loop in the SASS (the host
// divides the loop's instructions by these; tools/roofline.py UNROLL).
constexpr int UNROLL_PAR = 8, UNROLL_SER = 4, UNROLL_MIX = 2,
              UNROLL_CELL = 2;

__device__ __forceinline__ int step(int v, int it) { return max(v ^ it, v - 1); }

__global__ void par_kernel(const int* in, int* out, int iters) {
  const int n = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  int v[W];
#pragma unroll
  for (int c = 0; c < W; ++c) v[c] = in[c * n + g];
#pragma unroll UNROLL_PAR
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < W; ++c) v[c] = step(v[c], it);
  }
  int acc = v[0];
#pragma unroll
  for (int c = 1; c < W; ++c) acc = max(acc, v[c]);
  out[g] = acc;
}

__global__ void ser_kernel(const int* in, int* out, int iters) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  int v = in[g];
#pragma unroll UNROLL_SER
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < 8; ++r) v = step(v, it);
  }
  out[g] = v;
}

// MIX and DPX: inputs hh[ALPHA], ee[ALPHA], up_h, up_f, dg0, rb.
template <bool USE_DPX>
__global__ void mix_kernel(const int* in, int* out, int iters) {
  const int n = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  int hh[ALPHA], ee[ALPHA];
#pragma unroll
  for (int k = 0; k < ALPHA; ++k) {
    hh[k] = in[k * n + g];
    ee[k] = in[(ALPHA + k) * n + g];
  }
  const int up_h = in[(2 * ALPHA) * n + g];
  const int up_f = in[(2 * ALPHA + 1) * n + g];
  const int dg0 = in[(2 * ALPHA + 2) * n + g];
  const int rb0 = in[(2 * ALPHA + 3) * n + g];
#pragma unroll UNROLL_MIX
  for (int it = 0; it < iters; ++it) {
    const int rb = rb0 ^ it;  // fold-breaker (the real step reads a char)
    int uh = up_h, uf = up_f, dg = dg0;
#pragma unroll
    for (int k = 0; k < ALPHA; ++k) {
      const int sub = rb == k ? 1 : -3;
      int e, f, h;
      if (USE_DPX) {
        e = __viaddmax_s32(hh[k], -GO, ee[k]) - GE;
        f = __viaddmax_s32(uh, -GO, uf) - GE;
        h = __vimax_s32_relu(__viaddmax_s32(dg, sub, e), f);
      } else {
        e = max(hh[k] - GO, ee[k]) - GE;
        f = max(uh - GO, uf) - GE;
        h = max(max(max(dg + sub, e), f), 0);
      }
      dg = hh[k];
      hh[k] = h;
      ee[k] = e;
      uh = h;
      uf = f;
    }
  }
  int acc = max(max(up_h, up_f), max(dg0, rb0));
#pragma unroll
  for (int k = 0; k < ALPHA; ++k) acc = max(acc, max(hh[k], ee[k]));
  out[g] = acc;
}

// M16: MIX on two int16 lanes packed in each int32 (low half = even lane).
__global__ void m16_kernel(const unsigned* in, int* out, int iters) {
  const int n = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned hh[ALPHA], ee[ALPHA];
#pragma unroll
  for (int k = 0; k < ALPHA; ++k) {
    hh[k] = in[k * n + g];
    ee[k] = in[(ALPHA + k) * n + g];
  }
  const unsigned up_h = in[(2 * ALPHA) * n + g];
  const unsigned up_f = in[(2 * ALPHA + 1) * n + g];
  const unsigned dg0 = in[(2 * ALPHA + 2) * n + g];
  const unsigned rb0 = in[(2 * ALPHA + 3) * n + g];
  const unsigned go2 = GO * 0x00010001u, ge2 = GE * 0x00010001u;
  const unsigned plus1 = 0x00010001u, minus3 = 0xFFFDFFFDu;
#pragma unroll UNROLL_MIX
  for (int it = 0; it < iters; ++it) {
    const unsigned it2 = ((unsigned)it & 0xFFFFu) * 0x00010001u;
    const unsigned rb = rb0 ^ it2;
    unsigned uh = up_h, uf = up_f, dg = dg0;
#pragma unroll
    for (int k = 0; k < ALPHA; ++k) {
      const unsigned eq = __vcmpeq2(rb, (unsigned)k * 0x00010001u);
      const unsigned sub = (eq & plus1) | (~eq & minus3);
      const unsigned e = __vsub2(__vmaxs2(__vsub2(hh[k], go2), ee[k]), ge2);
      const unsigned f = __vsub2(__vmaxs2(__vsub2(uh, go2), uf), ge2);
      unsigned h = __vmaxs2(__vmaxs2(__vadd2(dg, sub), e), f);
      h = __vmaxs2(h, 0u);
      dg = hh[k];
      hh[k] = h;
      ee[k] = e;
      uh = h;
      uf = f;
    }
  }
  unsigned acc = __vmaxs2(__vmaxs2(up_h, up_f), __vmaxs2(dg0, rb0));
#pragma unroll
  for (int k = 0; k < ALPHA; ++k) acc = __vmaxs2(acc, __vmaxs2(hh[k], ee[k]));
  out[2 * g] = (int)(int16_t)(acc & 0xFFFFu);
  out[2 * g + 1] = (int)(int16_t)(acc >> 16);
}

struct Score {
  int match, mismatch, go, ge;
};

// K1, K1N and K1W.  Inputs: hl[ALPHA], el[ALPHA] (the rows' H and E),
// ch[ALPHA] (row characters, the low two bits), dprev, ph, pf (H of the
// row above one column back; its H and F at this column) and cb (a
// column character, the low two bits).  bs[i] is cb of the block's
// thread i % blockDim.x.  WARP: ring[w][0] holds lane l's (ph, pf) at
// slots l, l + 32, ..., and ring[w][1] starts as -INF.
template <bool SW, bool TRACK, bool WARP>
__global__ void cell_kernel(const int* in, int* out, int iters, Score sc) {
  __shared__ uint8_t bs[2 * CHUNK];
  __shared__ int2 ring[WARP ? MAX_WARPS : 1][2][RING];
  const int n = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  int hl[ALPHA], el[ALPHA], ch[ALPHA], bv[ALPHA], bj[ALPHA];
#pragma unroll
  for (int k = 0; k < ALPHA; ++k) {
    hl[k] = in[k * n + g];
    el[k] = in[(ALPHA + k) * n + g];
    ch[k] = in[(2 * ALPHA + k) * n + g] & 3;
    bv[k] = NEG;
    bj[k] = 0;
  }
  int dprev = in[(3 * ALPHA) * n + g];
  int ph = in[(3 * ALPHA + 1) * n + g];
  int pf = in[(3 * ALPHA + 2) * n + g];
  const int* cb = in + (size_t)(3 * ALPHA + 3) * n + blockIdx.x * blockDim.x;
  for (int i = threadIdx.x; i < 2 * CHUNK; i += blockDim.x)
    bs[i] = (uint8_t)(cb[i % blockDim.x] & 3);
  if (WARP) {
    for (int i = lane; i < RING; i += 32) {
      ring[w][0][i] = make_int2(ph, pf);
      ring[w][1][i] = make_int2(NEG, NEG);
    }
  }
  __syncthreads();
  const int gofirst = -(sc.go + sc.ge);
#pragma unroll UNROLL_CELL
  for (int it = 0; it < iters; ++it) {
    const int j = it - lane;  // lane l runs l columns behind lane 0
    int uh = ph, uf = pf;
    if (WARP) {
      const int2 above = ring[w][0][it & (RING - 1)];  // lane 0's row above
      uh = lane == 0 ? above.x : ph;
      uf = lane == 0 ? above.y : pf;
    }
    const int bc = bs[j & (2 * CHUNK - 1)];
    int vh = uh, vf = uf, dg = dprev;
#pragma unroll
    for (int k = 0; k < ALPHA; ++k) {
      masa::gotoh_cell<SW>(hl[k], el[k], dg, vh, vf, ch[k], bc, sc.match,
                           sc.mismatch, gofirst, sc.ge);
      if (TRACK) masa::track_best(vh, j, bv[k], bj[k]);
    }
    dprev = uh;
    if (WARP) {
      if (lane == 31) ring[w][1][j & (RING - 1)] = make_int2(vh, vf);
      ph = __shfl_up_sync(ALL, vh, 1);
      pf = __shfl_up_sync(ALL, vf, 1);
    } else {
      ph = vh;
      pf = vf;
    }
  }
  int acc = dprev + ph + pf;
#pragma unroll
  for (int k = 0; k < ALPHA; ++k) {
    acc += hl[k] + el[k];
    if (TRACK) acc += bv[k] + bj[k];
  }
  if (WARP) {
    __syncwarp();
    for (int i = lane; i < RING; i += 32)
      acc += ring[w][1][i].x + ring[w][1][i].y;
  }
  out[g] = acc;
}

typedef void (*CellKernel)(const int*, int*, int, Score);

CellKernel cell_kernel_of(int body) {
  switch (body) {
    case K1: return cell_kernel<true, true, false>;
    case K1N: return cell_kernel<false, false, false>;
    case K1W: return cell_kernel<true, true, true>;
    default: return nullptr;
  }
}

const void* kernel_of(int body) {
  switch (body) {
    case PAR: return reinterpret_cast<const void*>(par_kernel);
    case SER: return reinterpret_cast<const void*>(ser_kernel);
    case MIX: return reinterpret_cast<const void*>(mix_kernel<false>);
    case DPX: return reinterpret_cast<const void*>(mix_kernel<true>);
    case M16: return reinterpret_cast<const void*>(m16_kernel);
    default: return reinterpret_cast<const void*>(cell_kernel_of(body));
  }
}

}  // namespace

// Blocks of `threads` threads of body `body` one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 when the body is
// unknown or the device cannot be asked.
extern "C" int masa_roofline_blocks_per_sm(int body, int threads) {
  const void* kernel = kernel_of(body);
  int per_sm = 0;
  if (kernel == nullptr || threads < 1 || threads > 1024) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess)
    return -1;
  return per_sm;
}

// Launch body `body` (a Body value) for `iters` iterations on `blocks` x
// `threads` lanes.  `in` holds the body's input arrays, each
// blocks*threads int32 long (packed int16 pairs for M16); `out` receives
// one int32 per lane (two per lane for M16).  K1W takes whole warps, at
// most 8 a block.
// Returns a cudaError_t value: 0 when the launch was accepted.
extern "C" int masa_roofline_launch(int body, int iters, int blocks,
                                    int threads, const void* in, void* out,
                                    void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024 || iters < 0)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i32 = static_cast<const int*>(in);
  int* o = static_cast<int*>(out);
  switch (body) {
    case PAR: par_kernel<<<blocks, threads, 0, s>>>(i32, o, iters); break;
    case SER: ser_kernel<<<blocks, threads, 0, s>>>(i32, o, iters); break;
    case MIX: mix_kernel<false><<<blocks, threads, 0, s>>>(i32, o, iters);
      break;
    case DPX: mix_kernel<true><<<blocks, threads, 0, s>>>(i32, o, iters);
      break;
    case M16:
      m16_kernel<<<blocks, threads, 0, s>>>(
          static_cast<const unsigned*>(in), o, iters);
      break;
    default: {
      const CellKernel kernel = cell_kernel_of(body);
      if (kernel == nullptr) return (int)cudaErrorInvalidValue;
      if (body == K1W && (threads % 32 || threads > 32 * MAX_WARPS))
        return (int)cudaErrorInvalidValue;
      const Score sc{MATCH, MISMATCH, GO, GE};
      kernel<<<blocks, threads, 0, s>>>(i32, o, iters, sc);
    }
  }
  return (int)cudaGetLastError();
}
