// Hopper roofline microbenchmarks for the DP step of csrc/strip.cu.
//
// Replaces the Pallas kernels of tools/roofline.py (bench_kernel.make_call,
// tools/roofline.py:86), which measure a TPU core's vector issue rate,
// its dependent-op latency and the DP step's op mix.  Here every thread
// is one lane: it loads its inputs (one int32 per input array, or one
// pair of int16 packed in an int32 for m16), runs `iters` iterations of a
// body in registers, and stores the max over its chains, as the TPU
// kernel stores the max over its vectors.  The bodies, as in the TPU
// tool (every one consumes the loop index, so the compiler cannot fold
// the loop):
//
//   PAR  W = 8 independent chains of v = max(v ^ it, v - 1): issue rate;
//   SER  one chain of 8 such steps per iteration: dependent-op latency
//        (launched as one warp, so nothing hides it);
//   MIX  the DP step's dependency graph for ALPHA = 8 rows per thread
//        (tools/roofline.py:133-153; csrc/strip.cu's 8 rows per thread):
//        e/f/sub/h chains, no shifts, no bus traffic.  An upper bound on
//        the strip kernel's cells/s;
//   DPX  the same graph issued through Hopper's DPX instructions
//        (__viaddmax_s32, __vimax_s32_relu): the same values;
//   M16  MIX on packed int16 pairs (__vsub2, __vmaxs2, ...): the card's
//        form of the TPU's 16-bit packing question (tools/roofline.py:
//        161-166).
//
// What bounds them: the SM's integer issue rate (PAR, MIX, DPX, M16) or
// one instruction's latency (SER); no memory traffic inside the loop.
// The host side (masa_tpu_torch/tools/roofline.py) times T and 2T
// iterations with CUDA events and takes the slope, so the launch and the
// loads cancel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Body { PAR = 0, SER = 1, MIX = 2, DPX = 3, M16 = 4 };
constexpr int W = 8;      // PAR chains
constexpr int ALPHA = 8;  // MIX rows per thread
constexpr int GO = 3, GE = 2;

__device__ __forceinline__ int step(int v, int it) { return max(v ^ it, v - 1); }

__global__ void par_kernel(const int* in, int* out, int iters) {
  const int n = gridDim.x * blockDim.x;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  int v[W];
#pragma unroll
  for (int c = 0; c < W; ++c) v[c] = in[c * n + g];
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

}  // namespace

// Launch body `body` (PAR, SER, MIX, DPX, M16) for `iters` iterations on
// `blocks` x `threads` lanes.  `in` holds the body's input arrays, each
// blocks*threads int32 long (packed int16 pairs for M16); `out` receives
// one int32 per lane (two per lane for M16).  Returns a cudaError_t
// value: 0 when the launch was accepted.
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
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
