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
// (i+1) % flush_every == 0.  int32 throughout.
//
// What bounds it.  Operations, not bytes: a sub-strip reads 8 bytes of bus
// and one character per column and writes 8 bytes back, for thousands of
// cells.  A cell is about fourteen instructions in the interior loop (8
// rows a thread, SW, best tracked), ten of them on the SM's INT32 lanes
// (16 a clock a quarter-SM): one add-max each for E, F and the diagonal,
// one max for H, compare and select for the substitution score, compare,
// select and max for the per-row best, and the selects of the exchange;
// the two subtracts go to the FMA pipe.  The bare cell (gotoh_cell.cuh
// alone: the roofline's k1 body) needs nine, the recurrence itself five
// (three add-max, a max, a max for the best: the kernel's bound).  A strip
// as tall as the card runs at about 70% of the bare cell's rate and 37% of
// that bound on an H100: with four
// warps a quarter-SM about half of a warp's cycles go to waiting for the
// warp above or below (tools/strip_tune.py --profile), so the chain of
// dependent cells in a step (ALPHA add-max/max pairs, then a shuffle) is
// not always hidden.  A short strip (a stage-2 hop of 8192 rows) has
// too few rows to fill the card: it is bound by the latency of one
// wavefront step times the columns plus the pipeline's fill (about 64
// steps per warp of the chain).
//
// What the design does about that.
//   * A thread owns ALPHA consecutive rows, a warp 32 * ALPHA, and lane l
//     runs l columns behind lane 0, so the vertical chain stays in
//     registers and the bottom row's (H, F) moves to the next lane by
//     __shfl_up_sync.  Warps advance on their own: there is no barrier of
//     the block inside a sub-strip.  Between warps the bottom row moves
//     through a ring of RING columns in shared memory, guarded by two
//     counters a ring (columns produced, columns consumed) that are
//     published once per CHUNK columns.
//   * One extra warp per block does the global traffic: it waits for the
//     sub-strip above (a progress counter per sub-strip, acquire/release),
//     loads the bus ahead of use in 128-byte lines into the first warp's
//     ring, and drains the last warp's ring back to the bus in whole
//     lines, one release per CHUNK columns.  The compute warps never wait
//     on global memory; b comes a chunk ahead through a register.
//   * The kernel is a template over <ALPHA, SW, TRACK_BEST, FLUSH>, the
//     sub-strip body over <full block> and the chunk body over <edge>: the
//     interior chunk of a full block carries no bound check.  The caller's
//     arguments pick the instance.
//   * The cell is gotoh_cell.cuh's, which csrc/batched_strip.cu sweeps too
//     and csrc/roofline.cu times alone (its k1, k1n and k1w bodies say
//     what this spelling of the cell costs).  The recurrence goes through
//     the DPX instructions (__viaddmax_s32, __vimax_s32_relu): the same
//     int32 values (plain add and max; -INF is -999999999, far from
//     overflow).  Measured against max(a + b, c) in plain C this is worth
//     about 2%: the compiler fuses an add followed by a max by itself.
//   * Rows per block follow the strip's height (ALPHA 8, 4 or 2 and 1 to 8
//     compute warps; the rule is ops/kernels.strip_geometry), so a short
//     strip spreads over many warps and tens of SMs.
//   * Sub-strips are handed out in increasing order by an atomic ticket,
//     so the sub-strip above is always already running: the launch is an
//     ordinary one, on as many persistent blocks as the card holds.  A
//     sub-strip that waits 10 s for the one above flags the run and every
//     block gives up, so a fault cannot hang the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gotoh_cell.cuh"

namespace {

constexpr int NEG = -999999999;  // -INF of the package's types, with headroom
constexpr int MAXW = 8;          // compute warps per block, at most
constexpr int CHUNK = 32;        // columns per hand-off (one per lane)
constexpr int RING = 128;        // columns of slack in a ring
constexpr int MAX_THREADS = 32 * (MAXW + 1);
constexpr unsigned ALL = 0xffffffffu;
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
  int* ticket;    // (1,) zeroed: the next sub-strip to hand out
  int* error;     // (1,) zeroed: set to 1 when a wait timed out
  int corner, h, nj, n_sub;
  int match, mismatch, go, ge;
  int store_lastcol, flush_every;
  int warps;  // compute warps per block
};

struct Shared {
  int2 ring[MAXW + 1][RING];   // ring[w]: (H, F) of the row above warp w
  uint8_t bs[MAXW][2 * CHUNK]; // the two chunks of b a warp is reading
  volatile int prod[MAXW + 1]; // columns written into ring[w]
  volatile int cons[MAXW + 1]; // columns of ring[w] no longer needed
  volatile int abort;
  int g;
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

#ifdef MASA_PROFILE
// A measurement build (tools/strip_tune.py --profile): summed over the
// compute warps, the cycles spent in wait_ge, the cycles of their chunk
// loops, the waits that found nothing ready, and the chunks.
__device__ unsigned long long prof[4];
#endif

// Wait until *p >= need; false (for the whole warp) when the run aborted.
__device__ __forceinline__ bool wait_ge(volatile int* p, int need,
                                        volatile int* abort) {
  bool ok = true;
#ifdef MASA_PROFILE
  const long long t0 = clock64();
  const bool waited = *p < need;
#endif
  while (*p < need) {
    if (*abort) {
      ok = false;
      break;
    }
    __nanosleep(20);
  }
  ok = __all_sync(ALL, ok);
  __threadfence_block();
#ifdef MASA_PROFILE
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&prof[0], (unsigned long long)(clock64() - t0));
    if (waited) atomicAdd(&prof[2], 1ull);
  }
#endif
  return ok;
}

// One thread's rows: everything a lane carries from step to step.
template <int A>
struct Lane {
  int hl[A], el[A], bv[A], bj[A], ch[A];
  int fmask;   // bit k: row k of this thread is flushed
  int fq0;     // the flushed-row index of the first such row
  int dprev;   // H of the row above at the column before this lane's
  int ph, pf;  // (H, F) of the row above at this lane's next column
};

// CHUNK wavefront steps of one warp, steps s = c0 .. c0+CHUNK-1; lane l
// computes column j = s - l.  EDGE chunks (the strip's first and last
// ones) hold lanes whose column is outside [0, nj) and the last column.
template <int A, bool SW, bool TRACK, bool FLUSH, bool FULL, bool EDGE>
__device__ __forceinline__ void run_chunk(const Args& p, Shared& sh,
                                          Lane<A>& t, int w, int lane,
                                          int c0, int row0, int out_lane,
                                          int last_k) {
  const int nj = p.nj;
  const int gofirst = -(p.go + p.ge);
#pragma unroll 4
  for (int i = 0; i < CHUNK; ++i) {
    const int s = c0 + i;
    const int j = s - lane;
    const int2 in = sh.ring[w][s & (RING - 1)];  // lane 0's row above
    const int uh = lane == 0 ? in.x : t.ph;
    const int uf = lane == 0 ? in.y : t.pf;
    const bool act = !EDGE || (unsigned)j < (unsigned)nj;
    int vh = uh, vf = uf, oh = NEG, of = NEG;
    if (act) {
      const int bc = sh.bs[w][j & (2 * CHUNK - 1)];
      int dg = t.dprev;
#pragma unroll
      for (int k = 0; k < A; ++k) {
        // the cell (gotoh_cell.cuh): vh, vf become this row's H and F
        masa::gotoh_cell<SW>(t.hl[k], t.el[k], dg, vh, vf, t.ch[k], bc,
                             p.match, p.mismatch, gofirst, p.ge);
        if (TRACK) masa::track_best(vh, j, t.bv[k], t.bj[k]);
        if (FLUSH && (t.fmask >> k & 1)) {
          const int q = t.fq0 + __popc(t.fmask & ((1 << k) - 1));
          const size_t o = (size_t)q * nj + j;
          p.rows_h[o] = vh;
          p.rows_f[o] = vf;
        }
        if (!FULL && k == last_k) {
          oh = vh;
          of = vf;
        }
      }
      if (FULL) {
        oh = vh;
        of = vf;
      }
      t.dprev = uh;
      if (EDGE && p.store_lastcol && j == nj - 1) {
#pragma unroll
        for (int k = 0; k < A; ++k) {
          const int r = row0 + k;
          if (FULL || r < p.h) {
            p.last_h[r] = t.hl[k];
            p.last_e[r] = t.el[k];
          }
        }
      }
      if (lane == out_lane) sh.ring[w + 1][j & (RING - 1)] = make_int2(oh, of);
    }
    t.ph = __shfl_up_sync(ALL, vh, 1);
    t.pf = __shfl_up_sync(ALL, vf, 1);
  }
}

// One compute warp's share of sub-strip g: rows top + (32 w + lane) A ...
template <int A, bool SW, bool TRACK, bool FLUSH, bool FULL>
__device__ void compute_warp(const Args& p, Shared& sh, int top, int h_sub,
                             int w, int lane) {
  const int nj = p.nj;
  const int last_t = (h_sub - 1) / A;  // thread owning the sub-strip's last row
  // the warp's bottom row: lane 31's last row, but for the warp that holds
  // the sub-strip's last row
  const bool whole = FULL || w < last_t / 32;
  const int last_k = whole ? A - 1 : (h_sub - 1) % A;
  const int out_lane = whole ? 31 : last_t % 32;
  const int row0 = top + (w * 32 + lane) * A;

  Lane<A> t;
  t.fmask = 0;
  t.fq0 = 0;
#pragma unroll
  for (int k = 0; k < A; ++k) {
    const int r = row0 + k;
    const bool valid = FULL || r < p.h;
    t.ch[k] = valid ? (int)p.a[r] : -1;  // -1 never equals a byte
    t.hl[k] = valid ? p.col_h[r] : NEG;  // H(r, column -1) = left border
    t.el[k] = valid ? p.col_e[r] : NEG;
    t.bv[k] = NEG;
    t.bj[k] = 0;
    if (FLUSH && valid && r < p.h - 1 && (r + 1) % p.flush_every == 0) {
      if (t.fmask == 0) t.fq0 = (r + 1) / p.flush_every - 1;
      t.fmask |= 1 << k;
    }
  }
  // H of the row above at column j-1 (the diagonal of this thread's first
  // row); at j = 0 it is the left border of that row.
  t.dprev = row0 == 0 ? p.corner
                      : ((FULL || row0 - 1 < p.h) ? p.col_h[row0 - 1] : NEG);
  t.ph = NEG;
  t.pf = NEG;

  int bcur = lane < nj ? (int)__ldg(p.b + lane) : 0;
#ifdef MASA_PROFILE
  const long long tstart = clock64();
#endif
  for (int c0 = 0; c0 < nj + 31; c0 += CHUNK) {
    const int bnext =
        c0 + CHUNK + lane < nj ? (int)__ldg(p.b + c0 + CHUNK + lane) : 0;
    if (c0 < nj && !wait_ge(&sh.prod[w], min(c0 + CHUNK, nj), &sh.abort))
      return;
    // room in the ring below for the columns this chunk writes
    if (!wait_ge(&sh.cons[w + 1], c0 + CHUNK - out_lane - RING, &sh.abort))
      return;
    sh.bs[w][(c0 + lane) & (2 * CHUNK - 1)] = (uint8_t)bcur;
    bcur = bnext;
    __syncwarp();
    if (c0 >= CHUNK && c0 + CHUNK < nj)  // every lane inside, none on the last column
      run_chunk<A, SW, TRACK, FLUSH, FULL, false>(p, sh, t, w, lane, c0, row0,
                                                  out_lane, last_k);
    else
      run_chunk<A, SW, TRACK, FLUSH, FULL, true>(p, sh, t, w, lane, c0, row0,
                                                 out_lane, last_k);
    __syncwarp();
    if (lane == out_lane) {
      __threadfence_block();
      sh.prod[w + 1] = min(c0 + CHUNK - out_lane, nj);
    }
    if (lane == 0) {
      __threadfence_block();
      sh.cons[w] = c0 + CHUNK;
    }
  }

#ifdef MASA_PROFILE
  if (lane == 0) {
    atomicAdd(&prof[1], (unsigned long long)(clock64() - tstart));
    atomicAdd(&prof[3], (unsigned long long)((nj + 31 + CHUNK - 1) / CHUNK));
  }
#endif
  if (TRACK) {
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const int r = row0 + k;
      if (FULL || r < p.h) {
        p.best_v[r] = t.bv[k];
        p.best_j[r] = t.bj[k];
      }
    }
  }
}

// The block's extra warp: the bus of sub-strip g-1 from global memory into
// ring[0], ahead of use, and ring[out] (the sub-strip's last row) back to
// the bus in place, CHUNK columns at a time.
__device__ void io_warp(const Args& p, Shared& sh, int g, int lane, int out) {
  const int nj = p.nj;
  int in_done = 0, out_done = 0;
  int avail = g == 0 ? nj : 0;  // bus columns known to be written
  unsigned long long t0 = 0;
  int idle = 0;
  while (in_done < nj || out_done < nj) {
    bool moved = false;
    if (in_done < nj) {
      const int need = min(in_done + CHUNK, nj);
      const int consumed = __shfl_sync(ALL, sh.cons[0], 0);
      if (need - consumed <= RING) {
        if (avail < need)
          avail = __shfl_sync(ALL, ld_acquire(p.progress + g - 1), 0);
        if (avail >= need) {
          const int c = in_done + lane;
          int2 v = make_int2(NEG, NEG);
          if (c < nj) {
            v.x = __ldcg(p.bus_h + c);
            v.y = __ldcg(p.bus_f + c);
          }
          sh.ring[0][c & (RING - 1)] = v;
          __syncwarp();
          if (lane == 0) {
            __threadfence_block();
            sh.prod[0] = need;
          }
          in_done = need;
          moved = true;
        }
      }
    }
    if (out_done < nj) {
      const int need = min(out_done + CHUNK, nj);
      const int ready = __shfl_sync(ALL, sh.prod[out], 0);
      if (ready >= need) {
        __threadfence_block();
        const int c = out_done + lane;
        if (c < nj) {
          const int2 v = sh.ring[out][c & (RING - 1)];
          __stcg(p.bus_h + c, v.x);
          __stcg(p.bus_f + c, v.y);
        }
        __syncwarp();
        if (lane == 0) {
          __threadfence();
          st_release(p.progress + g, need);
          sh.cons[out] = need;
        }
        out_done = need;
        moved = true;
      }
    }
    if (moved) {
      idle = 0;
      continue;
    }
    // nothing to move: the compute warps or the sub-strip above are busy
    if (sh.abort) return;
    if (++idle == 1) t0 = now_ns();
    if ((idle & 255) == 0) {
      int bad = 0;
      if (lane == 0)
        bad = now_ns() - t0 > WAIT_NS || *(volatile int*)p.error != 0;
      if (__shfl_sync(ALL, bad, 0)) {
        if (lane == 0) {
          atomicExch(p.error, 1);
          sh.abort = 1;
        }
        return;
      }
    }
    __nanosleep(40);
  }
}

template <int A, bool SW, bool TRACK, bool FLUSH>
__global__ void __launch_bounds__(MAX_THREADS)
strip_kernel(const __grid_constant__ Args p) {
  __shared__ Shared sh;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int block_rows = 32 * A * p.warps;
  if (threadIdx.x == 0) sh.abort = 0;

  for (;;) {
    if (threadIdx.x == 0) sh.g = atomicAdd(p.ticket, 1);
    if (threadIdx.x <= MAXW) {
      sh.prod[threadIdx.x] = 0;
      sh.cons[threadIdx.x] = 0;
    }
    __syncthreads();
    const int g = sh.g;
    if (g >= p.n_sub) return;
    const int top = g * block_rows;
    const int h_sub = min(block_rows, p.h - top);
    const int used = (h_sub - 1) / (32 * A) + 1;  // compute warps with rows
    if (w == p.warps) {
      io_warp(p, sh, g, lane, used);
    } else if (w < used) {
      if (h_sub == block_rows)
        compute_warp<A, SW, TRACK, FLUSH, true>(p, sh, top, h_sub, w, lane);
      else
        compute_warp<A, SW, TRACK, FLUSH, false>(p, sh, top, h_sub, w, lane);
    }
    if (__syncthreads_or(sh.abort)) return;
  }
}

typedef void (*Kernel)(Args);

template <int A>
Kernel pick(bool sw, bool track, bool flush) {
  static const Kernel table[8] = {
      strip_kernel<A, false, false, false>, strip_kernel<A, false, false, true>,
      strip_kernel<A, false, true, false>,  strip_kernel<A, false, true, true>,
      strip_kernel<A, true, false, false>,  strip_kernel<A, true, false, true>,
      strip_kernel<A, true, true, false>,   strip_kernel<A, true, true, true>};
  return table[4 * sw + 2 * track + flush];
}

Kernel pick_kernel(int alpha, bool sw, bool track, bool flush) {
  switch (alpha) {
    case 8: return pick<8>(sw, track, flush);
    case 4: return pick<4>(sw, track, flush);
    case 2: return pick<2>(sw, track, flush);
    default: return nullptr;
  }
}

// Blocks of `threads` threads of kernel k the card holds at once.
int resident(Kernel k, int threads, cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, 0);
  if (*err != cudaSuccess) return 0;
  return per_sm * sms;
}

}  // namespace

#ifdef MASA_PROFILE
// Copy the four profile counters to `out` (host memory) and zero them.
extern "C" int masa_strip_profile(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, prof, sizeof(prof));
  if (e == cudaSuccess && reset) {
    unsigned long long z[4] = {0, 0, 0, 0};
    e = cudaMemcpyToSymbol(prof, z, sizeof(z));
  }
  return (int)e;
}
#endif

// Rows of the tallest block (ALPHA 8 x 32 lanes x MAXW warps): what a
// strip as tall as the card is cut into.
extern "C" int masa_strip_block_rows() { return 8 * 32 * MAXW; }

// Blocks of that shape the card holds at once (blocks per SM at full
// occupancy x SMs): a strip of more sub-strips than this runs its blocks
// in several waves.  Returns -1 when the device cannot be queried.
extern "C" int masa_strip_resident_blocks() {
  cudaError_t err;
  const int n = resident(pick_kernel(8, true, true, true), MAX_THREADS, &err);
  return err == cudaSuccess ? n : -1;
}

// Launch one strip on `stream`.  `sync` holds n_sub + 2 zeroed ints (the
// sub-strips' progress counters, the ticket and the error flag) for
// n_sub = ceil(h / (32 * alpha * warps)).  alpha is 8, 4 or 2 rows per
// thread, warps 1..8 compute warps per block.  Returns a cudaError_t
// value: 0 when the launch was accepted.  max_ctas > 0 caps the number of
// persistent blocks.
extern "C" int masa_strip_launch(
    const void* a, const void* b, void* bus_h, void* bus_f, const void* col_h,
    const void* col_e, int corner, int h, int nj, int match, int mismatch,
    int gap_open, int gap_ext, int sw, int track_best, int store_lastcol,
    int flush_every, void* best_v, void* best_j, void* last_h, void* last_e,
    void* rows_h, void* rows_f, void* sync, int alpha, int warps,
    int max_ctas, void* stream) {
  if (warps < 1 || warps > MAXW || h < 1 || nj < 1)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel =
      pick_kernel(alpha, sw != 0, track_best != 0, flush_every > 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int block_rows = 32 * alpha * warps;
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
  p.n_sub = (h + block_rows - 1) / block_rows;
  p.progress = static_cast<int*>(sync);
  p.ticket = p.progress + p.n_sub;
  p.error = p.ticket + 1;
  p.corner = corner;
  p.h = h;
  p.nj = nj;
  p.match = match;
  p.mismatch = mismatch;
  p.go = gap_open;
  p.ge = gap_ext;
  p.store_lastcol = store_lastcol;
  p.flush_every = flush_every;
  p.warps = warps;

  const int threads = 32 * (warps + 1);
  cudaError_t err;
  int grid = resident(kernel, threads, &err);
  if (err != cudaSuccess) return (int)err;
  if (grid > p.n_sub) grid = p.n_sub;
  if (max_ctas > 0 && max_ctas < grid) grid = max_ctas;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
