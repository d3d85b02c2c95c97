// A stage-2 hop on the card: its prologue, its hb x W NW sweep and its
// goal match, so that a chain of hops needs no read on the host until its
// end.
//
// Replaces masa_tpu/ops/wavefront.py:1216 hop_step_device, masa_tpu's hop
// as one XLA program around its strip kernel (the prologue, the strip,
// :1171 goal_match_device and the state update in one dispatch).  The
// port's first form of it (still here, for hops taller than a cluster
// holds) is three launches:
//
//   hop_prep_kernel   from the hop's state (cj, score, type, ok), an int32
//                     (4,) tensor on the card, writes the window b of W
//                     characters of the reversed seq1 at n - cj, the
//                     entering bus from the row border code and the left
//                     border H/E from the column border code;
//   the strip kernel  csrc/strip.cu: NW over hb x W, nothing tracked,
//                     corner 0;
//   hop_match_kernel  one block: the first k in [0, W] where the forward
//                     cut plus the reverse row reaches the goal (a
//                     block-wide min over W + 1 int64 sums), then the
//                     state update.
//
// hop_kernel does all of it in one launch and computes the same state,
// byte for byte, writing nothing but the state (and, when asked, the
// hop's last row) to device memory.  The plain version is
// ops/wavefront.py hop_plain; the kernels must give the same bytes.
//
// What bounds it.  Operations: hb x W cells of four INT32-lane
// instructions each (0.125 us at 512 x 1024, 32.1 us at 8192 x 16384 on
// an H100 at 1980 MHz), against a few bytes a column (a, the window, the
// cut up to the first stop, the state).  But a hop is short and wide: its
// rows fill only a few SMs, so the latency of one wavefront step (ALPHA
// dependent cells and a shuffle) times the W + hb / ALPHA steps of the
// sweep sets its time, and each launch of its own costs microseconds on
// top (the three-launch form spent them three times a hop, and wrote the
// window, the borders and the last row to device memory between them).
//
// What the design does about that.
//   * One launch.  Every thread reads the state and decides eligibility
//     as hop_match_kernel does (ok, cj >= W + 1, cj <= len(cut), under SW
//     score > min(hb, cj) * match) and checks k = 0 against the border
//     element; an ineligible hop, or one that stops at k = 0, writes its
//     state and returns with no sweep (unless the last row is asked for).
//   * The prologue in registers: the window is read straight from s1r at
//     clamp(n - cj) a chunk ahead, the entering bus is border_h(row code,
//     j + 1) with F = -INF in closed form in the first warp, and each
//     row's left border is border_h(column code, i + 1) with E = -INF.
//   * The sweep is the strip kernel's scheme (gotoh_cell.cuh's cell, NW,
//     nothing tracked): ALPHA rows a thread, lane l one column behind lane
//     l - 1, __shfl_up_sync down a warp, a shared-memory ring of RING
//     columns between warps.  A hop of one CTA's rows is one CTA.  A
//     taller one runs on a thread block cluster (8 CTAs, or 16 where the
//     card schedules that non-portable size): each CTA owns a band of
//     rows, and its extra warp moves the band's last row into the next
//     CTA's first ring through distributed shared memory, with release and
//     acquire at cluster scope.  No global progress counter, no ticket, no
//     wait on device memory: a launched cluster is resident whole, so no
//     CTA can wait on one that never started.
//   * The epilogue in the stream: the last CTA's extra warp takes the
//     hop's last row from its ring a chunk at a time, reads the cut a
//     chunk ahead, and checks the chunk's 32 columns at once (int64 sums,
//     a ballot for the first stop).  The first stop decides hit or
//     overshoot as hop_match_kernel decides; nothing after it changes the
//     state, so it raises a flag in every CTA of the cluster and the sweep
//     ends there.  Asked for the last row, the kernel sweeps to the end
//     and writes it.
//   * Rows a thread, warps a CTA and the cluster follow the hop's height
//     (ops/kernels.hop_geometry, measured on the card with
//     tools/hop_tune.py --variants).
//   * A wait that sees nothing move for 10 s sets the error flag and stops
//     every CTA of the cluster, so a fault cannot hang the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gotoh_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NEG = -999999999;  // -INF of the package's types
constexpr int WITH_GAPS = 1;     // InitType
constexpr int WITH_GAPS_OPENED = 2;
constexpr int GAP_1 = 1;         // CrosspointType
constexpr int GAP_2 = 2;
constexpr int MATCH_THREADS = 512;
// hop_kernel
constexpr int MAXW = 16;          // compute warps a CTA, at most
constexpr int CHUNK = 32;         // columns a hand-off (one a lane)
constexpr int RING = 128;         // columns of slack in a ring
constexpr int HOP_THREADS = 32 * (MAXW + 1);
constexpr int PORTABLE_CLUSTER = 8;
constexpr int MAX_CLUSTER = 16;   // non-portable, where the card allows it
constexpr unsigned ALL = 0xffffffffu;
constexpr int HALT_ERROR = 1;     // a wait timed out
constexpr int HALT_STOP = 2;      // the state is decided: the sweep may end
constexpr unsigned long long WAIT_NS = 10ull * 1000 * 1000 * 1000;

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

struct HopArgs {
  const uint8_t* a;    // (hb,) the hop's rows of the reversed seq0
  const uint8_t* s1r;  // (n,) the reversed seq1
  const int* cut_h;    // (cut_n,) the stored cut, index j - 1 -> column j
  const int* cut_f;
  const int* st_in;    // (4,) cj, score, type, ok
  int* st_out;
  int* rev_h;          // (W,) the hop's last row, or null: not asked
  int* rev_f;
  int* error;          // (1,) written 0, set to 1 when a wait timed out
  int hb, W, n, cut_n;
  int match, mismatch, go, ge, sw;
  int warps;           // compute warps a CTA
};

struct HopShared {
  int2 ring[MAXW + 1][RING];    // ring[w]: (H, F) of the row above warp w
  uint8_t bs[MAXW][2 * CHUNK];  // the two chunks of b a warp is reading
  volatile int prod[MAXW + 1];  // columns written into ring[w]
  volatile int cons[MAXW + 1];  // columns of ring[w] no longer needed
  volatile int halt;            // 0, HALT_ERROR or HALT_STOP
};

// What every thread derives from the hop's state on entry.
struct HopState {
  int cj, score, typ;
  bool eligible;      // the epilogue matches (hop_match_kernel's test)
  int j0;             // the window's first character in s1r
  int row_go, col_go; // gap open of the row / column border: 0 or go
  long long goal, edge;
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int ld_acquire_cluster(const volatile int* p) {
  int v;
  asm volatile("ld.acquire.cluster.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cluster(volatile int* p, int v) {
  asm volatile("st.release.cluster.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;" ::: "memory");
}

__device__ HopState read_state(const HopArgs& p) {
  HopState s;
  s.cj = p.st_in[0];
  s.score = p.st_in[1];
  s.typ = p.st_in[2];
  bool ok = p.st_in[3] && s.cj >= p.W + 1 && s.cj <= p.cut_n;
  if (p.sw && (long long)s.score <= (long long)(p.hb < s.cj ? p.hb : s.cj) *
                                        p.match)
    ok = false;
  s.eligible = ok;
  // an ineligible hop's window is clamped into the sequence, as
  // hop_prep_kernel clamps it
  long long j0 = (long long)p.n - s.cj;
  j0 = j0 < 0 ? 0 : (j0 > p.n - p.W ? p.n - p.W : j0);
  s.j0 = (int)j0;
  s.row_go = s.typ == GAP_1 ? 0 : p.go;  // border_h: WITH_GAPS_OPENED or not
  s.col_go = s.typ == GAP_2 ? 0 : p.go;
  s.goal = (long long)s.score + (s.typ != 0 ? p.go : 0);
  s.edge = -(long long)p.hb * p.ge - s.col_go;
  return s;
}

__device__ __forceinline__ bool stops(const HopState& s, long long fh,
                                      long long ff, long long rh,
                                      long long rf, int go) {
  return fh + rh >= s.goal || ff + rf + go >= s.goal;
}

__device__ __forceinline__ void write_state(int* st, int cj, int score,
                                            int typ, int ok) {
  st[0] = cj;
  st[1] = score;
  st[2] = typ;
  st[3] = ok;
}

// The state after the first stop at k: a hit moves to column cj - k, an
// overshoot carries the state through with ok = 0 (hop_match_kernel).
__device__ void write_verdict(int* st, const HopState& s, int k, long long fh,
                              long long ff, long long rh, long long rf,
                              int go) {
  const bool m_at = fh + rh == s.goal;
  if (m_at || ff + rf + go == s.goal)
    write_state(st, s.cj - k, m_at ? (int)fh : (int)ff, m_at ? 0 : GAP_2, 1);
  else
    write_state(st, s.cj, s.score, s.typ, 0);
}

// Stop every CTA of the cluster with `why` (one lane each).
__device__ void halt_all(HopShared& sh, cg::cluster_group& cluster, int lane,
                         int why) {
  if (lane < (int)cluster.num_blocks())
    cluster.map_shared_rank(&sh, lane)->halt = why;
  __syncwarp();
}

// Wait until *p >= need; false (for the whole warp) once the cluster is
// halted.  `remote`: *p is written by another CTA, so each lane polls it
// with an acquire at cluster scope (a cluster fence after the wait made
// every chunk of the band's first warp slower, and so the whole chain).
__device__ __forceinline__ bool wait_ge(volatile int* p, int need,
                                        volatile int* halt, bool remote) {
  bool ok = true;
  while ((remote ? ld_acquire_cluster(p) : *p) < need) {
    if (*halt) {
      ok = false;
      break;
    }
    __nanosleep(20);
  }
  ok = __all_sync(ALL, ok);
  if (!remote) __threadfence_block();
  return ok;
}

// The extra warp's idle clock: true (and the cluster stopped, the error
// flag set) once nothing has moved for WAIT_NS.
__device__ bool timed_out(const HopArgs& p, HopShared& sh,
                          cg::cluster_group& cluster, int lane, int& idle,
                          unsigned long long& t0) {
  if (++idle == 1) t0 = now_ns();
  if ((idle & 255) != 0) return false;
  int bad = 0;
  if (lane == 0) bad = now_ns() - t0 > WAIT_NS;
  if (!__shfl_sync(ALL, bad, 0)) return false;
  if (lane == 0) atomicExch(p.error, 1);
  halt_all(sh, cluster, lane, HALT_ERROR);
  return true;
}

// One thread's rows.
template <int A>
struct HopLane {
  int hl[A], el[A], ch[A];
  int dprev;   // H of the row above at the column before this lane's
  int ph, pf;  // (H, F) of the row above at this lane's next column
};

// CHUNK wavefront steps of one warp; lane l computes column j = s - l.
// TOP: the hop's first warp, whose row above is the entering bus
// (border_h(row code, j + 1), F = -INF), not a ring.  EDGE chunks hold
// lanes outside [0, W).
template <int A, bool FULL, bool TOP, bool EDGE>
__device__ __forceinline__ void hop_chunk(const HopArgs& p, const HopState& s,
                                          HopShared& sh, HopLane<A>& t,
                                          int w, int lane, int c0,
                                          int out_lane, int last_k) {
  const int nj = p.W;
  const int gofirst = -(p.go + p.ge);
#pragma unroll 4
  for (int i = 0; i < CHUNK; ++i) {
    const int st = c0 + i;
    const int j = st - lane;
    const int2 in = TOP ? make_int2(-s.row_go - (st + 1) * p.ge, NEG)
                        : sh.ring[w][st & (RING - 1)];
    const int uh = lane == 0 ? in.x : t.ph;
    const int uf = lane == 0 ? in.y : t.pf;
    const bool act = !EDGE || (unsigned)j < (unsigned)nj;
    int vh = uh, vf = uf, oh = NEG, of = NEG;
    if (act) {
      const int bc = sh.bs[w][j & (2 * CHUNK - 1)];
      int dg = t.dprev;
#pragma unroll
      for (int k = 0; k < A; ++k) {
        masa::gotoh_cell<false>(t.hl[k], t.el[k], dg, vh, vf, t.ch[k], bc,
                                p.match, p.mismatch, gofirst, p.ge);
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
      if (lane == out_lane) sh.ring[w + 1][j & (RING - 1)] = make_int2(oh, of);
    }
    t.ph = __shfl_up_sync(ALL, vh, 1);
    t.pf = __shfl_up_sync(ALL, vf, 1);
  }
}

// One compute warp's rows of the CTA's band: top + (32 w + lane) A ...
template <int A, bool FULL, bool TOP>
__device__ void hop_warp(const HopArgs& p, const HopState& s, HopShared& sh,
                         int top, int h_sub, int w, int lane) {
  const int nj = p.W;
  const int last_t = (h_sub - 1) / A;  // thread owning the band's last row
  const bool whole = FULL || w < last_t / 32;
  const int last_k = whole ? A - 1 : (h_sub - 1) % A;
  const int out_lane = whole ? 31 : last_t % 32;
  const int row0 = top + (w * 32 + lane) * A;
  const bool remote = w == 0;  // ring[0] is written by the CTA above

  HopLane<A> t;
#pragma unroll
  for (int k = 0; k < A; ++k) {
    const int r = row0 + k;
    const bool valid = FULL || r < p.hb;
    t.ch[k] = valid ? (int)p.a[r] : -1;  // -1 never equals a byte
    t.hl[k] = valid ? -s.col_go - (r + 1) * p.ge : NEG;  // border_h(r + 1)
    t.el[k] = NEG;
  }
  // H of the row above at column 0: the corner (0) or the left border
  t.dprev = row0 == 0 ? 0 : -s.col_go - row0 * p.ge;
  t.ph = NEG;
  t.pf = NEG;

  const uint8_t* b = p.s1r + s.j0;
  int bcur = lane < nj ? (int)__ldg(b + lane) : 0;
  for (int c0 = 0; c0 < nj + 31; c0 += CHUNK) {
    if (__any_sync(ALL, sh.halt != 0)) return;
    const int bnext =
        c0 + CHUNK + lane < nj ? (int)__ldg(b + c0 + CHUNK + lane) : 0;
    if (!TOP && c0 < nj &&
        !wait_ge(&sh.prod[w], min(c0 + CHUNK, nj), &sh.halt, remote))
      return;
    // room in the ring below for the columns this chunk writes
    if (!wait_ge(&sh.cons[w + 1], c0 + CHUNK - out_lane - RING, &sh.halt,
                 false))
      return;
    sh.bs[w][(c0 + lane) & (2 * CHUNK - 1)] = (uint8_t)bcur;
    bcur = bnext;
    __syncwarp();
    if (c0 >= CHUNK && c0 + CHUNK < nj)
      hop_chunk<A, FULL, TOP, false>(p, s, sh, t, w, lane, c0, out_lane,
                                     last_k);
    else
      hop_chunk<A, FULL, TOP, true>(p, s, sh, t, w, lane, c0, out_lane,
                                    last_k);
    __syncwarp();
    if (lane == out_lane) {
      __threadfence_block();
      sh.prod[w + 1] = min(c0 + CHUNK - out_lane, nj);
    }
    // the columns this chunk read from ring[w] are free: their values
    // are already used, so no release is needed even where the CTA above
    // reads the count (a release there slowed the chain as the fence did)
    if (!TOP && lane == 0) {
      __threadfence_block();
      sh.cons[w] = c0 + CHUNK;
    }
  }
}

// The extra warp of every CTA but the last: the band's last row, ring[out],
// into the next CTA's ring[0] through distributed shared memory, CHUNK
// columns at a time.
__device__ void forward_warp(const HopArgs& p, HopShared& sh,
                             cg::cluster_group& cluster, int rank, int lane,
                             int out) {
  HopShared* next = cluster.map_shared_rank(&sh, rank + 1);
  const int nj = p.W;
  int done = 0;
  int room = RING;  // columns of next's ring[0] known to be free
  int idle = 0;
  unsigned long long t0 = 0;
  while (done < nj) {
    const int need = min(done + CHUNK, nj);
    if (__shfl_sync(ALL, sh.prod[out], 0) >= need) {
      if (need > room)
        room = __shfl_sync(ALL, ld_acquire_cluster(&next->cons[0]), 0) + RING;
      if (need <= room) {
        __threadfence_block();
        const int c = done + lane;
        if (c < nj)
          next->ring[0][c & (RING - 1)] = sh.ring[out][c & (RING - 1)];
        fence_cluster();
        __syncwarp();
        if (lane == 0) {
          st_release_cluster(&next->prod[0], need);
          sh.cons[out] = need;
        }
        done = need;
        idle = 0;
        continue;
      }
    }
    if (__any_sync(ALL, sh.halt != 0)) return;
    if (timed_out(p, sh, cluster, lane, idle, t0)) return;
    __nanosleep(40);
  }
}

// The last CTA's extra warp: the hop's last row from ring[out], a chunk at
// a time, matched against the cut (k = j + 1 for column j; the cut read a
// chunk ahead), and written out when asked.  `decided`: the state was
// written before the sweep (an ineligible hop, or a stop at k = 0).
__device__ void match_warp(const HopArgs& p, const HopState& s,
                           HopShared& sh, cg::cluster_group& cluster,
                           int lane, int out, bool decided) {
  const int nj = p.W;
  const bool want_row = p.rev_h != nullptr;
  int nh = 0, nf = 0;  // the cut at the next chunk's column of this lane
  if (!decided && lane < nj) {
    nh = __ldg(p.cut_h + s.cj - 2 - lane);
    nf = __ldg(p.cut_f + s.cj - 2 - lane);
  }
  int done = 0;
  int idle = 0;
  unsigned long long t0 = 0;
  while (done < nj) {
    const int need = min(done + CHUNK, nj);
    if (__shfl_sync(ALL, sh.prod[out], 0) >= need) {
      __threadfence_block();
      const int c = done + lane;
      int2 v = make_int2(NEG, NEG);
      if (c < nj) v = sh.ring[out][c & (RING - 1)];
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        sh.cons[out] = need;
      }
      if (want_row && c < nj) {
        p.rev_h[c] = v.x;
        p.rev_f[c] = v.y;
      }
      if (!decided) {
        const long long fh = nh, ff = nf;
        const int c2 = c + CHUNK;
        if (c2 < nj) {
          nh = __ldg(p.cut_h + s.cj - 2 - c2);
          nf = __ldg(p.cut_f + s.cj - 2 - c2);
        }
        const unsigned m = __ballot_sync(
            ALL, c < nj && stops(s, fh, ff, v.x, v.y, p.go));
        if (m) {
          if (lane == __ffs(m) - 1)
            write_verdict(p.st_out, s, c + 1, fh, ff, v.x, v.y, p.go);
          decided = true;
          if (!want_row) {
            halt_all(sh, cluster, lane, HALT_STOP);
            return;
          }
        }
      }
      done = need;
      idle = 0;
      continue;
    }
    if (__any_sync(ALL, sh.halt != 0)) return;
    if (timed_out(p, sh, cluster, lane, idle, t0)) return;
    __nanosleep(40);
  }
  if (!decided && lane == 0) write_state(p.st_out, s.cj, s.score, s.typ, 0);
}

template <int A, bool FULL>
__device__ void hop_rows(const HopArgs& p, const HopState& s, HopShared& sh,
                         int top, int h_sub, int w, int lane) {
  if (top == 0 && w == 0)
    hop_warp<A, FULL, true>(p, s, sh, top, h_sub, w, lane);
  else
    hop_warp<A, FULL, false>(p, s, sh, top, h_sub, w, lane);
}

// One hop on one cluster of CTAs (grid = the cluster), each CTA a band of
// 32 * A * warps rows.
template <int A>
__global__ void __launch_bounds__(HOP_THREADS)
hop_kernel(const __grid_constant__ HopArgs p) {
  __shared__ HopShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int last = (int)cluster.num_blocks() - 1;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const HopState s = read_state(p);
  // k = 0: the cut at cj against the reverse row's border element
  const bool stop0 =
      s.eligible && stops(s, p.cut_h[s.cj - 1], p.cut_f[s.cj - 1], s.edge,
                          s.edge, p.go);
  const bool decided = !s.eligible || stop0;
  if (rank == 0 && threadIdx.x == 0) *p.error = 0;
  if (rank == last && threadIdx.x == 0 && decided) {
    if (stop0)
      write_verdict(p.st_out, s, 0, p.cut_h[s.cj - 1], p.cut_f[s.cj - 1],
                    s.edge, s.edge, p.go);
    else
      write_state(p.st_out, s.cj, s.score, s.typ, 0);
  }
  if (decided && p.rev_h == nullptr) return;  // every CTA: no sweep

  const int band = 32 * A * p.warps;
  const int top = rank * band;
  const int h_sub = min(band, p.hb - top);  // >= 1: the host's geometry
  const int used = (h_sub - 1) / (32 * A) + 1;  // compute warps with rows
  if (threadIdx.x <= MAXW) {
    sh.prod[threadIdx.x] = 0;
    sh.cons[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) sh.halt = 0;
  cluster.sync();  // every CTA's counters set before a remote write
  if (w == p.warps) {
    if (rank == last)
      match_warp(p, s, sh, cluster, lane, used, decided);
    else
      forward_warp(p, sh, cluster, rank, lane, used);
  } else if (w < used) {
    if (h_sub == band)
      hop_rows<A, true>(p, s, sh, top, h_sub, w, lane);
    else
      hop_rows<A, false>(p, s, sh, top, h_sub, w, lane);
  }
  // no CTA leaves while another may still write to its shared memory
  cluster.sync();
}

typedef void (*HopKernel)(HopArgs);

HopKernel pick_hop(int alpha) {
  switch (alpha) {
    case 8: return hop_kernel<8>;
    case 4: return hop_kernel<4>;
    case 2: return hop_kernel<2>;
    default: return nullptr;
  }
}

cudaLaunchConfig_t hop_config(int cluster, int warps, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(32 * (warps + 1), 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
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

// The largest cluster of hop_kernel's tallest CTA (MAXW + 1 warps, 8 rows a
// thread) the card schedules: MAX_CLUSTER where it can hold one such
// non-portable cluster, else PORTABLE_CLUSTER.  Negative: a CUDA error.
extern "C" int masa_hop_max_cluster() {
  const HopKernel kernel = pick_hop(8);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = hop_config(MAX_CLUSTER, MAXW, 0, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  if (e == cudaErrorInvalidClusterSize) {
    cudaGetLastError();  // that size is refused: the portable one serves
    return PORTABLE_CLUSTER;
  }
  if (e != cudaSuccess) return -(int)e;
  return n >= 1 ? MAX_CLUSTER : PORTABLE_CLUSTER;
}

// Compute warps a CTA of hop_kernel may hold.
extern "C" int masa_hop_max_warps() { return MAXW; }

// Launch one hop (hop_kernel) on `stream`: hb rows of `a` against the
// window of W characters of s1r (n of them) that the state st_in (int32
// (4,)) picks, matched against the cut (cut_n ints each), the next state
// written to st_out.  rev_h/rev_f (W ints each, both or neither): the hop's
// last row.  error: one int the kernel zeroes and sets on a timeout.
// alpha (2, 4 or 8) rows a thread, warps (1..MAXW) compute warps a CTA,
// cluster (1..MAX_CLUSTER) CTAs, each with rows: (cluster - 1) * 32 *
// alpha * warps < hb <= cluster * 32 * alpha * warps.  Returns a
// cudaError_t value: 0 when the launch was accepted.
extern "C" int masa_hop_launch(const void* a, int hb, const void* s1r, int n,
                               const void* cut_h, const void* cut_f,
                               int cut_n, const void* st_in, void* st_out,
                               void* rev_h, void* rev_f, void* error, int W,
                               int match, int mismatch, int gap_open,
                               int gap_ext, int sw, int alpha, int warps,
                               int cluster, void* stream) {
  const HopKernel kernel = pick_hop(alpha);
  const long long band = 32LL * alpha * warps;
  if (kernel == nullptr || warps < 1 || warps > MAXW || cluster < 1 ||
      cluster > MAX_CLUSTER || W < 1 || W >= n || hb < 1 ||
      (long long)hb > cluster * band || (long long)hb <= (cluster - 1) * band ||
      (rev_h == nullptr) != (rev_f == nullptr))
    return (int)cudaErrorInvalidValue;
  if (cluster > PORTABLE_CLUSTER) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  HopArgs p;
  p.a = static_cast<const uint8_t*>(a);
  p.s1r = static_cast<const uint8_t*>(s1r);
  p.cut_h = static_cast<const int*>(cut_h);
  p.cut_f = static_cast<const int*>(cut_f);
  p.st_in = static_cast<const int*>(st_in);
  p.st_out = static_cast<int*>(st_out);
  p.rev_h = static_cast<int*>(rev_h);
  p.rev_f = static_cast<int*>(rev_f);
  p.error = static_cast<int*>(error);
  p.hb = hb;
  p.W = W;
  p.n = n;
  p.cut_n = cut_n;
  p.match = match;
  p.mismatch = mismatch;
  p.go = gap_open;
  p.ge = gap_ext;
  p.sw = sw;
  p.warps = warps;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      hop_config(cluster, warps, static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
