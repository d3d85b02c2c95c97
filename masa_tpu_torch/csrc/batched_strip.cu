// Hopper batched strip kernels: many score-only NW strips in one launch.
//
// Two entries share one sweep (`element` below):
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
//    j+1 for j < w; columns j >= w are written as -INF.
//
//  * batched_strip_fixed_kernel replaces masa_tpu/ops/wavefront.py:
//    batched_strip_pallas: B equal-shape elements (h rows, nj columns)
//    with every border given: characters a (B, h) and b (B, nj), the left
//    border's H/E (B, h) at DP rows 1..h, the row above (B, nj) and a
//    corner (B,).  The kernel reads the row above and writes the last
//    row's (H, F) to its own output.  Logical column order: the TPU's
//    lane offset and padding are not part of it.
//
// Both keep the strip contract of csrc/strip.cu in logical coordinates.
//
// What bounds them.  Operations, not bytes: an element reads a character
// per row and per column and writes 8 bytes per column, for h cells a
// column.  A cell is seven instructions on the SM's integer pipe (an
// add-max each for E, F and the diagonal, a max for H, a compare and a
// select for the substitution score, a subtract for the gap extension).
// Stage 4's halves come in levels: a hundred elements of thousands of
// rows at the first, thousands of elements of a few hundred rows at the
// last, half a million rows a launch at every level.  So a launch is as
// much work as the card has lanes, and what costs is the latency of a
// wavefront step that nothing else on the SM hides.
//
// What the design does about that.
//   * A thread owns ALPHA consecutive rows (2, 4 or 8), a warp 32 * ALPHA,
//     and lane l runs l columns behind lane 0: the vertical chain stays in
//     registers and the bottom row's (H, F) moves to the next lane by
//     __shfl_up_sync.  There is no barrier of the block in the sweep: the
//     one __syncthreads() of a kernel follows the zeroing of the counters.
//   * An element of at most 32 * ALPHA rows is one warp and meets no other
//     warp; a block holds several such elements side by side.  A taller
//     element is a chain of warps of one block, each advancing on its
//     own: the bottom row moves through a ring of RING columns in shared
//     memory, guarded by two counters (columns produced, columns consumed)
//     published once per CHUNK columns.
//   * An element taller than its warps' rows is cut into sub-strips, each
//     an item of the launch on warps of its own, in the same block or in
//     another: the chain of warps goes on through the element's output
//     row in global memory, guarded by a counter per sub-strip (columns
//     written back), which the sub-strip below polls.  The row is
//     rewritten in place: a sub-strip overwrites a column only after it
//     has read it.  So a straggler twice as tall as the rest
//     takes two blocks side by side, not twice the time.  Items are handed
//     out in the table's order by an atomic ticket, a sub-strip after the
//     one above it, so the one above is always running already; a wait of
//     many seconds traps, so a fault cannot hang the card.
//   * Nothing in a step touches global memory.  The first warp of an
//     element fetches the row above (synthesized from the border code for
//     the first sub-strip of batched_strip_kernel: no load at all) and
//     every warp its characters of b one chunk ahead, 32 consecutive
//     columns a load, through a register into shared memory; the last
//     warp writes the bottom row back from its ring, 32 consecutive
//     columns a store.
//   * The kernels are templates over ALPHA and the border kind, the chunk
//     body over <whole warp> and <edge chunk>: the interior chunk of a
//     warp whose rows are all valid carries no bound check.
//   * The recurrence goes through the DPX add-max (__viaddmax_s32): the
//     same int32 values as plain add and max.
//   * Rows per thread, warps per element and elements per block follow the
//     launch's heights (ops/kernels.batched_geometry); elements are
//     dispatched tallest first, through a table of items in that order
//     that names each one's output row, sub-strip and counter.
// A launch with no chained element takes no ticket and touches no
// counter in global memory.  Heights, widths, offsets, border codes and
// scores are runtime data.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -999999999;  // -INF of the package's types, with headroom
constexpr int CHUNK = 32;        // columns per hand-off (one per lane)
constexpr int RING = 128;        // columns of slack in a ring
constexpr unsigned ALL = 0xffffffffu;
enum Field { I0, H, J0, W, ROW_CODE, COL_CODE, OUT, SUB, CTR, N_FIELDS };

struct Score {
  int match, mismatch, go, ge;
};

// Warps of one block, at most: 1024 threads but for ALPHA 8, whose
// registers allow 512.
__host__ __device__ constexpr int max_warps(int alpha) {
  return alpha == 8 ? 16 : 32;
}

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
  // the first row's (H, F) at column j
  __device__ int2 first_row(int j) const {
    return make_int2(border_h(rc, j + 1, go, ge), NEG);
  }
};

// Borders given as data (batched_strip_fixed_kernel).
struct DataBorder {
  const int* col_h;  // (h,) this element's left border
  const int* col_e;
  const int* in_h;   // (nj,) the row above
  const int* in_f;
  int corner;
  __device__ int left_h(int r) const { return __ldg(col_h + r); }
  __device__ int left_e(int r) const { return __ldg(col_e + r); }
  __device__ int above_h(int r) const {
    return r == 0 ? corner : __ldg(col_h + r - 1);
  }
  __device__ int2 first_row(int j) const {
    return make_int2(__ldg(in_h + j), __ldg(in_f + j));
  }
};

// One item: sub-strip `sub` of an element of h rows by w columns (both
// >= 1); the sub-strip's last row's (H, F) lands in out_h/out_f[0, w),
// where the sub-strip below reads it.
struct Job {
  const uint8_t* a;
  const uint8_t* b;
  int h, w;
  int* out_h;
  int* out_f;
  int sub;
  volatile unsigned* written;  // columns this sub-strip has written back,
                               // if one below waits for them; the counter
                               // of the sub-strip above is the one before
};

// What one warp sees of its element's shared memory.
struct Shared {
  int2* rin;                    // ring of the row above this warp
  int2* rout;                   // ring of this warp's bottom row
  volatile unsigned* prod_in;   // columns written into rin
  volatile unsigned* cons_in;   // columns of rin no longer needed
  volatile unsigned* prod_out;  // the same two of rout
  volatile unsigned* cons_out;
  uint8_t* bs;                  // the two chunks of b this warp is reading
};

// Wait until *p has reached `need`; by difference, so that a need below
// zero (room in a ring nobody has filled yet) is met at once.
__device__ __forceinline__ void wait_ge(volatile unsigned* p, unsigned need) {
  while ((int)(*p - need) < 0) __nanosleep(20);
  __syncwarp();
  __threadfence_block();
}

// The same on a sub-strip's counter in global memory, which a warp of
// another block may write; gives up (the launch fails) after many seconds.
__device__ __forceinline__ void wait_written(volatile unsigned* p,
                                             unsigned need) {
  unsigned spins = 0;
  while ((int)(*p - need) < 0) {
    __nanosleep(100);
    if (++spins > (1u << 27)) __trap();
  }
  __syncwarp();
  __threadfence();
}

// One thread's rows: everything a lane carries from step to step.
template <int A>
struct Lane {
  int hl[A], el[A], ch[A];
  int dprev;   // H of the row above at the column before this lane's
  int ph, pf;  // (H, F) of the row above at this lane's next column
};

// CHUNK wavefront steps of one warp, steps s = c0 .. c0+CHUNK-1; lane l
// computes column j = s - l.  EDGE chunks (the first and last ones) hold
// lanes whose column is outside [0, w).  WHOLE: every row of the warp is
// inside the element, so the bottom row is lane 31's last.
template <int A, bool WHOLE, bool EDGE>
__device__ __forceinline__ void run_chunk(const Score& sc, const Shared& sh,
                                          Lane<A>& t, int lane, int c0, int w,
                                          int out_lane, int last_k) {
  const int gofirst = -(sc.go + sc.ge);
#pragma unroll 4
  for (int i = 0; i < CHUNK; ++i) {
    const int s = c0 + i;
    const int j = s - lane;
    const int2 in = sh.rin[s & (RING - 1)];  // lane 0's row above
    const int uh = lane == 0 ? in.x : t.ph;
    const int uf = lane == 0 ? in.y : t.pf;
    int vh = uh, vf = uf;
    if (!EDGE || (unsigned)j < (unsigned)w) {
      const int bc = sh.bs[j & (2 * CHUNK - 1)];
      int dg = t.dprev, oh = NEG, of = NEG;
#pragma unroll
      for (int k = 0; k < A; ++k) {
        const int e = __viaddmax_s32(t.hl[k], gofirst, t.el[k] - sc.ge);
        const int f = __viaddmax_s32(vh, gofirst, vf - sc.ge);
        const int sub = t.ch[k] == bc ? sc.match : sc.mismatch;
        const int hv = max(__viaddmax_s32(dg, sub, e), f);
        dg = t.hl[k];
        t.hl[k] = hv;
        t.el[k] = e;
        vh = hv;
        vf = f;
        if (!WHOLE && k == last_k) {
          oh = hv;
          of = f;
        }
      }
      if (WHOLE) {
        oh = vh;
        of = vf;
      }
      t.dprev = uh;
      if (lane == out_lane) sh.rout[j & (RING - 1)] = make_int2(oh, of);
    }
    t.ph = __shfl_up_sync(ALL, vh, 1);
    t.pf = __shfl_up_sync(ALL, vf, 1);
  }
}

// One item on `wpe` warps of a block; `wl` is this warp's place among
// them.  Every warp of the item calls it; none waits for a warp of
// another item but through the counter of the sub-strip above.
template <int A, class Border>
__device__ void element(const Job& jb, const Border& bd, const Score& sc,
                        const Shared& sh, int wl, int wpe, int lane) {
  const int h = jb.h, w = jb.w;
  const int rows = 32 * A * wpe;
  const int top = jb.sub * rows;
  const int h_sub = min(rows, h - top);
  const bool more = top + rows < h;  // a sub-strip below reads this one's row
  const int last_t = (h_sub - 1) / A;  // thread owning the last row
  const int used = last_t / 32 + 1;    // warps with rows
  if (wl >= used) return;
  const bool first = wl == 0, last = wl == used - 1;
  const bool whole = (wl + 1) * 32 * A <= h_sub;
  const int out_lane = whole ? 31 : last_t % 32;
  const int last_k = whole ? A - 1 : (h_sub - 1) % A;
  const int row0 = top + (wl * 32 + lane) * A;

  Lane<A> t;
#pragma unroll
  for (int k = 0; k < A; ++k) {
    const int r = row0 + k;
    const bool valid = r < h;
    t.ch[k] = valid ? (int)__ldg(jb.a + r) : -1;  // -1 never equals a byte
    t.hl[k] = valid ? bd.left_h(r) : NEG;  // H(r, column -1) = left border
    t.el[k] = valid ? bd.left_e(r) : NEG;
  }
  // H of the row above at column -1: the left border (the corner at 0)
  t.dprev = row0 < h ? bd.above_h(row0) : NEG;
  t.ph = NEG;
  t.pf = NEG;

  // The row above the first warp at columns cn + lane: the border's first
  // row, or what the sub-strip above wrote back.
  auto fetch = [&](int cn) -> int2 {
    const int c = cn + lane;
    if (top > 0 && cn < w)
      wait_written(jb.written - 1, min(cn + CHUNK, w));
    if (c >= w) return make_int2(NEG, NEG);
    if (top == 0) return bd.first_row(c);
    return make_int2(__ldcg(jb.out_h + c), __ldcg(jb.out_f + c));
  };

  int2 cur = first ? fetch(0) : make_int2(NEG, NEG);
  int bcur = lane < w ? (int)__ldg(jb.b + lane) : 0;
  int done = 0;  // columns the last warp has written back

  for (int c0 = 0; c0 < w + CHUNK - 1; c0 += CHUNK) {
    const int bnext =
        c0 + CHUNK + lane < w ? (int)__ldg(jb.b + c0 + CHUNK + lane) : 0;
    if (first) {
      sh.rin[(c0 + lane) & (RING - 1)] = cur;
      cur = fetch(c0 + CHUNK);
    } else if (c0 < w) {
      wait_ge(sh.prod_in, min(c0 + CHUNK, w));
    }
    // room in the ring below for the columns this chunk writes
    if (!last) wait_ge(sh.cons_out, c0 + CHUNK - out_lane - RING);
    sh.bs[(c0 + lane) & (2 * CHUNK - 1)] = (uint8_t)bcur;
    bcur = bnext;
    __syncwarp();
    const bool edge = c0 < CHUNK || c0 + CHUNK >= w;
    if (whole) {
      if (edge)
        run_chunk<A, true, true>(sc, sh, t, lane, c0, w, out_lane, last_k);
      else
        run_chunk<A, true, false>(sc, sh, t, lane, c0, w, out_lane, last_k);
    } else {
      run_chunk<A, false, true>(sc, sh, t, lane, c0, w, out_lane, last_k);
    }
    __syncwarp();
    if (!last) {
      if (lane == out_lane) {
        __threadfence_block();
        *sh.prod_out = min(c0 + CHUNK - out_lane, w);
      }
    } else {
      // write back what is complete, 32 consecutive columns a store
      const int ready = min(c0 + CHUNK - out_lane, w);
      const int before = done;
      while (done + CHUNK <= ready || (ready == w && done < w)) {
        const int c = done + lane;
        if (c < w) {
          const int2 v = sh.rout[c & (RING - 1)];
          __stcg(jb.out_h + c, v.x);
          __stcg(jb.out_f + c, v.y);
        }
        done = min(done + CHUNK, w);
      }
      if (more && done != before) {
        __syncwarp();
        if (lane == 0) {
          __threadfence();
          *jb.written = done;
        }
      }
    }
    if (!first && lane == 0) {
      __threadfence_block();
      *sh.cons_in = c0 + CHUNK;
    }
  }
}

// The block's shared memory: per item slot wpe + 1 rings with their two
// counters, then 2 * CHUNK bytes of b per warp.  `slot` is the item's
// place in the block.  Also hands the block its place in the launch's
// order: the next ticket of `sync` where sub-strips wait for one another,
// else its index.
__device__ __forceinline__ Shared carve(int2* smem, int wpe, int epb,
                                        int slot, int wl, unsigned* sync,
                                        unsigned* block) {
  __shared__ unsigned ticket;
  const int n_rings = epb * (wpe + 1);
  unsigned* counters = reinterpret_cast<unsigned*>(smem + n_rings * RING);
  // zeroed by every thread of the block, then the kernel's one barrier
  for (int i = threadIdx.x; i < 2 * n_rings; i += blockDim.x) counters[i] = 0;
  if (threadIdx.x == 0) ticket = sync ? atomicAdd(sync, 1u) : blockIdx.x;
  __syncthreads();
  *block = ticket;
  const int ring = slot * (wpe + 1) + wl;
  Shared sh;
  sh.rin = smem + ring * RING;
  sh.rout = sh.rin + RING;
  sh.prod_in = counters + ring;
  sh.prod_out = sh.prod_in + 1;
  sh.cons_in = counters + n_rings + ring;
  sh.cons_out = sh.cons_in + 1;
  sh.bs = reinterpret_cast<uint8_t*>(counters + 2 * n_rings) +
          (slot * wpe + wl) * 2 * CHUNK;
  return sh;
}

size_t shared_bytes(int wpe, int epb) {
  const size_t n_rings = (size_t)epb * (wpe + 1);
  return n_rings * RING * sizeof(int2) + 2 * n_rings * sizeof(unsigned) +
         (size_t)epb * wpe * 2 * CHUNK;
}

template <int A>
__global__ void __launch_bounds__(32 * max_warps(A))
    batched_strip_kernel(const uint8_t* a, const uint8_t* b, const int* items,
                         int n, int* bus_h, int* bus_f, int width, Score sc,
                         int wpe, int epb, unsigned* sync) {
  extern __shared__ int2 smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / wpe, wl = warp % wpe;
  unsigned block;
  const Shared sh = carve(smem, wpe, epb, slot, wl, sync, &block);
  const size_t at = (size_t)block * epb + slot;  // place in dispatch order
  if (at >= (size_t)n) return;
  const int* it = items + at * N_FIELDS;
  const int w = it[W];
  int* out_h = bus_h + (size_t)it[OUT] * width;
  int* out_f = bus_f + (size_t)it[OUT] * width;
  if (it[SUB] == 0)
    for (int c = w + wl * 32 + lane; c < width; c += 32 * wpe) {
      out_h[c] = NEG;
      out_f[c] = NEG;
    }
  if (w <= 0) return;
  const CodeBorder bd{it[ROW_CODE], it[COL_CODE], sc.go, sc.ge};
  const Job jb{a + it[I0], b + it[J0], it[H], w, out_h, out_f, it[SUB],
               it[CTR] < 0 ? nullptr : sync + 1 + it[CTR]};
  element<A>(jb, bd, sc, sh, wl, wpe, lane);
}

template <int A>
__global__ void __launch_bounds__(32 * max_warps(A))
    batched_strip_fixed_kernel(const uint8_t* a, const uint8_t* b,
                               const int* col_h, const int* col_e,
                               const int* corners, const int* in_h,
                               const int* in_f, int* out_h, int* out_f, int n,
                               int h, int nj, Score sc, int wpe, int epb,
                               unsigned* sync) {
  extern __shared__ int2 smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / wpe, wl = warp % wpe;
  unsigned block;
  const Shared sh = carve(smem, wpe, epb, slot, wl, sync, &block);
  // items in order: the sub-strips of element 0, then of element 1, ...
  const int n_sub = (h + 32 * A * wpe - 1) / (32 * A * wpe);
  const size_t at = (size_t)block * epb + slot;
  if (at >= (size_t)n * n_sub) return;
  const size_t e = at / n_sub;
  const DataBorder bd{col_h + e * h, col_e + e * h, in_h + e * nj,
                      in_f + e * nj, __ldg(corners + e)};
  const Job jb{a + e * h, b + e * nj, h, nj, out_h + e * nj, out_f + e * nj,
               (int)(at % n_sub), sync ? sync + 1 + at : nullptr};
  element<A>(jb, bd, sc, sh, wl, wpe, lane);
}

// Checks a block shape and makes room for its shared memory; the grid
// size for n items, or 0 with *err set.
template <class Kernel>
int prepare(Kernel kernel, int alpha, long long n, int wpe, int epb,
            size_t* smem, cudaError_t* err) {
  *err = cudaErrorInvalidConfiguration;
  if (n < 1 || wpe < 1 || epb < 1 || wpe * epb > max_warps(alpha)) return 0;
  const long long grid = (n + epb - 1) / epb;
  if (grid > 0x7fffffffLL) return 0;
  *smem = shared_bytes(wpe, epb);
  *err = cudaSuccess;
  if (*smem > 48 * 1024)  // more than a kernel gets unasked
    *err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
  if (*err != cudaSuccess) return 0;
  return (int)grid;
}

}  // namespace

// Warps a block of the kernels may hold at `alpha` rows a thread (2, 4 or
// 8), 0 for another alpha.
extern "C" int masa_batched_strip_max_warps(int alpha) {
  return alpha == 2 || alpha == 4 || alpha == 8 ? max_warps(alpha) : 0;
}

// Launch `n` items on `stream`: `alpha` rows a thread (2, 4 or 8), `wpe`
// warps per item, `epb` items per block (wpe * epb at most
// masa_batched_strip_max_warps(alpha)).  `items` holds N_FIELDS ints per
// item in dispatch order: an element's i0, h, j0, w, row code, column
// code, its row of bus_h/bus_f, the item's sub-strip of 32 * alpha * wpe
// rows, and the index of the sub-strip's counter (-1: the element is one
// sub-strip); the sub-strips of an element follow one another, counters
// too.  `sync` holds 1 + counters zeroed ints (the ticket first), or is
// null when no element is chained.  Returns a cudaError_t value: 0 when
// the launch was accepted.
extern "C" int masa_batched_strip_launch(const void* a, const void* b,
                                         const void* items, int n, int alpha,
                                         int wpe, int epb, void* bus_h,
                                         void* bus_f, int width, void* sync,
                                         int match, int mismatch,
                                         int gap_open, int gap_ext,
                                         void* stream) {
  void (*kernel)(const uint8_t*, const uint8_t*, const int*, int, int*, int*,
                 int, Score, int, int, unsigned*);
  switch (alpha) {
    case 8: kernel = batched_strip_kernel<8>; break;
    case 4: kernel = batched_strip_kernel<4>; break;
    case 2: kernel = batched_strip_kernel<2>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  size_t smem;
  cudaError_t err;
  const int grid = prepare(kernel, alpha, n, wpe, epb, &smem, &err);
  if (grid == 0) return (int)err;
  const Score sc{match, mismatch, gap_open, gap_ext};
  kernel<<<grid, 32 * wpe * epb, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const int*>(items), n, static_cast<int*>(bus_h),
      static_cast<int*>(bus_f), width, sc, wpe, epb,
      static_cast<unsigned*>(sync));
  return (int)cudaGetLastError();
}

// Launch `n` equal-shape elements of h rows by nj columns on `stream`, in
// the block shape given as above; in_h/in_f hold the rows above, out_h/
// out_f take the last rows.  An element taller than 32 * alpha * wpe rows
// is chained: `sync` then holds 1 + n * ceil(h / (32 * alpha * wpe))
// zeroed ints, else it is null.  Returns a cudaError_t value: 0 when the
// launch was accepted.
extern "C" int masa_batched_strip_fixed_launch(
    const void* a, const void* b, const void* col_h, const void* col_e,
    const void* corners, const void* in_h, const void* in_f, int n, int h,
    int nj, int alpha, int wpe, int epb, void* out_h, void* out_f, void* sync,
    int match, int mismatch, int gap_open, int gap_ext, void* stream) {
  void (*kernel)(const uint8_t*, const uint8_t*, const int*, const int*,
                 const int*, const int*, const int*, int*, int*, int, int, int,
                 Score, int, int, unsigned*);
  switch (alpha) {
    case 8: kernel = batched_strip_fixed_kernel<8>; break;
    case 4: kernel = batched_strip_fixed_kernel<4>; break;
    case 2: kernel = batched_strip_fixed_kernel<2>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (n < 1 || h < 1 || nj < 1 || wpe < 1) return (int)cudaErrorInvalidValue;
  const long long rows = 32LL * alpha * wpe;
  const long long n_sub = (h + rows - 1) / rows;
  if ((n_sub > 1) != (sync != nullptr)) return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err;
  const int grid = prepare(kernel, alpha, n * n_sub, wpe, epb, &smem, &err);
  if (grid == 0) return (int)err;
  const Score sc{match, mismatch, gap_open, gap_ext};
  kernel<<<grid, 32 * wpe * epb, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const int*>(col_h), static_cast<const int*>(col_e),
      static_cast<const int*>(corners), static_cast<const int*>(in_h),
      static_cast<const int*>(in_f), static_cast<int*>(out_h),
      static_cast<int*>(out_f), n, h, nj, sc, wpe, epb,
      static_cast<unsigned*>(sync));
  return (int)cudaGetLastError();
}
