// Stage 5 on the card: the constrained Gotoh DP and the traceback of many
// partitions in one launch, one thread block a partition.
//
// Replaces no TPU kernel: masa_tpu runs stage 5 on the host
// (ops/smallsw.py, native/masanative.cpp masa_traceback), one call a
// partition, and so did the port.  This kernel computes what
// masa_traceback computes, byte for byte: the segment score of the end
// state and the path's run-length operations in forward order (code 0
// diagonal, 1 up, 2 left, bit 2 (value 4) a gap run that opens), with the
// same borders (row 0: H = E, column 0: H = F), the same start-state seeds
// of H/E/F at (0, 0), -INF = -999,999,999, the same tie order of the walk
// (diagonal, then E, then F; an E or F opens where it equals the cell
// before it less gap_open and gap_ext) and the same failures (a walk that
// ends in a state it may not end in, a gap that runs off the border).
// Scores are int32: the caller admits a partition only where its largest
// score and its deepest gap stay far from the int32 edge
// (ops/kernels.traceback_fits), so every comparison is the int64 one.
// The plain version is ops/smallsw.py traceback_plain.
//
// What bounds it.  Operations: about seven INT32-lane instructions a cell
// (three add-max, a max, three compares for the cell's bits), h x w cells a
// partition, 5.4 x 10^8 cells in the CLI's 2,048 partitions of 512 x 512:
// 0.23 ms at the card's int32 peak.  A partition is small, so what costs is
// the latency of a wavefront step, the fill of the chain of strips, and the
// walk, a chain of shared-memory reads h + w cells long.
//
// What the design does about that.
//   * The table never leaves the SM: 4 bits a cell in shared memory (H's
//     source: diagonal, E, F or none; E opened; F opened), 131.6 KB for a
//     512 x 512 partition.  Nothing but the partition's characters and its
//     result touches device memory.
//   * The sweep is kernel 1's layout (csrc/strip.cu): a thread owns a row,
//     a warp a strip of 32 rows, lane l runs l columns behind lane 0 and
//     the row above moves down the warp by __shfl_up_sync.  The running
//     H/E/F stay in registers; a lane packs eight cells' bits into a word
//     before it stores them.  One row a thread, not kernel 1's eight: a
//     512 x 512 table fills an SM, so the SM's only block has to hide the
//     latency of each step with its own warps; on an H100, 2 and 4 rows a
//     thread (8 and 4 warps a block) took 1.44 and 1.59 times as long
//     over the CLI's 2,048 partitions of 512 x 512.
//   * Strips hand their last row to the strip below through shared memory
//     (a slot a warp, a full row wide), on a fixed schedule: strip s starts
//     (s - 1) * lag steps into the sweep, lag = PHASE + 32 or more, and the
//     block meets at a barrier every PHASE steps, so that a column is read
//     a barrier after it was written.  No warp spins: in this kernel's
//     first form each strip polled a counter of the columns the strip
//     above had written, and on an H100 a 512 x 512 sweep took 2.9 times
//     as long (a strip trailed the one above by ~125 steps, not 48).  A
//     block has at most MAXW warps; a taller partition deals its strips
//     round robin, a warp's next strip starting after its last has ended.
//   * Then the first warp walks back from (h, w) over the bits: each lane
//     reads one cell further along the way the state goes (the diagonal, a
//     row in E, a column in F), and a ballot finds where the run ends, so
//     the warp moves up to 32 cells a read (one thread's walk took ~176
//     cycles a cell).  It writes the runs from the end of the partition's
//     slot backwards, so that they lie in forward order at its end.
//   * The caller sizes dynamic shared memory to each launch's largest
//     table, and groups partitions by the memory they need, so that small
//     tables pack several blocks on an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -999999999;  // -INF of the package's types
constexpr int MAXW = 16;         // warps a block at most
constexpr int PHASE = 16;        // steps between the block's barriers
constexpr int LAG = PHASE + 32;  // least steps from a strip's start to the next's
constexpr unsigned ALL = 0xffffffffu;
// an item: the partition's rows [i0, i0+h) of a, columns [j0, j0+w) of b,
// its start and end states, the index in out of its (score, run count)
// and of its slot of 2 (h + w) ints
enum Field { I0, H, J0, W, TS, TE, OUT, OPS, N_FIELDS };

struct Score {
  int match, mismatch, go, ge;
};

// Shared memory of a block, in the kernel's order: nw slots of `cols`
// (H, F) pairs, the table of `table_words` words, the score of the end
// state and the `cols` - 1 characters of b; where the last of them ends.
constexpr long long layout_end(int nw, int table_words, int cols) {
  return 8LL * nw * cols + 4LL * table_words + 4LL + cols - 1;
}

// The H/E of row 0 at column j >= 1: E(0, 1) = max(-go, E(0, 0)) - ge, and
// from there E(0, j) = E(0, j - 1) + max(-go, 0) - ge, since H(0, j) =
// E(0, j) on row 0.
__device__ __forceinline__ int row0(int e01, int de, int j) {
  return e01 + (j - 1) * de;
}

// One lane's row of a strip: what it carries from step to step.
struct Lane {
  int i;              // the row (1-based); past h: the lane only shuffles
  int ai;             // its character
  const int2* above;  // the slot of the strip above
  int2* below;        // this strip's slot, when a strip below reads it
  unsigned* bits;     // its row of the table
  int hl, el;         // H and E of the cell to the left
  int hd;             // H of the cell above-left
  int oh, of;         // H and F of the lane's last cell, for the lane below
  unsigned word;      // the bits of up to eight cells not yet stored

  __device__ __forceinline__ void begin(int s, int strips, int nw, int cols,
                                        const uint8_t* a, int2* bus,
                                        unsigned* table, int h, int wpr) {
    i = 32 * (s - 1) + (threadIdx.x & 31) + 1;
    ai = i <= h ? a[i - 1] : 0;
    above = bus + ((s - 1) % nw) * cols;
    below = s < strips ? bus + (s % nw) * cols : nullptr;
    bits = table + i * wpr;
    hl = 0;
    el = NEG;
    hd = 0;
    oh = 0;
    of = NEG;
    word = 0;
  }

  // Step t of the strip: lane l computes the cell (i, t - l).
  __device__ __forceinline__ void step(int t, int h, int w, int te,
                                       const uint8_t* bs, int* seg,
                                       Score sc) {
    const int lane = threadIdx.x & 31;
    const int j = t - lane;
    const int gofirst = -(sc.go + sc.ge);
    // lane 0's cell above and the column's character, read ahead of the
    // shuffles
    int2 top = make_int2(0, 0);
    if (lane == 0 && j >= 0 && j <= w) top = above[j];
    const int bj = j >= 1 && j <= w ? bs[j - 1] : -1;
    int uh = __shfl_up_sync(ALL, oh, 1);
    int uf = __shfl_up_sync(ALL, of, 1);
    if (lane == 0) {
      uh = top.x;
      uf = top.y;
    }
    if (i > h || j < 0 || j > w) return;
    const int fv = max(uh + gofirst, uf - sc.ge);
    int hv, ev;
    unsigned b;
    if (j == 0) {  // column 0: H = F, E = -INF
      ev = NEG;
      hv = fv;
      b = (hv == ev ? 1u : 2u) | (unsigned)(fv == uh + gofirst) << 3;
    } else {
      ev = max(hl + gofirst, el - sc.ge);
      const int d = hd + (ai == bj ? sc.match : sc.mismatch);
      hv = max(d, max(ev, fv));
      const unsigned src = d == hv ? 0u : ev == hv ? 1u : fv == hv ? 2u : 3u;
      b = src | (unsigned)(ev == hl + gofirst) << 2 |
          (unsigned)(fv == uh + gofirst) << 3;
    }
    word |= b << (4 * (j & 7));
    if ((j & 7) == 7 || j == w) {
      bits[j >> 3] = word;
      word = 0;
    }
    hd = uh;
    hl = hv;
    el = ev;
    oh = hv;
    of = fv;
    if (i == h && j == w) *seg = te == 0 ? hv : te == 1 ? ev : fv;
    if (below != nullptr && lane == 31) below[j] = make_int2(hv, fv);
  }
};

// The walk's run-length output, the same in every lane; lane 0 writes.
struct Runs {
  int* slot;  // the first int written so far; runs go backwards from the end
  int code = -1, len = 0, count = 0;

  __device__ __forceinline__ void flush() {
    if (!len) return;
    slot -= 2;
    if ((threadIdx.x & 31) == 0) {
      slot[0] = code;
      slot[1] = len;
    }
    count++;
  }
  __device__ __forceinline__ void push(int c, int n) {
    if (n <= 0) return;
    if (c == code) {
      len += n;
      return;
    }
    flush();
    code = c;
    len = n;
  }
};

__global__ void __launch_bounds__(32 * MAXW)
    traceback_kernel(const uint8_t* __restrict__ a,
                     const uint8_t* __restrict__ b,
                     const int* __restrict__ items, int* __restrict__ out,
                     Score sc, int nw, int table_words, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* bus = reinterpret_cast<int2*>(smem);
  unsigned* table = reinterpret_cast<unsigned*>(bus + nw * cols);
  int* seg = reinterpret_cast<int*>(table + table_words);
  uint8_t* bs = reinterpret_cast<uint8_t*>(seg + 1);

  const int* it = items + (long long)blockIdx.x * N_FIELDS;
  const int h = it[H], w = it[W], ts = it[TS], te = it[TE];
  const int wpr = (w >> 3) + 1;  // words a row of the table
  const int gofirst = -(sc.go + sc.ge);

  // b's characters; row 0 into slot 0 and its bits
  for (int j = threadIdx.x; j < w; j += blockDim.x) bs[j] = b[it[J0] + j];
  const int e00 = ts == 1 ? 0 : NEG;
  const int f00 = ts == 2 ? 0 : NEG;
  const int e01 = max(-sc.go, e00) - sc.ge;
  const int de = max(-sc.go, 0) - sc.ge;
  for (int j = threadIdx.x; j <= w; j += blockDim.x)
    bus[j] = make_int2(j == 0 ? 0 : row0(e01, de, j), j == 0 ? f00 : NEG);
  for (int k = threadIdx.x; k < wpr; k += blockDim.x) {
    unsigned word = 0;
    for (int q = 0; q < 8; q++) {
      const int j = 8 * k + q;
      if (j == 0 || j > w) continue;
      const int hl = j == 1 ? 0 : row0(e01, de, j - 1);
      // H's source E; E opened where it equals H(0, j - 1) - go - ge
      word |= (1u | (unsigned)(row0(e01, de, j) == hl + gofirst) << 2)
              << (4 * q);
    }
    table[k] = word;
  }
  if (threadIdx.x == 0 && h == 0) {
    const int hv = w == 0 ? 0 : row0(e01, de, w);
    *seg = te == 0 ? hv : te == 1 ? (w == 0 ? e00 : hv) : (w == 0 ? f00 : NEG);
  }
  __syncthreads();

  // The sweep on a fixed schedule: strip s starts at step (s - 1) * lag,
  // at least PHASE + 32 steps after the strip above (whose last lane has
  // then written the columns it reads, a barrier ago) and nw * lag after
  // this warp's last strip began (which has then ended).
  const int strips = (h + 31) >> 5;
  const int lag = max(LAG, (w + 32 + nw - 1) / nw);
  const int steps = strips ? (strips - 1) * lag + w + 32 : 0;
  int s = (threadIdx.x >> 5) + 1, first = (s - 1) * lag;
  Lane r;
  if (s <= strips) r.begin(s, strips, nw, cols, a + it[I0], bus, table, h, wpr);
  for (int g0 = 0; g0 < steps; g0 += PHASE) {
    const int g1 = min(g0 + PHASE, steps);
    for (int g = g0; g < g1; g++) {
      if (s > strips || g < first) continue;
      r.step(g - first, h, w, te, bs, seg, sc);
      if (g - first == w + 31) {
        s += nw;
        first += nw * lag;
        if (s <= strips)
          r.begin(s, strips, nw, cols, a + it[I0], bus, table, h, wpr);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x >= 32) return;

  // The walk, as masa_traceback's, by the first warp: each lane looks one
  // cell further along the way the state goes (a diagonal, a row, a
  // column), a ballot finds the first cell that ends the run, and the warp
  // moves up to 32 cells at once.  Runs go backwards from the slot's end,
  // so that they lie in forward order.
  const int lane = threadIdx.x;
  auto cell = [&](int y, int x) {
    return table[y * wpr + (x >> 3)] >> (4 * (x & 7));
  };
  Runs runs{out + it[OPS] + 2LL * (h + w)};
  int i = h, j = w, state = te;
  bool ok = true;
  while (i > 0 || j > 0) {
    if (state == 0) {  // diagonal moves while H comes from the diagonal
      const int y = i - lane, x = j - lane;
      const bool stop = y < 0 || x < 0 || (y == 0 && x == 0) ||
                        (cell(y, x) & 3) != 0;
      const unsigned m = __ballot_sync(ALL, stop);
      const int n = m ? __ffs(m) - 1 : 32;
      runs.push(0, n);
      i -= n;
      j -= n;
      if (n == 32 || (i == 0 && j == 0)) continue;
      const unsigned src = cell(i, j) & 3;
      if (src == 3) {
        ok = false;
        break;
      }
      state = (int)src;
      continue;
    }
    // a gap: left along row i (E) or up along column j (F) until a cell
    // that opens it, or the border
    const bool left = state == 1;
    const int k = (left ? j : i) - lane;
    const bool edge = k <= 0;
    const bool opened =
        !edge && (left ? cell(i, k) >> 2 & 1 : cell(k, j) >> 3 & 1);
    const unsigned m = __ballot_sync(ALL, edge || opened);
    const int n = m ? __ffs(m) - 1 : 32;
    const int code = left ? 2 : 1;
    runs.push(code, n);
    (left ? j : i) -= n;
    if (n == 32) continue;
    if ((left ? j : i) == 0) {  // the gap reached the border unopened
      if ((left ? i : j) > 0) ok = false;
      break;
    }
    runs.push(code | 4, 1);
    (left ? j : i) -= 1;
    state = 0;
  }
  if (ok) runs.flush();
  // arriving in H is always legal: H(0, 0) = 0 closes a pinned gap
  if (state != ts && state != 0) ok = false;
  if (lane == 0) {
    out[it[OUT]] = *seg;
    out[it[OUT] + 1] = ok ? runs.count : -1;
  }
}

}  // namespace

// The most shared memory a block may ask for on the current card, or
// -(the CUDA error).
extern "C" int masa_traceback_max_shared() {
  int dev, v;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return e == cudaSuccess ? v : -(int)e;
}

// Launch `n` partitions on `stream`, a block each of `nw` warps (1..MAXW)
// with a table of `table_words` words and rows of `cols` columns, the
// largest of the launch, and `smem` bytes of dynamic shared memory (the
// caller's size, ops/kernels.traceback_smem; a size below the layout's
// end is refused).  `items` holds N_FIELDS ints a partition; `out` takes
// each partition's score and run count (-1: the walk failed) at its OUT
// and its runs at the end of its slot at OPS.  Returns a cudaError_t
// value: 0 when the launch was accepted.
extern "C" int masa_traceback_launch(const void* a, const void* b,
                                     const void* items, int n, void* out,
                                     int match, int mismatch, int gap_open,
                                     int gap_ext, int nw, int table_words,
                                     int cols, int smem, void* stream) {
  if (n < 1 || nw < 1 || nw > MAXW || table_words < 1 || cols < 1 ||
      smem < layout_end(nw, table_words, cols))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(traceback_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Score sc{match, mismatch, gap_open, gap_ext};
  traceback_kernel<<<n, 32 * nw, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const int*>(items), static_cast<int*>(out), sc, nw,
      table_words, cols);
  return (int)cudaGetLastError();
}
