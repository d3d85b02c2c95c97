// Taken from ``masa_tpu/native/masanative.cpp`` (the JAX reference).
// Native host-side helpers for masa_tpu: FASTA loading and the
// stage-5 constrained DP + traceback (the parts the reference implements
// in C++: biology/SequenceData.cpp and stage5/sw_stage5.cpp).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread
//
// State algebra matches ops/smallsw.py: a crosspoint pins the path to a
// DP state (0=H/MATCH, 1=E/GAP_1 horizontal, 2=F/GAP_2 vertical); gap
// state seeds are free to close (H(0,0)=0 always).

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t NEG = -999999999LL;

inline int64_t max2(int64_t a, int64_t b) { return a > b ? a : b; }
inline int64_t max3(int64_t a, int64_t b, int64_t c) {
  return max2(max2(a, b), c);
}

}  // namespace

extern "C" {

// Parse a single-record FASTA file: uppercased residues into out
// (capacity cap), description into desc (capacity desc_cap).  Returns the
// residue count, or -1 on error.
long long masa_load_fasta(const char* path, unsigned char* out,
                          long long cap, char* desc, long long desc_cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  desc[0] = '\0';
  long long n = 0;
  std::vector<char> buf(1 << 20);
  bool first_line = true;
  bool in_header = false;
  long long dlen = 0;
  size_t got;
  while ((got = fread(buf.data(), 1, buf.size(), f)) > 0) {
    for (size_t k = 0; k < got; k++) {
      char c = buf[k];
      if (first_line && c == '>') {
        in_header = true;
        first_line = false;
        continue;
      }
      first_line = false;
      if (in_header) {
        if (c == '\n') {
          in_header = false;
          desc[dlen] = '\0';
        } else if (dlen + 1 < desc_cap && c != '\r') {
          desc[dlen++] = c;
        }
        continue;
      }
      if ((unsigned char)c > 32) {
        if (n >= cap) { fclose(f); return -1; }
        out[n++] = (unsigned char)std::toupper((unsigned char)c);
      }
    }
  }
  // trim trailing header whitespace
  while (dlen > 0 && isspace((unsigned char)desc[dlen - 1])) {
    desc[--dlen] = '\0';
  }
  fclose(f);
  return n;
}

// Constrained DP + traceback for one partition.
// ops_out layout: [count, code0, len0, code1, len1, ...]; codes:
//   0 = diagonal run, 1 = up (gap chars in seq1), 2 = left (gap in seq0),
//   bit 2 (value 4) marks the gap run as opened (charges gap_open).
// Runs are emitted in FORWARD path order.  Returns the segment score or
// -(1<<62) on failure.
long long masa_traceback(const unsigned char* seq0, long long h,
                         const unsigned char* seq1, long long w,
                         int type_s, int type_e,
                         int match, int mismatch, int gap_open,
                         int gap_ext,
                         int* ops_out, long long ops_cap) {
  const long long FAIL = -(1LL << 62);
  const int64_t go = gap_open, ge = gap_ext;
  const long long W1 = w + 1;
  std::vector<int64_t> H((h + 1) * W1), E((h + 1) * W1), F((h + 1) * W1);
  auto idx = [W1](long long i, long long j) { return i * W1 + j; };

  H[idx(0, 0)] = 0;
  E[idx(0, 0)] = (type_s == 1) ? 0 : NEG;
  F[idx(0, 0)] = (type_s == 2) ? 0 : NEG;
  for (long long j = 1; j <= w; j++) {
    E[idx(0, j)] = max2(H[idx(0, j - 1)] - go, E[idx(0, j - 1)]) - ge;
    H[idx(0, j)] = E[idx(0, j)];
    F[idx(0, j)] = NEG;
  }
  for (long long i = 1; i <= h; i++) {
    F[idx(i, 0)] = max2(H[idx(i - 1, 0)] - go, F[idx(i - 1, 0)]) - ge;
    H[idx(i, 0)] = F[idx(i, 0)];
    E[idx(i, 0)] = NEG;
    const unsigned char c0 = seq0[i - 1];
    const int64_t* Hp = &H[idx(i - 1, 0)];
    const int64_t* Fp = &F[idx(i - 1, 0)];
    int64_t* Hc = &H[idx(i, 0)];
    int64_t* Ec = &E[idx(i, 0)];
    int64_t* Fc = &F[idx(i, 0)];
    for (long long j = 1; j <= w; j++) {
      Ec[j] = max2(Hc[j - 1] - go, Ec[j - 1]) - ge;
      Fc[j] = max2(Hp[j] - go, Fp[j]) - ge;
      int64_t s = (c0 == seq1[j - 1]) ? match : mismatch;
      Hc[j] = max3(Hp[j - 1] + s, Ec[j], Fc[j]);
    }
  }

  long long seg;
  if (type_e == 1) seg = E[idx(h, w)];
  else if (type_e == 2) seg = F[idx(h, w)];
  else seg = H[idx(h, w)];

  // traceback (reverse order), run-length compressed
  std::vector<int> rcodes;
  std::vector<int> rlens;
  auto push = [&](int code) {
    if (!rcodes.empty() && rcodes.back() == code) {
      rlens.back()++;
    } else {
      rcodes.push_back(code);
      rlens.push_back(1);
    }
  };
  long long i = h, j = w;
  int state = type_e;
  while (i > 0 || j > 0) {
    if (state == 0) {
      int64_t s = (i > 0 && j > 0 &&
                   seq0[i - 1] == seq1[j - 1]) ? match : mismatch;
      if (i > 0 && j > 0 && H[idx(i, j)] == H[idx(i - 1, j - 1)] + s) {
        push(0);
        i--; j--;
        continue;
      }
      if (H[idx(i, j)] == E[idx(i, j)]) { state = 1; continue; }
      if (H[idx(i, j)] == F[idx(i, j)]) { state = 2; continue; }
      return FAIL;
    }
    if (state == 1) {
      if (j <= 0) return FAIL;
      bool opened = E[idx(i, j)] == H[idx(i, j - 1)] - go - ge;
      push(opened ? 6 : 2);
      j--;
      if (opened) state = 0;
      continue;
    }
    if (i <= 0) return FAIL;
    bool opened = F[idx(i, j)] == H[idx(i - 1, j)] - go - ge;
    push(opened ? 5 : 1);
    i--;
    if (opened) state = 0;
  }
  // Arriving in H state is always legal: H(0,0)=0 is the free closure of
  // a pinned gap state (see ops/smallsw.py).
  if (state != type_s && state != 0) return FAIL;

  long long count = (long long)rcodes.size();
  if (1 + 2 * count > ops_cap) return FAIL;
  ops_out[0] = (int)count;
  for (long long k = 0; k < count; k++) {
    // reverse to forward order
    ops_out[1 + 2 * k] = rcodes[count - 1 - k];
    ops_out[2 + 2 * k] = rlens[count - 1 - k];
  }
  return seg;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Stage 4: Myers-Miller midpoint splitting (the reference's pthreaded
// reduce, stage4/sw_stage4.cpp:806-852, with the optimized banded
// strategy of ort_split_2, :297-380).  Bit-identical to the Python
// OPTIMIZED path in ops/myers_miller.py (same window ladder, same
// descending-j match scan, same crosspoint state algebra).
// ---------------------------------------------------------------------------

namespace {

struct Cp {
  long long i, j, score;
  int type;  // 0=MATCH, 1=GAP_1 (E), 2=GAP_2 (F)
};

// InitType codes mirroring types.py: 1=WITH_GAPS, 2=WITH_GAPS_OPENED
inline int64_t border_h(int init, long long k, int64_t go, int64_t ge) {
  if (init == 2) return -k * ge;
  return k == 0 ? 0 : -go - k * ge;
}

inline int64_t border_f_value(int init, long long i, int64_t go,
                              int64_t ge) {
  // stages/core._border_f_value: the true gap-state value straight along
  // a synthesized border column
  if (init == 2) return -i * ge;
  return -go - i * ge;
}

// init_types_for (stages/core.py:95-103): (row_init, col_init) per pin
inline void init_types_for(int t, int* row_init, int* col_init) {
  if (t == 1) { *row_init = 2; *col_init = 1; return; }
  if (t == 2) { *row_init = 1; *col_init = 2; return; }
  *row_init = 1; *col_init = 1;
}

// NW forward pass over seq0[0..h) x seq1[0..w): fills last_h/last_f
// (w+1 each); last_f[0] is synthesized (stage-4 half-pass convention).
void nw_last_row(const unsigned char* s0, long long h,
                 const unsigned char* s1, long long w,
                 int row_init, int col_init,
                 int64_t match, int64_t mismatch, int64_t go, int64_t ge,
                 std::vector<int64_t>& hp, std::vector<int64_t>& fp) {
  hp.assign(w + 1, 0);
  fp.assign(w + 1, NEG);
  for (long long j = 0; j <= w; j++) hp[j] = border_h(row_init, j, go, ge);
  std::vector<int64_t> hc(w + 1), fc(w + 1);
  for (long long i = 1; i <= h; i++) {
    hc[0] = border_h(col_init, i, go, ge);
    fc[0] = NEG;
    int64_t e = NEG;
    const unsigned char c0 = s0[i - 1];
    for (long long j = 1; j <= w; j++) {
      e = max2(hc[j - 1] - go, e) - ge;
      fc[j] = max2(hp[j] - go, fp[j]) - ge;
      int64_t s = (c0 == s1[j - 1]) ? match : mismatch;
      hc[j] = max3(hp[j - 1] + s, e, fc[j]);
    }
    hp.swap(hc);
    fp.swap(fc);
  }
  fp[0] = border_f_value(col_init, h, go, ge);
}

struct SplitCtx {
  const unsigned char* seq0;
  const unsigned char* seq1;
  int64_t match, mismatch, go, ge;
  long long mps;
};

// Find the crosspoint where the optimal c0->c1 path crosses the middle
// row (ops/myers_miller.split_partition, OPTIMIZED window ladder).
// Returns false on backtrace loss.
bool split_partition(const SplitCtx& cx, const Cp& c0, const Cp& c1,
                     Cp* out) {
  const long long h = c1.i - c0.i, w = c1.j - c0.j;
  const long long rm = c0.i + h / 2;
  const long long hb = rm - c0.i, ht = c1.i - rm;
  const int64_t goal =
      c1.score - c0.score + (c1.type != 0 ? cx.go : 0);
  int fr_init, fc_init, rr_init, rc_init;
  init_types_for(c0.type, &fr_init, &fc_init);
  init_types_for(c1.type, &rr_init, &rc_init);

  std::vector<unsigned char> sub0r(ht);
  for (long long k = 0; k < ht; k++) sub0r[k] = cx.seq0[c1.i - 1 - k];

  long long hb2 = hb > ht ? hb : ht;
  long long w0 = 2 * hb2 > 64 ? 2 * hb2 : 64;
  if (w0 > w) w0 = w;
  std::vector<long long> windows;
  while (w0 < w) { windows.push_back(w0); w0 *= 2; }
  windows.push_back(w);

  std::vector<int64_t> fh, ff, rh, rf;
  std::vector<unsigned char> rw;
  for (long long win : windows) {
    const long long fw_len =
        (c0.j + win < c1.j ? c0.j + win : c1.j) - c0.j;
    const long long rw_lo = (c1.j - win > c0.j ? c1.j - win : c0.j);
    const long long rw_len = c1.j - rw_lo;
    rw.resize(rw_len);
    for (long long k = 0; k < rw_len; k++) rw[k] = cx.seq1[c1.j - 1 - k];
    nw_last_row(cx.seq0 + c0.i, hb, cx.seq1 + c0.j, fw_len,
                fr_init, fc_init, cx.match, cx.mismatch, cx.go, cx.ge,
                fh, ff);
    nw_last_row(sub0r.data(), ht, rw.data(), rw_len,
                rr_init, rc_init, cx.match, cx.mismatch, cx.go, cx.ge,
                rh, rf);
    const long long j_lo = (c0.j > c1.j - win ? c0.j : c1.j - win);
    const long long j_hi = (c1.j < c0.j + win ? c1.j : c0.j + win);
    if (j_lo > j_hi) continue;
    // descending-j scan (match_column over the reversed arrays): first
    // hit wins; an overshoot before a hit = lost in this window
    bool lost = false;
    for (long long j = j_hi; j >= j_lo; j--) {
      const int64_t sm = fh[j - c0.j] + rh[c1.j - j];
      const int64_t sg = ff[j - c0.j] + rf[c1.j - j] + cx.go;
      if (sm == goal) {
        *out = Cp{rm, j, c0.score + fh[j - c0.j], 0};
        return true;
      }
      if (sg == goal) {
        *out = Cp{rm, j, c0.score + ff[j - c0.j], 2};
        return true;
      }
      if (sm > goal || sg > goal) { lost = true; break; }
    }
    (void)lost;  // lost within a band: widen and retry
  }
  return false;
}

bool emit_pair(const SplitCtx& cx, const Cp& c0, const Cp& c1,
               std::vector<Cp>* out) {
  const long long h = c1.i - c0.i, w = c1.j - c0.j;
  if ((h > w ? h : w) <= cx.mps || h < 2) {
    out->push_back(c1);
    return true;
  }
  Cp cm;
  if (!split_partition(cx, c0, c1, &cm)) return false;
  if (!emit_pair(cx, c0, cm, out)) return false;
  return emit_pair(cx, cm, c1, out);
}

}  // namespace

extern "C" {

// Stage-4 reduce: split every adjacent crosspoint pair until
// max(height, width) <= mps.  cps_in/cps_out: (i, j, score, type) int64
// quads.  Returns the output crosspoint count, -1 on backtrace loss, or
// -2 when cps_out is too small (caller retries with a larger buffer).
// nthreads > 1 fans the pairs out over a thread pool
// (the reference's 4-pthread reduce_partitions).
long long masa_reduce_partitions(
    const unsigned char* seq0, long long m,
    const unsigned char* seq1, long long n,
    const long long* cps_in, long long n_in,
    int match, int mismatch, int gap_open, int gap_ext,
    long long mps, int nthreads,
    long long* cps_out, long long cap_out) {
  (void)m;
  (void)n;
  if (n_in < 1) return -1;
  SplitCtx cx{seq0, seq1, match, mismatch, gap_open, gap_ext, mps};
  std::vector<Cp> cps(n_in);
  for (long long k = 0; k < n_in; k++) {
    cps[k] = Cp{cps_in[4 * k], cps_in[4 * k + 1], cps_in[4 * k + 2],
                (int)cps_in[4 * k + 3]};
  }
  const long long pairs = n_in - 1;
  std::vector<std::vector<Cp>> results(pairs);
  std::atomic<long long> next(0);
  std::atomic<bool> failed(false);
  auto work = [&]() {
    long long k;
    while ((k = next.fetch_add(1)) < pairs) {
      if (failed.load(std::memory_order_relaxed)) return;
      if (!emit_pair(cx, cps[k], cps[k + 1], &results[k])) {
        failed.store(true);
        return;
      }
    }
  };
  int nt = nthreads > 1 ? nthreads : 1;
  if (nt > pairs) nt = (int)(pairs > 0 ? pairs : 1);
  if (nt <= 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  if (failed.load()) return -1;
  long long count = 0;
  auto put = [&](const Cp& c) {
    if (count >= cap_out) return false;
    cps_out[4 * count] = c.i;
    cps_out[4 * count + 1] = c.j;
    cps_out[4 * count + 2] = c.score;
    cps_out[4 * count + 3] = c.type;
    count++;
    return true;
  };
  if (!put(cps[0])) return -2;
  for (long long k = 0; k < pairs; k++) {
    for (const Cp& c : results[k]) {
      if (!put(c)) return -2;
    }
  }
  return count;
}

}  // extern "C"
