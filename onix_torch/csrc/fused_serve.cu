// Fused serving pass: score + feedback filter + tol screen + bottom-M
// selection, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_call` of
// onix/models/pallas_serve.py:325 (body `_make_kernel`, :176; membership
// `_member_cols`, :159; order `_lt`, :152) and every entry point that
// ends in it, with a leading request-row axis r. Per event i of row r:
//
//   score   dot:    s = sum_k theta[slot_r*D_pad + d, k] * phi[slot_r*V_pad + w, k],
//                   summed in k order from k = 0, one rounded product
//                   and one rounded add per step (nvcc -fmad=false)
//           min2:   s = min(sa, sb), NaN if either is NaN; under
//                   token_words each side first takes the word stage
//           scores: s = sa
//   filter  token_words: pair boost (s * scale) then pair suppress (+inf);
//           otherwise one combined boost where the word key OR the pair
//           key is a boost member, then one combined suppress
//           (onix/feedback/filter.py apply_filter). Word keys are
//           (0, word), pair keys (hi, lo); in dot mode without explicit
//           keys they are the event's (doc, word) ids, as the bank keys
//           them (onix/serving/model_bank.py _row_filter_adjust).
//           Membership is the lower-bound bisection of filter._member
//           over a sorted, SENTINEL-padded power-of-two table, compared
//           natively as uint64.
//   ev      optional: the post-filter, pre-screen score stream
//   screen  s stays if i < row_len_r, mask > 0 (when given) and s < tol,
//           else +inf
//   select  the bottom M of the row under the strict (score, index)
//           order, ascending; +inf slots and non-finite scores report
//           index -1 (pallas_serve.py:418-420).
//
// The order is made total by one uint64 key per event: the score's
// order-preserving bits high (-0.0 taken as +0.0 first: the float
// compare holds them equal, their raw bits would not), the event index
// low. The bottom M are the M smallest keys. Keys are unique, so any
// set of them sorts to one order whatever the order it was gathered in.
//
// What bounds it, on an H100 SXM (3.35 TB/s HBM): bytes. The function
// must move, for R rows of N events,
//
//   dot:  8 R N (doc and word ids) + 4 K (T + P) (the T distinct theta
//         rows and P distinct phi rows the real events touch, each read
//         once: a tenant's tables sit in the 50 MB L2)
//   min2 / scores: 4 R N per score column, + 4 R N per key column
//         (word, pair hi, pair lo; token_words adds a second word)
//   + 4 R N for the mask, + 8 F per filter table entry (hi and lo),
//   + 8 R M for the winners, + 4 R N for the score stream,
//
// and does 2 K float operations per real dot-mode event. At the harness
// wave (R = 64, N = 2,048, K = 20, M = 2,000) that is about 13.7 MB,
// 4.1 us; at the 2^21-event day row about 27 MB, 8 us (chip_smoke.py
// computes it from each run's data). The tensor cores do not apply:
// each event's score is a dot of two gathered K-vectors that must round
// step by step in k order, not a product of matrices, and f32 outside
// the tensor cores already does the 2K operations far below the byte
// bound.
//
// Two forms, picked by shape alone (onix_fused_serve_form): R, N and M
// decide; K does not, as theta and phi are staged kKC topics at a time.
//
//   row form  (pow2(N) <= kRowMaxN): ONE launch, no memset and no
//     device scratch. A cluster of two CTAs takes a row
//     (cudaLaunchKernelEx with a cluster dimension), each CTA half its
//     events: it scores
//     them into 8-byte keys in its shared memory and counts the keys'
//     top kBinBits bits in a shared histogram; the two add each other's
//     histogram through distributed shared memory, and one block scan
//     finds the bin of the k-th key (k = min(M, qualifying)); each CTA
//     compacts its keys of the bins up to it in place and sorts them on
//     chip (bitonic); a key's rank in the row is its index in its half
//     plus the number of the other half's candidates below it (a binary
//     search in the other CTA's sorted keys). The pair writes M
//     outputs, +inf and -1 after the k-th.
//   long-row form (above): four device operations.
//     1. a memset of the row histograms and bin cursors;
//     2. long_score_kernel: one CTA a tile of kLongTile events writes
//        each key once and adds its shared histogram of the keys' top
//        kBinBits bits to the row's histogram;
//     3. long_compact_kernel: each CTA scans the row's histogram, finds
//        the bin of the k-th key, reads its tile's keys (the one read of
//        the row's keys) and scatters every key of a bin up to that one
//        into the row's candidate buffer, grouped by bin in bin order;
//     4. long_finish_kernel: one CTA a window of kWindow output
//        positions. It finds the unit of keys that holds its first and
//        its last position: a bin, or, where a bin holds more than kUnit
//        keys, a sub-range found by refining over that bin's candidates
//        alone (the min and max key fix the bits all of them share; a
//        histogram of the next kBinBits bits below them picks the
//        sub-range; repeat), never over the row. It gathers the keys
//        between the two units (at most kFinishCap), sorts them on chip
//        and writes the outputs at their ranks. Sort work follows the
//        candidates: ceil(M / kWindow) CTAs of at most kFinishCap keys.
//
// How the design deals with what held the first, one-form design back
// (a radix select: 12 launches at the harness wave, about 32 at
// M = 100,000):
//   - launches: the harness wave is one launch; a long row four at any
//     M (before: 2 memsets, 8 radix passes, a compaction and a sort
//     whose global-stride steps grew with pow2(M));
//   - key traffic: a long row's keys are written once and read once
//     (before: read in eight byte passes, each closed by a serial
//     256-bin scan in the row's last CTA behind a done counter);
//   - sort size: the candidates', not pow2(M);
//   - gathers: a warp takes 32 events; its lanes load the events' theta
//     and phi rows together, 16-byte loads where K % 4 == 0 (K = 20 is
//     five float4s a row, all ten in flight at once), into a
//     warp-private stage in shared memory (row stride kKC floats:
//     conflict-free float4 reads at K = 20; kKC + 1 for the scalar
//     form), and each lane then sums its own event's products in k
//     order from the stage;
//   - streaming the columns (ids, mask, score columns; 12 B an event in
//     dot mode): in the long-row form each lane loads four consecutive
//     events' columns with 16-byte loads, so a warp has 512 B of each
//     in flight, and scores them as four groups of 32 from registers;
//     the row form loads one group's columns before its gathers (four
//     at a time spill at its 128-register cap);
//   - warps: the row form runs two 16-warp CTAs a row (the harness
//     wave's 64 rows fill 128 of 132 multiprocessors), the long form
//     8-warp CTAs of 8,192 events, two a multiprocessor.
// Designs measured and dropped (PERF.md section 6): a register-resident
// bitonic sort, phi in shared memory, four event groups hoisted a warp
// step, a warp-aggregated (__match_any_sync) histogram, tighter launch
// bounds, prefetching the next group's columns, two sort runs a warp,
// L1 cache hints on the gathers, quad loads in the row form, one CTA a
// row in the row form.
//
// Limits: the row form holds pow2(N) <= kRowMaxN keys, all that two
// CTAs' shared memory holds (it beats the long-row form at every N up
// to there, PERF.md section 6); a CTA's shared memory is
// 4 pow2(N) B of keys + 16 KB of histogram + 5,376 B of stage a warp
// (167,936 B at 16,384). The long-row form takes any N < 2^31 and
// R <= 65,535, with 16 B an event of device scratch. ptxas (sm_90a,
// -fmad=false; chip_smoke.py prints the report at every build):
// row_kernel 123 registers, no spill; long_score_kernel 128 registers,
// 4 B spilled; long_compact_kernel 80; long_finish_kernel 40; static
// shared memory at most a few hundred bytes a kernel, the rest dynamic
// as above.
//
// The kernels allocate nothing (the caller passes one work buffer of
// onix_fused_serve_work_bytes() bytes: 0 for the row form), launch on
// the caller's stream and do not synchronise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr unsigned long long kNoKey = ~0ull;
constexpr int kBinBits = 12;
constexpr int kBins = 1 << kBinBits;                // 4,096
constexpr int kBinShift = 64 - kBinBits;
constexpr int kKC = 20;                             // topics staged at once
constexpr int kStageFloats = 2 * 32 * (kKC + 1);    // a warp's stage
constexpr int kStageBytes = kStageFloats * 4;       // 5,376
constexpr int kRowMaxN = 16384;                     // largest pow2(N), row form
constexpr int kRowMinN = 128;                       // smallest key array
constexpr int kLongThreads = 256;
constexpr int kLongTile = 8192;                     // events a CTA
constexpr int kUnit = 64;                           // a unit's most keys
constexpr int kWindow = 2048 - 2 * kUnit;           // output positions a CTA
constexpr int kFinishCap = 2048;                    // keys a finish CTA sorts
constexpr int kFinishThreads = 1024;
constexpr int kScanUnroll = 4;                      // keys a thread loads at once

static_assert(kWindow + 2 * (kUnit - 1) <= kFinishCap, "finish window");
static_assert(kFinishCap * 8 >= kBins * 4, "refine histogram aliases keys");

struct Params {
  int struct_bytes;          // sizeof(Params), checked against the caller
  int mode;                  // 0 dot, 1 min2, 2 scores
  int rows, n, max_results;
  const int32_t* row_len;    // [R] real events per row, or null (= n)
  // dot
  const float* theta;        // [C, D_pad, K]
  const float* phi;          // [C, V_pad, K]
  const int32_t* slots;      // [R], or null (slot 0)
  const int32_t* doc;        // [R, n]
  const int32_t* word;       // [R, n]
  long long d_pad, v_pad;
  int k;
  // min2 / scores
  const float* sa;           // [R, n]
  const float* sb;           // [R, n]
  const float* mask;         // [R, n], or null
  // filter
  int filtered, token_words;
  const uint32_t* wkey_a;    // [R, n] word key (lo half), or null (dot: word id)
  const uint32_t* wkey_b;    // [R, n] second token's word key (token_words)
  const uint32_t* pair_hi;   // [R, n], or null (dot: doc id)
  const uint32_t* pair_lo;   // [R, n], or null (dot: word id)
  // families: 0 word_suppress, 1 word_boost, 2 pair_suppress, 3 pair_boost
  const uint32_t* tab_hi[4];
  const uint32_t* tab_lo[4];
  int tab_len[4];            // power of two
  int tab_stride[4];         // per row: tab_len, or 0 when rows share one
  const float* scale;        // boost scale, [R] or [1]
  int scale_stride;          // 1 or 0
  float tol;
  float* ev;                 // [R, n], or null
  float* out_scores;         // [R, M]
  int32_t* out_idx;          // [R, M]
};

// The long-row form's device scratch.
struct Work {
  unsigned long long* keys;    // [R, n] each event's key
  unsigned long long* cand;    // [R, n] candidates, grouped by bin
  unsigned int* hist;          // [R, kBins] keys a bin
  unsigned int* cursor;        // [R, kBins] fill of each bin's group
};

__host__ __device__ inline long long pow2_at_least(long long m) {
  long long p = 1;
  while (p < m) p <<= 1;
  return p;
}

__host__ inline size_t align_up(size_t x) {
  return (x + 255) & ~(size_t)255;
}

struct Layout {
  size_t keys, cand, hist, cursor, total;
};

__host__ inline Layout layout(long long rows, long long n) {
  Layout l;
  size_t at = 0;
  l.keys = at;   at = align_up(at + (size_t)rows * n * 8);
  l.cand = at;   at = align_up(at + (size_t)rows * n * 8);
  l.hist = at;   at = align_up(at + (size_t)rows * kBins * 4);
  l.cursor = at; at = align_up(at + (size_t)rows * kBins * 4);
  l.total = at;
  return l;
}

__host__ inline int row_np(int n) {
  return (int)pow2_at_least(n < kRowMinN ? kRowMinN : n);
}

// Shared memory of a row-form CTA: half the row's keys, the histogram,
// 16 warps' stages.
__host__ inline size_t row_smem(int np) {
  return (size_t)(np / 2) * 8 + (size_t)kBins * 4 + (size_t)16 * kStageBytes;
}

constexpr size_t kLongScoreSmem = (size_t)kBins * 4
                                  + (size_t)(kLongThreads / 32) * kStageBytes;
constexpr size_t kLongCompactSmem = (size_t)kBins * 4;
constexpr size_t kFinishSmem = (size_t)kFinishCap * 8 + (size_t)kBins * 4;

__device__ inline unsigned long long make_key(float s, unsigned int i) {
  unsigned int bits = __float_as_uint(s);
  if (bits == 0x80000000u) bits = 0u;           // -0.0 -> +0.0
  const unsigned int ob = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((unsigned long long)ob << 32) | i;
}

__device__ inline float key_score(unsigned long long key) {
  const unsigned int ob = (unsigned int)(key >> 32);
  const unsigned int bits = (ob & 0x80000000u) ? (ob & 0x7FFFFFFFu) : ~ob;
  return __uint_as_float(bits);
}

__device__ inline unsigned long long umin(unsigned long long a,
                                          unsigned long long b) {
  return a < b ? a : b;
}

__device__ inline unsigned long long umax(unsigned long long a,
                                          unsigned long long b) {
  return a < b ? b : a;
}

// filter._member: lower bound of `key` in a sorted power-of-two table,
// then equality.
__device__ inline bool member(unsigned int khi, unsigned int klo,
                              const uint32_t* hi, const uint32_t* lo,
                              int len) {
  const unsigned long long key = ((unsigned long long)khi << 32) | klo;
  int pos = 0;
  for (int step = len; step > 1;) {
    step >>= 1;
    const int probe = pos + step - 1;
    const unsigned long long t =
        ((unsigned long long)hi[probe] << 32) | lo[probe];
    if (t < key) pos += step;
  }
  return (((unsigned long long)hi[pos] << 32) | lo[pos]) == key;
}

__device__ inline bool fam_member(const Params& p, int fam, int r,
                                  unsigned int khi, unsigned int klo) {
  const long long off = (long long)r * p.tab_stride[fam];
  return member(khi, klo, p.tab_hi[fam] + off, p.tab_lo[fam] + off,
                p.tab_len[fam]);
}

__device__ inline float word_stage(const Params& p, int r, float s,
                                   unsigned int wlo, float scale) {
  if (fam_member(p, 1, r, 0u, wlo)) s = __fmul_rn(s, scale);
  if (fam_member(p, 0, r, 0u, wlo)) s = __int_as_float(0x7f800000);
  return s;
}

__device__ inline int row_len(const Params& p, int r) {
  return p.row_len ? p.row_len[r] : p.n;
}

// The dot of each lane's event (doc d, word w) over K, in k order from
// k = 0. The warp loads its 32 events' theta and phi rows together into
// its stage `st`, kKC topics at a time (every load of a chunk issued
// before the first is stored), then each lane sums its own event from
// the stage. All 32 lanes must call it.
__device__ float dot_warp(const Params& p, const float* tb, const float* pb,
                          unsigned int d, unsigned int w, bool vec,
                          float* st) {
  const int lane = threadIdx.x & 31;
  const int K = p.k;
  const int stride = vec ? kKC : kKC + 1;
  float* sth = st;
  float* sph = st + 32 * (kKC + 1);
  float s = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kc = K - k0 < kKC ? K - k0 : kKC;
    if (vec) {
      constexpr int kQ = kKC / 4;         // float4s of a full chunk
      const int q4 = kc >> 2;             // float4s of this chunk's rows
      float4 ta[kQ], pa[kQ];
      int at[kQ];
#pragma unroll
      for (int it = 0; it < kQ; ++it) {
        if (it < q4) {                    // uniform across the warp
          const int j = lane + 32 * it;
          const int e = j / q4, q = j - e * q4;
          const unsigned int de = __shfl_sync(0xffffffffu, d, e);
          const unsigned int we = __shfl_sync(0xffffffffu, w, e);
          ta[it] = __ldg(reinterpret_cast<const float4*>(
                             tb + (long long)de * K + k0) + q);
          pa[it] = __ldg(reinterpret_cast<const float4*>(
                             pb + (long long)we * K + k0) + q);
          at[it] = e * stride + 4 * q;
        }
      }
#pragma unroll
      for (int it = 0; it < kQ; ++it) {
        if (it < q4) {
          *reinterpret_cast<float4*>(sth + at[it]) = ta[it];
          *reinterpret_cast<float4*>(sph + at[it]) = pa[it];
        }
      }
    } else {
      for (int j = lane; j < 32 * kc; j += 32) {   // kc rounds a lane
        const int e = j / kc, q = j - e * kc;
        const unsigned int de = __shfl_sync(0xffffffffu, d, e);
        const unsigned int we = __shfl_sync(0xffffffffu, w, e);
        sth[e * stride + q] = __ldg(tb + (long long)de * K + k0 + q);
        sph[e * stride + q] = __ldg(pb + (long long)we * K + k0 + q);
      }
    }
    __syncwarp();
    const float* a = sth + lane * stride;
    const float* b = sph + lane * stride;
    if (vec) {
      for (int q = 0; q < (kc >> 2); ++q) {
        const float4 x = reinterpret_cast<const float4*>(a)[q];
        const float4 y = reinterpret_cast<const float4*>(b)[q];
        const float t0 = __fmul_rn(x.x, y.x);
        s = (k0 == 0 && q == 0) ? t0 : __fadd_rn(s, t0);
        s = __fadd_rn(s, __fmul_rn(x.y, y.y));
        s = __fadd_rn(s, __fmul_rn(x.z, y.z));
        s = __fadd_rn(s, __fmul_rn(x.w, y.w));
      }
    } else {
      for (int kk = 0; kk < kc; ++kk) {
        const float t = __fmul_rn(a[kk], b[kk]);
        s = (k0 == 0 && kk == 0) ? t : __fadd_rn(s, t);
      }
    }
    __syncwarp();
  }
  return s;
}

// One event's columns: its ids (dot) or score columns (min2 / scores),
// and whether the mask and the row length let it through.
struct Cols {
  unsigned int d, w;
  float a, b;
  bool ok;
};

// Event i's columns (i < limit), or zeros past it: every load of a
// group issued before its gathers (the row form's step).
__device__ inline Cols load_cols(const Params& p, int r, int i, int limit,
                                 int len) {
  Cols c = {0u, 0u, 0.0f, 0.0f, false};
  if (i < limit) {
    const long long off = (long long)r * p.n + i;
    if (p.mode == 0) {
      c.d = (unsigned int)p.doc[off];
      c.w = (unsigned int)p.word[off];
    } else {
      c.a = p.sa[off];
      if (p.mode == 1) c.b = p.sb[off];
    }
    c.ok = i < len && (!p.mask || p.mask[off] > 0.0f);
  }
  return c;
}

// A lane's quad: events i .. i + 3 of a row (i % 4 == 0), their ids
// (dot) or score columns, and in bit g whether the mask and the row
// length let event i + g through.
struct Quad {
  unsigned int d[4], w[4];
  float a[4], b[4];
  unsigned int ok;
};

template <typename T>
__device__ inline T sel4(const T (&v)[4], int g) {
  return g == 0 ? v[0] : g == 1 ? v[1] : g == 2 ? v[2] : v[3];
}

// The quad of events from i (zeros at and past `limit`): 16-byte loads
// of each column when `vcol` (n % 4 == 0, columns 16-byte aligned) and
// the four are in range, so a warp has 512 B of each column in flight
// (the long-row form's step: four groups of 32 from registers).
__device__ inline Quad load_quad(const Params& p, int r, int i, int limit,
                                 int len, bool vcol) {
  Quad q;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    q.d[g] = q.w[g] = 0u;
    q.a[g] = q.b[g] = 0.0f;
  }
  q.ok = 0u;
  const long long off = (long long)r * p.n + i;
  if (vcol && i + 3 < limit) {
    if (p.mode == 0) {
      const uint4 d = __ldg(reinterpret_cast<const uint4*>(p.doc + off));
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p.word + off));
      q.d[0] = d.x; q.d[1] = d.y; q.d[2] = d.z; q.d[3] = d.w;
      q.w[0] = w.x; q.w[1] = w.y; q.w[2] = w.z; q.w[3] = w.w;
    } else {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p.sa + off));
      q.a[0] = a.x; q.a[1] = a.y; q.a[2] = a.z; q.a[3] = a.w;
      if (p.mode == 1) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(p.sb + off));
        q.b[0] = b.x; q.b[1] = b.y; q.b[2] = b.z; q.b[3] = b.w;
      }
    }
    const float4 m = p.mask
        ? __ldg(reinterpret_cast<const float4*>(p.mask + off))
        : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    q.ok = (m.x > 0.0f) | (m.y > 0.0f) << 1 | (m.z > 0.0f) << 2
           | (m.w > 0.0f) << 3;
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (i + g < limit) {
        if (p.mode == 0) {
          q.d[g] = (unsigned int)p.doc[off + g];
          q.w[g] = (unsigned int)p.word[off + g];
        } else {
          q.a[g] = p.sa[off + g];
          if (p.mode == 1) q.b[g] = p.sb[off + g];
        }
        q.ok |= (unsigned int)(!p.mask || p.mask[off + g] > 0.0f) << g;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g)
    if (i + g >= len) q.ok &= ~(1u << g);
  return q;
}

// The screened score of event i of row r (+inf where it is rejected;
// `in`: i < limit), from its columns. Writes the score stream when
// asked. All 32 lanes must call it, each with its own event.
__device__ float event_score(const Params& p, int r, int i, bool in,
                             bool vec, float* st, unsigned int d,
                             unsigned int w, float a, float b, bool ok) {
  const float inf = __int_as_float(0x7f800000);
  const long long off = (long long)r * p.n + i;
  const float scale = p.filtered ? p.scale[r * p.scale_stride] : 1.0f;
  float s = inf;
  if (p.mode == 0) {
    const long long slot = p.slots ? p.slots[r] : 0;
    s = dot_warp(p, p.theta + slot * p.d_pad * p.k,
                 p.phi + slot * p.v_pad * p.k, d, w, vec, st);
  } else if (in && p.mode == 1) {
    if (p.filtered && p.token_words) {
      a = word_stage(p, r, a, p.wkey_a[off], scale);
      b = word_stage(p, r, b, p.wkey_b[off], scale);
    }
    s = (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000)
                               : ((b < a) ? b : a);
  } else if (in) {
    s = a;
  }
  if (!in) return inf;
  if (p.filtered) {
    const unsigned int ph = p.pair_hi ? p.pair_hi[off] : d;
    const unsigned int pl = p.pair_lo ? p.pair_lo[off] : w;
    if (p.token_words) {
      if (fam_member(p, 3, r, ph, pl)) s = __fmul_rn(s, scale);
      if (fam_member(p, 2, r, ph, pl)) s = inf;
    } else {
      const unsigned int wl = p.wkey_a ? p.wkey_a[off] : w;
      if (fam_member(p, 1, r, 0u, wl) || fam_member(p, 3, r, ph, pl))
        s = __fmul_rn(s, scale);
      if (fam_member(p, 0, r, 0u, wl) || fam_member(p, 2, r, ph, pl))
        s = inf;
    }
  }
  if (p.ev) p.ev[off] = s;
  return (ok && s < p.tol) ? s : inf;
}

// Add one digit to a shared histogram; a digit of kBins or more adds
// nothing.
__device__ inline void hist_add(unsigned int* h, int digit) {
  if (digit < kBins) atomicAdd(&h[digit], 1u);
}

// In-place inclusive scan of the kBins counts h; blockDim.x divides
// kBins and is at most 1,024. `tot` holds 32 words of scratch.
__device__ void block_incl_scan(unsigned int* h, unsigned int* tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5, per = kBins / blockDim.x;
  unsigned int sum = 0;
  for (int c = 0; c < per; ++c) sum += h[t * per + c];
  unsigned int x = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned int y = lane < nw ? tot[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned int z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    if (lane < nw) tot[lane] = y;
  }
  __syncthreads();
  unsigned int run = x - sum + (warp ? tot[warp - 1] : 0u);
  for (int c = 0; c < per; ++c) {
    run += h[t * per + c];
    h[t * per + c] = run;
  }
  __syncthreads();
}

// The bin holding rank `pos` (0-based) of an inclusive-scanned
// histogram `incl`, written to *out by the one thread that finds it.
// The caller synchronises before reading it.
__device__ inline void find_bin(const unsigned int* incl, unsigned int pos,
                                int* out) {
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    const unsigned int lo = b ? incl[b - 1] : 0u;
    if (lo <= pos && pos < incl[b]) *out = b;
  }
}

__device__ inline void write_out(const Params& p, int r, long long g,
                                 unsigned long long key) {
  if (g >= p.max_results) return;
  const long long o = (long long)r * p.max_results + g;
  const float s = key == kNoKey ? __int_as_float(0x7f800000) : key_score(key);
  p.out_scores[o] = s;
  p.out_idx[o] = isfinite(s) ? (int32_t)(key & 0xffffffffull) : -1;
}

// Output slots [from, to) of row r: +inf, -1.
__device__ inline void write_pads(const Params& p, int r, long long from,
                                  long long to) {
  for (long long g = from + threadIdx.x; g < to; g += blockDim.x)
    write_out(p, r, g, kNoKey);
}

// One bitonic stage over a warp's two keys a lane (elements e0, e0 + 1
// of an aligned run of 64): strides jtop .. 1 of size `size`.
__device__ inline void warp_merge(unsigned long long& x0,
                                  unsigned long long& x1, int e0, int size,
                                  int jtop) {
  const bool up = (e0 & size) == 0;
  for (int j = jtop; j >= 2; j >>= 1) {
    const unsigned long long y0 = __shfl_xor_sync(0xffffffffu, x0, j >> 1);
    const unsigned long long y1 = __shfl_xor_sync(0xffffffffu, x1, j >> 1);
    const bool keep_min = ((e0 & j) == 0) == up;
    x0 = keep_min ? umin(x0, y0) : umax(x0, y0);
    x1 = keep_min ? umin(x1, y1) : umax(x1, y1);
  }
  if ((x0 > x1) == up) {
    const unsigned long long t = x0;
    x0 = x1;
    x1 = t;
  }
}

// Sort a[0, n) ascending in shared memory; n is a power of two >= 64
// and every thread of the block calls it. Strides below 64 run in
// registers and warp shuffles (each warp takes aligned runs of 64
// keys, two a lane), longer ones in shared memory, one barrier each.
__device__ void block_sort(unsigned long long* a, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int b0 = warp * 64; b0 < n; b0 += nw * 64) {
    const int e0 = b0 + 2 * lane;
    unsigned long long x0 = a[e0], x1 = a[e0 + 1];
    for (int size = 2; size <= 64; size <<= 1)
      warp_merge(x0, x1, e0, size, size >> 1);
    a[e0] = x0;
    a[e0 + 1] = x1;
  }
  __syncthreads();
  for (int size = 128; size <= n; size <<= 1) {
    for (int j = size >> 1; j >= 64; j >>= 1) {
      for (int q = threadIdx.x; q < (n >> 1); q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int l = i + j;
        const bool up = (i & size) == 0;
        const unsigned long long x = a[i], y = a[l];
        if ((x > y) == up) {
          a[i] = y;
          a[l] = x;
        }
      }
      __syncthreads();
    }
    for (int b0 = warp * 64; b0 < n; b0 += nw * 64) {
      const int e0 = b0 + 2 * lane;
      unsigned long long x0 = a[e0], x1 = a[e0 + 1];
      warp_merge(x0, x1, e0, size, 32);
      a[e0] = x0;
      a[e0 + 1] = x1;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Row form: a cluster of two CTAs a row, keys on chip, one launch.
// ---------------------------------------------------------------------------

// CTA `half` of a row's cluster scores events
// [half * np / 2, (half + 1) * np / 2) into its own shared memory; the
// two add each other's histogram through distributed shared memory, cut
// at the same bin, compact and sort their own candidates, and each key
// is written at its rank in the row: its index in its half plus the
// number of the other half's candidates below it (a binary search in the
// other CTA's sorted keys). Keys are unique, so the ranks are a
// permutation.
__global__ void __launch_bounds__(512)
row_kernel(Params p, int np, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = np >> 1;                        // events a CTA
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  unsigned int* hist = reinterpret_cast<unsigned int*>(keys + h);
  float* stage = reinterpret_cast<float*>(hist + kBins);
  __shared__ unsigned int s_tot[32];
  __shared__ int s_cut;
  cg::cluster_group cluster = cg::this_cluster();
  const int half = (int)cluster.block_rank();
  const float inf = __int_as_float(0x7f800000);
  const int r = blockIdx.x >> 1;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int first = half * h;
  for (int b = t; b < kBins; b += blockDim.x) hist[b] = 0u;
  __syncthreads();
  const int limit = p.ev ? p.n : row_len(p, r);
  float* st = stage + warp * kStageFloats;
  const int len = row_len(p, r);
  for (int i0 = first + warp * 32; i0 < first + h; i0 += nw * 32) {
    unsigned long long key = kNoKey;
    if (i0 < limit) {
      const int i = i0 + lane;
      const Cols c = load_cols(p, r, i, limit, len);
      const float s = event_score(p, r, i, i < limit, vec, st, c.d, c.w,
                                  c.a, c.b, c.ok);
      if (s != inf) key = make_key(s, (unsigned int)i);
    }
    keys[i0 - first + lane] = key;
    hist_add(hist, key == kNoKey ? kBins : (int)(key >> kBinShift));
  }
  // The row's histogram: both halves' counts, in both CTAs.
  __syncthreads();
  cluster.sync();
  const unsigned int* other_hist = cluster.map_shared_rank(hist, half ^ 1);
  constexpr int kMaxPer = kBins / 256;
  const int per = kBins / blockDim.x;
  unsigned int o[kMaxPer];
#pragma unroll
  for (int x = 0; x < kMaxPer; ++x)
    o[x] = x < per ? other_hist[t * per + x] : 0u;
  cluster.sync();                     // both have read before either adds
#pragma unroll
  for (int x = 0; x < kMaxPer; ++x)
    if (x < per) hist[t * per + x] += o[x];
  __syncthreads();
  block_incl_scan(hist, s_tot);
  const unsigned int q = hist[kBins - 1];
  const unsigned int m = (unsigned int)p.max_results;
  const unsigned int k = q < m ? q : m;
  if (k == 0) {                       // the same in both: no more remote reads
    write_pads(p, r, half ? p.max_results / 2 : 0,
               half ? p.max_results : p.max_results / 2);
    return;
  }
  find_bin(hist, k - 1, &s_cut);
  __syncthreads();
  const int cut = s_cut;
  const unsigned int c_row = hist[cut];   // the row's keys up to the cut
  unsigned int c_own = 0;
  for (int c0 = 0; c0 < h; c0 += blockDim.x) {
    const int i = c0 + t;
    const unsigned long long key = i < h ? keys[i] : kNoKey;
    const bool take = key != kNoKey && (int)(key >> kBinShift) <= cut;
    const unsigned int ballot = __ballot_sync(0xffffffffu, take);
    if (lane == 0) s_tot[warp] = __popc(ballot);
    __syncthreads();
    unsigned int before = 0, total = 0;
    for (int x = 0; x < nw; ++x) {
      const unsigned int v = s_tot[x];
      before += x < warp ? v : 0u;
      total += v;
    }
    if (take)
      keys[c_own + before + __popc(ballot & ((1u << lane) - 1u))] = key;
    c_own += total;
    __syncthreads();
  }
  const int n_sort =
      (int)pow2_at_least(c_own < kRowMinN / 2 ? kRowMinN / 2 : c_own);
  for (int i = (int)c_own + t; i < n_sort; i += blockDim.x) keys[i] = kNoKey;
  __syncthreads();
  block_sort(keys, n_sort);
  cluster.sync();                     // both halves sorted
  const unsigned long long* other = cluster.map_shared_rank(keys, half ^ 1);
  const unsigned int c_other = c_row - c_own;
  for (unsigned int i = t; i < c_own && i < m; i += blockDim.x) {
    const unsigned long long x = keys[i];
    unsigned int lo = 0, n = c_other;  // other's keys below x
    while (n > 0) {
      const unsigned int step = n >> 1;
      if (other[lo + step] < x) {
        lo += step + 1;
        n -= step + 1;
      } else {
        n = step;
      }
    }
    write_out(p, r, (long long)i + lo, x);
  }
  const long long lim = c_row < m ? c_row : m;
  const long long mid = lim + (p.max_results - lim) / 2;
  write_pads(p, r, half ? mid : lim, half ? p.max_results : mid);
  cluster.sync();                     // the other may still read our keys
}

// ---------------------------------------------------------------------------
// Long-row form.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kLongThreads)
long_score_kernel(Params p, Work wk, int vec, int vcol) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned int* hist = reinterpret_cast<unsigned int*>(smem);
  float* stage = reinterpret_cast<float*>(hist + kBins);
  const float inf = __int_as_float(0x7f800000);
  const int r = blockIdx.y;
  const int base = blockIdx.x * kLongTile;
  const int limit = p.ev ? p.n : row_len(p, r);
  if (base >= limit) return;           // uniform per block
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int b = t; b < kBins; b += blockDim.x) hist[b] = 0u;
  __syncthreads();
  float* st = stage + warp * kStageFloats;
  const int end = base + kLongTile < limit ? base + kLongTile : limit;
  const int len = row_len(p, r);
  for (int i0 = base + warp * 128; i0 < end; i0 += kLongThreads * 4) {
    const int i = i0 + 4 * lane;
    const Quad q = load_quad(p, r, i, limit, len, vcol);
    unsigned long long k4[4];
#pragma unroll 1
    for (int g = 0; g < 4; ++g) {
      const float s = event_score(p, r, i + g, i + g < limit, vec, st,
                                  sel4(q.d, g), sel4(q.w, g), sel4(q.a, g),
                                  sel4(q.b, g), (q.ok >> g) & 1u);
      const unsigned long long key =
          s != inf ? make_key(s, (unsigned int)(i + g)) : kNoKey;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j == g) k4[j] = key;
      hist_add(hist, key == kNoKey ? kBins : (int)(key >> kBinShift));
    }
    unsigned long long* dst = wk.keys + (long long)r * p.n + i;
    if (vcol && i + 3 < limit) {
      reinterpret_cast<ulonglong2*>(dst)[0] = make_ulonglong2(k4[0], k4[1]);
      reinterpret_cast<ulonglong2*>(dst)[1] = make_ulonglong2(k4[2], k4[3]);
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (i + g < limit) dst[g] = k4[g];
    }
  }
  __syncthreads();
  for (int b = t; b < kBins; b += blockDim.x) {
    const unsigned int v = hist[b];
    if (v) atomicAdd(&wk.hist[(long long)r * kBins + b], v);
  }
}

// The row's histogram, inclusive-scanned into `incl`, and the bin of
// its k-th key: returns k (0 when no event qualifies) and sets *cut.
__device__ unsigned int row_cut(const Params& p, const Work& wk, int r,
                                unsigned int* incl, unsigned int* tot,
                                int* s_cut) {
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    incl[b] = __ldcg(&wk.hist[(long long)r * kBins + b]);
  __syncthreads();
  block_incl_scan(incl, tot);
  const unsigned int q = incl[kBins - 1];
  const unsigned int m = (unsigned int)p.max_results;
  const unsigned int k = q < m ? q : m;
  if (k) {
    find_bin(incl, k - 1, s_cut);
    __syncthreads();
  }
  return k;
}

__global__ void __launch_bounds__(kLongThreads)
long_compact_kernel(Params p, Work wk) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned int* incl = reinterpret_cast<unsigned int*>(smem);
  __shared__ unsigned int s_tot[32];
  __shared__ int s_cut;
  const int r = blockIdx.y;
  const int base = blockIdx.x * kLongTile;
  const int len = row_len(p, r);
  if (base >= len) return;             // uniform per block
  const unsigned long long* keys = wk.keys + (long long)r * p.n;
  constexpr int kPer = kLongTile / kLongThreads;
  unsigned long long mine[kPer];       // in flight while the cut is found
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = base + j * kLongThreads + threadIdx.x;
    mine[j] = i < len ? keys[i] : kNoKey;
  }
  if (row_cut(p, wk, r, incl, s_tot, &s_cut) == 0) return;
  const int cut = s_cut;
  const int lane = threadIdx.x & 31;
  unsigned long long* cand = wk.cand + (long long)r * p.n;
  unsigned int* cursor = wk.cursor + (long long)r * kBins;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned long long key = mine[j];
    const int bin = key == kNoKey ? kBins : (int)(key >> kBinShift);
    const bool take = bin <= cut;
    if (!__any_sync(0xffffffffu, take)) continue;
    const unsigned int same = __match_any_sync(0xffffffffu,
                                               take ? bin : kBins);
    const int leader = __ffs(same) - 1;
    unsigned int at = 0;
    if (take && lane == leader) at = atomicAdd(&cursor[bin], __popc(same));
    at = __shfl_sync(0xffffffffu, at, leader);
    if (take) {
      const unsigned int pos = (bin ? incl[bin - 1] : 0u) + at
                               + __popc(same & ((1u << lane) - 1u));
      cand[pos] = key;
    }
  }
}

// A unit: the keys in [lo, hi], which hold ranks [start, start + count)
// of the row's candidates.
struct Unit {
  unsigned long long lo, hi;
  unsigned int start, count;
};

// The unit of at most kUnit keys that holds rank `pos` (< the number of
// candidates). Starts from the bin that holds it; while that holds more
// than kUnit keys, refines over that bin's candidates alone: the min
// and max key of the unit fix the bits all its keys share, and a
// histogram of the next kBinBits bits below them picks the sub-range
// that holds `pos`. Every thread of the block calls it and gets the
// same unit. `h2` is kBins words of scratch.
__device__ Unit locate(const unsigned int* incl, const unsigned long long* cand,
                       unsigned int pos, unsigned int* h2,
                       unsigned long long* s_red, unsigned int* tot,
                       int* s_bin) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();                      // *s_bin and h2 free
  find_bin(incl, pos, s_bin);
  __syncthreads();
  const int b = *s_bin;
  const unsigned int seg0 = b ? incl[b - 1] : 0u, seg1 = incl[b];
  Unit u;
  u.lo = (unsigned long long)b << kBinShift;
  u.hi = u.lo | ((1ull << kBinShift) - 1ull);
  u.start = seg0;
  u.count = seg1 - seg0;
  while (u.count > (unsigned int)kUnit) {
    unsigned long long mn = kNoKey, mx = 0ull;
    for (unsigned int j = seg0; j < seg1; j += blockDim.x * kScanUnroll) {
      unsigned long long v[kScanUnroll];
#pragma unroll
      for (int x = 0; x < kScanUnroll; ++x) {
        const unsigned int i = j + x * blockDim.x + t;
        v[x] = i < seg1 ? cand[i] : kNoKey;
      }
#pragma unroll
      for (int x = 0; x < kScanUnroll; ++x) {
        if (j + x * blockDim.x + t < seg1 && v[x] >= u.lo && v[x] <= u.hi) {
          mn = umin(mn, v[x]);
          mx = umax(mx, v[x]);
        }
      }
    }
    for (int o = 16; o; o >>= 1) {
      mn = umin(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = umax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
      s_red[warp] = mn;
      s_red[32 + warp] = mx;
    }
    for (int x = t; x < kBins; x += blockDim.x) h2[x] = 0u;
    __syncthreads();
    mn = kNoKey;
    mx = 0ull;
    for (int x = 0; x < nw; ++x) {
      mn = umin(mn, s_red[x]);
      mx = umax(mx, s_red[32 + x]);
    }
    // count > kUnit >= 1 keys, all distinct: mn < mx.
    const int top_bit = 63 - __clzll((long long)(mn ^ mx));
    const int shift = top_bit >= kBinBits - 1 ? top_bit - (kBinBits - 1) : 0;
    const int above = shift + kBinBits;  // bits >= above are shared
    const unsigned long long keep = above >= 64 ? 0ull : (~0ull << above);
    for (unsigned int j = seg0; j < seg1; j += blockDim.x * kScanUnroll) {
      unsigned long long v[kScanUnroll];  // every lane runs every round
#pragma unroll
      for (int x = 0; x < kScanUnroll; ++x) {
        const unsigned int i = j + x * blockDim.x + t;
        v[x] = i < seg1 ? cand[i] : kNoKey;
      }
#pragma unroll
      for (int x = 0; x < kScanUnroll; ++x) {
        const bool in = j + x * blockDim.x + t < seg1 && v[x] >= u.lo
                        && v[x] <= u.hi;
        hist_add(h2, in ? (int)((v[x] >> shift) & (kBins - 1)) : kBins);
      }
    }
    __syncthreads();
    block_incl_scan(h2, tot);
    find_bin(h2, pos - u.start, s_bin);
    __syncthreads();
    const int d = *s_bin;
    const unsigned int e0 = d ? h2[d - 1] : 0u;
    u.lo = (mn & keep) | ((unsigned long long)d << shift);
    u.hi = u.lo | ((1ull << shift) - 1ull);
    u.start += e0;
    u.count = h2[d] - e0;
    __syncthreads();                    // h2 and s_bin reused
  }
  return u;
}

__global__ void __launch_bounds__(kFinishThreads)
long_finish_kernel(Params p, Work wk) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem);
  unsigned int* incl = reinterpret_cast<unsigned int*>(buf + kFinishCap);
  unsigned int* h2 = reinterpret_cast<unsigned int*>(buf);   // aliases buf
  __shared__ unsigned long long s_red[64];
  __shared__ unsigned int s_tot[32];
  __shared__ int s_cut, s_bin;
  __shared__ unsigned int s_fill;
  const int r = blockIdx.y;
  const long long w0 = (long long)blockIdx.x * kWindow;
  const long long w1 = w0 + kWindow < p.max_results ? w0 + kWindow
                                                    : p.max_results;
  const unsigned int k = row_cut(p, wk, r, incl, s_tot, &s_cut);
  if (k == 0) {
    write_pads(p, r, w0, w1);
    return;
  }
  const unsigned int c = incl[s_cut];  // candidates: bins up to the cut
  const long long lim = c < (unsigned int)p.max_results ? c : p.max_results;
  write_pads(p, r, w0 > lim ? w0 : lim, w1);
  if (w0 >= lim) return;               // uniform per block
  const long long p1 = w1 < lim ? w1 : lim;
  const unsigned long long* cand = wk.cand + (long long)r * p.n;
  const Unit u0 = locate(incl, cand, (unsigned int)w0, h2, s_red, s_tot,
                         &s_bin);
  const Unit u1 = locate(incl, cand, (unsigned int)(p1 - 1), h2, s_red,
                         s_tot, &s_bin);
  // Gather the keys of ranks [u0.start, u1.start + u1.count): those in
  // [u0.lo, u1.hi], from the bins that hold the two units and those
  // between.
  const unsigned int count = u1.start + u1.count - u0.start;
  const int b0 = (int)(u0.lo >> kBinShift), b1 = (int)(u1.hi >> kBinShift);
  const unsigned int g0 = b0 ? incl[b0 - 1] : 0u, g1 = incl[b1];
  if (threadIdx.x == 0) s_fill = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (unsigned int j = g0; j < g1; j += blockDim.x * kScanUnroll) {
    unsigned long long v[kScanUnroll];
#pragma unroll
    for (int x = 0; x < kScanUnroll; ++x) {
      const unsigned int i = j + x * blockDim.x + threadIdx.x;
      v[x] = i < g1 ? cand[i] : kNoKey;
    }
#pragma unroll
    for (int x = 0; x < kScanUnroll; ++x) {
      const bool take = j + x * blockDim.x + threadIdx.x < g1
                        && v[x] >= u0.lo && v[x] <= u1.hi;
      const unsigned int ballot = __ballot_sync(0xffffffffu, take);
      unsigned int at = 0;
      if (lane == 0 && ballot) at = atomicAdd(&s_fill, __popc(ballot));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (take) buf[at + __popc(ballot & ((1u << lane) - 1u))] = v[x];
    }
  }
  const int n_sort = (int)pow2_at_least(count < kRowMinN ? kRowMinN : count);
  __syncthreads();
  for (int i = (int)count + threadIdx.x; i < n_sort; i += blockDim.x)
    buf[i] = kNoKey;
  __syncthreads();
  block_sort(buf, n_sort);
  for (unsigned int i = threadIdx.x; i < count; i += blockDim.x)
    write_out(p, r, (long long)u0.start + i, buf[i]);
}

Work work_at(void* buf, const Layout& l) {
  char* b = (char*)buf;
  Work w;
  w.keys = (unsigned long long*)(b + l.keys);
  w.cand = (unsigned long long*)(b + l.cand);
  w.hist = (unsigned int*)(b + l.hist);
  w.cursor = (unsigned int*)(b + l.cursor);
  return w;
}

// Opt every kernel into the shared memory its form may ask for.
cudaError_t set_smem_limits() {
  cudaError_t e = cudaFuncSetAttribute(
      row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)row_smem(kRowMaxN));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(long_score_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kLongScoreSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(long_compact_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kLongCompactSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(long_finish_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kFinishSmem);
  return e;
}

// set_smem_limits once a device (a second, racing call sets the same
// values again).
cudaError_t smem_limits_set() {
  constexpr int kMaxDevices = 64;
  static volatile bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = set_smem_limits();
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

}  // namespace

// The form a call of these sizes runs: 0 the row form, 1 the long-row
// form, -1 sizes the kernel refuses. K does not change it: theta and
// phi are staged kKC topics at a time whatever K is.
extern "C" int onix_fused_serve_form(int rows, int n, int max_results,
                                     int k) {
  if (rows <= 0 || rows > 65535 || n <= 0 || max_results <= 0 || k < 0)
    return -1;
  return row_np(n) <= kRowMaxN ? 0 : 1;
}

// Bytes of the work buffer a call with these sizes needs: none for the
// row form.
extern "C" long long onix_fused_serve_work_bytes(int rows, int n,
                                                 int max_results) {
  if (onix_fused_serve_form(rows, n, max_results, 0) != 1) return 0;
  return (long long)layout(rows, n).total;
}

extern "C" int onix_fused_serve_params_bytes() { return (int)sizeof(Params); }

// Launch the whole pass on `stream`; `params` points to a Params.
// Returns cudaGetLastError() after the last launch (0 = launched), or
// cudaErrorInvalidValue for a parameter block of the wrong size or
// out-of-range sizes.
extern "C" int onix_fused_serve(const void* params, void* work,
                                void* stream) {
  const Params& p = *(const Params*)params;
  if (p.struct_bytes != (int)sizeof(Params))
    return (int)cudaErrorInvalidValue;
  const int form = onix_fused_serve_form(p.rows, p.n, p.max_results, p.k);
  if (form < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t limits = smem_limits_set();
  if (limits != cudaSuccess) return (int)limits;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec = p.mode == 0 && p.k % 4 == 0
                  && ((uintptr_t)p.theta & 15) == 0
                  && ((uintptr_t)p.phi & 15) == 0;
  const int vcol = p.n % 4 == 0
                   && (((uintptr_t)p.doc | (uintptr_t)p.word | (uintptr_t)p.sa
                        | (uintptr_t)p.sb | (uintptr_t)p.mask) & 15) == 0;
  if (form == 0) {
    const int np = row_np(p.n);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2 * p.rows);
    cfg.blockDim = dim3(512);
    cfg.dynamicSmemBytes = row_smem(np);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, row_kernel, p, np, vec);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const Layout l = layout(p.rows, p.n);
  const Work wk = work_at(work, l);
  cudaMemsetAsync((char*)work + l.hist, 0, l.total - l.hist, st);
  const dim3 tiles((p.n + kLongTile - 1) / kLongTile, p.rows);
  long_score_kernel<<<tiles, kLongThreads, kLongScoreSmem, st>>>(p, wk, vec,
                                                                 vcol);
  long_compact_kernel<<<tiles, kLongThreads, kLongCompactSmem, st>>>(p, wk);
  const dim3 windows((p.max_results + kWindow - 1) / kWindow, p.rows);
  long_finish_kernel<<<windows, kFinishThreads, kFinishSmem, st>>>(p, wk);
  return (int)cudaGetLastError();
}
