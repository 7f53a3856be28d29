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
// low. The bottom M are then the M smallest keys. Blocks on Hopper run
// in no order, so the TPU kernel's one winner buffer carried across a
// sequential grid (pallas_serve.py:207-214, :278-307) becomes:
//
//   1. score_kernel  one CTA per tile of a row: scores, filters,
//      screens, writes each event's key and adds the top byte of every
//      qualifying key to the row's 256-bin histogram.
//   2. radix select  seven more histogram passes, one byte each, over
//      the keys that share the prefix chosen so far. The last CTA of a
//      row to finish a pass (a done counter) scans the row's histogram
//      and fixes that byte of the k-th smallest key, k = min(M,
//      qualifying). After eight passes the prefix is the k-th key.
//   3. compact       every key <= that key (exactly k: keys are unique)
//      goes to the row's candidate buffer of P = pow2(M) slots, the
//      rest of which holds the all-ones key.
//   4. bitonic sort  of each row's P slots: in shared memory when P <=
//      4096; above that, chunks of 4096 in shared memory and the longer
//      strides in global memory. The last stage writes the M outputs.
//
// M may exceed any tile and any shared-memory buffer: nothing here
// holds M keys on chip except the 4096-key sort chunk.
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
// computes it from each run's data). The key scratch (8 B an event,
// written once, read by eight passes) is this design's own traffic,
// not the function's; it stays in L2 up to about 6e6 events.
//
// The kernel allocates nothing (the caller passes one work buffer of
// onix_fused_serve_work_bytes() bytes), launches on the caller's
// stream and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;     // events per CTA
constexpr int kPasses = 8;                       // bytes of a key
constexpr int kSortChunk = 4096;                 // keys sorted on chip
constexpr int kSortThreads = 1024;
constexpr unsigned long long kNoKey = ~0ull;

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

struct Work {
  unsigned long long* keys;    // [R, n]
  unsigned long long* cand;    // [R, P]
  unsigned long long* prefix;  // [R]
  unsigned int* hist;          // [kPasses, R, 256]
  unsigned int* done;          // [kPasses, R]
  unsigned int* rank;          // [R]
  unsigned int* kth;           // [R] k = min(M, qualifying)
  unsigned int* fill;          // [R] compaction cursor
};

__host__ __device__ inline long long pow2_at_least(long long m) {
  long long p = 1;
  while (p < m) p <<= 1;
  return p;
}

__host__ __device__ inline size_t align_up(size_t x) {
  return (x + 255) & ~(size_t)255;
}

// Byte layout of the work buffer. Each call sets the candidate rows to
// all ones and zeroes everything after them (prefix .. fill).
struct Layout {
  size_t keys, cand, prefix, hist, done, rank, kth, fill, total;
};

__host__ inline Layout layout(long long rows, long long n, long long m) {
  Layout l;
  size_t at = 0;
  l.keys = at;   at = align_up(at + (size_t)rows * n * 8);
  l.cand = at;   at = align_up(at + (size_t)rows * pow2_at_least(m) * 8);
  l.prefix = at; at = align_up(at + (size_t)rows * 8);
  l.hist = at;   at = align_up(at + (size_t)kPasses * rows * 256 * 4);
  l.done = at;   at = align_up(at + (size_t)kPasses * rows * 4);
  l.rank = at;   at = align_up(at + (size_t)rows * 4);
  l.kth = at;    at = align_up(at + (size_t)rows * 4);
  l.fill = at;   at = align_up(at + (size_t)rows * 4);
  l.total = at;
  return l;
}

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

// Event i of row r: the screened score, or +inf. Writes the score
// stream when asked.
__device__ inline float event_score(const Params& p, int r, int i) {
  const float inf = __int_as_float(0x7f800000);
  const long long off = (long long)r * p.n + i;
  const float scale = p.filtered ? p.scale[r * p.scale_stride] : 1.0f;
  float s;
  unsigned int d = 0, w = 0;
  if (p.mode == 0) {
    const long long slot = p.slots ? p.slots[r] : 0;
    d = (unsigned int)p.doc[off];
    w = (unsigned int)p.word[off];
    const float* tr = p.theta + (slot * p.d_pad + d) * p.k;
    const float* pr = p.phi + (slot * p.v_pad + w) * p.k;
    s = __fmul_rn(tr[0], pr[0]);
    for (int kk = 1; kk < p.k; ++kk)
      s = __fadd_rn(s, __fmul_rn(tr[kk], pr[kk]));
  } else if (p.mode == 1) {
    float a = p.sa[off], b = p.sb[off];
    if (p.filtered && p.token_words) {
      a = word_stage(p, r, a, p.wkey_a[off], scale);
      b = word_stage(p, r, b, p.wkey_b[off], scale);
    }
    s = (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000)
                               : ((b < a) ? b : a);
  } else {
    s = p.sa[off];
  }
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
  const bool valid = i < row_len(p, r) && (!p.mask || p.mask[off] > 0.0f);
  return (valid && s < p.tol) ? s : inf;
}

// Add one byte of a key to the block's histogram, one shared-memory
// atomic per distinct byte in the warp (scores cluster in few bins).
__device__ inline void hist_add(unsigned int* h, int digit) {
  const unsigned int same = __match_any_sync(0xffffffffu, digit);
  const int lane = threadIdx.x & 31;
  if (digit < 256 && lane == __ffs(same) - 1)
    atomicAdd(&h[digit], __popc(same));
}

// After a block has added its histogram for (pass, r): the last block
// of the row to do so fixes byte `pass` of the row's k-th smallest key.
__device__ void finish_pass(const Params& p, const Work& wk, int pass,
                            int r, unsigned int* s_hist) {
  __shared__ unsigned int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&wk.done[pass * p.rows + r], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int t = threadIdx.x;           // blockDim.x == 256
  const unsigned int c =
      __ldcg(&wk.hist[((long long)pass * p.rows + r) * 256 + t]);
  s_hist[t] = c;
  __syncthreads();
  // Inclusive scan of the 256 bins.
  for (int off = 1; off < 256; off <<= 1) {
    const unsigned int v = t >= off ? s_hist[t - off] : 0u;
    __syncthreads();
    s_hist[t] += v;
    __syncthreads();
  }
  const unsigned int incl = s_hist[t];
  const unsigned int excl = incl - c;
  unsigned int rank;
  if (pass == 0) {
    const unsigned int total = s_hist[255];
    const unsigned int kth = total < (unsigned int)p.max_results
                                 ? total : (unsigned int)p.max_results;
    if (t == 0) {
      wk.kth[r] = kth;
      wk.prefix[r] = 0ull;
    }
    rank = kth;
  } else {
    rank = wk.rank[r];
  }
  if (rank == 0) return;               // no qualifying event in the row
  __syncthreads();
  if (excl < rank && incl >= rank) {
    const int shift = 56 - 8 * pass;
    wk.prefix[r] = (pass == 0 ? 0ull : wk.prefix[r])
                   | ((unsigned long long)t << shift);
    wk.rank[r] = rank - excl;
  }
}

__global__ void __launch_bounds__(kThreads)
score_kernel(Params p, Work wk) {
  __shared__ unsigned int s_hist[256];
  const int r = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int len = p.ev ? p.n : row_len(p, r);
  s_hist[threadIdx.x] = 0u;
  __syncthreads();
  if (base < len) {
    for (int j = 0; j < kPerThread; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      int digit = 256;
      if (i < p.n) {
        const float s = event_score(p, r, i);
        unsigned long long key = kNoKey;
        if (s != __int_as_float(0x7f800000)) {
          key = make_key(s, (unsigned int)i);
          digit = (int)(key >> 56);
        }
        wk.keys[(long long)r * p.n + i] = key;
      }
      hist_add(s_hist, digit);
    }
  }
  __syncthreads();
  const unsigned int c = s_hist[threadIdx.x];
  if (c) atomicAdd(&wk.hist[(long long)r * 256 + threadIdx.x], c);
  finish_pass(p, wk, 0, r, s_hist);
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(Params p, Work wk, int pass) {
  __shared__ unsigned int s_hist[256];
  const int r = blockIdx.y;
  if (wk.kth[r] == 0) return;          // uniform per row: no pass runs
  const int base = blockIdx.x * kTile;
  const int len = row_len(p, r);
  const unsigned long long want = wk.prefix[r];
  const unsigned long long himask = ~0ull << (64 - 8 * pass);
  const int shift = 56 - 8 * pass;
  s_hist[threadIdx.x] = 0u;
  __syncthreads();
  if (base < len) {
    for (int j = 0; j < kPerThread; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      int digit = 256;
      if (i < len) {
        const unsigned long long key = wk.keys[(long long)r * p.n + i];
        if (key != kNoKey && (key & himask) == want)
          digit = (int)((key >> shift) & 255ull);
      }
      hist_add(s_hist, digit);
    }
  }
  __syncthreads();
  const unsigned int c = s_hist[threadIdx.x];
  if (c)
    atomicAdd(&wk.hist[((long long)pass * p.rows + r) * 256 + threadIdx.x],
              c);
  finish_pass(p, wk, pass, r, s_hist);
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(Params p, Work wk, long long cand_stride) {
  const int r = blockIdx.y;
  if (wk.kth[r] == 0) return;
  const int base = blockIdx.x * kTile;
  const int len = row_len(p, r);
  if (base >= len) return;             // uniform per block
  const unsigned long long kth_key = wk.prefix[r];
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j * kThreads + threadIdx.x;
    bool take = false;
    unsigned long long key = kNoKey;
    if (i < len) {
      key = wk.keys[(long long)r * p.n + i];
      take = key <= kth_key;
    }
    const unsigned int ballot = __ballot_sync(0xffffffffu, take);
    unsigned int at = 0;
    if (lane == 0 && ballot) at = atomicAdd(&wk.fill[r], __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (take) {
      const unsigned int pos = at + __popc(ballot & ((1u << lane) - 1u));
      wk.cand[r * cand_stride + pos] = key;
    }
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

// Bitonic stages with strides below `chunk` on one chunk of a row's
// candidates, in shared memory: for every size s in [s_lo, s_hi], the
// strides min(s, chunk)/2 .. 1. Directions follow the global position,
// so chunks sort so that the next, longer merge finds bitonic runs.
// With `final`, the sorted chunk is written out as results.
__global__ void __launch_bounds__(kSortThreads)
sort_chunk_kernel(Params p, Work wk, long long cand_stride, int chunk,
                  long long s_lo, long long s_hi, int final) {
  __shared__ unsigned long long s_keys[kSortChunk];
  const int r = blockIdx.y;
  const long long base = (long long)blockIdx.x * chunk;
  unsigned long long* row = wk.cand + r * cand_stride;
  for (int t = threadIdx.x; t < chunk; t += blockDim.x)
    s_keys[t] = row[base + t];
  __syncthreads();
  for (long long s = s_lo; s <= s_hi; s <<= 1) {
    for (int j = (int)((s < chunk ? s : chunk) >> 1); j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < chunk / 2; q += blockDim.x) {
        const int i = (q / j) * 2 * j + (q % j);
        const int l = i + j;
        const bool up = ((base + i) & s) == 0;
        const unsigned long long a = s_keys[i], b = s_keys[l];
        if ((a > b) == up) {
          s_keys[i] = b;
          s_keys[l] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
    if (final)
      write_out(p, r, base + t, s_keys[t]);
    else
      row[base + t] = s_keys[t];
  }
}

// One bitonic stage (size s, stride j >= chunk) over a row's P slots.
__global__ void __launch_bounds__(kThreads)
sort_step_kernel(Work wk, long long cand_stride, long long s, long long j) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= cand_stride / 2) return;
  unsigned long long* row = wk.cand + (long long)blockIdx.y * cand_stride;
  const long long i = (q / j) * 2 * j + (q % j);
  const long long l = i + j;
  const bool up = (i & s) == 0;
  const unsigned long long a = row[i], b = row[l];
  if ((a > b) == up) {
    row[i] = b;
    row[l] = a;
  }
}

Work work_at(void* buf, const Layout& l) {
  char* b = (char*)buf;
  Work w;
  w.keys = (unsigned long long*)(b + l.keys);
  w.cand = (unsigned long long*)(b + l.cand);
  w.prefix = (unsigned long long*)(b + l.prefix);
  w.hist = (unsigned int*)(b + l.hist);
  w.done = (unsigned int*)(b + l.done);
  w.rank = (unsigned int*)(b + l.rank);
  w.kth = (unsigned int*)(b + l.kth);
  w.fill = (unsigned int*)(b + l.fill);
  return w;
}

}  // namespace

// Bytes of the work buffer a call with these sizes needs.
extern "C" long long onix_fused_serve_work_bytes(int rows, int n,
                                                 int max_results) {
  return (long long)layout(rows, n, max_results).total;
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
  if (p.rows <= 0 || p.n <= 0 || p.max_results <= 0 || p.rows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Layout l = layout(p.rows, p.n, p.max_results);
  const Work wk = work_at(work, l);
  const long long cand_stride = pow2_at_least(p.max_results);
  cudaMemsetAsync((char*)work + l.cand, 0xff, l.prefix - l.cand, st);
  cudaMemsetAsync((char*)work + l.prefix, 0, l.total - l.prefix, st);
  const dim3 grid((p.n + kTile - 1) / kTile, p.rows);
  score_kernel<<<grid, kThreads, 0, st>>>(p, wk);
  for (int pass = 1; pass < kPasses; ++pass)
    hist_kernel<<<grid, kThreads, 0, st>>>(p, wk, pass);
  compact_kernel<<<grid, kThreads, 0, st>>>(p, wk, cand_stride);
  const int chunk =
      (int)(cand_stride < kSortChunk ? cand_stride : kSortChunk);
  const dim3 chunks((unsigned int)(cand_stride / chunk), p.rows);
  const int one_chunk = cand_stride == chunk;
  sort_chunk_kernel<<<chunks, kSortThreads, 0, st>>>(
      p, wk, cand_stride, chunk, 2, chunk, one_chunk);
  for (long long s = 2LL * chunk; s <= cand_stride; s <<= 1) {
    for (long long j = s >> 1; j >= chunk; j >>= 1) {
      const dim3 steps((unsigned int)((cand_stride / 2 + kThreads - 1)
                                      / kThreads), p.rows);
      sort_step_kernel<<<steps, kThreads, 0, st>>>(wk, cand_stride, s, j);
    }
    sort_chunk_kernel<<<chunks, kSortThreads, 0, st>>>(
        p, wk, cand_stride, chunk, s, s, s == cand_stride);
  }
  return (int)cudaGetLastError();
}
