// Kernel K1 for Hopper (sm_90a): one collapsed-Gibbs token block step,
// drawn from the block-start counts and then applied to them.
//
// Replaces the Pallas TPU kernel `sample_count_block` of
// onix/models/pallas_gibbs.py:148 (body `_kernel`, :105) and, on the
// card, the count updates that the reference's block step does around
// it (onix/models/lda_gibbs.py:749-770). What it computes, per token t
// of the block:
//
//   e      = onehot(z_old[t])                 (zero row for the pad K)
//   ndk    = f32(n_dk[d[t]]) - e
//   nwk    = f32(n_wk[w[t]]) - e
//   nk     = f32(n_k) - e
//   gumbel: s = (log(ndk + alpha) + log(max(nwk + eta, 1e-10)))
//               - log(nk + v_eta) + noise[t]
//   race:   s = (ndk + alpha) * max(nwk + eta, 1e-10) / (nk + v_eta)
//               / -log(noise[t])
//   z_new[t] = mask[t] > 0 ? argmax_k s : z_old[t]
//
// and then, for every token whose topic changed, +1 at [w][z_new] and
// -1 at [w][z_old] of a word table, the same at [d][.] of a doc table,
// the same in a topic-total table, and z_new written out. The float ops
// are those of `_kernel` and `lda_gibbs.make_block_step`, in the same
// order, with IEEE logf and division (nvcc runs with -fmad=false, so no
// product is contracted into an FMA). The argmax keeps the first
// maximum, as jnp.argmax and torch.argmax do.
//
// Chains. The reference runs C independent chains under `vmap`
// (onix/models/lda_gibbs.py:1131-1158): each chain has its own counts,
// noise and topics, and all share the block's token ids and mask. Here
// the chain is blockIdx.y of both kernels: a CTA offsets each per-chain
// operand (n_dk, n_wk, n_k, noise, z and z_new, and the targets with
// their sources) by its chain's stride, given in elements, and the
// shared ids are read as they are. One call still launches one sample
// and one apply kernel, whatever C; C = 1 launches the one-chain grid.
// A chain stride need not be the operand's size: the fit's z operand is
// the strided view z[:, i] of its [C, n_blocks, B] state.
//
// Lanes. The fleet refit (onix/models/fleet_gibbs.py:375-392) vmaps the
// block step over tenants, and each tenant lane has its own token ids
// and mask. So d, w and mask carry a stride too: 0 when every chain
// shares them (the chains above), a lane's row stride when each row of
// a [C, B] operand (or the strided view docs[:, i] of a [C, n_blocks,
// B] stack) belongs to one lane. Both kernels offset their id and mask
// reads by blockIdx.y times that stride; the apply kernel's atomics
// already land in the lane's own tables.
//
// One C function, `onix_gibbs_block`, launches two kernels on the
// caller's stream: `sample_kernel` (or, for K above about 4,000,
// `sample_row_kernel`) writes z_new to a scratch buffer and changes no
// count; `apply_kernel` then adds the deltas into whichever
// targets are not null. The two entry points of
// onix_torch/models/sample_count.py are this one function:
//   sample_count_block (the TPU kernel's contract): word target a
//     zeroed d_wk, no doc, topic-total or z target;
//   gibbs_block_step_ (the fit's block step): the targets are n_wk,
//     n_dk, n_k and z itself, updated in place.
//
// The snapshot. The reference samples every token of a block from the
// counts as they stood at the block's start. CTAs run in no order, so a
// kernel that added a token's +-1 to n_dk/n_wk/n_k while another CTA
// still read those rows would draw from counts that depend on the
// schedule. Here no kernel both reads and writes the counts: the
// sample kernel only reads them, the apply kernel only writes them,
// and stream order puts every read before every write. There is no
// grid-wide barrier to get wrong.
//
// What bounds it, on an H100 SXM (3.35 TB/s HBM): bytes. Per real token
// the sample kernel reads its noise row (K*4 B) and ids; the n_dk and
// n_wk rows repeat within a block (V = 504 words at the main path), so
// counted once per touched row, a main-path block (B = 65,536, K = 20,
// D = 20,575) needs about 7.6 MB read, 2.3 us; the apply kernel
// read-modify-writes the touched rows once more. C chains move C times
// the per-chain bytes (counts, noise, z); the shared ids are the same
// for every chain and come from L2 after the first. The arithmetic (three
// logs, or one log and two divisions, per topic) is far below the
// card's f32 rate. There is no matrix product: the tensor cores do not
// apply, and the kernel would be bound by bytes if they did.
//
// What the design does about the three costs the first K1 (one thread
// per token, a K-loop in registers) had:
// - Launches around the kernel. The fit's block step was K1, a memset
//   of d_wk and about eleven torch launches (topic delta, index_add_,
//   the n_wk and n_k adds, the copy of z). It is now this call: two
//   kernels, no memset, no torch op on a count.
// - Uncoalesced row reads. A CTA takes a tile of T tokens as its flat
//   [T*K] elements. Neighbouring threads read neighbouring addresses of
//   the noise tile and of each token's n_dk and n_wk rows; where K % 4
//   == 0 and the tables are 16-byte aligned (the main path), each
//   thread reads four elements with 16-byte vector loads. The scores go
//   to shared memory (rows of odd stride, so the scan meets no bank
//   conflict), then one thread per token scans its K scores in
//   ascending k with a strict `>`. The topic-total term, log(nk +
//   v_eta) or nk + v_eta, depends only on the column and on whether it
//   is the token's own topic: each CTA computes those 2K values once
//   into shared memory from n_k (one log a column, not one a token).
//   Padding tokens read no row.
// - Contended atomics. Each CTA of the apply kernel sums its tokens'
//   topic-total changes in shared memory and makes at most K global
//   atomics, not two per token. The n_dk and n_wk +-1 go straight to
//   global memory (integer atomics: exact in any order); they spread
//   over D and V rows.
//
// Tile: T = max(1, 1024 / K) tokens a CTA of 256 threads: 51 at the
// main path (1,286 CTAs, about 5.3 KB of shared memory each). Tiles of
// 51 to 102 tokens, a one-wave grid (T = 83) among them, take the same
// time there; 64, 128 and 166 are slower (PERF.md). Where even one
// token's K scores and the 2K topic-total terms outgrow 48 KB of shared
// memory (K above about 4,000), `sample_row_kernel` takes one token a
// CTA and reduces its columns' first maxima in registers, so any K
// runs. PERF.md has the ptxas report (registers, spills), times, the
// designs measured against this one, and launches. Neither kernel
// allocates memory or synchronises the device.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;       // threads per CTA, both kernels
constexpr int kTileElems = 1024;    // T*K elements per sample CTA
constexpr int kSmemFloats = 12288;  // a sample CTA's shared memory, 48 KB
constexpr int kMaxChains = 65535;   // gridDim.y

// Each per-chain operand's chain stride, in elements. The targets of the
// apply kernel step with their sources: the word target with n_wk, the
// doc target with n_dk, the topic-total target with n_k, z_out with z.
// d, w and mask are the token ids and mask: 0 when the chains share
// them, a lane's row stride when each chain has its own.
struct ChainStrides {
  int64_t dk, wk, k, noise, z, zn, d, w, mask;
};

// The score of one element, given the topic-total term of its column:
// log(nk + v_eta) for the Gumbel form, nk + v_eta for the race, with
// nk = f32(n_k) - e (each CTA computes the 2K terms once).
__device__ __forceinline__ float element_score(
    int ndk_count, int nwk_count, float nk_term, float e, float g,
    float alpha, float eta, bool gumbel) {
  const float ndk = (float)ndk_count - e;
  const float nwk = (float)nwk_count - e;
  if (gumbel) {
    const float logp = (logf(ndk + alpha) + logf(fmaxf(nwk + eta, 1e-10f)))
                       - nk_term;
    return logp + g;
  }
  const float p = ((ndk + alpha) * fmaxf(nwk + eta, 1e-10f)) / nk_term;
  return p / -logf(g);
}

// Reads only: the counts, the noise and the block's ids; writes z_new.
// A CTA samples the tokens [blockIdx.x * tile, +tile).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) sample_kernel(
    const int32_t* __restrict__ n_dk, const int32_t* __restrict__ n_wk,
    const int32_t* __restrict__ n_k, const float* __restrict__ noise,
    const int32_t* __restrict__ d, const int32_t* __restrict__ w,
    const int32_t* __restrict__ z_old, const float* __restrict__ mask,
    int32_t* __restrict__ z_new, int n_tokens, int k_topics, int tile,
    float alpha, float eta, float v_eta, int use_gumbel, ChainStrides cs) {
  extern __shared__ float smem[];
  const int64_t c = blockIdx.y;
  n_dk += c * cs.dk;
  n_wk += c * cs.wk;
  n_k += c * cs.k;
  noise += c * cs.noise;
  z_old += c * cs.z;
  z_new += c * cs.zn;
  d += c * cs.d;
  w += c * cs.w;
  mask += c * cs.mask;
  const int stride = k_topics | 1;
  float* s_score = smem;                               // [tile][stride]
  float* s_nk = s_score + tile * stride;               // [2][K]
  int* s_d = reinterpret_cast<int*>(s_nk + 2 * k_topics);  // [tile] each
  int* s_w = s_d + tile;
  int* s_z = s_w + tile;
  int* s_live = s_z + tile;

  const int t0 = blockIdx.x * tile;
  const int nt = min(tile, n_tokens - t0);
  const bool gumbel = use_gumbel != 0;
  // The topic-total term depends only on the column and on whether it
  // is the token's own topic (e = 1): 2K values a CTA, not one a token.
  for (int i = threadIdx.x; i < 2 * k_topics; i += blockDim.x) {
    const int k = i < k_topics ? i : i - k_topics;
    const float nk = (float)n_k[k] - (i < k_topics ? 0.0f : 1.0f);
    s_nk[i] = gumbel ? logf(nk + v_eta) : nk + v_eta;
  }
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    s_d[t] = d[t0 + t];
    s_w[t] = w[t0 + t];
    s_z[t] = z_old[t0 + t];
    s_live[t] = mask[t0 + t] > 0.0f;
  }
  __syncthreads();

  const int64_t e0 = (int64_t)t0 * k_topics;
  const int n_el = nt * k_topics;
  if (kVec) {
    // K % 4 == 0: a quad of elements lies in one row, 16-byte aligned.
    const float4* g4 = reinterpret_cast<const float4*>(noise + e0);
    for (int q = threadIdx.x; q < n_el / 4; q += blockDim.x) {
      const int e = 4 * q;
      const int t = e / k_topics;
      const int k = e - t * k_topics;
      if (!s_live[t]) continue;
      const float4 g = g4[q];
      const int4 a = *reinterpret_cast<const int4*>(
          n_dk + (int64_t)s_d[t] * k_topics + k);
      const int4 b = *reinterpret_cast<const int4*>(
          n_wk + (int64_t)s_w[t] * k_topics + k);
      const int zo = s_z[t];
      const float gs[4] = {g.x, g.y, g.z, g.w};
      const int as[4] = {a.x, a.y, a.z, a.w};
      const int bs[4] = {b.x, b.y, b.z, b.w};
      float* out = s_score + t * stride + k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool own = k + j == zo;
        out[j] = element_score(as[j], bs[j],
                               s_nk[(own ? k_topics : 0) + k + j],
                               own ? 1.0f : 0.0f, gs[j], alpha, eta, gumbel);
      }
    }
  } else {
    for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
      const int t = e / k_topics;
      const int k = e - t * k_topics;
      if (!s_live[t]) continue;
      const bool own = k == s_z[t];
      s_score[t * stride + k] = element_score(
          n_dk[(int64_t)s_d[t] * k_topics + k],
          n_wk[(int64_t)s_w[t] * k_topics + k],
          s_nk[(own ? k_topics : 0) + k], own ? 1.0f : 0.0f, noise[e0 + e],
          alpha, eta, gumbel);
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    int zn = s_z[t];
    if (s_live[t]) {
      const float* row = s_score + t * stride;
      float best = row[0];
      zn = 0;
      for (int k = 1; k < k_topics; ++k) {
        if (row[k] > best) {
          best = row[k];
          zn = k;
        }
      }
    }
    z_new[t0 + t] = zn;
  }
}

// The sample kernel for a K too large for one token's scores in a CTA's
// shared memory: one CTA a token. Each thread keeps the first maximum
// of its columns k = threadIdx.x + i * blockDim.x (ascending, strict
// `>`), then the CTA reduces the pairs, preferring the larger score
// and on a tie the lower k: the same draw as the ascending scan.
__global__ void __launch_bounds__(kThreads) sample_row_kernel(
    const int32_t* __restrict__ n_dk, const int32_t* __restrict__ n_wk,
    const int32_t* __restrict__ n_k, const float* __restrict__ noise,
    const int32_t* __restrict__ d, const int32_t* __restrict__ w,
    const int32_t* __restrict__ z_old, const float* __restrict__ mask,
    int32_t* __restrict__ z_new, int k_topics, float alpha, float eta,
    float v_eta, int use_gumbel, ChainStrides cs) {
  __shared__ float s_best[kThreads / 32];
  __shared__ int s_arg[kThreads / 32];
  const int64_t c = blockIdx.y;
  n_dk += c * cs.dk;
  n_wk += c * cs.wk;
  n_k += c * cs.k;
  noise += c * cs.noise;
  z_old += c * cs.z;
  z_new += c * cs.zn;
  d += c * cs.d;
  w += c * cs.w;
  mask += c * cs.mask;
  const int t = blockIdx.x;
  const int zo = z_old[t];
  if (!(mask[t] > 0.0f)) {
    if (threadIdx.x == 0) z_new[t] = zo;
    return;
  }
  const bool gumbel = use_gumbel != 0;
  const int64_t e0 = (int64_t)t * k_topics;
  const int32_t* ndk_row = n_dk + (int64_t)d[t] * k_topics;
  const int32_t* nwk_row = n_wk + (int64_t)w[t] * k_topics;
  float best = 0.0f;
  int arg = -1;   // no column yet
  for (int k = threadIdx.x; k < k_topics; k += blockDim.x) {
    const bool own = k == zo;
    const float nk = (float)n_k[k] - (own ? 1.0f : 0.0f);
    const float s = element_score(
        ndk_row[k], nwk_row[k], gumbel ? logf(nk + v_eta) : nk + v_eta,
        own ? 1.0f : 0.0f, noise[e0 + k], alpha, eta, gumbel);
    if (arg < 0 || s > best) {
      best = s;
      arg = k;
    }
  }
  // (b, a) replaces (best, arg) when it scores higher, or equal at a
  // lower k; a = -1 marks a thread that had no column.
  for (int off = 16; off > 0; off >>= 1) {
    const float b = __shfl_down_sync(0xffffffffu, best, off);
    const int a = __shfl_down_sync(0xffffffffu, arg, off);
    if (a >= 0 && (arg < 0 || b > best || (b == best && a < arg))) {
      best = b;
      arg = a;
    }
  }
  if ((threadIdx.x & 31) == 0) {
    s_best[threadIdx.x >> 5] = best;
    s_arg[threadIdx.x >> 5] = arg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) {
      const float b = s_best[i];
      const int a = s_arg[i];
      if (a >= 0 && (arg < 0 || b > best || (b == best && a < arg))) {
        best = b;
        arg = a;
      }
    }
    z_new[t] = arg;
  }
}

// Writes only: the +-1 of every token whose topic changed into each
// non-null target, and z_new into z_out. z_old and z_out may be the
// same buffer (each thread reads its token's z_old before it writes).
__global__ void __launch_bounds__(kThreads) apply_kernel(
    const int32_t* __restrict__ z_new, const int32_t* z_old,
    const int32_t* __restrict__ d, const int32_t* __restrict__ w,
    int32_t* word_target, int32_t* doc_target, int32_t* nk_target,
    int32_t* z_out, int n_tokens, int k_topics, ChainStrides cs) {
  extern __shared__ int s_dnk[];   // [K] when nk_target is set
  const int64_t c = blockIdx.y;
  z_new += c * cs.zn;
  z_old += c * cs.z;
  d += c * cs.d;
  w += c * cs.w;
  if (word_target != nullptr) word_target += c * cs.wk;
  if (doc_target != nullptr) doc_target += c * cs.dk;
  if (nk_target != nullptr) nk_target += c * cs.k;
  if (z_out != nullptr) z_out += c * cs.z;
  if (nk_target != nullptr) {
    for (int k = threadIdx.x; k < k_topics; k += blockDim.x) s_dnk[k] = 0;
    __syncthreads();
  }
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_tokens) {
    const int zn = z_new[t];
    const int zo = z_old[t];
    if (zn != zo) {
      if (word_target != nullptr) {
        int32_t* row = word_target + (int64_t)w[t] * k_topics;
        if (zn < k_topics) atomicAdd(&row[zn], 1);
        if (zo < k_topics) atomicAdd(&row[zo], -1);
      }
      if (doc_target != nullptr) {
        int32_t* row = doc_target + (int64_t)d[t] * k_topics;
        if (zn < k_topics) atomicAdd(&row[zn], 1);
        if (zo < k_topics) atomicAdd(&row[zo], -1);
      }
      if (nk_target != nullptr) {
        if (zn < k_topics) atomicAdd(&s_dnk[zn], 1);
        if (zo < k_topics) atomicAdd(&s_dnk[zo], -1);
      }
    }
    if (z_out != nullptr) z_out[t] = zn;
  }
  if (nk_target != nullptr) {
    __syncthreads();
    for (int k = threadIdx.x; k < k_topics; k += blockDim.x)
      if (s_dnk[k] != 0) atomicAdd(&nk_target[k], s_dnk[k]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

size_t sample_smem(int tile, int k_topics) {
  return ((size_t)tile * (k_topics | 1) + 2 * (size_t)k_topics)
             * sizeof(float) + 4 * (size_t)tile * sizeof(int);
}

// The 16-byte loads must be aligned at every chain's offset, not only
// at the base pointers: each chain stride a multiple of 4 elements.
bool vector_form(const void* n_dk, const void* n_wk, const void* noise,
                 int k_topics, int n_chains, const ChainStrides& cs) {
  const bool strides = n_chains == 1
      || (cs.dk % 4 == 0 && cs.wk % 4 == 0 && cs.noise % 4 == 0);
  return k_topics % 4 == 0 && aligned16(noise) && aligned16(n_dk)
         && aligned16(n_wk) && strides;
}

}  // namespace

// Sample the block from the counts as they are, then apply its deltas
// to the non-null targets; both kernels on `stream`, each with one grid
// row (blockIdx.y) a chain. z_new is the sample's output (scratch for
// the in-place step). s_* are the chain strides, in elements, of n_dk,
// n_wk, n_k, noise, z (z_old and z_out), z_new, d, w and mask (the last
// three 0 when the ids and mask are shared); they are not read when
// n_chains is 1. Returns cudaGetLastError() after the second
// launch (0 = both launched), or the first error met. An empty block
// launches nothing.
extern "C" int onix_gibbs_block(
    const void* n_dk, const void* n_wk, const void* n_k, const void* noise,
    const void* d, const void* w, const void* z_old, const void* mask,
    void* z_new, void* word_target, void* doc_target, void* nk_target,
    void* z_out, int n_tokens, int k_topics, float alpha, float eta,
    float v_eta, int use_gumbel, int n_chains, long long s_dk,
    long long s_wk, long long s_k, long long s_noise, long long s_z,
    long long s_zn, long long s_d, long long s_w, long long s_mask,
    void* stream) {
  if (n_tokens <= 0) return (int)cudaSuccess;
  if (k_topics < 1 || n_chains < 1 || n_chains > kMaxChains)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const ChainStrides cs{s_dk, s_wk, s_k, s_noise, s_z, s_zn, s_d, s_w,
                        s_mask};
  if (sample_smem(1, k_topics) > kSmemFloats * sizeof(float)) {
    sample_row_kernel<<<dim3(n_tokens, n_chains), kThreads, 0, s>>>(
        (const int32_t*)n_dk, (const int32_t*)n_wk, (const int32_t*)n_k,
        (const float*)noise, (const int32_t*)d, (const int32_t*)w,
        (const int32_t*)z_old, (const float*)mask, (int32_t*)z_new,
        k_topics, alpha, eta, v_eta, use_gumbel, cs);
  } else {
    const bool vec = vector_form(n_dk, n_wk, noise, k_topics, n_chains, cs);
    const int tile = std::max(1, kTileElems / k_topics);
    auto kernel = vec ? sample_kernel<true> : sample_kernel<false>;
    kernel<<<dim3((n_tokens + tile - 1) / tile, n_chains), kThreads,
             sample_smem(tile, k_topics), s>>>(
        (const int32_t*)n_dk, (const int32_t*)n_wk, (const int32_t*)n_k,
        (const float*)noise, (const int32_t*)d, (const int32_t*)w,
        (const int32_t*)z_old, (const float*)mask, (int32_t*)z_new,
        n_tokens, k_topics, tile, alpha, eta, v_eta, use_gumbel, cs);
  }
  const int err = (int)cudaGetLastError();
  if (err != (int)cudaSuccess) return err;
  const size_t smem_apply = nk_target ? k_topics * sizeof(int) : 0;
  apply_kernel<<<dim3((n_tokens + kThreads - 1) / kThreads, n_chains),
                 kThreads, smem_apply, s>>>(
      (const int32_t*)z_new, (const int32_t*)z_old, (const int32_t*)d,
      (const int32_t*)w, (int32_t*)word_target, (int32_t*)doc_target,
      (int32_t*)nk_target, (int32_t*)z_out, n_tokens, k_topics, cs);
  return (int)cudaGetLastError();
}
