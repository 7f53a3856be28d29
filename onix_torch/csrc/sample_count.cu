// Fused categorical sample + n_wk count delta for one collapsed-Gibbs
// token block, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sample_count_block` of
// onix/models/pallas_gibbs.py:148 (body `_kernel`, :105). What it
// computes, per token t of the block:
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
//   d_wk    += onehot(w[t]) (x) (onehot(z_new[t]) - onehot(z_old[t]))
//
// These are the float ops of `_kernel` and of
// `lda_gibbs.make_block_step`, in the same order, with IEEE logf and
// division (no fast math; nvcc runs with -fmad=false so no product is
// contracted into an FMA). The argmax is a strict `>` scan over k
// ascending, so the first maximum wins, as jnp.argmax and torch.argmax
// do.
//
// What differs from the TPU kernel, and why. Mosaic has no gather, so
// the TPU kernel took pre-gathered [B, K] rows; and it has no scatter,
// so it built the [V, K] delta as a one-hot contraction on the MXU.
// Hopper has neither limit: each thread gathers its own token's n_dk
// and n_wk rows, and adds its +1/-1 straight into the global d_wk with
// atomicAdd (the caller zeroes d_wk). A per-CTA [V, K] copy in shared
// memory, flushed once per CTA, was built and measured first: it took
// about twice as long at the main-path shape as the global atomics
// (PERF.md, Findings), so it was dropped. Integer atomics do not depend
// on order, so d_wk is exact. The kernel allocates nothing and does not
// synchronise the device.
//
// What bounds it, on an H100 SXM (3.35 TB/s HBM): bytes. Per token the
// kernel reads its n_dk row and n_wk row (2*K*4 B), its noise row
// (K*4 B) and d, w, z_old, mask (16 B), and writes z_new (4 B): 12*K +
// 20 B, 260 B at K = 20, 17 MB per main-path block (B = 65,536) if every
// row came from HBM. Rows repeat within a block (V = 504 words), so
// counting each touched row once, as chip_smoke.py's bound does, gives
// about 7.6 MB, 2.3 us. The arithmetic (3 logs, or 1 log and 2
// divisions, per topic) is far below the card's rate. The repo's byte
// model for the whole block step (onix/utils/obs.py:388,
// gibbs_pallas_bytes_per_token) counts 413 B per token at this shape,
// about 27 MB per step, because it adds the noise write and the n_dk
// scatter that run outside this kernel. One thread per token with its
// K-loop in registers reads its rows with a stride of K: far from
// coalesced, simple, and right first; PERF.md has its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void sample_count_kernel(
    const int32_t* __restrict__ n_dk, const int32_t* __restrict__ n_wk,
    const int32_t* __restrict__ n_k, const float* __restrict__ noise,
    const int32_t* __restrict__ d, const int32_t* __restrict__ w,
    const int32_t* __restrict__ z_old, const float* __restrict__ mask,
    int32_t* __restrict__ z_new, int32_t* __restrict__ d_wk,
    int n_tokens, int k_topics, float alpha, float eta, float v_eta,
    int use_gumbel) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tokens) return;
  const int zo = z_old[t];
  int zn = zo;
  if (mask[t] > 0.0f) {
    const int32_t* rd = n_dk + (int64_t)d[t] * k_topics;
    const int32_t* rw = n_wk + (int64_t)w[t] * k_topics;
    const float* g = noise + (int64_t)t * k_topics;
    float best = 0.0f;
    int arg = 0;
    for (int k = 0; k < k_topics; ++k) {
      const float e = (k == zo) ? 1.0f : 0.0f;
      const float ndk = (float)rd[k] - e;
      const float nwk = (float)rw[k] - e;
      const float nk = (float)n_k[k] - e;
      float s;
      if (use_gumbel) {
        const float logp = (logf(ndk + alpha)
                            + logf(fmaxf(nwk + eta, 1e-10f)))
                           - logf(nk + v_eta);
        s = logp + g[k];
      } else {
        const float p = ((ndk + alpha) * fmaxf(nwk + eta, 1e-10f))
                        / (nk + v_eta);
        s = p / -logf(g[k]);
      }
      if (k == 0 || s > best) {
        best = s;
        arg = k;
      }
    }
    zn = arg;
  }
  z_new[t] = zn;
  if (zn != zo) {
    int32_t* row = d_wk + (int64_t)w[t] * k_topics;
    if (zn < k_topics) atomicAdd(&row[zn], 1);
    if (zo < k_topics) atomicAdd(&row[zo], -1);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch
// (0 = launched). An empty block launches nothing.
extern "C" int onix_sample_count_block(
    const void* n_dk, const void* n_wk, const void* n_k, const void* noise,
    const void* d, const void* w, const void* z_old, const void* mask,
    void* z_new, void* d_wk, int n_tokens, int k_topics, float alpha,
    float eta, float v_eta, int use_gumbel, void* stream) {
  if (n_tokens <= 0) return (int)cudaSuccess;
  const int blocks = (n_tokens + kThreads - 1) / kThreads;
  sample_count_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)n_dk, (const int32_t*)n_wk, (const int32_t*)n_k,
      (const float*)noise, (const int32_t*)d, (const int32_t*)w,
      (const int32_t*)z_old, (const float*)mask, (int32_t*)z_new,
      (int32_t*)d_wk, n_tokens, k_topics, alpha, eta, v_eta, use_gumbel);
  return (int)cudaGetLastError();
}
