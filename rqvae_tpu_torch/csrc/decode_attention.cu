// Single-token (decode) multi-head attention over a KV cache, for the
// RQ-Transformer body on Hopper (sm_90a), in two forms compiled from one
// template: with the in-place cache row write, and read-only.
//
// Replaces the TPU kernels of rqvae_tpu/ops/attention_kernel.py (math in
// _attn_math, :85):
//   - decode_attention_update (:316; cache write in
//     _decode_attn_kernel_update): rq_decode_attention_update, kWrite = true;
//   - decode_attention (:209) and decode_attention_stacked (:149), the
//     read-only forms: rq_decode_attention, kWrite = false. The stacked
//     form reads layer l of an [L, B, T, C] cache: the wrapper passes the
//     layer's own base pointer (k_cache[l].data_ptr()), which is what the
//     TPU kernel's index_map did, so one kernel serves both; every offset
//     inside is size_t, so a stack beyond 2^31 elements is safe.
//
// What it computes, for every batch row b and head h (head size hs = C /
// n_head, 64 or 104: the template's instantiations):
//   s_t    = <q, k_cache[b, t]> / sqrt(hs)        for t < n_valid = min(cur_len, W)
//   s_self = <q, k_new[b]> / sqrt(hs)
//   p      = softmax over (s_0 .. s_{n_valid-1}, s_self), fp32
//   y[b]   = sum_t p_t v_cache[b, t] + p_self v_new[b]     (fp32 sums)
// and, with kWrite, then writes k_new / v_new into row cur_len of both
// caches. n_valid may be 0 (a first step at cur_len 0): y is then v_new.
//
// Bound on the H100: cache bytes. Each call streams 2 * B * n_valid * C * 2
// bytes of bf16 cache (about 39 MB at B=100, W=64, C=1536; 157 MB at
// cur_len 256, the stacked sampler's last step at 16x16 codes) against a
// few kFLOP of arithmetic per head, so the kernel is a pure memory stream.
// Design: one block per (head, batch row), 2400 blocks at bs100 and 24
// heads; each warp reads whole head slices of cache rows (fused::HeadSlice:
// at head size 64 two bf16 per lane, a 128-byte load; at 104 four bf16 on
// each of 26 lanes, a 208-byte load with 6 lanes idle), neighbouring lanes
// on neighbouring addresses, so every cache byte is read once, coalesced,
// and nothing but the [B, C] output (and with kWrite one cache row) is
// written. The TPU kernel's 0/1 "segment" matmuls, sublane-aligned windows,
// b_tile batch blocks and input_output_aliases are Mosaic workarounds and
// have no counterpart here: the cache is updated in place through its
// pointer, and a ragged batch is simply B blocks.
//
// Races: a block reads only rows < min(cur_len, W) and writes only its own
// head's slice of row cur_len, so no two blocks touch the same bytes. The
// read-only form never reads row cur_len: the new token's term comes from
// k_new / v_new, so a caller may write that row after the launch on the
// same stream (stack_step writes all layers' rows after its layer loop).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "fused_layer.cuh"

namespace {

using fused::bf16;
using fused::kThreads;
using fused::kWarps;
using fused::warp_max;
using fused::warp_sum;

template <bool kWrite, int kHeadSize>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_new, const bf16* __restrict__ v_new,
    bf16* k_cache, bf16* v_cache, bf16* __restrict__ y, int T, int C, int n_valid, int cur_len,
    float scale) {
  using HS = fused::HeadSlice<kHeadSize>;
  constexpr int kVec = HS::kVec;
  extern __shared__ float scores[];  // n_valid + 1 entries; the last is the self term
  __shared__ float red[kWarps];
  __shared__ float ypart[kWarps][kHeadSize];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool active = HS::active(lane);
  // this lane's columns, in a [B, C] row and in row 0 of the [B, T, C] cache
  const size_t row = (size_t)b * C + h * kHeadSize + kVec * lane;
  const size_t cache0 = (size_t)b * T * C + h * kHeadSize + kVec * lane;

  float qf[kVec], kf[kVec];
  fused::load_bf16v<kVec>(q + row, active, qf);
  for (int t = warp; t < n_valid; t += kWarps) {
    fused::load_bf16v<kVec>(k_cache + cache0 + (size_t)t * C, active, kf);
    const float d = warp_sum(fused::dot_lane<kVec>(qf, kf));
    if (lane == 0) scores[t] = d * scale;
  }
  if (warp == kWarps - 1) {
    fused::load_bf16v<kVec>(k_new + row, active, kf);
    const float d = warp_sum(fused::dot_lane<kVec>(qf, kf));
    if (lane == 0) scores[n_valid] = d * scale;
  }
  __syncthreads();

  const int n = n_valid + 1;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kThreads) m = fmaxf(m, scores[i]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // every thread has read red before it is reused

  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float e = expf(scores[i] - m);
    scores[i] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  float denom = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) denom += red[w];
  const float inv = 1.f / denom;

  float acc[kVec] = {}, vf[kVec];
  for (int t = warp; t < n_valid; t += kWarps) {
    const float p = scores[t] * inv;
    fused::load_bf16v<kVec>(v_cache + cache0 + (size_t)t * C, active, vf);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] += p * vf[i];
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) ypart[warp][kVec * lane + i] = acc[i];
  }
  __syncthreads();

  if (!active) return;
  if (warp == 0) {
    const float p_self = scores[n_valid] * inv;
    float out[kVec];
    fused::load_bf16v<kVec>(v_new + row, true, vf);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      out[i] = p_self * vf[i];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) out[i] += ypart[w][kVec * lane + i];
    }
    fused::store_bf16v<kVec>(y + row, out);
  } else if (kWrite && warp == 1) {
    const size_t dst = cache0 + (size_t)cur_len * C;
    fused::copy_bf16v<kVec>(k_cache + dst, k_new + row);
    fused::copy_bf16v<kVec>(v_cache + dst, v_new + row);
  }
}

template <bool kWrite, int kHeadSize>
int launch_hs(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
              void* y, int B, int T, int C, int n_head, int window, int cur_len, void* stream) {
  const int n_valid = cur_len < window ? cur_len : window;
  const float scale = 1.0f / sqrtf((float)kHeadSize);
  const dim3 grid(n_head, B);
  const size_t smem = (size_t)(n_valid + 1) * sizeof(float);
  decode_attention_kernel<kWrite, kHeadSize><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
      static_cast<bf16*>(k_cache), static_cast<bf16*>(v_cache), static_cast<bf16*>(y), T, C,
      n_valid, cur_len, scale);
  return (int)cudaGetLastError();
}

// the instantiation for head size C / n_head; cudaErrorInvalidValue when
// there is none
template <bool kWrite>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
           void* y, int B, int T, int C, int n_head, int window, int cur_len, void* stream) {
  if (n_head <= 0 || C % n_head) return (int)cudaErrorInvalidValue;
  switch (C / n_head) {
    case 64:
      return launch_hs<kWrite, 64>(q, k_new, v_new, k_cache, v_cache, y, B, T, C, n_head, window,
                                   cur_len, stream);
    case 104:
      return launch_hs<kWrite, 104>(q, k_new, v_new, k_cache, v_cache, y, B, T, C, n_head, window,
                                    cur_len, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k_new, v_new, y: [B, C]; k_cache, v_cache: [B, T, C]; all bf16,
// contiguous, 4-byte aligned (8-byte at head size 104). C / n_head is 64
// or 104. Attends rows < min(cur_len, window) and writes row cur_len (< T).
// Returns cudaGetLastError() after the launch.
extern "C" int rq_decode_attention_update(const void* q, const void* k_new,
                                          const void* v_new, void* k_cache,
                                          void* v_cache, void* y, int B, int T,
                                          int C, int n_head, int window,
                                          int cur_len, void* stream) {
  return launch<true>(q, k_new, v_new, k_cache, v_cache, y, B, T, C, n_head, window, cur_len,
                      stream);
}

// The read-only form: the same arguments, the caches only read (rows
// < min(cur_len, window); cur_len may reach T). For a stacked [L, B, T, C]
// cache the caller passes layer l's base pointer. Returns
// cudaGetLastError() after the launch.
extern "C" int rq_decode_attention(const void* q, const void* k_new, const void* v_new,
                                   const void* k_cache, const void* v_cache, void* y, int B,
                                   int T, int C, int n_head, int window, int cur_len,
                                   void* stream) {
  return launch<false>(q, k_new, v_new, const_cast<void*>(k_cache), const_cast<void*>(v_cache),
                       y, B, T, C, n_head, window, cur_len, stream);
}
