// Single-token (decode) multi-head attention over an int8 KV cache, with
// the in-kernel quantization and write of the new row, for the
// RQ-Transformer body on Hopper (sm_90a).
//
// Replaces the TPU kernel rqvae_tpu/ops/attention_kernel.py::
// decode_attention_q8_update (math in _attn_math_q8_val, quantization in
// _quantize_row_in_kernel, cache write in _decode_attn_kernel_q8_update).
//
// The cache of one layer is kq, vq int8 [B, T, C] with one bf16 scale per
// (row, head) in ks, vs [B, T, n_head]. For batch row b and head h (head
// size 64), rounding where the JAX math rounds (bf16 whatever the input):
//   s_t    = sum_i bf16(kq[t, i] * q[i]) * ks[t] / 8    (fp32 sum), t < n_valid
//   s_self = sum_i bf16(k_new[i] * q[i]) / 8
//   e      = exp(s - max s), denom = sum e               (fp32)
//   w_t    = bf16((e_t / denom) * vs[t])
//   y      = sum_t bf16(vq[t, i] * w_t) + v_new[i] * e_self / denom  (fp32)
// where n_valid = min(cur_len, window). Then k_new and v_new are quantized
// per head, scale = max(absmax / 127, 1e-8) in fp32 and q = round-half-even
// (x / scale) with IEEE division (no fast-math), bit-equal to the plain
// quantize_kv, and written into row cur_len of the four caches with the
// scale stored as bf16.
//
// Bound on the H100: cache bytes. At B=100, W=64, C=1536 one call reads
// 2 * B * 63 * C bytes of int8 (19.4 MB) plus 0.6 MB of scales, half the
// bf16 kernel's stream, against a few kFLOP per head: about 6 us at
// 3.35 TB/s. Design: one block per (head, batch row), as
// csrc/decode_attention.cu; each warp reads whole 64-byte int8 head slices
// of cache rows (two values per lane, neighbouring lanes on neighbouring
// addresses), so every cache byte is read once, coalesced. The K scale
// folds into the score and the V scale into the softmax weight, so the
// [B, T, C] tile is never dequantized.
//
// Races: a block reads only rows < cur_len and writes only its own head's
// slice of row cur_len (and its one scale), so no two blocks touch the
// same bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHeadSize = 64;  // 2 values per lane of one warp
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_i8x2(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return make_float2((float)v.x, (float)v.y);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// sum over the warp's head slice of bf16(a * b), two values per lane
__device__ __forceinline__ float dot_bf16(float2 a, float2 b) {
  return warp_sum(round_bf16(a.x * b.x) + round_bf16(a.y * b.y));
}

// quantize this lane's two values of one head (the whole warp holds the
// head) into dst_q, and the head's scale into *dst_s (lane 0)
__device__ __forceinline__ void quantize_head(float2 x, int8_t* dst_q, bf16* dst_s, int lane) {
  const float amax = warp_max(fmaxf(fabsf(x.x), fabsf(x.y)));
  const float scale = fmaxf(amax / 127.0f, 1e-8f);
  char2 q;
  q.x = (signed char)__float2int_rn(x.x / scale);
  q.y = (signed char)__float2int_rn(x.y / scale);
  *reinterpret_cast<char2*>(dst_q) = q;
  if (lane == 0) *dst_s = __float2bfloat16_rn(scale);
}

__global__ void __launch_bounds__(kThreads) decode_attention_q8_update_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_new, const bf16* __restrict__ v_new,
    int8_t* kq, bf16* ks, int8_t* vq, bf16* vs, bf16* __restrict__ y, int T, int C,
    int n_head, int n_valid, int cur_len, float scale) {
  extern __shared__ float scores[];  // n_valid + 1 entries; the last is the self term
  __shared__ float red[kWarps];
  __shared__ float ypart[kWarps][kHeadSize];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this lane's two columns in a [B, C] row and in row 0 of the [B, T, C]
  // cache; this head's scale in row 0 of the [B, T, n_head] scales
  const size_t row = (size_t)b * C + h * kHeadSize + 2 * lane;
  const size_t cache0 = (size_t)b * T * C + h * kHeadSize + 2 * lane;
  const size_t scale0 = (size_t)b * T * n_head + h;

  const float2 qf = load_bf16x2(q + row);
  for (int t = warp; t < n_valid; t += kWarps) {
    const float d = dot_bf16(load_i8x2(kq + cache0 + (size_t)t * C), qf);
    if (lane == 0) scores[t] = d * __bfloat162float(ks[scale0 + (size_t)t * n_head]) * scale;
  }
  if (warp == kWarps - 1) {
    const float d = dot_bf16(load_bf16x2(k_new + row), qf);
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

  float2 acc = make_float2(0.f, 0.f);
  for (int t = warp; t < n_valid; t += kWarps) {
    const float w = round_bf16((scores[t] / denom) * __bfloat162float(vs[scale0 + (size_t)t * n_head]));
    const float2 vf = load_i8x2(vq + cache0 + (size_t)t * C);
    acc.x += round_bf16(vf.x * w);
    acc.y += round_bf16(vf.y * w);
  }
  ypart[warp][2 * lane] = acc.x;
  ypart[warp][2 * lane + 1] = acc.y;
  __syncthreads();

  const size_t dst = cache0 + (size_t)cur_len * C;
  const size_t dst_s = scale0 + (size_t)cur_len * n_head;
  if (warp == 0) {
    const float p_self = scores[n_valid] / denom;
    const float2 vn = load_bf16x2(v_new + row);
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      y0 += ypart[w][2 * lane];
      y1 += ypart[w][2 * lane + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(y + row) =
        __floats2bfloat162_rn(y0 + vn.x * p_self, y1 + vn.y * p_self);
  } else if (warp == 1) {
    quantize_head(load_bf16x2(k_new + row), kq + dst, ks + dst_s, lane);
  } else if (warp == 2) {
    quantize_head(load_bf16x2(v_new + row), vq + dst, vs + dst_s, lane);
  }
}

}  // namespace

// q, k_new, v_new, y: [B, C] bf16; kq, vq: [B, T, C] int8; ks, vs:
// [B, T, n_head] bf16; all contiguous. C == n_head * 64. Attends rows
// < min(cur_len, window) and writes row cur_len (< T) of all four caches.
// Returns cudaGetLastError() after the launch.
extern "C" int rq_decode_attention_q8_update(const void* q, const void* k_new,
                                             const void* v_new, void* kq, void* ks, void* vq,
                                             void* vs, void* y, int B, int T, int C,
                                             int n_head, int window, int cur_len,
                                             void* stream) {
  const int n_valid = cur_len < window ? cur_len : window;
  const float scale = 1.0f / sqrtf((float)kHeadSize);
  const dim3 grid(n_head, B);
  const size_t smem = (size_t)(n_valid + 1) * sizeof(float);
  decode_attention_q8_update_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<int8_t*>(kq), static_cast<bf16*>(ks),
      static_cast<int8_t*>(vq), static_cast<bf16*>(vs), static_cast<bf16*>(y), T, C, n_head,
      n_valid, cur_len, scale);
  return (int)cudaGetLastError();
}
