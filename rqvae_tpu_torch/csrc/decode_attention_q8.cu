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
// addresses), so every cache byte is read once, coalesced; a warp issues
// the loads of all its rows (up to 16) before it reduces the first, and
// prefetches the same V rows into L2 meanwhile, so the weighted sum after
// the softmax reads from L2. The K scale folds into the score and the V
// scale into the softmax weight, so the [B, T, C] tile is never
// dequantized.
//
// Races: a block reads only rows < cur_len and writes only its own head's
// slice of row cur_len (and its one scale), so no two blocks touch the
// same bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_layer.cuh"

namespace {

using fused::bf16;
using fused::kHeadSize;
using fused::kThreads;
using fused::kWarps;
using fused::load_bf16x2;
using fused::prefetch_l2;
using fused::round_bf16;
using fused::warp_max;
using fused::warp_sum;

constexpr int kRowBatch = 16;  // rows of one warp whose loads are in flight together

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

// head h of batch row b: y and the quantized cache row cur_len. scores:
// n_valid + 1 floats of shared memory (the last is the self term); red,
// ypart: shared scratch
__device__ __forceinline__ void attend_q8(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                                          const bf16* __restrict__ v_new, int8_t* kq, bf16* ks,
                                          int8_t* vq, bf16* vs, bf16* __restrict__ y, int T, int C,
                                          int n_head, int n_valid, int cur_len, float scale, int h,
                                          int b, float* scores, float* red,
                                          float (*ypart)[kHeadSize]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this lane's two columns in a [B, C] row and in row 0 of the [B, T, C]
  // cache; this head's scale in row 0 of the [B, T, n_head] scales
  const size_t row = (size_t)b * C + h * kHeadSize + 2 * lane;
  const size_t cache0 = (size_t)b * T * C + h * kHeadSize + 2 * lane;
  const size_t scale0 = (size_t)b * T * n_head + h;

  // this warp's rows t0 + kWarps j: their loads (and lane j's load of row j's
  // scale) in flight before the first sum; the V rows prefetched meanwhile
  const float2 qf = load_bf16x2(q + row);
  for (int t0 = warp; t0 < n_valid; t0 += kWarps * kRowBatch) {
    char2 kv[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const size_t t = min(t0 + kWarps * j, n_valid - 1);
      kv[j] = *reinterpret_cast<const char2*>(kq + cache0 + t * C);
      prefetch_l2(vq + cache0 + t * C);
    }
    const size_t tl = min(t0 + kWarps * (lane % kRowBatch), n_valid - 1);
    const float ks_lane = __bfloat162float(ks[scale0 + tl * n_head]);
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      if (t0 + kWarps * j >= n_valid) break;
      const float d = dot_bf16(make_float2((float)kv[j].x, (float)kv[j].y), qf);
      const float ks_j = __shfl_sync(0xffffffffu, ks_lane, j);
      if (lane == 0) scores[t0 + kWarps * j] = d * ks_j * scale;
    }
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
  for (int t0 = warp; t0 < n_valid; t0 += kWarps * kRowBatch) {
    char2 vv[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j)
      vv[j] = *reinterpret_cast<const char2*>(vq + cache0 + (size_t)min(t0 + kWarps * j, n_valid - 1) * C);
    const size_t tl = min(t0 + kWarps * (lane % kRowBatch), n_valid - 1);
    const float vs_lane = __bfloat162float(vs[scale0 + tl * n_head]);
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      if (t0 + kWarps * j >= n_valid) break;
      const float w = round_bf16((scores[t0 + kWarps * j] / denom) * __shfl_sync(0xffffffffu, vs_lane, j));
      acc.x += round_bf16((float)vv[j].x * w);
      acc.y += round_bf16((float)vv[j].y * w);
    }
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

__global__ void __launch_bounds__(kThreads) decode_attention_q8_update_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_new, const bf16* __restrict__ v_new,
    int8_t* kq, bf16* ks, int8_t* vq, bf16* vs, bf16* __restrict__ y, int T, int C,
    int n_head, int n_valid, int cur_len, float scale) {
  extern __shared__ float scores[];  // n_valid + 1 entries; the last is the self term
  __shared__ float red[kWarps];
  __shared__ float ypart[kWarps][kHeadSize];
  attend_q8(q, k_new, v_new, kq, ks, vq, vs, y, T, C, n_head, n_valid, cur_len, scale, blockIdx.x,
            blockIdx.y, scores, red, ypart);
}

// rq_decode_attention_q8_update_wo: the attention above, then the output
// projection, residual and LN2, in one cooperative launch of three phases
// (fused_layer.cuh) separated by grid barriers:
//   0 attend_q8, block per (row, head)  -> y (bf16 [B, C]) and the cache rows
//   1 y @ wo^T, split-K wmma GEMM        -> fp32 partial sums
//   2 block per row: x2 = bf16(x + bf16(proj * wo_s + bo)), h2 = LN2(x2)
// which replaces rqvae_tpu/ops/attention_kernel.py::
// decode_attention_q8_update_wo (kernel body _decode_attn_kernel_q8_update_wo):
// y = bf16(the fp32 attention), wo cast to bf16 (int8 is exact in bf16),
// the product summed in fp32 and times the per-output scale in fp32 (ones
// for a float wo: no scale pointer), bo added before the one cast. The
// projection needs every head of a row and LN2 every column, hence the
// barriers. Bound: bytes, about 23.4 MB (int8 wo) or 25.8 MB (bf16 wo) at
// B=100, C=1536, W=64: 7.0 / 7.7 us at 3.35 TB/s. Block 0 stamps the
// globaltimer at the start and after each barrier, the last block to finish
// at the end (wo_phase_ns, read by rq_decode_attention_q8_update_wo_phase_ns).
__device__ unsigned long long wo_phase_ns[4];

struct WoParams {
  const bf16 *q, *k_new, *v_new;
  int8_t* kq;
  bf16* ks;
  int8_t* vq;
  bf16* vs;
  const bf16* x;
  const void* wo;
  const bf16 *wo_s, *bo, *ln2_w, *ln2_b;
  bf16 *x2, *h2;
  float* part;  // [kMaxSplits, B, C] fp32 partial sums
  bf16* y;      // [B, C]
  int B, T, C, n_head, n_valid, cur_len, splits;
  float eps, scale;
};

template <typename WT>
__global__ void __launch_bounds__(fused::kThreads) decode_attention_q8_update_wo_kernel(WoParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float red[kWarps];
  __shared__ float ypart[kWarps][kHeadSize];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const bool stamp = blockIdx.x == 0 && threadIdx.x == 0;
  if (stamp) {
    wo_phase_ns[0] = fused::global_ns();
    wo_phase_ns[3] = 0;  // the last block to finish sets it (atomicMax below)
  }
  for (int u = blockIdx.x; u < p.B * p.n_head; u += gridDim.x) {
    attend_q8(p.q, p.k_new, p.v_new, p.kq, p.ks, p.vq, p.vs, p.y, p.T, p.C, p.n_head, p.n_valid,
              p.cur_len, p.scale, u % p.n_head, u / p.n_head, reinterpret_cast<float*>(smem_raw), red,
              ypart);
    __syncthreads();  // scores, red and ypart are free for the next unit
  }
  grid.sync();
  if (stamp) wo_phase_ns[1] = fused::global_ns();
  fused::gemm_phase<WT>(*reinterpret_cast<fused::Smem*>(smem_raw), p.y, static_cast<const WT*>(p.wo),
                        p.part, p.B, p.C, p.C, p.splits);
  grid.sync();
  if (stamp) wo_phase_ns[2] = fused::global_ns();
  for (int r = blockIdx.x; r < p.B; r += gridDim.x)
    fused::residual_ln_row(p.part, p.splits, p.wo_s, p.bo, p.x, p.x2, p.ln2_w, p.ln2_b, p.h2, r, p.B,
                           p.C, p.eps, red);
  if (threadIdx.x == 0) atomicMax(&wo_phase_ns[3], fused::global_ns());
}

int grid_cache_i8[16];
int grid_cache_bf16[16];

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

// q, k_new, v_new, x, x2, h2: [B, C] bf16; kq, vq: [B, T, C] int8; ks, vs:
// [B, T, n_head] bf16; wo: [C, C] int8 (wo_int8) or bf16; wo_s: [C] bf16 or
// null (a scale of ones); bo, ln2_w, ln2_b: [C] bf16; all contiguous. C ==
// n_head * 64, window <= fused::kMaxWindow. work: kMaxSplits * B * C fp32,
// then B * C bf16. Attends rows < min(cur_len, window), writes row cur_len
// (< T) of all four caches, and x2, h2. Returns the launch's cudaError_t
// (cudaErrorCooperativeLaunchTooLarge if the grid cannot be co-resident), or
// cudaGetLastError() after it.
extern "C" int rq_decode_attention_q8_update_wo(const void* q, const void* k_new, const void* v_new,
                                                void* kq, void* ks, void* vq, void* vs,
                                                const void* x, const void* wo, const void* wo_s,
                                                const void* bo, const void* ln2_w,
                                                const void* ln2_b, void* x2, void* h2, void* work,
                                                int B, int T, int C, int n_head, int window,
                                                int cur_len, int wo_int8, float eps,
                                                void* stream) {
  const void* kernel = wo_int8 ? (const void*)decode_attention_q8_update_wo_kernel<int8_t>
                               : (const void*)decode_attention_q8_update_wo_kernel<bf16>;
  int grid = 0;
  int err = fused::coop_grid(kernel, wo_int8 ? grid_cache_i8 : grid_cache_bf16, &grid);
  if (err) return err;
  WoParams p;
  p.q = static_cast<const bf16*>(q);
  p.k_new = static_cast<const bf16*>(k_new);
  p.v_new = static_cast<const bf16*>(v_new);
  p.kq = static_cast<int8_t*>(kq);
  p.ks = static_cast<bf16*>(ks);
  p.vq = static_cast<int8_t*>(vq);
  p.vs = static_cast<bf16*>(vs);
  p.x = static_cast<const bf16*>(x);
  p.wo = wo;
  p.wo_s = static_cast<const bf16*>(wo_s);
  p.bo = static_cast<const bf16*>(bo);
  p.ln2_w = static_cast<const bf16*>(ln2_w);
  p.ln2_b = static_cast<const bf16*>(ln2_b);
  p.x2 = static_cast<bf16*>(x2);
  p.h2 = static_cast<bf16*>(h2);
  p.part = static_cast<float*>(work);
  p.y = reinterpret_cast<bf16*>(p.part + (size_t)fused::kMaxSplits * B * C);
  p.B = B;
  p.T = T;
  p.C = C;
  p.n_head = n_head;
  p.n_valid = cur_len < window ? cur_len : window;
  p.cur_len = cur_len;
  p.splits = fused::pick_splits(((B + fused::kBM - 1) / fused::kBM) * (C / fused::kBN), C, grid);
  p.eps = eps;
  p.scale = 1.0f / sqrtf((float)kHeadSize);
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(fused::kThreads), args,
                                                    fused::kSmemBytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The globaltimer (ns) at the start of the last rq_decode_attention_q8_update_wo
// launch and after each of its three phases, into host memory out[4]. Synchronous.
extern "C" int rq_decode_attention_q8_update_wo_phase_ns(void* out) {
  return (int)cudaMemcpyFromSymbol(out, wo_phase_ns, sizeof(wo_phase_ns));
}
