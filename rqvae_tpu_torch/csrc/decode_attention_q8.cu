// Single-token (decode) multi-head attention over an int8 KV cache, for the
// RQ-Transformer body on Hopper (sm_90a), in two forms compiled from one
// device function (attend_q8, template <bool kWrite, int kHeadSize>): with
// the in-kernel quantization and write of the new row, and read-only.
//
// Replaces the TPU kernels of rqvae_tpu/ops/attention_kernel.py (math in
// _attn_math_q8_val):
//   - decode_attention_q8_update (:577; quantization in
//     _quantize_row_in_kernel, cache write in _decode_attn_kernel_q8_update):
//     rq_decode_attention_q8_update, kWrite = true;
//   - decode_attention_q8 (:830, kernel body _decode_attn_kernel_q8), the
//     read-only form: rq_decode_attention_q8, kWrite = false.
//
// The cache of one layer is kq, vq int8 [B, T, C] with one bf16 scale per
// (row, head) in ks, vs [B, T, n_head]. For batch row b and head h (head
// size hs = C / n_head, 64 or 104: the template's instantiations), rounding
// where the JAX math rounds (bf16 whatever the input):
//   s_t    = sum_i bf16(kq[t, i] * q[i]) * ks[t] / sqrt(hs)   (fp32 sum), t < n_valid
//   s_self = sum_i bf16(k_new[i] * q[i]) / sqrt(hs)
//   e      = exp(s - max s), denom = sum e                     (fp32)
//   w_t    = bf16((e_t / denom) * vs[t])
//   y      = sum_t bf16(vq[t, i] * w_t) + v_new[i] * e_self / denom  (fp32)
// where n_valid = min(cur_len, window); the new token's term comes from the
// unquantized k_new / v_new. With kWrite, k_new and v_new are then
// quantized per head, scale = max(absmax / 127, 1e-8) in fp32 and q =
// round-half-even(x / scale) with IEEE division (no fast-math), bit-equal to
// the plain quantize_kv, and written into row cur_len of the four caches
// with the scale stored as bf16. The read-only form writes nothing but y,
// and cur_len may reach T (the TPU kernel's window has no write tile).
//
// Bound on the H100: cache bytes. At B=100, W=64, C=1536 one call reads
// 2 * B * 63 * C bytes of int8 (19.4 MB) plus 0.6 MB of scales, half the
// bf16 kernel's stream, against a few kFLOP per head: about 6 us at
// 3.35 TB/s. Design: one block per (head, batch row), as
// csrc/decode_attention.cu; each warp reads whole int8 head slices of cache
// rows (fused::HeadSlice: at head size 64 two values per lane, a 64-byte
// load; at 104 four values on each of 26 lanes, a 104-byte load with 6
// lanes idle), neighbouring lanes on neighbouring addresses, so every cache
// byte is read once, coalesced; a warp issues the loads of all its rows (up
// to 16) before it reduces the first, and prefetches the same V rows into
// L2 meanwhile, so the weighted sum after the softmax reads from L2. The K
// scale folds into the score and the V scale into the softmax weight, so
// the [B, T, C] tile is never dequantized.
//
// Races: a block reads only rows < min(cur_len, window) and, with kWrite,
// writes only its own head's slice of row cur_len (and its one scale), so
// no two blocks touch the same bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_layer.cuh"

namespace {

using fused::bf16;
using fused::kThreads;
using fused::kWarps;
using fused::prefetch_l2;
using fused::round_bf16;
using fused::warp_max;
using fused::warp_sum;

constexpr int kRowBatch = 16;  // rows of one warp whose loads are in flight together

// sum over the warp's head slice of bf16(a * b), in pairs per lane
template <int kVec>
__device__ __forceinline__ float dot_bf16(const float (&a)[kVec], const float (&b)[kVec]) {
  float d = round_bf16(a[0] * b[0]) + round_bf16(a[1] * b[1]);
#pragma unroll
  for (int i = 2; i < kVec; i += 2) d += round_bf16(a[i] * b[i]) + round_bf16(a[i + 1] * b[i + 1]);
  return warp_sum(d);
}

// quantize this lane's kVec values of one head (the whole warp holds the
// head; idle lanes hold zeros and store nothing) into dst_q, and the head's
// scale into *dst_s (lane 0)
template <int kVec>
__device__ __forceinline__ void quantize_head(const float (&x)[kVec], bool active, int8_t* dst_q,
                                              bf16* dst_s, int lane) {
  float a = fmaxf(fabsf(x[0]), fabsf(x[1]));
#pragma unroll
  for (int i = 2; i < kVec; ++i) a = fmaxf(a, fabsf(x[i]));
  const float amax = warp_max(a);
  const float scale = fmaxf(amax / 127.0f, 1e-8f);
  signed char q[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) q[i] = (signed char)__float2int_rn(x[i] / scale);
  if (active) {
    if constexpr (kVec == 2) {
      *reinterpret_cast<char2*>(dst_q) = make_char2(q[0], q[1]);
    } else {
      *reinterpret_cast<char4*>(dst_q) = make_char4(q[0], q[1], q[2], q[3]);
    }
  }
  if (lane == 0) *dst_s = __float2bfloat16_rn(scale);
}

// head h of batch row b: y and, with kWrite, the quantized cache row
// cur_len. scores: n_valid + 1 floats of shared memory (the last is the
// self term); red, ypart: shared scratch
template <bool kWrite, int kHeadSize>
__device__ __forceinline__ void attend_q8(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                                          const bf16* __restrict__ v_new, int8_t* kq, bf16* ks,
                                          int8_t* vq, bf16* vs, bf16* __restrict__ y, int T, int C,
                                          int n_head, int n_valid, int cur_len, float scale, int h,
                                          int b, float* scores, float* red,
                                          float (*ypart)[kHeadSize]) {
  using HS = fused::HeadSlice<kHeadSize>;
  constexpr int kVec = HS::kVec;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool active = HS::active(lane);
  // this lane's columns in a [B, C] row and in row 0 of the [B, T, C]
  // cache; this head's scale in row 0 of the [B, T, n_head] scales
  const size_t row = (size_t)b * C + h * kHeadSize + kVec * lane;
  const size_t cache0 = (size_t)b * T * C + h * kHeadSize + kVec * lane;
  const size_t scale0 = (size_t)b * T * n_head + h;

  // this warp's rows t0 + kWarps j: their loads (and lane j's load of row j's
  // scale) in flight before the first sum; the V rows prefetched meanwhile
  float qf[kVec], xf[kVec];
  fused::load_bf16v<kVec>(q + row, active, qf);
  for (int t0 = warp; t0 < n_valid; t0 += kWarps * kRowBatch) {
    fused::I8v<kVec> kv[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      const size_t t = min(t0 + kWarps * j, n_valid - 1);
      kv[j] = fused::load_i8v<kVec>(kq + cache0 + t * C, active);
      if (active) prefetch_l2(vq + cache0 + t * C);
    }
    const size_t tl = min(t0 + kWarps * (lane % kRowBatch), n_valid - 1);
    const float ks_lane = __bfloat162float(ks[scale0 + tl * n_head]);
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      if (t0 + kWarps * j >= n_valid) break;
      fused::to_float(kv[j], xf);
      const float d = dot_bf16<kVec>(xf, qf);
      const float ks_j = __shfl_sync(0xffffffffu, ks_lane, j);
      if (lane == 0) scores[t0 + kWarps * j] = d * ks_j * scale;
    }
  }
  if (warp == kWarps - 1) {
    fused::load_bf16v<kVec>(k_new + row, active, xf);
    const float d = dot_bf16<kVec>(xf, qf);
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

  float acc[kVec] = {};
  for (int t0 = warp; t0 < n_valid; t0 += kWarps * kRowBatch) {
    fused::I8v<kVec> vv[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j)
      vv[j] = fused::load_i8v<kVec>(vq + cache0 + (size_t)min(t0 + kWarps * j, n_valid - 1) * C, active);
    const size_t tl = min(t0 + kWarps * (lane % kRowBatch), n_valid - 1);
    const float vs_lane = __bfloat162float(vs[scale0 + tl * n_head]);
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      if (t0 + kWarps * j >= n_valid) break;
      const float w = round_bf16((scores[t0 + kWarps * j] / denom) * __shfl_sync(0xffffffffu, vs_lane, j));
      fused::to_float(vv[j], xf);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += round_bf16(xf[i] * w);
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) ypart[warp][kVec * lane + i] = acc[i];
  }
  __syncthreads();

  const size_t dst = cache0 + (size_t)cur_len * C;
  const size_t dst_s = scale0 + (size_t)cur_len * n_head;
  if (warp == 0) {
    if (!active) return;
    const float p_self = scores[n_valid] / denom;
    float out[kVec];
    fused::load_bf16v<kVec>(v_new + row, true, xf);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += ypart[w][kVec * lane + i];
      out[i] = s + xf[i] * p_self;
    }
    fused::store_bf16v<kVec>(y + row, out);
  } else if (kWrite && warp == 1) {
    fused::load_bf16v<kVec>(k_new + row, active, xf);
    quantize_head<kVec>(xf, active, kq + dst, ks + dst_s, lane);
  } else if (kWrite && warp == 2) {
    fused::load_bf16v<kVec>(v_new + row, active, xf);
    quantize_head<kVec>(xf, active, vq + dst, vs + dst_s, lane);
  }
}

template <bool kWrite, int kHeadSize>
__global__ void __launch_bounds__(kThreads) decode_attention_q8_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_new, const bf16* __restrict__ v_new,
    int8_t* kq, bf16* ks, int8_t* vq, bf16* vs, bf16* __restrict__ y, int T, int C,
    int n_head, int n_valid, int cur_len, float scale) {
  extern __shared__ float scores[];  // n_valid + 1 entries; the last is the self term
  __shared__ float red[kWarps];
  __shared__ float ypart[kWarps][kHeadSize];
  attend_q8<kWrite, kHeadSize>(q, k_new, v_new, kq, ks, vq, vs, y, T, C, n_head, n_valid, cur_len,
                               scale, blockIdx.x, blockIdx.y, scores, red, ypart);
}

template <bool kWrite, int kHeadSize>
int launch_q8_hs(const void* q, const void* k_new, const void* v_new, void* kq, void* ks, void* vq,
                 void* vs, void* y, int B, int T, int C, int n_head, int window, int cur_len,
                 void* stream) {
  const int n_valid = cur_len < window ? cur_len : window;
  const float scale = 1.0f / sqrtf((float)kHeadSize);
  const dim3 grid(n_head, B);
  const size_t smem = (size_t)(n_valid + 1) * sizeof(float);
  decode_attention_q8_kernel<kWrite, kHeadSize><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<int8_t*>(kq), static_cast<bf16*>(ks),
      static_cast<int8_t*>(vq), static_cast<bf16*>(vs), static_cast<bf16*>(y), T, C, n_head,
      n_valid, cur_len, scale);
  return (int)cudaGetLastError();
}

// the instantiation for head size C / n_head; cudaErrorInvalidValue when
// there is none
template <bool kWrite>
int launch_q8(const void* q, const void* k_new, const void* v_new, void* kq, void* ks, void* vq,
              void* vs, void* y, int B, int T, int C, int n_head, int window, int cur_len,
              void* stream) {
  if (n_head <= 0 || C % n_head) return (int)cudaErrorInvalidValue;
  switch (C / n_head) {
    case 64:
      return launch_q8_hs<kWrite, 64>(q, k_new, v_new, kq, ks, vq, vs, y, B, T, C, n_head, window,
                                      cur_len, stream);
    case 104:
      return launch_q8_hs<kWrite, 104>(q, k_new, v_new, kq, ks, vq, vs, y, B, T, C, n_head, window,
                                       cur_len, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
// barriers. Head size 64 only (fused::kHeadSize): no configuration of the
// repository reaches this path at another. Bound: bytes, about 23.4 MB
// (int8 wo) or 25.8 MB (bf16 wo) at B=100, C=1536, W=64: 7.0 / 7.7 us at
// 3.35 TB/s. Block 0 stamps the globaltimer at the start and after each
// barrier, the last block to finish at the end (wo_phase_ns, read by
// rq_decode_attention_q8_update_wo_phase_ns).
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
  __shared__ float ypart[kWarps][fused::kHeadSize];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const bool stamp = blockIdx.x == 0 && threadIdx.x == 0;
  if (stamp) {
    wo_phase_ns[0] = fused::global_ns();
    wo_phase_ns[3] = 0;  // the last block to finish sets it (atomicMax below)
  }
  for (int u = blockIdx.x; u < p.B * p.n_head; u += gridDim.x) {
    attend_q8<true, fused::kHeadSize>(p.q, p.k_new, p.v_new, p.kq, p.ks, p.vq, p.vs, p.y, p.T, p.C,
                                      p.n_head, p.n_valid, p.cur_len, p.scale, u % p.n_head,
                                      u / p.n_head, reinterpret_cast<float*>(smem_raw), red, ypart);
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
// [B, T, n_head] bf16; all contiguous, the bf16 [B, C] tensors 4-byte
// aligned (8-byte at head size 104). C / n_head is 64 or 104. Attends rows
// < min(cur_len, window) and writes row cur_len (< T) of all four caches.
// Returns cudaGetLastError() after the launch.
extern "C" int rq_decode_attention_q8_update(const void* q, const void* k_new,
                                             const void* v_new, void* kq, void* ks, void* vq,
                                             void* vs, void* y, int B, int T, int C,
                                             int n_head, int window, int cur_len,
                                             void* stream) {
  return launch_q8<true>(q, k_new, v_new, kq, ks, vq, vs, y, B, T, C, n_head, window, cur_len,
                         stream);
}

// The read-only form: the same arguments, the four caches only read (rows
// < min(cur_len, window); cur_len may reach T), nothing written but y.
// Returns cudaGetLastError() after the launch.
extern "C" int rq_decode_attention_q8(const void* q, const void* k_new, const void* v_new,
                                      const void* kq, const void* ks, const void* vq,
                                      const void* vs, void* y, int B, int T, int C, int n_head,
                                      int window, int cur_len, void* stream) {
  return launch_q8<false>(q, k_new, v_new, const_cast<void*>(kq), const_cast<void*>(ks),
                          const_cast<void*>(vq), const_cast<void*>(vs), y, B, T, C, n_head, window,
                          cur_len, stream);
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
  p.scale = 1.0f / sqrtf((float)fused::kHeadSize);
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
