// The dense half of a decode transformer layer on Hopper (sm_90a), split-K:
//
//   rq_fused_ln_qkv_splitk:   qkv = LN1(x) @ wqkv^T + bqkv
//   rq_fused_proj_mlp_splitk: x2  = x + (y @ wo^T + bo)
//                             out = x2 + (gelu(LN2(x2) @ w1^T + b1) @ w2^T + b2)
//
// with int8 weights and one bf16 scale s per output column:
//
//   rq_fused_ln_qkv_q8_splitk:   qkv = bf16(acc * s + bqkv),      acc = LN1(x) @ q^T
//   rq_fused_proj_mlp_q8_splitk: x2  = x + bf16(acc_o * s_o + bo)
//                                t   = bf16(gelu(acc_1 * s_1 + b1))
//                                out = x2 + bf16(acc_2 * s_2 + b2)
//
// These are the first design of #2 / #3 and #5-#8, kept as the A/B baseline
// of their single-launch kernels in csrc/decode_dense.cu (rq_fused_ln_qkv,
// rq_fused_proj_mlp, bf16 or int8 weights), which the sampler runs; only
// chip_smoke.py reaches these.
//
// Replace the TPU kernels rqvae_tpu/ops/decode_layer_kernel.py::fused_ln_qkv
// and ::fused_proj_mlp, and ::fused_ln_qkv_q8 / ::fused_ln_qkv_q8_ring and
// ::fused_proj_mlp_q8 / ::fused_proj_mlp_q8_ring (each grid/ring pair
// differs only in TPU DMA depth; one Hopper kernel serves both). Weights
// are read in the nn.Linear [out, in] layout directly (no transposed copy).
//
// Bound on the H100: weight bytes. At C=1536 one layer-step streams
// 14 MB (wqkv) + 42 MB (wo, w1, w2) of bf16 weights for a batch of ~100
// rows: about 2 * B = 200 FLOP per weight element, far below the card's
// ~295 FLOP/B ridge, so the tensor cores idle and DRAM sets the time.
// Design: every weight element is read from device memory exactly once per
// call. A block owns 64 output columns (one 16-column tensor-core fragment
// per warp) for up to 128 activation rows, and a slice of the reduction
// dimension (split-K, so that even the 1536-column products launch ~200
// blocks and keep enough loads in flight); the activation tile is staged
// in shared memory, where the LN1/LN2 prologue normalises it on the fly
// from one-pass fp32 row statistics. Products run on the tensor cores
// (wmma bf16 16x16x16, fp32 accumulation). Split-K partial sums go to an
// fp32 workspace; a second small kernel adds the splits and applies the
// epilogue (bias, gelu, residual) with the JAX kernel's rounding points.
// The fused_proj_mlp wrapper is therefore a sequence of six launches
// (proj, proj epilogue, LN2+w1, gelu epilogue, w2, residual epilogue): LN2
// needs the whole of x2, a grid-wide dependency that the TPU kernel's
// sequential grid hid.
//
// int8 weights halve the bytes that bound the kernel: 7.1 MB for wqkv and
// 21.2 MB for wo + w1 + w2 at C=1536, about 2.1 us and 6.3 us at 3.35 TB/s.
// Each warp loads its 16 columns x 64 rows of int8 weight per chunk into
// shared memory as bf16 (int8 values are exact in bf16), so the tensor-core
// products stay wmma bf16 with fp32 accumulation and give the same sums as
// for the dequantized weight; the per-column scales are applied to the
// split-summed fp32 accumulator in the epilogue, before the bias, so w2's
// scale multiplies the whole hidden sum once, as in the JAX kernel. The q8
// forms share the bf16 forms' structure, and its limit (one fragment of
// columns per warp, no pipelining: about 5% of HBM bandwidth for bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBM = 128;  // activation rows per block (8 row fragments)
constexpr int kBN = 64;   // output columns per block (16 per warp)
constexpr int kBK = 64;   // reduction chunk staged through shared memory
constexpr int kLDA = kBK + 8;  // padded row stride of the staged tile (elements)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMFrag = kBM / 16;
constexpr int kKFrag = kBK / 16;

// acc is the split-summed fp32 product, times the column scale when the
// weights are int8
enum Epilogue : int {
  kBias = 0,          // out = bf16(acc + b)
  kBiasGeluErf = 1,   // out = bf16(gelu_erf(acc + b))
  kBiasGeluSig = 2,   // out = bf16(t * sigmoid(1.702 t)), t = acc + b
  kProjResidual = 3,  // out = bf16(res + bf16(bf16(acc) + b))
  kBiasResidual = 4,  // out = bf16(res + bf16(acc + b))
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// part[split, m, n] = sum over this split's k of A[m, k] * w[n, k], where A
// is a (LN = false) or LayerNorm(a) with weight ln_w, bias ln_b (LN = true,
// then K is the full row length). a: [M, K], w: [N, K] bf16 or int8 (WT),
// part: [S, M, N].
template <bool LN, typename WT>
__global__ void __launch_bounds__(kThreads) gemm_partial_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ ln_w,
    const bf16* __restrict__ ln_b, const WT* __restrict__ w,
    float* __restrict__ part, int M, int N, int K, int k_per_split, float eps) {
  constexpr bool kInt8 = std::is_same<WT, int8_t>::value;
  __shared__ __align__(32) bf16 a_s[kBM * kLDA];
  __shared__ __align__(32) float c_s[kWarps][16 * 16];
  // int8 weights: each warp's 16 columns x kBK rows, widened to bf16
  __shared__ __align__(32) bf16 w_s[kInt8 ? kWarps * 16 * kLDA : 16];
  __shared__ float mean_s[kBM];
  __shared__ float rstd_s[kBM];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int split = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = min(kBM, M - m0);
  const int mfrags = (rows + 15) / 16;
  const int rows_pad = mfrags * 16;
  const int col = n0 + warp * 16;  // this warp's first output column
  const bool col_ok = col < N;     // N % 16 == 0 (checked by the wrapper)

  if (LN) {
    // one-pass fp32 statistics of the whole row, as model.layer_norm
    for (int r = warp; r < rows; r += kWarps) {
      const bf16* xr = a + (size_t)(m0 + r) * K;
      float s1 = 0.f, s2 = 0.f;
      for (int k = 2 * lane; k < K; k += 64) {
        const float2 v = load_bf16x2(xr + k);
        s1 += v.x + v.y;
        s2 += v.x * v.x + v.y * v.y;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        const float mean = s1 / (float)K;
        const float var = fmaxf(s2 / (float)K - mean * mean, 0.f);
        mean_s[r] = mean;
        rstd_s[r] = rsqrtf(var + eps);
      }
    }
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMFrag];
#pragma unroll
  for (int i = 0; i < kMFrag; ++i) wmma::fill_fragment(acc[i], 0.f);

  const int k_begin = split * k_per_split;
  const int k_end = k_begin + k_per_split;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // stage A[m0 : m0 + rows_pad, k0 : k0 + kBK] as bf16, zero past row M
    for (int i = threadIdx.x; i < rows_pad * (kBK / 2); i += kThreads) {
      const int r = i / (kBK / 2);
      const int c = (i % (kBK / 2)) * 2;
      float2 v = make_float2(0.f, 0.f);
      if (r < rows) {
        v = load_bf16x2(a + (size_t)(m0 + r) * K + k0 + c);
        if (LN) {
          const float2 g = load_bf16x2(ln_w + k0 + c);
          const float2 bb = load_bf16x2(ln_b + k0 + c);
          v.x = (v.x - mean_s[r]) * rstd_s[r] * g.x + bb.x;
          v.y = (v.y - mean_s[r]) * rstd_s[r] * g.y + bb.y;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(a_s + r * kLDA + c) = __floats2bfloat162_rn(v.x, v.y);
    }
    __syncthreads();
    if (col_ok) {
      // B(k, n) = w[col + n, k0 + k]: a column-major 16x16 tile, ldm = K
      // (ldm = kLDA for the widened int8 tile)
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[kKFrag];
      if constexpr (kInt8) {
        bf16* ws = w_s + warp * 16 * kLDA;
        for (int e = lane; e < 16 * (kBK / 4); e += 32) {
          const int n = e / (kBK / 4);
          const int k = (e % (kBK / 4)) * 4;
          const char4 v = *reinterpret_cast<const char4*>(w + (size_t)(col + n) * K + k0 + k);
          *reinterpret_cast<__nv_bfloat162*>(ws + n * kLDA + k) =
              __floats2bfloat162_rn((float)v.x, (float)v.y);
          *reinterpret_cast<__nv_bfloat162*>(ws + n * kLDA + k + 2) =
              __floats2bfloat162_rn((float)v.z, (float)v.w);
        }
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < kKFrag; ++kk) wmma::load_matrix_sync(bfr[kk], ws + kk * 16, kLDA);
      } else {
#pragma unroll
        for (int kk = 0; kk < kKFrag; ++kk)
          wmma::load_matrix_sync(bfr[kk], w + (size_t)col * K + k0 + kk * 16, K);
      }
#pragma unroll
      for (int kk = 0; kk < kKFrag; ++kk) {
#pragma unroll
        for (int i = 0; i < kMFrag; ++i) {
          if (i < mfrags) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
            wmma::load_matrix_sync(afr, a_s + i * 16 * kLDA + kk * 16, kLDA);
            wmma::mma_sync(acc[i], afr, bfr[kk], acc[i]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (col_ok) {
    float* out = part + (size_t)split * M * N;
#pragma unroll
    for (int i = 0; i < kMFrag; ++i) {
      if (i < mfrags) {
        wmma::store_matrix_sync(c_s[warp], acc[i], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = i * 16 + e / 16;
          if (r < rows) out[(size_t)(m0 + r) * N + col + (e % 16)] = c_s[warp][e];
        }
        __syncwarp();
      }
    }
  }
}

// out[m, n] = epilogue(sum over splits of part[s, m, n], times scale[n]
// when scale is not null); see Epilogue.
__global__ void epilogue_kernel(const float* __restrict__ part, int splits,
                                const bf16* __restrict__ scale,
                                const bf16* __restrict__ bias,
                                const bf16* __restrict__ res, bf16* __restrict__ out,
                                int M, int N, int mode) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (idx >= total) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * total + idx];
  if (scale != nullptr) acc *= __bfloat162float(scale[idx % N]);
  const float b = __bfloat162float(bias[idx % N]);
  float r;
  switch (mode) {
    case kBiasGeluErf: {
      const float t = acc + b;
      r = 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
      break;
    }
    case kBiasGeluSig: {
      const float t = acc + b;
      r = t / (1.f + expf(-1.702f * t));
      break;
    }
    case kProjResidual:
      r = __bfloat162float(res[idx]) + round_bf16(round_bf16(acc) + b);
      break;
    case kBiasResidual:
      r = __bfloat162float(res[idx]) + round_bf16(acc + b);
      break;
    default:
      r = acc + b;
  }
  out[idx] = __float2bfloat16_rn(r);
}

template <typename WT>
int gemm(const bf16* a, const bf16* ln_w, const bf16* ln_b, const WT* w,
         float* part, int M, int N, int K, int splits, float eps,
         cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  const int k_per_split = K / splits;
  if (ln_w != nullptr)
    gemm_partial_kernel<true, WT><<<grid, kThreads, 0, stream>>>(a, ln_w, ln_b, w, part, M,
                                                                  N, K, k_per_split, eps);
  else
    gemm_partial_kernel<false, WT><<<grid, kThreads, 0, stream>>>(a, ln_w, ln_b, w, part, M,
                                                                   N, K, k_per_split, eps);
  return (int)cudaGetLastError();
}

int epilogue(const float* part, int splits, const bf16* scale, const bf16* bias,
             const bf16* res, bf16* out, int M, int N, int mode, cudaStream_t stream) {
  const int threads = 256;
  const size_t total = (size_t)M * N;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  epilogue_kernel<<<blocks, threads, 0, stream>>>(part, splits, scale, bias, res, out, M, N,
                                                  mode);
  return (int)cudaGetLastError();
}

// LN1 + QKV; scale is null for bf16 weights.
template <typename WT>
int ln_qkv(const bf16* x, const bf16* ln_w, const bf16* ln_b, const WT* w, const bf16* scale,
           const bf16* bias, bf16* out, float* part, int M, int N, int C, int splits, float eps,
           cudaStream_t s) {
  int err = gemm(x, ln_w, ln_b, w, part, M, N, C, splits, eps, s);
  if (err) return err;
  return epilogue(part, splits, scale, bias, nullptr, out, M, N, kBias, s);
}

// proj + residual + LN2 + MLP + residual: six launches. Scales are null for
// bf16 weights, whose projection is cast before + bo (kProjResidual); the
// int8 form adds bo to the scaled fp32 sum first (kBiasResidual).
template <typename WT>
int proj_mlp(const bf16* x, const bf16* y, const WT* wo, const bf16* wo_s, const bf16* bo,
             const bf16* ln_w, const bf16* ln_b, const WT* w1, const bf16* w1_s,
             const bf16* b1, const WT* w2, const bf16* w2_s, const bf16* b2, bf16* out,
             bf16* x2, bf16* hidden, float* part, int M, int C, int H, int splits_o,
             int splits_1, int splits_2, int gelu_sigmoid, float eps, cudaStream_t s) {
  int err = gemm(y, nullptr, nullptr, wo, part, M, C, C, splits_o, eps, s);
  if (err) return err;
  err = epilogue(part, splits_o, wo_s, bo, x, x2, M, C,
                 wo_s == nullptr ? kProjResidual : kBiasResidual, s);
  if (err) return err;
  err = gemm(x2, ln_w, ln_b, w1, part, M, H, C, splits_1, eps, s);
  if (err) return err;
  err = epilogue(part, splits_1, w1_s, b1, nullptr, hidden, M, H,
                 gelu_sigmoid ? kBiasGeluSig : kBiasGeluErf, s);
  if (err) return err;
  err = gemm(hidden, nullptr, nullptr, w2, part, M, C, H, splits_2, eps, s);
  if (err) return err;
  return epilogue(part, splits_2, w2_s, b2, x2, out, M, C, kBiasResidual, s);
}

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

}  // namespace

// x: [M, C]; ln_w, ln_b: [C]; wqkv: [N, C]; bqkv: [N]; out: [M, N]; all
// bf16 and contiguous. work: fp32 [splits, M, N]. C % (64 * splits) == 0,
// N % 16 == 0. Returns the first non-zero cudaGetLastError().
extern "C" int rq_fused_ln_qkv_splitk(const void* x, const void* ln_w, const void* ln_b,
                               const void* wqkv, const void* bqkv, void* out, void* work,
                               int M, int N, int C, int splits, float eps, void* stream) {
  return ln_qkv(in<bf16>(x), in<bf16>(ln_w), in<bf16>(ln_b), in<bf16>(wqkv), nullptr,
                in<bf16>(bqkv), static_cast<bf16*>(out), static_cast<float*>(work), M, N, C,
                splits, eps, (cudaStream_t)stream);
}

// rq_fused_ln_qkv_splitk with int8 wq [N, C] and bf16 column scales ws [N].
extern "C" int rq_fused_ln_qkv_q8_splitk(const void* x, const void* ln_w, const void* ln_b,
                                  const void* wq, const void* ws, const void* bqkv, void* out,
                                  void* work, int M, int N, int C, int splits, float eps,
                                  void* stream) {
  return ln_qkv(in<bf16>(x), in<bf16>(ln_w), in<bf16>(ln_b), in<int8_t>(wq), in<bf16>(ws),
                in<bf16>(bqkv), static_cast<bf16*>(out), static_cast<float*>(work), M, N, C,
                splits, eps, (cudaStream_t)stream);
}

// x, y, out, x2: [M, C]; wo: [C, C]; w1: [H, C]; w2: [C, H]; biases and
// LN2 parameters [C] or [H]; hidden: [M, H]; all bf16 and contiguous. x2
// and hidden are scratch. work: fp32 of at least max(splits_o * M * C,
// splits_1 * M * H, splits_2 * M * C) elements. gelu_sigmoid selects the
// "v2" gelu (t * sigmoid(1.702 t)) over the exact-erf one.
extern "C" int rq_fused_proj_mlp_splitk(const void* x, const void* y, const void* wo,
                                 const void* bo, const void* ln_w, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* out, void* x2, void* hidden,
                                 void* work, int M, int C, int H, int splits_o,
                                 int splits_1, int splits_2, int gelu_sigmoid, float eps,
                                 void* stream) {
  return proj_mlp(in<bf16>(x), in<bf16>(y), in<bf16>(wo), nullptr, in<bf16>(bo),
                  in<bf16>(ln_w), in<bf16>(ln_b), in<bf16>(w1), nullptr, in<bf16>(b1),
                  in<bf16>(w2), nullptr, in<bf16>(b2), static_cast<bf16*>(out),
                  static_cast<bf16*>(x2), static_cast<bf16*>(hidden), static_cast<float*>(work),
                  M, C, H, splits_o, splits_1, splits_2, gelu_sigmoid, eps, (cudaStream_t)stream);
}

// rq_fused_proj_mlp_splitk with int8 wo_q / w1_q / w2_q (same shapes) and bf16
// column scales wo_s [C], w1_s [H], w2_s [C].
extern "C" int rq_fused_proj_mlp_q8_splitk(const void* x, const void* y, const void* wo_q,
                                    const void* wo_s, const void* bo, const void* ln_w,
                                    const void* ln_b, const void* w1_q, const void* w1_s,
                                    const void* b1, const void* w2_q, const void* w2_s,
                                    const void* b2, void* out, void* x2, void* hidden,
                                    void* work, int M, int C, int H, int splits_o,
                                    int splits_1, int splits_2, int gelu_sigmoid, float eps,
                                    void* stream) {
  return proj_mlp(in<bf16>(x), in<bf16>(y), in<int8_t>(wo_q), in<bf16>(wo_s), in<bf16>(bo),
                  in<bf16>(ln_w), in<bf16>(ln_b), in<int8_t>(w1_q), in<bf16>(w1_s),
                  in<bf16>(b1), in<int8_t>(w2_q), in<bf16>(w2_s), in<bf16>(b2),
                  static_cast<bf16*>(out), static_cast<bf16*>(x2), static_cast<bf16*>(hidden),
                  static_cast<float*>(work), M, C, H, splits_o, splits_1, splits_2,
                  gelu_sigmoid, eps, (cudaStream_t)stream);
}
