// Device code shared by the fused decode-layer kernels on Hopper (sm_90a):
// csrc/decode_megakernel.cu (a whole body layer step in one launch) and
// rq_decode_attention_q8_update_wo in csrc/decode_attention_q8.cu (the q8
// attention with the output projection, residual and LN2 folded in). The
// warp helpers and the head-slice lane mapping (HeadSlice) also serve the
// decode attention kernels of csrc/decode_attention.cu and
// csrc/decode_attention_q8.cu.
//
// Both are one cooperative persistent launch: the grid is as large as the
// card can hold at once (occupancy x SMs, so cudaLaunchCooperativeKernel
// can guarantee that every block is resident), each phase walks its work
// units with a block-stride loop, and a grid-wide barrier
// (cooperative_groups grid.sync) separates phases that need all of the
// previous phase's output: a projection needs every column of its input
// row, LN needs a whole row, attention needs q/k/v of its head. Results
// that cross a barrier live in a small global workspace the wrapper
// allocates (fp32 split-K partial sums and bf16 activations, a few MB that
// stay in the 50 MB L2).
//
// GEMM tile: out[m, n] = sum_k a[m, k] * w[n, k] for up to 128 rows of a
// (bf16 [M, K]) and 64 columns of w (bf16 or int8 [N, K], the nn.Linear
// layout), over one split of the reduction dimension; the fp32 partial sum
// goes to part[split, m, n] and the consumer phase adds the splits in a
// fixed order (deterministic). Chunks of 64 k are staged into shared
// memory with cp.async, two stages deep, so the next chunk's weight bytes
// are in flight while the tensor cores (wmma bf16 16x16x16, fp32
// accumulation) work on this one; each of the 4 warps owns 16 output
// columns. int8 weight chunks are widened to bf16 in shared memory (exact),
// so the product is the one of the dequantized weight before its scale.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace fused {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kHeadSize = 64;  // 2 values per lane of one warp
constexpr int kBM = 128;       // activation rows per GEMM tile
constexpr int kBN = 64;        // output columns per GEMM tile (16 per warp)
constexpr int kBK = 64;        // reduction chunk staged through shared memory
constexpr int kLD = kBK + 8;   // padded row stride of a staged bf16 tile (elements)
constexpr int kMFrag = kBM / 16;
constexpr int kKFrag = kBK / 16;
constexpr int kMaxSplits = 8;  // split-K factor cap: bounds the partial-sum workspace
// cache rows a warp loads before it reduces the first: a persistent grid
// holds ~12 warps per SM, so each needs many loads in flight to stream
constexpr int kRowBatch = 32;

// the dynamic shared memory of one block: two stages of the activation and
// weight chunks, an int8 staging area, and one 16x16 fp32 tile per warp for
// ragged stores; the attention phases reuse it for their scores
struct Smem {
  bf16 a[2][kBM * kLD];
  bf16 b[2][kBN * kLD];
  int8_t bq[2][kBN * kBK];
  float c[kWarps][16 * 16];
};
constexpr int kSmemBytes = (int)sizeof(Smem);
// the attention phases give each warp window + 1 floats of it for scores
constexpr int kMaxWindow = kSmemBytes / (int)sizeof(float) / kWarps - 1;

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

// a load of data another block wrote before the last grid barrier: through
// L2 only, never a stale L1 line
__device__ __forceinline__ float2 load_bf16x2_cg(const bf16* p) {
  return __bfloat1622float2(__ldcg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One warp holds one attention head: lane i the kVec neighbouring columns
// kVec i .. kVec i + kVec - 1, so a warp reads a head slice of a cache row
// in one coalesced load (64: 32 lanes of 2 values; 104: 26 lanes of 4, 6
// lanes idle). Idle lanes load nothing and hold zeros.
template <int kHeadSize>
struct HeadSlice {
  static constexpr int kVec = kHeadSize <= 64 ? 2 : 4;  // values per lane
  static constexpr int kLanes = kHeadSize / kVec;        // lanes that hold the head
  static_assert(kHeadSize % kVec == 0 && kLanes <= 32, "a head must fit one warp");
  static __device__ __forceinline__ bool active(int lane) { return kLanes == 32 || lane < kLanes; }
};

struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};

// kVec bf16 values at p (4- or 8-byte aligned) as floats; zeros when !active
template <int kVec>
__device__ __forceinline__ void load_bf16v(const bf16* p, bool active, float (&out)[kVec]) {
  static_assert(kVec == 2 || kVec == 4, "2 or 4 values per lane");
  if (!active) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = 0.f;
  } else if constexpr (kVec == 2) {
    const float2 f = load_bf16x2(p);
    out[0] = f.x;
    out[1] = f.y;
  } else {
    const bf16x4 v = *reinterpret_cast<const bf16x4*>(p);
    const float2 lo = __bfloat1622float2(v.lo), hi = __bfloat1622float2(v.hi);
    out[0] = lo.x;
    out[1] = lo.y;
    out[2] = hi.x;
    out[3] = hi.y;
  }
}

// kVec floats rounded to bf16 at p (4- or 8-byte aligned)
template <int kVec>
__device__ __forceinline__ void store_bf16v(bf16* p, const float (&v)[kVec]) {
  static_assert(kVec == 2 || kVec == 4, "2 or 4 values per lane");
  if constexpr (kVec == 2) {
    store_bf16x2(p, v[0], v[1]);
  } else {
    bf16x4 o;
    o.lo = __floats2bfloat162_rn(v[0], v[1]);
    o.hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<bf16x4*>(p) = o;
  }
}

// kVec bf16 values copied bit for bit from src to dst (4- or 8-byte aligned)
template <int kVec>
__device__ __forceinline__ void copy_bf16v(bf16* dst, const bf16* src) {
  static_assert(kVec == 2 || kVec == 4, "2 or 4 values per lane");
  if constexpr (kVec == 2) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = *reinterpret_cast<const __nv_bfloat162*>(src);
  } else {
    *reinterpret_cast<bf16x4*>(dst) = *reinterpret_cast<const bf16x4*>(src);
  }
}

// kVec int8 values of one lane, kept packed in a register until used
template <int kVec>
using I8v = typename std::conditional<kVec == 2, char2, char4>::type;

template <int kVec>
__device__ __forceinline__ I8v<kVec> load_i8v(const int8_t* p, bool active) {
  I8v<kVec> v{};
  if (active) v = *reinterpret_cast<const I8v<kVec>*>(p);
  return v;
}

__device__ __forceinline__ void to_float(char2 v, float (&out)[2]) {
  out[0] = (float)v.x;
  out[1] = (float)v.y;
}

__device__ __forceinline__ void to_float(char4 v, float (&out)[4]) {
  out[0] = (float)v.x;
  out[1] = (float)v.y;
  out[2] = (float)v.z;
  out[3] = (float)v.w;
}

// this lane's part of <a, b>, in pairs: a0 b0 + a1 b1 (+ a2 b2 + a3 b3)
template <int kVec>
__device__ __forceinline__ float dot_lane(const float (&a)[kVec], const float (&b)[kVec]) {
  float d = a[0] * b[0] + a[1] * b[1];
#pragma unroll
  for (int i = 2; i < kVec; i += 2) d += a[i] * b[i] + a[i + 1] * b[i + 1];
  return d;
}

// sum of the whole block's v, in a fixed order; every thread gets it. red:
// kWarps floats of shared memory
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red is free: every thread has read its last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w];
  return s;
}

// the fp32 sum over `splits` partials [splits, stride] at idx, idx + 1
__device__ __forceinline__ float2 sum_parts2(const float* part, int splits, size_t stride, size_t idx) {
  float2 s = make_float2(0.f, 0.f);
  for (int i = 0; i < splits; ++i) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(part + i * stride + idx));
    s.x += v.x;
    s.y += v.y;
  }
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// every committed group but the most recent one has landed
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// stage chunk [k, k + kBK) of rows m0 .. m0 + rows_pad of a (rows >= M are
// zero-filled, nothing is read for them) and of columns n0 .. n0 + kBN of w
template <typename WT>
__device__ __forceinline__ void load_chunk(Smem& sm, int st, const bf16* a, int M, int K, int m0,
                                           int rows_pad, const WT* w, int n0, int k) {
  for (int i = threadIdx.x; i < rows_pad * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8);
    const int c = (i % (kBK / 8)) * 8;
    const bool ok = m0 + r < M;
    cp_async16(&sm.a[st][r * kLD + c], a + (size_t)(ok ? m0 + r : 0) * K + k + c, ok);
  }
  if constexpr (std::is_same<WT, int8_t>::value) {
    for (int i = threadIdx.x; i < kBN * (kBK / 16); i += kThreads) {
      const int r = i / (kBK / 16);
      const int c = (i % (kBK / 16)) * 16;
      cp_async16(&sm.bq[st][r * kBK + c], w + (size_t)(n0 + r) * K + k + c, true);
    }
  } else {
    for (int i = threadIdx.x; i < kBN * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      cp_async16(&sm.b[st][r * kLD + c], w + (size_t)(n0 + r) * K + k + c, true);
    }
  }
}

// part[m, n] = sum over k in [k_begin, k_begin + k_len) of a[m, k] * w[n, k]
// for rows m0 .. min(m0 + kBM, M) and columns n0 .. n0 + kBN; part is the
// [M, N] slab of this split. k_len % kBK == 0, N % kBN == 0.
template <typename WT>
__device__ void gemm_tile(Smem& sm, const bf16* a, const WT* w, float* part, int M, int N, int K,
                          int m0, int n0, int k_begin, int k_len) {
  using namespace nvcuda;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = min(kBM, M - m0);
  const int mfrags = (rows + 15) / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMFrag];
#pragma unroll
  for (int i = 0; i < kMFrag; ++i) wmma::fill_fragment(acc[i], 0.f);

  const int n_chunks = k_len / kBK;
  load_chunk<WT>(sm, 0, a, M, K, m0, mfrags * 16, w, n0, k_begin);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    if (c + 1 < n_chunks) load_chunk<WT>(sm, st ^ 1, a, M, K, m0, mfrags * 16, w, n0, k_begin + (c + 1) * kBK);
    cp_async_commit();  // (an empty group on the last chunk)
    cp_async_wait_1();
    __syncthreads();
    bf16* bw = sm.b[st] + warp * 16 * kLD;
    if constexpr (std::is_same<WT, int8_t>::value) {
      // widen this warp's 16 weight rows (its output columns) to bf16
      const int8_t* q = sm.bq[st] + warp * 16 * kBK;
      for (int e = lane; e < 16 * (kBK / 4); e += 32) {
        const int n = e / (kBK / 4);
        const int k = (e % (kBK / 4)) * 4;
        const char4 v = *reinterpret_cast<const char4*>(q + n * kBK + k);
        store_bf16x2(bw + n * kLD + k, (float)v.x, (float)v.y);
        store_bf16x2(bw + n * kLD + k + 2, (float)v.z, (float)v.w);
      }
      __syncwarp();
    }
#pragma unroll
    for (int kk = 0; kk < kKFrag; ++kk) {
      // B(k, n) = w[n0 + 16 warp + n, k]: column-major in the staged tile
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
      wmma::load_matrix_sync(bfr, bw + kk * 16, kLD);
#pragma unroll
      for (int i = 0; i < kMFrag; ++i) {
        if (i < mfrags) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
          wmma::load_matrix_sync(afr, sm.a[st] + i * 16 * kLD + kk * 16, kLD);
          wmma::mma_sync(acc[i], afr, bfr, acc[i]);
        }
      }
    }
    __syncthreads();  // stage st is free for the chunk after next
  }

  const int col = n0 + warp * 16;
#pragma unroll
  for (int i = 0; i < kMFrag; ++i) {
    if (i >= mfrags) continue;
    if (i * 16 + 16 <= rows) {
      wmma::store_matrix_sync(part + (size_t)(m0 + i * 16) * N + col, acc[i], N, wmma::mem_row_major);
    } else {  // the ragged last fragment: through shared memory, rows < M only
      wmma::store_matrix_sync(sm.c[warp], acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = i * 16 + e / 16;
        if (r < rows) part[(size_t)(m0 + r) * N + col + (e % 16)] = sm.c[warp][e];
      }
      __syncwarp();
    }
  }
}

// one GEMM phase: every (row tile, column tile, split) unit, block-stride;
// part is [splits, M, N]
template <typename WT>
__device__ void gemm_phase(Smem& sm, const bf16* a, const WT* w, float* part, int M, int N, int K,
                           int splits) {
  const int n_mt = (M + kBM - 1) / kBM;
  const int n_nt = N / kBN;
  const int k_len = K / splits;
  const int units = n_mt * n_nt * splits;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int s = u % splits;
    const int nt = (u / splits) % n_nt;
    const int mt = u / splits / n_nt;
    gemm_tile<WT>(sm, a, w, part + (size_t)s * M * N, M, N, K, mt * kBM, nt * kBN, s * k_len, k_len);
  }
}

// y = LayerNorm(xr) of one row of C values, one-pass fp32 statistics (mean
// and E[x^2]) as model.layer_norm, cast to bf16. xr may be data this block
// wrote itself (ordered by block_sum's barriers).
__device__ __forceinline__ void layer_norm_row(const bf16* xr, const bf16* w, const bf16* b, bf16* y,
                                               int C, float eps, float* red) {
  float s1 = 0.f, s2 = 0.f;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * kThreads) {
    const float2 v = load_bf16x2_cg(xr + c);
    s1 += v.x + v.y;
    s2 += v.x * v.x + v.y * v.y;
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  const float mean = s1 / (float)C;
  const float var = fmaxf(s2 / (float)C - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int c = 2 * threadIdx.x; c < C; c += 2 * kThreads) {
    const float2 v = load_bf16x2_cg(xr + c);
    const float2 g = load_bf16x2(w + c);
    const float2 bb = load_bf16x2(b + c);
    store_bf16x2(y + c, (v.x - mean) * rstd * g.x + bb.x, (v.y - mean) * rstd * g.y + bb.y);
  }
}

// row r of a projection's epilogue, residual and LayerNorm:
//   x2[r] = bf16(x[r] + bf16(proj * scale + bias)),  proj = sum over splits of part[., r]
//   h[r]  = LayerNorm(x2[r])
// (scale null: 1). part is [splits, M, C].
__device__ void residual_ln_row(const float* part, int splits, const bf16* scale, const bf16* bias,
                                const bf16* x, bf16* x2, const bf16* ln_w, const bf16* ln_b, bf16* h,
                                int r, int M, int C, float eps, float* red) {
  for (int c = 2 * threadIdx.x; c < C; c += 2 * kThreads) {
    float2 p = sum_parts2(part, splits, (size_t)M * C, (size_t)r * C + c);
    if (scale != nullptr) {
      const float2 s = load_bf16x2(scale + c);
      p.x *= s.x;
      p.y *= s.y;
    }
    const float2 b = load_bf16x2(bias + c);
    const float2 xv = load_bf16x2(x + (size_t)r * C + c);
    store_bf16x2(x2 + (size_t)r * C + c, xv.x + round_bf16(p.x + b.x), xv.y + round_bf16(p.y + b.y));
  }
  layer_norm_row(x2 + (size_t)r * C, ln_w, ln_b, h + (size_t)r * C, C, eps, red);
}

// host side: the split-K factor of a GEMM phase with `tiles` (row, column)
// tiles and K / kBK chunks, so that its units fill the grid once
inline int pick_splits(int tiles, int K, int grid) {
  const int chunks = K / kBK;
  int s = grid / tiles;
  s = s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s);
  if (s > chunks) s = chunks;
  while (chunks % s) --s;
  return s;
}

// host side: the largest grid of `kernel` (kThreads threads, kSmemBytes of
// dynamic shared memory) whose blocks are all resident at once, cached per
// device; 0 on success, else a cudaError_t
inline int coop_grid(const void* kernel, int* cache, int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 16 && cache[dev] > 0) {
    *grid = cache[dev];
    return 0;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = per_sm * sms;
  if (dev < 16) cache[dev] = *grid;
  return 0;
}

}  // namespace fused
