// The weight-chunk ring and the tensor-core helpers shared by the
// weight-streaming MLP kernels on Hopper (sm_90a): csrc/q8_pipeline.cu
// (#17-#20), csrc/w8a8.cu (#16) and csrc/mlp.cu (#15).
//
// All of them are one cooperative persistent launch of one block per SM
// (kMlpWarps warps). The unit of the weight stream is the chunk, the hidden
// slice whose w1 rows and w2 columns travel together, as on the TPU. Each
// chunk is split across the blocks: block b owns a balanced range of 8-row
// tiles of the chunk's w1 rows (its hidden units) and a range of 8-row
// tiles of w2's rows (its output columns, the same for every chunk). A
// stage is the block's share of one chunk: n1 * 8 rows of C weights and
// n2 * 8 rows of `chunk` weights, each row padded by 16 bytes. n_buf
// stages are kept in flight with 16-byte cp.async.cg copies, one commit
// group per chunk (Ring). Activations are the A operand of the products,
// read from L2 (they are written by other blocks before a grid barrier);
// warp w takes rows 16 w .. 16 w + 15 of a row group of kGroupRows rows.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fused_layer.cuh"

namespace ring {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kMlpWarps = 8;  // one 16-row tile of activations per warp
constexpr int kMlpThreads = kMlpWarps * 32;
constexpr int kGroupRows = kMlpWarps * 16;  // activation rows of one pass over the warps
constexpr int kMaxGroups = 4;               // row groups a block keeps sums for: M <= 512

constexpr int kNT = 4;       // most 8-row tiles a block owns in one share
constexpr int kRowPad = 16;  // bytes after each staged row

// block b's balanced share [lo, lo + n) of `tiles` tiles over G blocks
__device__ __forceinline__ void share(int tiles, int b, int G, int& lo, int& n) {
  lo = (int)((long long)b * tiles / G);
  n = (int)((long long)(b + 1) * tiles / G) - lo;
}

// the largest share of `tiles` tiles over G blocks (host side too)
__host__ __device__ __forceinline__ int max_share(int tiles, int G) { return (tiles + G - 1) / G; }

__host__ __device__ __forceinline__ size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }

// one stage: w1 rows (n1max * 8 rows of C weights) then w2 rows (n2max * 8
// rows of chunk weights); ld1 / ld2 are row strides in bytes
struct StageGeom {
  int ld1, ld2;
  size_t off2, bytes;
};

__host__ __device__ __forceinline__ StageGeom stage_geom(int C, int chunk, int wbytes, int G) {
  StageGeom s;
  s.ld1 = C * wbytes + kRowPad;
  s.ld2 = chunk * wbytes + kRowPad;
  s.off2 = align16((size_t)max_share(chunk / 8, G) * 8 * s.ld1);
  s.bytes = s.off2 + align16((size_t)max_share(C / 8, G) * 8 * s.ld2);
  return s;
}

// cp.async.wait_group with a run-time depth (n_buf - 1 <= 7)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// The weight stream of one block: where chunk j's share lives in device
// memory and in which stage it lands. w1 [H, C] (or packed [nc, chunk, C],
// the same bytes); w2 [C, H] (packed false: chunk j is the columns
// j*chunk.., a strided block) or packed [nc, C, chunk] (one contiguous
// block). Byte addressing; wbytes is the element size.
struct Ring {
  const unsigned char* w1;
  const unsigned char* w2;
  unsigned char* smem;
  StageGeom g;
  int C, H, chunk, wbytes, n_buf, lo1, n1, lo2, n2;
  bool packed;

  __device__ unsigned char* stage1(int slot) const { return smem + (size_t)slot * g.bytes; }
  __device__ unsigned char* stage2(int slot) const { return smem + (size_t)slot * g.bytes + g.off2; }

  // issue the 16-byte copies of chunk j's share into stage `slot` (no commit)
  __device__ void issue(int slot, int j) const {
    const int row1 = C * wbytes / 16, row2 = chunk * wbytes / 16;  // 16-byte pieces per row
    const int r1 = n1 * 8, r2 = n2 * 8;
    unsigned char* s1 = stage1(slot);
    unsigned char* s2 = stage2(slot);
    const unsigned char* src1 = w1 + ((size_t)j * chunk + (size_t)lo1 * 8) * C * wbytes;
    for (int i = threadIdx.x; i < r1 * row1; i += blockDim.x) {
      const int r = i / row1, c = i % row1;
      fused::cp_async16(s1 + (size_t)r * g.ld1 + c * 16, src1 + (size_t)r * C * wbytes + c * 16, true);
    }
    for (int i = threadIdx.x; i < r2 * row2; i += blockDim.x) {
      const int r = i / row2, c = i % row2;
      const size_t col = (size_t)lo2 * 8 + r;  // a row of w2: an output column
      const size_t off = packed ? ((size_t)j * C + col) * chunk : col * H + (size_t)j * chunk;
      fused::cp_async16(s2 + (size_t)r * g.ld2 + c * 16, w2 + off * wbytes + c * 16, true);
    }
  }

  // fill the ring: chunks 0 .. n_buf-1, one commit group each (empty past nc)
  __device__ void prologue(int nc) const {
    for (int s = 0; s < n_buf; ++s) {
      if (s < nc) issue(s, s);
      fused::cp_async_commit();
    }
  }

  // wait until chunk j has landed in its stage, for the whole block: n_buf +
  // j groups are committed, the oldest j + 1 must be complete
  __device__ void wait() const {
    cp_async_wait(n_buf - 1);
    __syncthreads();
  }

  // after every read of chunk j's stage: refill it with chunk j + n_buf
  // (always one commit, so the group count stays n_buf + j + 1)
  __device__ void refill(int j, int nc) const {
    __syncthreads();
    if (j + n_buf < nc) issue(j % n_buf, j + n_buf);
    fused::cp_async_commit();
  }
};

// block b's ring over G blocks for weights of wbytes bytes each
__device__ __forceinline__ Ring make_ring(const void* w1, const void* w2, unsigned char* smem, int C, int H,
                                          int chunk, int wbytes, int n_buf, bool packed, int b, int G) {
  Ring r;
  r.w1 = static_cast<const unsigned char*>(w1);
  r.w2 = static_cast<const unsigned char*>(w2);
  r.smem = smem;
  r.g = stage_geom(C, chunk, wbytes, G);
  r.C = C;
  r.H = H;
  r.chunk = chunk;
  r.wbytes = wbytes;
  r.n_buf = n_buf;
  r.packed = packed;
  share(chunk / 8, b, G, r.lo1, r.n1);
  share(C / 8, b, G, r.lo2, r.n2);
  return r;
}

__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&v);
}

// eight neighbouring weights of a row (8-byte aligned int8, 16-byte aligned
// bf16) as the two B-fragment register pairs of two k-steps
template <typename WT>
__device__ __forceinline__ void b_octet(const unsigned char* row, int k, unsigned (&b)[4]) {
  if constexpr (std::is_same<WT, int8_t>::value) {
    const int2 v = *reinterpret_cast<const int2*>(row + k);
    const int w[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 2; ++i)  // int8 -> bf16, exact
      b[2 * i] = pack_bf16x2((float)(int8_t)w[i], (float)(int8_t)(w[i] >> 8)),
      b[2 * i + 1] = pack_bf16x2((float)(int8_t)(w[i] >> 16), (float)(int8_t)(w[i] >> 24));
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(row + 2 * k);
    b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
  }
}

__device__ __forceinline__ uint4 a_octet(const bf16* a, size_t lda, int row, int M, int k) {
  return row < M ? __ldcg(reinterpret_cast<const uint4*>(a + (size_t)row * lda + k)) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void mma16816(float (&d)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[n] += A[rows 16 warp .. 16 warp + 16, 0:K] @ W[8 n .. 8 n + 8, 0:K]^T
// for n < nt; K % 32 == 0. A: bf16 rows of stride lda (read through L2;
// rows >= M are zeros). W: rows of stride ldw bytes, in shared or device
// memory. Lane 4 g + q holds rows g and g + 8 (of A) and g (of W), and
// reads the eight neighbouring k 8q .. 8q + 7 of each 32-wide k block in
// one load: the first k-step takes 8q .. 8q + 3 where m16n8k16 expects k
// 2q, 2q + 1, 2q + 8, 2q + 9, the second 8q + 4 .. 8q + 7. A and W see the
// same permutation of k, so the sums are those of the plain order, up to
// fp32 association; the fragment sums rows g, g + 8 x columns 2q, 2q + 1.
// The A loads of kU k blocks are issued together: the loop is bound by the
// latency of L2, so the loads in flight set its pace.
template <typename WT, int kU = 8>
__device__ __forceinline__ void mma_rows(float (&acc)[kNT][4], const bf16* A, size_t lda, int M,
                                         const unsigned char* W, int ldw, int nt, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = 16 * warp + g;
  if (16 * warp >= M) return;
  for (int k = 0; k < K; k += 32 * kU) {
    uint4 a[kU][2];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = k + 32 * u + 8 * q;
      const bool ok = kk < K;
      a[u][0] = a_octet(A, lda, ok ? r0 : M, M, kk);
      a[u][1] = a_octet(A, lda, ok ? r0 + 8 : M, M, kk);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = k + 32 * u + 8 * q;
      if (k + 32 * u >= K) break;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        if (n < nt) {
          unsigned b[4];
          b_octet<WT>(W + (size_t)(8 * n + g) * ldw, kk, b);
          mma16816(acc[n], a[u][0].x, a[u][1].x, a[u][0].y, a[u][1].y, b[0], b[1]);
          mma16816(acc[n], a[u][0].z, a[u][1].z, a[u][0].w, a[u][1].w, b[2], b[3]);
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void zero(T (&acc)[kNT][4]) {
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0;
}

// f(row, col, v0, v1) for each pair of neighbouring sums this lane holds
// (rows < M only); col is the first of the two columns within the share
template <typename T, typename F>
__device__ __forceinline__ void for_pairs(const T (&acc)[kNT][4], int nt, int M, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = 16 * warp + (lane >> 2);
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    if (n >= nt) continue;
    const int col = 8 * n + 2 * (lane & 3);
    if (row < M) f(row, col, acc[n][0], acc[n][1]);
    if (row + 8 < M) f(row + 8, col, acc[n][2], acc[n][3]);
  }
}

__device__ __forceinline__ float2 load2(const bf16* p) { return fused::load_bf16x2(p); }
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// (mean, 1 / sqrt(var + eps)) of one row of C bf16 values (C even),
// one-pass fp32 statistics (mean and E[x^2], var clamped at 0) as
// fused::layer_norm_row, over this kernel's kMlpThreads; red: 2 kMlpWarps
// floats of shared memory, free on entry and on return
__device__ __forceinline__ float2 row_stats(const bf16* xr, int C, float eps, float* red) {
  float s1 = 0.f, s2 = 0.f;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * kMlpThreads) {
    const float2 v = fused::load_bf16x2_cg(xr + c);
    s1 += v.x + v.y;
    s2 += v.x * v.x + v.y * v.y;
  }
  s1 = fused::warp_sum(s1);
  s2 = fused::warp_sum(s2);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s1, red[kMlpWarps + (threadIdx.x >> 5)] = s2;
  __syncthreads();
  s1 = s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kMlpWarps; ++i) s1 += red[i], s2 += red[kMlpWarps + i];
  __syncthreads();  // every thread has read red
  const float mean = s1 / (float)C;
  return make_float2(mean, rsqrtf(fmaxf(s2 / (float)C - mean * mean, 0.f) + eps));
}

// y = LayerNorm(xr) of one row of C values (C even), cast to bf16; the
// scale and bias bf16 or fp32
template <typename PT>
__device__ void layer_norm_row(const bf16* xr, const PT* w, const PT* b, bf16* y, int C, float eps, float* red) {
  const float2 st = row_stats(xr, C, eps, red);
  for (int c = 2 * threadIdx.x; c < C; c += 2 * kMlpThreads) {
    const float2 v = fused::load_bf16x2_cg(xr + c);
    const float2 g = load2(w + c), bb = load2(b + c);
    fused::store_bf16x2(y + c, (v.x - st.x) * st.y * g.x + bb.x, (v.y - st.x) * st.y * g.y + bb.y);
  }
}

template <int kGelu>
__device__ __forceinline__ float gelu(float t) {
  if constexpr (kGelu == 1) return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
  if constexpr (kGelu == 2) return t / (1.f + expf(-1.702f * t));
  return t;
}

// host side: the per-kernel launch state (dynamic shared memory set, and
// whether the grid fits at once), so that a launch inside a CUDA-graph
// capture makes no attribute or occupancy call once the same shape ran
struct LaunchCache {
  const void* kernel;
  int dev;
  size_t smem;
};
static LaunchCache launch_cache[64];
static int n_cached = 0;

// a cooperative launch of `grid` blocks with `smem` bytes of dynamic shared
// memory; cudaErrorInvalidValue when the block cannot hold that much,
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident at once
inline int coop_launch(const void* kernel, int grid, int threads, size_t smem, void** args, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  bool known = false;
  for (int i = 0; i < n_cached; ++i)
    if (launch_cache[i].kernel == kernel && launch_cache[i].dev == dev && launch_cache[i].smem >= smem) known = true;
  if (!known) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (n_cached < 64) launch_cache[n_cached++] = {kernel, dev, smem};
  }
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

}  // namespace ring
