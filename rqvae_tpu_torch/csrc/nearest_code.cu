// Nearest codebook entry (fp32-accurate distance + argmin) for residual
// quantization, on Hopper (sm_90a), with the products on the tensor cores
// in 3xTF32.
//
// Replaces the TPU kernel rqvae_tpu/ops/rq_kernel.py::_nearest_code_pallas
// (body _nearest_kernel).
//
// What it computes, for every row x_n of x [N, dim] against cb [E, dim]:
//   code[n] = argmin_e  cb_sq[e] - 2 <x_n, c_e>,   cb_sq[e] = <c_e, c_e>
// the ||x_n||^2 term left out as in the JAX kernel (it does not move the
// argmin), ties to the lowest e. The JAX kernel asks for fp32
// (Precision.HIGHEST: no TF32, no bf16); cb_sq is summed in fp32 here, the
// dot products in 3xTF32, which keeps fp32's accuracy within a few ulps.
//
// Bound on the H100: operations. At the encode path's shapes (N = 6400
// rows, dim 256, E = 16384) the dot products are 2 N E dim = 53.7 GFLOP
// against ~23 MB of inputs: 0.80 ms at the 67 TFLOP/s fp32 (SIMT) peak. On
// the tensor cores a TF32 product keeps 11 bits of each operand, so each
// operand v is split into hi = tf32(v) and lo = tf32(v - hi) (hi + lo keeps
// ~22 of fp32's 24 bits) and x.c = x_lo.c_hi + x_hi.c_lo + x_hi.c_hi (the
// x_lo.c_lo term, below fp32's last bit, is dropped): 3 x 53.7 GFLOP, 0.326
// ms at the 495 TFLOP/s dense TF32 peak.
//
// Design, three launches:
// 1. split_kernel, one warp a row: x and cb into [rows, 2 ldk] fp32
//    scratch, hi in columns [0, ldk), lo in [ldk, 2 ldk) (cvt.rna.tf32.f32,
//    ldk = dim rounded up to 32, the pad zero), and cb_sq[e] in fp32 from
//    the raw values in one fixed order for every code (lane-strided fmaf,
//    then a butterfly); codes past E (up to the last 256-code tile) get
//    cb_sq = +inf, so they are never picked and need no mask.
// 2. nearest_kernel: a persistent grid (one CTA an SM) over units = (row
//    block of 128 rows, code tile of 256 codes), unit u = (u mod row blocks,
//    u div row blocks), so the CTAs in flight share a few code tiles and
//    all of x in L2. A producer warp issues, per 32-wide K stage, four TMA
//    tiles with the 128-byte swizzle (x_hi, x_lo [128 x 32], cb_hi, cb_lo
//    [256 x 32]; 96 KB) into a ring of two stages (192 KB) with full/empty
//    mbarriers. Two consumer warpgroups each own 64 of the rows and all 256
//    codes: per k8 step three wgmma.m64n256k8.f32.tf32 into one fp32
//    accumulator (128 registers a thread), the small terms first: x_lo.c_hi,
//    x_hi.c_lo, x_hi.c_hi. Every code column gets the same split and the
//    same sequence of products, so two equal codebook rows give
//    bit-identical distances. The x tile cannot stay resident instead: x_hi
//    + x_lo of 128 rows x 256 dims is 256 KB, over the 227 KB a block may
//    hold (64 rows would leave 99 KB for one 64 KB codebook stage and no
//    second one).
//    Epilogue per unit, in registers: d = cb_sq[e] - 2 acc folded into a
//    running (d, e) per row over the thread's 64 columns in ascending e
//    (strict <), then the lexicographic (d, e) minimum over the 4 lanes
//    that share a row in the wgmma fragment; one partial per (code tile,
//    row). The next unit's stages are already in flight.
// 3. nearest_code_reduce_kernel: the lexicographic (d, e) minimum of a
//    row's partials, which gives the first index among equal distances
//    whatever order the tiles ran in.
// Ragged edges: TMA reads rows past N or E as zeros (their rows are not
// written, their codes cost +inf); columns past dim are zero in both
// operands. NaN distances are never picked; a row with no finite distance
// gets code 0.
//
// The ring, the TMA and mbarrier helpers, the swizzled descriptors and the
// wgmma forms are decode_dense.cuh's; the tensor maps come from
// csrc/decode_dense.cu::rq_dense_tensor_map (fp32, 32-column boxes).

#include "decode_dense.cuh"

namespace {

constexpr int kRowBlock = 128;                             // x rows per unit: 64 per consumer warpgroup
constexpr int kCodeTile = 256;                             // codes per unit: the wgmma N
constexpr int kKStage = 32;                                // fp32 per stage row: 128 bytes, four k8 steps
constexpr int kRing = 2;                                   // stages
constexpr int kXTile = kRowBlock * kKStage * 4;            // x_hi or x_lo of a stage: 16 KB
constexpr int kCTile = kCodeTile * kKStage * 4;            // cb_hi or cb_lo of a stage: 32 KB
constexpr int kStage = 2 * kXTile + 2 * kCTile;            // 96 KB
constexpr int kSmem = kRing * kStage + 2 * kRing * 8 + 1024;  // + the mbarriers and alignment slack
constexpr int kNoCode = 0x7fffffff;

__device__ __forceinline__ bool before(float d, int e, float best_d, int best_e) {
  return d < best_d || (d == best_d && e < best_e);
}

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

// One warp a row: rows [0, N) of x, then [N, N + E) of cb, then cb_sq's pad
// up to e_pad codes. A row's hi / lo go to dst [rows, 2 ldk].
__global__ void split_kernel(const float* __restrict__ x, const float* __restrict__ cb, float* __restrict__ xs,
                             float* __restrict__ cs, float* __restrict__ cb_sq, int N, int E, int e_pad, int dim,
                             int ldk) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= N + e_pad) return;
  if (row >= N + E) {
    if (lane == 0) cb_sq[row - N] = INFINITY;
    return;
  }
  const bool code = row >= N;
  const float* src = code ? cb + (size_t)(row - N) * dim : x + (size_t)row * dim;
  float* dst = code ? cs + (size_t)(row - N) * 2 * ldk : xs + (size_t)row * 2 * ldk;
  float s = 0.f;
  for (int k = lane; k < ldk; k += 32) {
    const float v = k < dim ? src[k] : 0.f;
    const float hi = tf32_rna(v);
    dst[k] = hi;
    dst[ldk + k] = tf32_rna(v - hi);
    s = fmaf(v, v, s);
  }
  if (!code) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) cb_sq[row - N] = s;
}

__global__ void __launch_bounds__(kThreads, 1)
    nearest_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap cb_map,
                   const float* __restrict__ cb_sq, float* __restrict__ part_d, int* __restrict__ part_e, int N,
                   int row_blocks, int code_tiles, int ldk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + kRing * kStage;  // full[kRing], then empty[kRing]
  const uint32_t empty = full + kRing * 8;
  const int units = row_blocks * code_tiles;
  const int k_stages = ldk / kKStage;

  if (threadIdx.x == 0) {  // full: the producer's arrival; empty: lane 0 of each of the 8 consumer warps
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + i * 8, 1);
      mbar_init(empty + i * 8, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int row0 = (u % row_blocks) * kRowBlock;
        const int code0 = (u / row_blocks) * kCodeTile;
        for (int kc = 0; kc < k_stages; ++kc, ++it) {
          const int stage = it % kRing;
          const uint32_t bar = full + stage * 8;
          const uint32_t dst = base + stage * kStage;
          const int k0 = kc * kKStage;
          mbar_wait(empty + stage * 8, ((it / kRing) & 1) ^ 1);
          mbar_expect_tx(bar, kStage);
          tma_tile(dst, &x_map, k0, row0, bar);                            // x_hi
          tma_tile(dst + kXTile, &x_map, ldk + k0, row0, bar);             // x_lo
          tma_tile(dst + 2 * kXTile, &cb_map, k0, code0, bar);             // cb_hi
          tma_tile(dst + 2 * kXTile + kCTile, &cb_map, ldk + k0, code0, bar);  // cb_lo
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;  // rows 64 wg .. 64 wg + 63 of the block
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int r_lo = 64 * wg + 16 * warp + (lane >> 2);  // this thread's rows: r_lo and r_lo + 8
  float acc[kCodeTile / 2];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int rb = u % row_blocks;
    const int ct = u / row_blocks;
#pragma unroll
    for (int i = 0; i < kCodeTile / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kc = 0; kc < k_stages; ++kc, ++it) {
      const int stage = it % kRing;
      mbar_wait(full + stage * 8, (it / kRing) & 1);
      const uint32_t s0 = base + stage * kStage;
      const uint64_t a_hi = sw128_desc(s0 + wg * (kXTile / 2));
      const uint64_t a_lo = sw128_desc(s0 + kXTile + wg * (kXTile / 2));
      const uint64_t b_hi = sw128_desc(s0 + 2 * kXTile);
      const uint64_t b_lo = sw128_desc(s0 + 2 * kXTile + kCTile);
      fence_acc<kCodeTile / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKStage / 8; ++kk) {  // +32 bytes per k8
        wgmma_tf32_256(acc, a_lo + 2 * kk, b_hi + 2 * kk);
        wgmma_tf32_256(acc, a_hi + 2 * kk, b_lo + 2 * kk);
        wgmma_tf32_256(acc, a_hi + 2 * kk, b_hi + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before is read: release it
      if (prev >= 0 && lane == 0) mbar_arrive(empty + prev * 8);
      prev = stage;
    }
    wgmma_wait<0>();
    fence_acc<kCodeTile / 2>(acc);
    if (lane == 0) mbar_arrive(empty + prev * 8);

    // lane (warp, l) holds rows r_lo (acc[4 j], acc[4 j + 1]) and r_lo + 8
    // (acc[4 j + 2], acc[4 j + 3]) at codes 8 j + 2 q and 8 j + 2 q + 1
    const int e0 = ct * kCodeTile + 2 * q;
    float best_d[2] = {INFINITY, INFINITY};
    int best_e[2] = {kNoCode, kNoCode};
#pragma unroll
    for (int j = 0; j < kCodeTile / 8; ++j) {
      const float2 c = __ldg(reinterpret_cast<const float2*>(cb_sq + e0 + 8 * j));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d0 = c.x - 2.f * acc[4 * j + 2 * h];
        const float d1 = c.y - 2.f * acc[4 * j + 2 * h + 1];
        if (d0 < best_d[h]) {
          best_d[h] = d0;
          best_e[h] = e0 + 8 * j;
        }
        if (d1 < best_d[h]) {
          best_d[h] = d1;
          best_e[h] = e0 + 8 * j + 1;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float d = __shfl_xor_sync(0xffffffffu, best_d[h], o);
        const int e = __shfl_xor_sync(0xffffffffu, best_e[h], o);
        if (before(d, e, best_d[h], best_e[h])) {
          best_d[h] = d;
          best_e[h] = e;
        }
      }
      const int r = rb * kRowBlock + r_lo + 8 * h;
      if (q == 0 && r < N) {
        part_d[(size_t)ct * N + r] = best_d[h];
        part_e[(size_t)ct * N + r] = best_e[h];
      }
    }
  }
}

// code[n] = the lexicographic minimum of the code tiles' partials of row n
__global__ void nearest_code_reduce_kernel(const float* __restrict__ part_d, const int* __restrict__ part_e,
                                           int64_t* __restrict__ code, int N, int code_tiles) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float best_d = INFINITY;
  int best_e = kNoCode;
  for (int s = 0; s < code_tiles; ++s) {
    const float d = part_d[(size_t)s * N + n];
    const int e = part_e[(size_t)s * N + n];
    if (before(d, e, best_d, best_e)) {
      best_d = d;
      best_e = e;
    }
  }
  code[n] = best_e == kNoCode ? 0 : best_e;  // only a row of NaN (or +inf) distances keeps no code
}

}  // namespace

// x [N, dim], cb [E, dim]: fp32, contiguous. Scratch from the caller (the
// plan of ops/rq_kernel.py::nearest_plan): xs [N, 2 ldk] and cs [E, 2 ldk]
// fp32 (16-byte aligned) with their tensor maps x_map (boxes of 128 rows)
// and cb_map (256 rows) from rq_dense_tensor_map, cb_sq [code_tiles * 256]
// fp32, part_d [code_tiles, N] fp32, part_e [code_tiles, N] int32, with
// code_tiles = ceil(E / 256); ldk = dim rounded up to 32. Output code [N]
// int64. Three launches on `stream`, the main one on `grid` CTAs; returns
// the first CUDA error, else 0.
extern "C" int rq_nearest_code(const void* x, const void* cb, void* xs, void* cs, const void* x_map,
                               const void* cb_map, void* cb_sq, void* part_d, void* part_e, void* code, int N, int E,
                               int dim, int ldk, int grid, void* stream) {
  if (N < 1 || E < 1 || dim < 1 || ldk < dim || ldk % kKStage || grid < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int row_blocks = (N + kRowBlock - 1) / kRowBlock;
  const int code_tiles = (E + kCodeTile - 1) / kCodeTile;
  const int e_pad = code_tiles * kCodeTile;

  split_kernel<<<(N + e_pad + 7) / 8, 256, 0, s>>>(static_cast<const float*>(x), static_cast<const float*>(cb),
                                                   static_cast<float*>(xs), static_cast<float*>(cs),
                                                   static_cast<float*>(cb_sq), N, E, e_pad, dim, ldk);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  err = (int)allow_smem((const void*)nearest_kernel, kSmem);
  if (err != 0) return err;
  CUtensorMap xm, cm;
  memcpy(&xm, x_map, sizeof(xm));
  memcpy(&cm, cb_map, sizeof(cm));
  nearest_kernel<<<grid, kThreads, kSmem, s>>>(xm, cm, static_cast<const float*>(cb_sq), static_cast<float*>(part_d),
                                               static_cast<int*>(part_e), N, row_blocks, code_tiles, ldk);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  nearest_code_reduce_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_e), static_cast<int64_t*>(code), N, code_tiles);
  return (int)cudaGetLastError();
}
